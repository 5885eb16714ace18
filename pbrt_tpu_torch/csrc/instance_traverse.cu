// Two-level instance traversal (object instances, animated shapes) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel pbrt_tpu/accel/pallas_instance.py::_kernel_inst
// (1024-ray blocks with one shared SMEM stack, block-majority near/far
// votes, and the current ray selected through `where` on every step). This
// kernel keeps that kernel's contract and arithmetic, not its layout: see
// pbrt_tpu_torch/accel/instance.py for the contract and for
// instance_traverse_plain, the PyTorch version it must match bit for bit.
//
// What bounds it on this card: latency, as for the BVH walk
// (csrc/bvh_traverse.cu). Each pop is a chain of dependent gathers: a 4-byte
// node word, then a 64-byte node record (48 bytes used) or a 512-byte leaf
// block of 8 prototype triangles, and the next address depends on the
// result. Entering an instance adds a 224-byte matrix record. Rays of a warp
// walk different nodes and different instances, so warps diverge and loads
// do not coalesce.
//
// What this simple design does about it: one thread per ray with a private
// stack in local memory, sized by the packer's bound (no inter-thread votes
// or barriers); the world ray stays in registers, so leaving an instance
// re-derives the world precomputes from it, and entering one derives them
// from the ray moved by the lane's own matrix at its own time; node, leaf
// and matrix reads go through the read-only path (__ldg). The slerp path is
// a template parameter, compiled in only for scenes with an animated
// instance. Wider nodes, ray sorting and a persistent scheduler are left for
// later work.
//
// Arithmetic: build with --fmad=false. The slab test is (lo - o) * inv with
// the far distance scaled by 1.00000024f; the triangle test is the
// naive-shear watertight test with the 1e-4*det lower bound and the strict
// t_sc < t_best*det; 1/x is IEEE; min/max propagate NaN like torch's; the
// slerp uses acosf, sinf and rsqrtf, as torch's CUDA ops do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStack = 96;        // instance.py STACK
constexpr int kLeafTris = 8;      // traverse.py LEAF_TRIS
constexpr int kGroup = 1024;      // traverse.py GROUP
constexpr int kRestore = -2;      // instance.py RESTORE
constexpr int kEnter = 15;        // instance.py ENTER
constexpr int kImat = 56;         // instance.py IMAT_STRIDE
constexpr int kThreads = 256;
constexpr float kTiny = 1e-20f;

__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float pick(float x, float y, float z, int k) {
  return k == 0 ? x : (k == 1 ? y : z);
}
__device__ __forceinline__ float guard_inv(float v) {
  return 1.0f / (fabsf(v) < kTiny ? (v < 0.0f ? -kTiny : kTiny) : v);
}

struct Ray {
  float ox, oy, oz;
  float ix, iy, iz;
  float sx, sy, sz;
  int kx, ky, kz;
  bool neg[3];
};

__device__ __forceinline__ void derive(Ray& r, float ox, float oy, float oz,
                                       float dx, float dy, float dz) {
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.ix = guard_inv(dx); r.iy = guard_inv(dy); r.iz = guard_inv(dz);
  float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
  r.kz = (adx >= ady && adx >= adz) ? 0 : (ady >= adz ? 1 : 2);
  r.kx = (r.kz + 1) % 3;
  r.ky = (r.kx + 1) % 3;
  float dpz = pick(dx, dy, dz, r.kz);
  r.sz = 1.0f / (dpz == 0.0f ? kTiny : dpz);
  r.sx = -pick(dx, dy, dz, r.kx) * r.sz;
  r.sy = -pick(dx, dy, dz, r.ky) * r.sz;
  r.neg[0] = dx < 0.0f; r.neg[1] = dy < 0.0f; r.neg[2] = dz < 0.0f;
}

__device__ __forceinline__ bool slab(const Ray& r, float lx, float ly, float lz,
                                     float hx, float hy, float hz, float t_best) {
  float t0x = (lx - r.ox) * r.ix;
  float t1x = (hx - r.ox) * r.ix;
  float t0y = (ly - r.oy) * r.iy;
  float t1y = (hy - r.oy) * r.iy;
  float t0z = (lz - r.oz) * r.iz;
  float t1z = (hz - r.oz) * r.iz;
  float tn = nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)), nmin(t0z, t1z));
  float tf = nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)), nmax(t0z, t1z)) * 1.00000024f;
  return (tn <= tf) && (tf > 0.0f) && (tn < t_best);
}

__device__ __forceinline__ void shear(const Ray& r, float px, float py, float pz,
                                      float& x, float& y, float& z) {
  float tx = px - r.ox, ty = py - r.oy, tz = pz - r.oz;
  float vz = pick(tx, ty, tz, r.kz);
  x = pick(tx, ty, tz, r.kx) + r.sx * vz;
  y = pick(tx, ty, tz, r.ky) + r.sy * vz;
  z = vz * r.sz;
}

// One triangle row (p0 in [0:3], p1 in [3:6], p2 in [6:9] of 16 floats).
__device__ __forceinline__ bool tri_test(const Ray& r, const float4* row, float t_best,
                                         float& t_hit, float& b1, float& b2) {
  float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
  float x0, y0, z0, x1, y1, z1, x2, y2, z2;
  shear(r, a.x, a.y, a.z, x0, y0, z0);
  shear(r, a.w, b.x, b.y, x1, y1, z1);
  shear(r, b.z, b.w, c.x, x2, y2, z2);
  float e0 = x1 * y2 - y1 * x2;
  float e1 = x2 * y0 - y2 * x0;
  float e2 = x0 * y1 - y0 * x1;
  bool same = (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) ||
              (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
  float det = e0 + e1 + e2;
  float t_sc = e0 * z0 + e1 * z1 + e2 * z2;
  bool t_ok = det > 0.0f ? (t_sc > 1e-4f * det && t_sc < t_best * det)
                         : (t_sc < 1e-4f * det && t_sc > t_best * det);
  if (!(same && det != 0.0f && t_ok)) return false;
  float inv_det = 1.0f / det;
  t_hit = t_sc * inv_det;
  b1 = e1 * inv_det;
  b2 = e2 * inv_det;
  return true;
}

// The lane's world->prototype 3x4 matrix at clipped time t (instance.py
// _walk_matrix, in the same order of operations).
template <bool kTrs>
__device__ __forceinline__ void walk_matrix(const float* __restrict__ m, float t,
                                            float M[12]) {
  if (!kTrs) {
#pragma unroll
    for (int j = 0; j < 12; ++j) M[j] = __ldg(m + j) + t * __ldg(m + 12 + j);
    return;
  }
  float c[kImat - 24];
#pragma unroll
  for (int j = 0; j < kImat - 24; ++j) c[j] = __ldg(m + 24 + j);
  const float* T0 = c;
  const float* T1 = c + 3;
  const float* q0 = c + 6;
  const float* q1 = c + 10;
  const float* S0 = c + 14;
  const float* S1 = c + 23;
  float dq = q0[0] * q1[0] + q0[1] * q1[1] + q0[2] * q1[2] + q0[3] * q1[3];
  dq = nmin(nmax(dq, -1.0f), 1.0f);
  float theta = acosf(dq);
  float sth = sinf(theta);
  bool small = sth < 1e-4f;
  float a = t * theta;
  float inv_s = 1.0f / (small ? 1.0f : sth);
  float w1 = small ? t : sinf(a) * inv_s;
  float w0 = small ? 1.0f - t : sinf(theta - a) * inv_s;
  float q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) q[j] = w0 * q0[j] + w1 * q1[j];
  float qn = rsqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  float x = q[0] * qn, y = q[1] * qn, z = q[2] * qn, w = q[3] * qn;
  float R[9] = {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - z * w), 2.0f * (x * z + y * w),
                2.0f * (x * y + z * w), 1.0f - 2.0f * (x * x + z * z), 2.0f * (y * z - x * w),
                2.0f * (x * z - y * w), 2.0f * (y * z + x * w), 1.0f - 2.0f * (x * x + y * y)};
  float S[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) S[j] = S0[j] + t * (S1[j] - S0[j]);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int col = 0; col < 3; ++col)
      M[4 * r + col] = R[3 * r] * S[col] + R[3 * r + 1] * S[3 + col] + R[3 * r + 2] * S[6 + col];
    M[4 * r + 3] = T0[r] + t * (T1[r] - T0[r]);
  }
}

template <bool kTrs>
__global__ void __launch_bounds__(kThreads)
instance_kernel(const int* __restrict__ metas, const float4* __restrict__ nodes,
                const float4* __restrict__ tris, const float* __restrict__ imat,
                const int* __restrict__ iroot, const float* __restrict__ o,
                const float* __restrict__ d, const float* __restrict__ tmax,
                const float* __restrict__ time, int n, float* __restrict__ t_out,
                int* __restrict__ slot_out, float* __restrict__ b1_out,
                float* __restrict__ b2_out, int* __restrict__ inst_out,
                int* __restrict__ scratch) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int pops = 0, ovf = 0;
  if (i < n) {
    const float wox = o[3 * i], woy = o[3 * i + 1], woz = o[3 * i + 2];
    const float wdx = d[3 * i], wdy = d[3 * i + 1], wdz = d[3 * i + 2];
    const float tcl = nmin(nmax(time[i], 0.0f), 1.0f);
    Ray r;
    derive(r, wox, woy, woz, wdx, wdy, wdz);
    float t_best = tmax[i], b1 = 0.0f, b2 = 0.0f;
    int slot = -1, inst = -1, cur = -1;
    float th, u, v;

    int stack[kStack];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const int raw = stack[--sp];
      ++pops;
      if (raw == kRestore) {  // leave the instance: back to the world ray
        derive(r, wox, woy, woz, wdx, wdy, wdz);
        cur = -1;
        continue;
      }
      const int w = __ldg(metas + raw);
      const int ax = w & 3, cnt = (w >> 2) & 15, payload = (w >> 6) & 0x1FFFFFF;
      if (cnt == kEnter) {  // enter instance `payload`
        float M[12];
        walk_matrix<kTrs>(imat + (size_t)payload * kImat, tcl, M);
        derive(r, M[0] * wox + M[1] * woy + M[2] * woz + M[3],
               M[4] * wox + M[5] * woy + M[6] * woz + M[7],
               M[8] * wox + M[9] * woy + M[10] * woz + M[11],
               M[0] * wdx + M[1] * wdy + M[2] * wdz,
               M[4] * wdx + M[5] * wdy + M[6] * wdz,
               M[8] * wdx + M[9] * wdy + M[10] * wdz);
        cur = payload;
        if (sp < kStack) stack[sp++] = kRestore; else ovf = 1;
        if (sp < kStack) stack[sp++] = __ldg(iroot + payload); else ovf = 1;
      } else if (cnt > 0) {
        const float4* blk = tris + (size_t)payload * kLeafTris * 4;
        for (int j = 0; j < kLeafTris && j < cnt; ++j) {
          if (tri_test(r, blk + 4 * j, t_best, th, u, v)) {
            t_best = th;
            b1 = u;
            b2 = v;
            slot = payload * kLeafTris + j;
            inst = cur;
          }
        }
      } else {
        const float4* rec = nodes + (size_t)raw * 4;
        float4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 2);
        bool hl = slab(r, a.x, a.y, a.z, a.w, b.x, b.y, t_best);
        bool hr = slab(r, b.z, b.w, c.x, c.y, c.z, c.w, t_best);
        bool swap = r.neg[ax];
        int near = swap ? payload : raw + 1, far = swap ? raw + 1 : payload;
        bool h_near = swap ? hr : hl, h_far = swap ? hl : hr;
        if (h_far) { if (sp < kStack) stack[sp++] = far; else ovf = 1; }
        if (h_near) { if (sp < kStack) stack[sp++] = near; else ovf = 1; }
      }
    }
    t_out[i] = t_best;
    slot_out[i] = slot;
    b1_out[i] = b1;
    b2_out[i] = b2;
    inst_out[i] = inst;
  }
  // per 1024-ray group: max pops and any overflow (max/or are order-free)
  unsigned mask = __ballot_sync(0xffffffffu, i < n);
  if (i < n) {
    int wmax = __reduce_max_sync(mask, pops);
    int wovf = __reduce_or_sync(mask, ovf);
    if ((threadIdx.x & 31) == __ffs(mask) - 1) {
      int g = i / kGroup;
      int ng = (n + kGroup - 1) / kGroup;
      atomicMax(scratch + g, wmax);
      if (wovf) atomicOr(scratch + ng + g, 1);
    }
  }
}

}  // namespace

extern "C" int pbrt_instance_traverse(const void* metas, const void* nodes, const void* tris,
                                      const void* imat, const void* iroot, const void* o,
                                      const void* d, const void* tmax, const void* time,
                                      int n, int trs, void* t_out, void* slot_out,
                                      void* b1_out, void* b2_out, void* inst_out,
                                      void* scratch, void* stream) {
  int blocks = (n + kThreads - 1) / kThreads;
  auto kernel = trs ? instance_kernel<true> : instance_kernel<false>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)metas, (const float4*)nodes, (const float4*)tris, (const float*)imat,
      (const int*)iroot, (const float*)o, (const float*)d, (const float*)tmax,
      (const float*)time, n, (float*)t_out, (int*)slot_out, (float*)b1_out, (float*)b2_out,
      (int*)inst_out, (int*)scratch);
  return (int)cudaGetLastError();
}
