// BVH2 closest-hit / any-hit traversal for Hopper (sm_90a).
//
// Replaces the TPU kernel pbrt_tpu/accel/pallas_traverse.py::_kernel_block_queue
// (persistent 1024-ray block walks with a shared SMEM stack and
// block-majority near/far votes). This kernel keeps that kernel's contract
// and arithmetic, not its layout: see pbrt_tpu_torch/accel/traverse.py for
// the contract and for traverse_plain, the PyTorch version it must match
// bit for bit.
//
// What bounds it on this card: latency, not bandwidth or arithmetic. Each
// pop is a chain of dependent gathers: a 4-byte node word, then either a
// 64-byte node record (48 bytes used) or a 512-byte leaf block of 8
// triangles (9 of every 16 floats used), and the next pop's address depends
// on the result. Rays of a warp walk different nodes, so warps diverge and
// loads do not coalesce.
//
// What this simple design does about it: one thread per ray with a private
// stack in local memory (no inter-thread votes or barriers), node and leaf
// reads through the read-only path (__ldg) as float4, enough resident warps
// to hide some latency, and the occluder seed (8 large triangles tested
// before the walk) to shrink t_best early. Wider nodes, a persistent
// scheduler and a compressed node layout are left for later work.
//
// Arithmetic: build with --fmad=false. The slab test is lo*inv - o*inv with
// the far distance scaled by 1.00000024f; the triangle test is the
// naive-shear watertight test with the 1e-4*det lower bound and the strict
// t_sc < t_best*det; 1/x is IEEE; min/max propagate NaN like torch's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStack = 64;      // traverse.py STACK
constexpr int kLeafTris = 8;    // traverse.py LEAF_TRIS
constexpr int kGroup = 1024;    // traverse.py GROUP
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
  float oxi, oyi, ozi;
  float sx, sy, sz;
  int kx, ky, kz;
  bool neg[3];
};

__device__ __forceinline__ bool slab(const Ray& r, float lx, float ly, float lz,
                                     float hx, float hy, float hz, float t_best) {
  float t0x = lx * r.ix - r.oxi;
  float t1x = hx * r.ix - r.oxi;
  float t0y = ly * r.iy - r.oyi;
  float t1y = hy * r.iy - r.oyi;
  float t0z = lz * r.iz - r.ozi;
  float t1z = hz * r.iz - r.ozi;
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
__device__ __forceinline__ bool tri_test(const Ray& r, const float4* row,
                                         float t_best, float& t_hit) {
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
  t_hit = t_sc * (1.0f / det);
  return true;
}

__global__ void __launch_bounds__(kThreads)
traverse_kernel(const int* __restrict__ metas, const float4* __restrict__ nodes,
                const float4* __restrict__ tris, const float4* __restrict__ seed,
                const int* __restrict__ seed_slots, const float* __restrict__ o,
                const float* __restrict__ d, const float* __restrict__ tmax,
                const uint8_t* __restrict__ anyhit, int n, float* __restrict__ t_out,
                int* __restrict__ slot_out, int* __restrict__ scratch) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int pops = 0, ovf = 0;
  if (i < n) {
    Ray r;
    r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
    float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    r.ix = guard_inv(dx); r.iy = guard_inv(dy); r.iz = guard_inv(dz);
    r.oxi = r.ox * r.ix; r.oyi = r.oy * r.iy; r.ozi = r.oz * r.iz;
    float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
    r.kz = (adx >= ady && adx >= adz) ? 0 : (ady >= adz ? 1 : 2);
    r.kx = (r.kz + 1) % 3;
    r.ky = (r.kx + 1) % 3;
    float dpz = pick(dx, dy, dz, r.kz);
    r.sz = 1.0f / (dpz == 0.0f ? kTiny : dpz);
    r.sx = -pick(dx, dy, dz, r.kx) * r.sz;
    r.sy = -pick(dx, dy, dz, r.ky) * r.sz;
    r.neg[0] = dx < 0.0f; r.neg[1] = dy < 0.0f; r.neg[2] = dz < 0.0f;
    const bool any = anyhit[i] != 0;

    float t_best = tmax[i];
    int slot = -1;
    float th;
    const int scnt = __ldg(seed_slots + kLeafTris);
    for (int j = 0; j < scnt; ++j) {
      if (tri_test(r, seed + 4 * j, t_best, th)) {
        t_best = any ? 0.0f : th;
        slot = __ldg(seed_slots + j);
      }
    }

    int stack[kStack];
    int sp = 0;
    if (!(any && slot >= 0)) stack[sp++] = 0;
    while (sp > 0) {
      const int idx = stack[--sp];
      ++pops;
      const int w = __ldg(metas + idx);
      const int ax = w & 3, cnt = (w >> 2) & 15, payload = (w >> 6) & 0x3FFFFFF;
      if (cnt > 0) {
        const float4* blk = tris + (size_t)payload * kLeafTris * 4;
        for (int j = 0; j < kLeafTris && j < cnt; ++j) {
          if (tri_test(r, blk + 4 * j, t_best, th)) {
            t_best = any ? 0.0f : th;
            slot = payload * kLeafTris + j;
          }
        }
        if (any && slot >= 0) break;
      } else {
        const float4* rec = nodes + (size_t)idx * 4;
        float4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 2);
        bool hl = slab(r, a.x, a.y, a.z, a.w, b.x, b.y, t_best);
        bool hr = slab(r, b.z, b.w, c.x, c.y, c.z, c.w, t_best);
        bool swap = r.neg[ax];
        int near = swap ? payload : idx + 1, far = swap ? idx + 1 : payload;
        bool h_near = swap ? hr : hl, h_far = swap ? hl : hr;
        if (h_far) { if (sp < kStack) stack[sp++] = far; else ovf = 1; }
        if (h_near) { if (sp < kStack) stack[sp++] = near; else ovf = 1; }
      }
    }
    t_out[i] = t_best;
    slot_out[i] = slot;
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

extern "C" int pbrt_bvh_traverse(const void* metas, const void* nodes, const void* tris,
                                 const void* seed, const void* seed_slots, const void* o,
                                 const void* d, const void* tmax, const void* anyhit, int n,
                                 void* t_out, void* slot_out, void* scratch, void* stream) {
  int blocks = (n + kThreads - 1) / kThreads;
  traverse_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)metas, (const float4*)nodes, (const float4*)tris, (const float4*)seed,
      (const int*)seed_slots, (const float*)o, (const float*)d, (const float*)tmax,
      (const uint8_t*)anyhit, n, (float*)t_out, (int*)slot_out, (int*)scratch);
  return (int)cudaGetLastError();
}
