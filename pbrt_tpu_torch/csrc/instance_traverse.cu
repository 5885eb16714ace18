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
// (csrc/bvh_traverse.cu). The walk is a pointer chase whose next address
// depends on the last load; entering an instance adds its matrix and a
// ray setup (four IEEE divisions); rays of a warp walk
// different nodes and different instances, so warps diverge and loads do
// not coalesce.
//
// What the design does about it: one thread per ray with a private
// 96-entry stack in local memory (the packer raises where the walk could
// need more). It walks the records of
// accel/instance.py::instance_records: each interior record holds both
// children's boxes and both children's words, so a pop makes one dependent
// load (a record, a leaf block, or an instance record), and an instance
// record holds its walk matrix and its prototype root's word, so entering
// is one load, not a chain of three. The world ray's setup stays in
// registers and leaving an instance switches back to it; entering derives
// the prototype ray from the ray moved by the lane's own matrix at its own
// time. The near child stays in a register rather than going through the
// stack. Blocks of 64 threads (kWalkThreads) hold 28 warps a SM at this
// kernel's registers, not 24, and free their slots two warps at a time:
// over a pass (1 camera and 4 shell launches) 2.5% faster than blocks of
// 256, though the camera launch alone is slower. Per ray the pops, their
// order, the tests and the overflows are those of the first design. A
// stack in shared memory, all 8 leaf rows loaded before the tests, a
// while-while loop, persistent warps and dynamic fetch were measured and
// were slower here (PERF.md section 6). The slerp path is a template
// parameter, compiled in only for scenes with an animated instance.
//
// Arithmetic: build with --fmad=false. The slab test is (lo - o) * inv with
// the far distance scaled by 1.00000024f; the triangle test is the
// naive-shear watertight test with the 1e-4*det lower bound and the strict
// t_sc < t_best*det; 1/x is IEEE; min/max propagate NaN like torch's; the
// slerp uses acosf, sinf and rsqrtf, as torch's CUDA ops do.

#include "bvh_common.cuh"

namespace {

using namespace bvh;

constexpr int kStack = 96;        // instance.py STACK
constexpr int kRestore = -2;      // instance.py RESTORE
constexpr int kEnter = 15;        // instance.py ENTER
constexpr int kImat = 56;         // instance.py IMAT_STRIDE
constexpr int kIrecFloat4 = 16;   // an instance record: instance.py IREC_STRIDE floats
constexpr int kIrecRoot = kImat;  // where an instance record holds its root's word

// The lane's world->prototype 3x4 matrix at clipped time t (instance.py
// _walk_matrix, in the same order of operations) and the prototype root's
// word, from one instance record: floats 0:24 (static) or 24:56 (kTrs) and
// the word at kIrecRoot, all loaded at once.
template <bool kTrs>
__device__ __forceinline__ int enter(const float4* __restrict__ rec, float t, float M[12]) {
  const int root = __float_as_int(__ldg(reinterpret_cast<const float*>(rec) + kIrecRoot));
  if (!kTrs) {
    float m[24];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      float4 v = __ldg(rec + j);
      m[4 * j] = v.x; m[4 * j + 1] = v.y; m[4 * j + 2] = v.z; m[4 * j + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < 12; ++j) M[j] = m[j] + t * m[12 + j];
    return root;
  }
  float c[kImat - 24];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float4 v = __ldg(rec + 6 + j);
    c[4 * j] = v.x; c[4 * j + 1] = v.y; c[4 * j + 2] = v.z; c[4 * j + 3] = v.w;
  }
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
  return root;
}


template <bool kTrs>
__global__ void __launch_bounds__(kWalkThreads)
instance_kernel(const float4* __restrict__ recs, const float4* __restrict__ tris,
                const float4* __restrict__ irec, const float* __restrict__ o,
                const float* __restrict__ d, const float* __restrict__ tmax,
                const float* __restrict__ time, int n, int root,
                float* __restrict__ t_out, int* __restrict__ slot_out,
                float* __restrict__ b1_out, float* __restrict__ b2_out,
                int* __restrict__ inst_out, int* __restrict__ scratch) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int pops = 0, ovf = 0;
  if (i < n) {
    const float wox = o[3 * i], woy = o[3 * i + 1], woz = o[3 * i + 2];
    const float wdx = d[3 * i], wdy = d[3 * i + 1], wdz = d[3 * i + 2];
    const float tcl = nmin(nmax(time[i], 0.0f), 1.0f);
    const WalkRay wr = walk_ray(wox, woy, woz, wdx, wdy, wdz);   // the world ray, kept
    WalkRay r = wr;
    Hit h = {tmax[i], -1, 0.0f, 0.0f};
    int inst = -1, cur = -1;

    int stack[kStack];
    Stack st = {stack, kStack, 0};
    int w = root;
    bool have = true;
    while (have) {
      ++pops;
      const int cnt = (w >> 2) & 15, payload = (w >> 6) & 0x1FFFFFF;
      if (w == kRestore) {  // leave the instance: back to the world ray
        r = wr;
        cur = -1;
        have = false;
      } else if (cnt == kEnter) {  // enter instance `payload`
        float M[12];
        const int proot = enter<kTrs>(irec + (size_t)payload * kIrecFloat4, tcl, M);
        r = walk_ray(M[0] * wox + M[1] * woy + M[2] * woz + M[3],
                     M[4] * wox + M[5] * woy + M[6] * woz + M[7],
                     M[8] * wox + M[9] * woy + M[10] * woz + M[11],
                     M[0] * wdx + M[1] * wdy + M[2] * wdz,
                     M[4] * wdx + M[5] * wdy + M[6] * wdz,
                     M[8] * wdx + M[9] * wdy + M[10] * wdz);
        cur = payload;
        st.push(kRestore, ovf);
        have = st.sp < st.cap;   // the root, pushed and popped at once
        if (have) w = proot; else ovf = 1;
      } else if (cnt > 0) {
        if (walk_leaf<true>(r, tris, payload, cnt, false, h)) inst = cur;
        have = false;
      } else {
        have = visit_next(r, load_rec(recs, payload), w & 3, h.t, st, ovf, w);
      }
      if (!have && st.sp > 0) { w = st.pop(); have = true; }
    }
    t_out[i] = h.t;
    slot_out[i] = h.slot;
    b1_out[i] = h.b1;
    b2_out[i] = h.b2;
    inst_out[i] = inst;
  }
  group_iters(i, n, pops, ovf, scratch);
}

}  // namespace

extern "C" int pbrt_instance_traverse(const void* recs, const void* tris, const void* irec,
                                      const void* o, const void* d, const void* tmax,
                                      const void* time, int n, int trs, int root,
                                      void* t_out, void* slot_out, void* b1_out, void* b2_out,
                                      void* inst_out, void* scratch, void* stream) {
  int blocks = (n + kWalkThreads - 1) / kWalkThreads;
  auto kernel = trs ? instance_kernel<true> : instance_kernel<false>;
  kernel<<<blocks, kWalkThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)recs, (const float4*)tris, (const float4*)irec, (const float*)o,
      (const float*)d, (const float*)tmax, (const float*)time, n, root, (float*)t_out,
      (int*)slot_out, (float*)b1_out, (float*)b2_out, (int*)inst_out, (int*)scratch);
  return (int)cudaGetLastError();
}
