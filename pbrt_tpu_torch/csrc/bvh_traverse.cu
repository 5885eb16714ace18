// BVH2 closest-hit / any-hit traversal for Hopper (sm_90a).
//
// Replaces four TPU kernels of pbrt_tpu/accel/pallas_traverse.py, which are
// schedules of one walk: _kernel_block_queue (B1: persistent 1024-ray block
// walks with a shared SMEM stack and block-majority near/far votes),
// _kernel_block_all (B2: the same walk in one launch over all blocks, with
// barycentrics out), _kernel_block (B4: one 1024-ray block per grid step,
// no occluder seed, slab (lo - o)*inv) and _kernel (B5: a 64-deep stack per
// 128-ray packet, node words from VMEM for trees over 32,768 nodes, B4's
// slab). This kernel keeps their contracts and arithmetic, not their
// layout; three template switches pick the contract:
//   kMulSub  slab lo*inv - o*inv (B1, B2), else (lo - o)*inv (B4, B5);
//   kSeed    test the 8-triangle occluder seed before the walk (B1, B2);
//   kBary    write b1/b2 of the hit (B2, B4, B5).
// See pbrt_tpu_torch/accel/traverse.py for the contract and for
// traverse_plain, the PyTorch version it must match bit for bit.
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
// to hide some latency, and (with kSeed) the occluder seed to shrink t_best
// early. Wider nodes (bvh4_traverse.cu), a persistent scheduler and a
// compressed node layout are left for later work.
//
// Arithmetic: see bvh_common.cuh; build with --fmad=false.

#include "bvh_common.cuh"

namespace {

using namespace bvh;

constexpr int kStack = 64;      // traverse.py STACK

template <bool kMulSub, bool kSeed, bool kBary>
__global__ void __launch_bounds__(kThreads)
traverse_kernel(const int* __restrict__ metas, const float4* __restrict__ nodes,
                const float4* __restrict__ tris, const float4* __restrict__ seed,
                const int* __restrict__ seed_slots, const float* __restrict__ o,
                const float* __restrict__ d, const float* __restrict__ tmax,
                const uint8_t* __restrict__ anyhit, int n, float* __restrict__ t_out,
                int* __restrict__ slot_out, float* __restrict__ b1_out,
                float* __restrict__ b2_out, int* __restrict__ scratch) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int pops = 0, ovf = 0;
  if (i < n) {
    const Ray r = make_ray(o, d, i);
    const bool any = anyhit[i] != 0;
    Hit h = {tmax[i], -1, 0.0f, 0.0f};
    if (kSeed) test_seed<kBary>(r, seed, seed_slots, any, h);

    int stack[kStack];
    int sp = 0;
    if (!(any && h.slot >= 0)) stack[sp++] = 0;
    while (sp > 0) {
      const int idx = stack[--sp];
      ++pops;
      const int w = __ldg(metas + idx);
      const int ax = w & 3, cnt = (w >> 2) & 15, payload = (w >> 6) & 0x3FFFFFF;
      if (cnt > 0) {
        test_leaf<kBary>(r, tris, payload, cnt, any, h);
        if (any && h.slot >= 0) break;
      } else {
        const float4* rec = nodes + (size_t)idx * 4;
        float4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 2);
        bool hl = slab<kMulSub>(r, a.x, a.y, a.z, a.w, b.x, b.y, h.t);
        bool hr = slab<kMulSub>(r, b.z, b.w, c.x, c.y, c.z, c.w, h.t);
        bool swap = r.neg[ax];
        int near = swap ? payload : idx + 1, far = swap ? idx + 1 : payload;
        bool h_near = swap ? hr : hl, h_far = swap ? hl : hr;
        if (h_far) { if (sp < kStack) stack[sp++] = far; else ovf = 1; }
        if (h_near) { if (sp < kStack) stack[sp++] = near; else ovf = 1; }
      }
    }
    t_out[i] = h.t;
    slot_out[i] = h.slot;
    if (kBary) {
      b1_out[i] = h.b1;
      b2_out[i] = h.b2;
    }
  }
  group_iters(i, n, pops, ovf, scratch);
}

}  // namespace

// B1: (t, slot), seed, slab lo*inv - o*inv.
extern "C" int pbrt_bvh_traverse(const void* metas, const void* nodes, const void* tris,
                                 const void* seed, const void* seed_slots, const void* o,
                                 const void* d, const void* tmax, const void* anyhit, int n,
                                 void* t_out, void* slot_out, void* scratch, void* stream) {
  int blocks = (n + kThreads - 1) / kThreads;
  traverse_kernel<true, true, false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)metas, (const float4*)nodes, (const float4*)tris, (const float4*)seed,
      (const int*)seed_slots, (const float*)o, (const float*)d, (const float*)tmax,
      (const uint8_t*)anyhit, n, (float*)t_out, (int*)slot_out, nullptr, nullptr,
      (int*)scratch);
  return (int)cudaGetLastError();
}

// With barycentrics: variant 0 is B2 (seed, slab lo*inv - o*inv), variant 1
// is B4/B5 (no seed, slab (lo - o)*inv).
extern "C" int pbrt_bvh_traverse_bary(const void* metas, const void* nodes, const void* tris,
                                      const void* seed, const void* seed_slots, const void* o,
                                      const void* d, const void* tmax, const void* anyhit,
                                      int n, int variant, void* t_out, void* slot_out,
                                      void* b1_out, void* b2_out, void* scratch, void* stream) {
  int blocks = (n + kThreads - 1) / kThreads;
  auto kernel = variant == 0 ? traverse_kernel<true, true, true>
                             : traverse_kernel<false, false, true>;
  if (variant != 0 && variant != 1) return (int)cudaErrorInvalidValue;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)metas, (const float4*)nodes, (const float4*)tris, (const float4*)seed,
      (const int*)seed_slots, (const float*)o, (const float*)d, (const float*)tmax,
      (const uint8_t*)anyhit, n, (float*)t_out, (int*)slot_out, (float*)b1_out,
      (float*)b2_out, (int*)scratch);
  return (int)cudaGetLastError();
}
