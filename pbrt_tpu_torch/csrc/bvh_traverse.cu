// BVH2 closest-hit / any-hit traversal for Hopper (sm_90a).
//
// Replaces four TPU kernels of pbrt_tpu/accel/pallas_traverse.py, which are
// schedules of one walk: _kernel_block_queue (B1, :1001, called at :1712:
// persistent 1024-ray block walks with a shared SMEM stack and
// block-majority near/far votes), _kernel_block_all (B2, :698, called at
// :1757: the same walk in one launch over all blocks, with barycentrics
// out), _kernel_block (B4, :512: one 1024-ray block per grid step, no
// occluder seed, slab (lo - o)*inv) and _kernel (B5, :257: a 64-deep stack
// per 128-ray packet, node words from VMEM for trees over 32,768 nodes, B4's
// slab; both called at :1848). These kernels keep their contracts and
// arithmetic, not their layout. walk_kernel's three template switches pick
// the contract:
//   kMulSub  slab lo*inv - o*inv (B1, B2), else (lo - o)*inv (B4, B5);
//   kSeed    test the 8-triangle occluder seed before the walk (B1, B2);
//   kBary    write b1/b2 of the hit (B2, B4, B5).
// See pbrt_tpu_torch/accel/traverse.py for the contract and for
// traverse_plain, the PyTorch version every instance must match bit for bit.
//
// What bounds it on this card: latency, not bandwidth or arithmetic. A walk
// is a pointer chase: each pop's loads decide the next pop's address, and
// rays of a warp walk different nodes, so warps diverge and loads do not
// coalesce. Its bound from bytes and operations is about 2% of its time.
//
// The design against that chase: one thread per ray walks the records of
// accel/traverse.py::walk_records from the root's word (a leaf's word where
// the root is a leaf). A record holds both children's boxes and both
// children's words, so a popped word already says whether it is a leaf and
// where its data is: one dependent load per pop (the first design of B1 and
// B2 loaded the node's word and only then its box record or leaf block, and
// kept its Ray in local memory to index the direction's signs). The near
// child stays in a register rather than going through the stack. The
// seeded walks (B1, B2) test the occluder seed first, and an any-hit ray
// the seed hit skips the walk. Every walk is a while-while loop (Aila and
// Laine, HPG 2009): a lane pops interior nodes until it reaches a leaf, so
// the lanes of a warp test their leaves together instead of each leaf test
// splitting the warp. Blocks of 64 threads (kWalkThreads) let the card
// refill an SM two warps at a time as their rays finish. Per ray the pops,
// their order, the tests and the overflows are those of the plain walk.
// Measured on the card and dropped: for B1/B2, one pop a step (the records
// and the register near child alone took 2% off a large render's B1 time,
// the while-while loop a further 9%) and blocks of 256 (1.6% slower a large
// render); for B4/B5, a stack in shared memory, all 8 leaf rows loaded
// before the tests (117 registers), persistent warps and dynamic fetch
// (PERF.md section 6).
//
// Arithmetic: see bvh_common.cuh; build with --fmad=false.

#include "bvh_common.cuh"

namespace {

using namespace bvh;

constexpr int kStack = 64;      // traverse.py STACK

// One thread per ray over the walk records from the word root. seed and
// seed_slots come last, so that the seedless instance's parameters keep the
// offsets they had before the seeded walks joined it.
template <bool kMulSub, bool kSeed, bool kBary>
__global__ void __launch_bounds__(kWalkThreads)
walk_kernel(const float4* __restrict__ recs, const float4* __restrict__ tris,
            const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ tmax, const uint8_t* __restrict__ anyhit, int n,
            int root, float* __restrict__ t_out, int* __restrict__ slot_out,
            float* __restrict__ b1_out, float* __restrict__ b2_out, int* __restrict__ scratch,
            const float4* __restrict__ seed, const int* __restrict__ seed_slots) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int pops = 0, ovf = 0;
  if (i < n) {
    const WalkRay r = walk_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2],
                               d[3 * i], d[3 * i + 1], d[3 * i + 2]);
    const bool any = anyhit[i] != 0;
    Hit h = {tmax[i], -1, 0.0f, 0.0f};
    if (kSeed) test_seed<kBary>(r, seed, seed_slots, any, h);
    int stack[kStack];
    Stack st = {stack, kStack, 0};
    int w = root;
    bool have = !(kSeed && any && h.slot >= 0);   // an any-hit ray the seed hit is done
    while (have) {
      while (have && ((w >> 2) & 15) == 0) {   // interior nodes until a leaf
        ++pops;
        have = visit_next<kMulSub>(r, load_rec(recs, (w >> 6) & 0x3FFFFFF), w & 3, h.t, st,
                                   ovf, w);
        if (!have && st.sp > 0) { w = st.pop(); have = true; }
      }
      if (!have) break;
      ++pops;                                  // the leaf
      walk_leaf<kBary>(r, tris, (w >> 6) & 0x3FFFFFF, (w >> 2) & 15, any, h);
      if (any && h.slot >= 0) break;
      have = st.sp > 0;
      if (have) w = st.pop();
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

template <bool kMulSub, bool kSeed, bool kBary>
int launch(const void* recs, const void* tris, const void* seed, const void* seed_slots,
           const void* o, const void* d, const void* tmax, const void* anyhit, int n, int root,
           void* t_out, void* slot_out, void* b1_out, void* b2_out, void* scratch,
           void* stream) {
  walk_kernel<kMulSub, kSeed, kBary><<<(n + kWalkThreads - 1) / kWalkThreads, kWalkThreads, 0,
                                       (cudaStream_t)stream>>>(
      (const float4*)recs, (const float4*)tris, (const float*)o, (const float*)d,
      (const float*)tmax, (const uint8_t*)anyhit, n, root, (float*)t_out, (int*)slot_out,
      (float*)b1_out, (float*)b2_out, (int*)scratch, (const float4*)seed,
      (const int*)seed_slots);
  return (int)cudaGetLastError();
}

}  // namespace

// B1: (t, slot) over the walk records recs from the word root; seed, slab
// lo*inv - o*inv.
extern "C" int pbrt_bvh_traverse(const void* recs, const void* tris, const void* seed,
                                 const void* seed_slots, const void* o, const void* d,
                                 const void* tmax, const void* anyhit, int n, int root,
                                 void* t_out, void* slot_out, void* scratch, void* stream) {
  return launch<true, true, false>(recs, tris, seed, seed_slots, o, d, tmax, anyhit, n, root,
                                   t_out, slot_out, nullptr, nullptr, scratch, stream);
}

// With barycentrics, over the same records: variant 0 is B2 (seed, slab
// lo*inv - o*inv), variant 1 is B4/B5 (no seed, slab (lo - o)*inv).
extern "C" int pbrt_bvh_traverse_bary(const void* recs, const void* tris, const void* seed,
                                      const void* seed_slots, const void* o, const void* d,
                                      const void* tmax, const void* anyhit, int n, int variant,
                                      int root, void* t_out, void* slot_out, void* b1_out,
                                      void* b2_out, void* scratch, void* stream) {
  if (variant == 0)
    return launch<true, true, true>(recs, tris, seed, seed_slots, o, d, tmax, anyhit, n, root,
                                    t_out, slot_out, b1_out, b2_out, scratch, stream);
  if (variant == 1)
    return launch<false, false, true>(recs, tris, seed, seed_slots, o, d, tmax, anyhit, n, root,
                                      t_out, slot_out, b1_out, b2_out, scratch, stream);
  return (int)cudaErrorInvalidValue;
}
