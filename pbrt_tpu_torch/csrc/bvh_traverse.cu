// BVH2 closest-hit / any-hit traversal for Hopper (sm_90a).
//
// Replaces four TPU kernels of pbrt_tpu/accel/pallas_traverse.py, which are
// schedules of one walk: _kernel_block_queue (B1: persistent 1024-ray block
// walks with a shared SMEM stack and block-majority near/far votes),
// _kernel_block_all (B2: the same walk in one launch over all blocks, with
// barycentrics out), _kernel_block (B4: one 1024-ray block per grid step,
// no occluder seed, slab (lo - o)*inv) and _kernel (B5: a 64-deep stack per
// 128-ray packet, node words from VMEM for trees over 32,768 nodes, B4's
// slab). These kernels keep their contracts and arithmetic, not their
// layout. traverse_kernel's three template switches pick the contract:
//   kMulSub  slab lo*inv - o*inv (B1, B2), else (lo - o)*inv;
//   kSeed    test the 8-triangle occluder seed before the walk (B1, B2);
//   kBary    write b1/b2 of the hit (B2).
// B1 and B2 instantiate it; B4/B5 (no seed, (lo - o)*inv, b1/b2 out) run
// packet_kernel, their redesign for this card.
// See pbrt_tpu_torch/accel/traverse.py for the contract and for
// traverse_plain, the PyTorch version both must match bit for bit.
//
// What bounds it on this card: latency, not bandwidth or arithmetic. A walk
// is a pointer chase: each pop's loads decide the next pop's address, and
// rays of a warp walk different nodes, so warps diverge and loads do not
// coalesce.
//
// B1 and B2 (traverse_kernel) keep the first design: one thread per ray,
// a private stack in local memory, and two dependent loads per pop, the
// popped node's 4-byte word and then its 64-byte box record or its 512-byte
// leaf block (9 of every 16 floats used).
//
// B4/B5 (packet_kernel) is redesigned for this card. It walks the records
// of accel/traverse.py::walk_records, which hold both children's boxes and
// both children's words, so a popped word already says whether it is a
// leaf and where its data is: one dependent load per pop. The near child
// stays in a register rather than going through the stack. The walk is a
// while-while loop (Aila and Laine, HPG 2009): a lane pops interior nodes
// until it reaches a leaf, so the lanes of a warp test their leaves
// together instead of each leaf test splitting the warp. Blocks of 64
// threads (kWalkThreads) let the card refill an SM two warps at a time as
// their rays finish. Per ray the pops, their order, the tests and the
// overflows are those of the first design.
// A stack in shared memory, all 8 leaf rows loaded before the tests (117
// registers), persistent warps and dynamic fetch were measured and were
// slower (PERF.md section 6).
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

// B4/B5: the seedless (lo - o)*inv walk with b1/b2 out, over the walk
// records: a popped word is a leaf's block or an interior node's record, so
// each pop makes one dependent load. A while-while loop: interior nodes up
// to a leaf, then the leaf.
__global__ void __launch_bounds__(kWalkThreads)
packet_kernel(const float4* __restrict__ recs, const float4* __restrict__ tris,
              const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ tmax, const uint8_t* __restrict__ anyhit, int n,
              int root, float* __restrict__ t_out, int* __restrict__ slot_out,
              float* __restrict__ b1_out, float* __restrict__ b2_out, int* __restrict__ scratch) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int pops = 0, ovf = 0;
  if (i < n) {
    const WalkRay r = walk_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2],
                               d[3 * i], d[3 * i + 1], d[3 * i + 2]);
    const bool any = anyhit[i] != 0;
    Hit h = {tmax[i], -1, 0.0f, 0.0f};
    int stack[kStack];
    Stack st = {stack, kStack, 0};
    int w = root;
    bool have = true;
    while (have) {
      while (have && ((w >> 2) & 15) == 0) {   // interior nodes until a leaf
        ++pops;
        have = visit_next(r, load_rec(recs, (w >> 6) & 0x3FFFFFF), w & 3, h.t, st, ovf, w);
        if (!have && st.sp > 0) { w = st.pop(); have = true; }
      }
      if (!have) break;
      ++pops;                                  // the leaf
      walk_leaf<true>(r, tris, (w >> 6) & 0x3FFFFFF, (w >> 2) & 15, any, h);
      if (any && h.slot >= 0) break;
      have = st.sp > 0;
      if (have) w = st.pop();
    }
    t_out[i] = h.t;
    slot_out[i] = h.slot;
    b1_out[i] = h.b1;
    b2_out[i] = h.b2;
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

// With barycentrics: variant 0 is B2 (traverse_kernel: seed, slab
// lo*inv - o*inv), variant 1 is B4/B5 (packet_kernel over the walk records
// recs from the word root: no seed, slab (lo - o)*inv).
extern "C" int pbrt_bvh_traverse_bary(const void* metas, const void* nodes, const void* tris,
                                      const void* seed, const void* seed_slots, const void* recs,
                                      const void* o, const void* d, const void* tmax,
                                      const void* anyhit, int n, int variant, int root,
                                      void* t_out, void* slot_out, void* b1_out, void* b2_out,
                                      void* scratch, void* stream) {
  int blocks = (n + kThreads - 1) / kThreads;
  if (variant == 1) {
    packet_kernel<<<(n + kWalkThreads - 1) / kWalkThreads, kWalkThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)recs, (const float4*)tris, (const float*)o, (const float*)d,
        (const float*)tmax, (const uint8_t*)anyhit, n, root, (float*)t_out,
        (int*)slot_out, (float*)b1_out, (float*)b2_out, (int*)scratch);
    return (int)cudaGetLastError();
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  traverse_kernel<true, true, true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)metas, (const float4*)nodes, (const float4*)tris, (const float4*)seed,
      (const int*)seed_slots, (const float*)o, (const float*)d, (const float*)tmax,
      (const uint8_t*)anyhit, n, (float*)t_out, (int*)slot_out, (float*)b1_out,
      (float*)b2_out, (int*)scratch);
  return (int)cudaGetLastError();
}
