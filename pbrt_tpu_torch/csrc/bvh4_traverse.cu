// BVH4 closest-hit / any-hit traversal for Hopper (sm_90a).
//
// Replaces the TPU kernel pbrt_tpu/accel/pallas_traverse.py::_kernel_block4_all
// (B3, :1330, called at :1739): B2's contract (occluder seed, slab
// lo*inv - o*inv, t/slot/b1/b2 out) over the 4-wide collapse of the BVH2
// tree made by _pack_bvh4. The TPU kernel walks 1024-ray blocks with a
// shared SMEM stack and orders by the block's majority vote. This kernel
// keeps its contract and arithmetic, not its layout: the port's packer is
// accel/traverse.py::pack_kernel_bvh4, and its plain version, which this
// kernel must equal bit for bit (pops, order and overflows included), is
// traverse4_plain.
//
// What bounds it on this card: latency, as for bvh_traverse.cu. The walk is
// a pointer chase: each pop's load decides the next pop's address, and rays
// of a warp walk different nodes, so warps diverge and loads do not
// coalesce. Its bound from bytes and operations is about 2% of its time.
// Against the 2-wide walk it pops about half as many interior words, the
// chain of dependent loads that bounds it, but tests four boxes a pop.
//
// The design against that chase: one thread per ray walks the records of
// accel/traverse.py::bvh4_records, one 128-byte record a node: its four
// slot boxes, its four slot words and its axis word. A popped word names
// the one aligned line its visit needs (the first design read the boxes,
// the slot words and the axis word from three tables). A slot word is an
// interior node's record, or LEAF_TAG | cnt<<26 | block for a leaf; an
// empty slot has word 0 and a NaN box. A visit slab-tests the four slots
// and pushes the hit ones far to near: the pair order by the node's own
// split axis, the order inside each pair by that child's axis, each by
// this ray's direction sign (the sign bits of WalkRay, so no array is
// indexed at run time and only the stack stays in local memory). The loop
// is a while-while loop (Aila and Laine, HPG 2009): a lane visits interior
// nodes until it pops a leaf word, then the lanes of a warp test their
// leaves together. Blocks are 64 threads (kWalkThreads), with a register
// budget under which the record's eight loads go out together (see the
// kernel's launch bounds). The seed is tested first, and an any-hit ray the
// seed hit skips the walk. Per ray the pops, their order, the tests and the
// overflows are those of the plain walk.
//
// Measured on the card (PERF.md section 6): against the first design the
// pair launches are 7 - 8% faster and the camera launches 7 - 17% slower,
// which the while-while loop costs them; a render pass's launches (one
// camera and four pair launches) 3 - 6% faster. B1 stays 4 - 6% faster on
// the same pair launches, at 1.8 times the pops but half the boxes and
// bytes a pop. Dropped: the nearest hit slot kept in a register rather
// than pushed and popped (a tie), one pop a step (faster on camera
// launches, slower a pass), blocks of 256, the boxes slot-interleaved (lo.x
// of the four slots in one float4: a tie under the register budget) and
// smaller register budgets (at 55 registers the loads split again and the
// camera launches are 11% slower).
//
// Arithmetic: see bvh_common.cuh; build with --fmad=false. The NaN boxes of
// empty slots fail the slab test only because nmin/nmax propagate NaN; the
// slot word is checked as well.

#include "bvh_common.cuh"

namespace {

using namespace bvh;

constexpr int kStack4 = 96;          // traverse.py STACK4
constexpr int kLeafTag = 1 << 30;    // traverse.py LEAF_TAG
constexpr int kRec4Float4 = 8;       // a BVH4 record: traverse.py REC4_FLOATS floats

// A BVH4 record (accel/traverse.py::bvh4_records): slot j's box (lo xyz,
// hi xyz) in floats 6j..6j+5, the slot words in 24:28 and the axis word
// a0 | a1<<2 | a2<<4 in 28, as int32 bits.
struct Rec4 {
  float4 q0, q1, q2, q3, q4, q5;
  int4 w;
  int axw;
};

__device__ __forceinline__ Rec4 load_rec4(const float4* __restrict__ recs4, int node) {
  const float4* p = recs4 + (size_t)node * kRec4Float4;
  Rec4 x;
  x.q0 = __ldg(p);
  x.q1 = __ldg(p + 1);
  x.q2 = __ldg(p + 2);
  x.q3 = __ldg(p + 3);
  x.q4 = __ldg(p + 4);
  x.q5 = __ldg(p + 5);
  x.w = __ldg(reinterpret_cast<const int4*>(p + 6));
  x.axw = __ldg(reinterpret_cast<const int*>(p + 7));
  return x;
}

// Visit a BVH4 record: push its hit slots far to near, so the nearest is
// popped next.
__device__ __forceinline__ void visit4(const WalkRay& r, const Rec4& x, float t_best,
                                       Stack& st, int& ovf) {
  const bool h0 = slab<true>(r, x.q0.x, x.q0.y, x.q0.z, x.q0.w, x.q1.x, x.q1.y, t_best) &&
                  x.w.x != 0;
  const bool h1 = slab<true>(r, x.q1.z, x.q1.w, x.q2.x, x.q2.y, x.q2.z, x.q2.w, t_best) &&
                  x.w.y != 0;
  const bool h2 = slab<true>(r, x.q3.x, x.q3.y, x.q3.z, x.q3.w, x.q4.x, x.q4.y, t_best) &&
                  x.w.z != 0;
  const bool h3 = slab<true>(r, x.q4.z, x.q4.w, x.q5.x, x.q5.y, x.q5.z, x.q5.w, t_best) &&
                  x.w.w != 0;
  const bool s0 = (r.negm >> (x.axw & 3)) & 1;
  const bool s1 = (r.negm >> ((x.axw >> 2) & 3)) & 1;
  const bool s2 = (r.negm >> ((x.axw >> 4) & 3)) & 1;
  // near and far within each pair, then the pairs by the node's axis
  const int e_ln = s1 ? x.w.y : x.w.x, e_lf = s1 ? x.w.x : x.w.y;
  const bool h_ln = s1 ? h1 : h0, h_lf = s1 ? h0 : h1;
  const int e_rn = s2 ? x.w.w : x.w.z, e_rf = s2 ? x.w.z : x.w.w;
  const bool h_rn = s2 ? h3 : h2, h_rf = s2 ? h2 : h3;
  const int pe[4] = {s0 ? e_lf : e_rf, s0 ? e_ln : e_rn, s0 ? e_rf : e_lf, s0 ? e_rn : e_ln};
  const bool ph[4] = {s0 ? h_lf : h_rf, s0 ? h_ln : h_rn, s0 ? h_rf : h_lf, s0 ? h_rn : h_ln};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (ph[k]) st.push(pe[k], ovf);
  }
}

// At least 8 blocks a SM, so a budget of 128 registers a thread: with it
// ptxas emits a record's eight loads together, one trip to L2 for the
// line. Under its default budget it emitted them in three to five batches,
// each a trip for the record's 32-byte sectors not yet read.
__global__ void __launch_bounds__(kWalkThreads, 8)
traverse4_kernel(const float4* __restrict__ recs4, const float4* __restrict__ tris,
                 const float4* __restrict__ seed, const int* __restrict__ seed_slots,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ tmax, const uint8_t* __restrict__ anyhit, int n,
                 float* __restrict__ t_out, int* __restrict__ slot_out,
                 float* __restrict__ b1_out, float* __restrict__ b2_out,
                 int* __restrict__ scratch) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int pops = 0, ovf = 0;
  if (i < n) {
    const WalkRay r = walk_ray(o[3 * i], o[3 * i + 1], o[3 * i + 2],
                               d[3 * i], d[3 * i + 1], d[3 * i + 2]);
    const bool any = anyhit[i] != 0;
    Hit h = {tmax[i], -1, 0.0f, 0.0f};
    test_seed<true>(r, seed, seed_slots, any, h);
    int stack[kStack4];
    Stack st = {stack, kStack4, 0};
    int w = 0;                                  // the root, node 0
    bool have = !(any && h.slot >= 0);          // an any-hit ray the seed hit is done
    while (have) {
      while (have && !(w & kLeafTag)) {         // interior nodes until a leaf
        ++pops;
        visit4(r, load_rec4(recs4, w), h.t, st, ovf);
        have = st.sp > 0;
        if (have) w = st.pop();
      }
      if (!have) break;
      ++pops;                                   // the leaf
      walk_leaf<true>(r, tris, w & 0x3FFFFFF, (w >> 26) & 15, any, h);
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

extern "C" int pbrt_bvh4_traverse(const void* recs4, const void* tris, const void* seed,
                                  const void* seed_slots, const void* o, const void* d,
                                  const void* tmax, const void* anyhit, int n, void* t_out,
                                  void* slot_out, void* b1_out, void* b2_out, void* scratch,
                                  void* stream) {
  int blocks = (n + kWalkThreads - 1) / kWalkThreads;
  traverse4_kernel<<<blocks, kWalkThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)recs4, (const float4*)tris, (const float4*)seed, (const int*)seed_slots,
      (const float*)o, (const float*)d, (const float*)tmax, (const uint8_t*)anyhit, n,
      (float*)t_out, (int*)slot_out, (float*)b1_out, (float*)b2_out, (int*)scratch);
  return (int)cudaGetLastError();
}
