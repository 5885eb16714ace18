// BVH4 closest-hit / any-hit traversal for Hopper (sm_90a).
//
// Replaces the TPU kernel pbrt_tpu/accel/pallas_traverse.py::_kernel_block4_all
// (B3): B2's contract (occluder seed, slab lo*inv - o*inv, t/slot/b1/b2 out)
// over the 4-wide collapse of the BVH2 tree made by _pack_bvh4. The port's
// packer is accel/traverse.py::pack_kernel_bvh4 and its plain version, which
// this kernel must equal bit for bit, is traverse4_plain.
//
// Stack entries are the packer's slot words: an interior BVH4 node id, or
// LEAF_TAG | cnt<<26 | block for a leaf. A pop of a leaf word tests its
// 8-triangle block. A pop of an interior word loads the node's four 24-byte
// slot boxes, four slot words and its axis word, slab-tests the four slots
// (an empty slot has word 0 and a NaN box) and pushes the hit ones far to
// near: the pair order by the node's own split axis, the order inside each
// pair by that child's axis, each by this ray's direction sign on the axis.
// The TPU kernel orders by its 1024-ray block's majority vote; one thread
// per ray orders by its own ray, as bvh_traverse.cu does.
//
// What bounds it: as bvh_traverse.cu, latency of dependent gathers. Against
// the 2-wide walk it pops about half as many interior words and never tests
// the skipped level's boxes, but tests four boxes per interior pop, so its
// box tests per ray can rise where few of a node's grandchildren are hit.
//
// Arithmetic: see bvh_common.cuh; build with --fmad=false. The NaN boxes of
// empty slots fail the slab test only because nmin/nmax propagate NaN; the
// slot word is checked as well.

#include "bvh_common.cuh"

namespace {

using namespace bvh;

constexpr int kStack4 = 96;          // traverse.py STACK4
constexpr int kLeafTag = 1 << 30;    // traverse.py LEAF_TAG

__global__ void __launch_bounds__(kThreads)
traverse4_kernel(const float4* __restrict__ nodes4, const int4* __restrict__ meta4,
                 const int* __restrict__ axs4, const float4* __restrict__ tris,
                 const float4* __restrict__ seed, const int* __restrict__ seed_slots,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ tmax, const uint8_t* __restrict__ anyhit, int n,
                 float* __restrict__ t_out, int* __restrict__ slot_out,
                 float* __restrict__ b1_out, float* __restrict__ b2_out,
                 int* __restrict__ scratch) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int pops = 0, ovf = 0;
  if (i < n) {
    const Ray r = make_ray(o, d, i);
    const bool any = anyhit[i] != 0;
    Hit h = {tmax[i], -1, 0.0f, 0.0f};
    test_seed<true>(r, seed, seed_slots, any, h);

    int stack[kStack4];
    int sp = 0;
    if (!(any && h.slot >= 0)) stack[sp++] = 0;
    while (sp > 0) {
      const int e = stack[--sp];
      ++pops;
      if (e & kLeafTag) {
        test_leaf<true>(r, tris, e & 0x3FFFFFF, (e >> 26) & 15, any, h);
        if (any && h.slot >= 0) break;
        continue;
      }
      const float4* rec = nodes4 + (size_t)e * 6;
      const float4 q0 = __ldg(rec), q1 = __ldg(rec + 1), q2 = __ldg(rec + 2);
      const float4 q3 = __ldg(rec + 3), q4 = __ldg(rec + 4), q5 = __ldg(rec + 5);
      const int4 w = __ldg(meta4 + e);
      const int axw = __ldg(axs4 + e);
      // slot j's box is floats 6j..6j+5 of the node's 24: lo xyz, hi xyz
      const bool h0 = slab<true>(r, q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, h.t) && w.x != 0;
      const bool h1 = slab<true>(r, q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, h.t) && w.y != 0;
      const bool h2 = slab<true>(r, q3.x, q3.y, q3.z, q3.w, q4.x, q4.y, h.t) && w.z != 0;
      const bool h3 = slab<true>(r, q4.z, q4.w, q5.x, q5.y, q5.z, q5.w, h.t) && w.w != 0;
      const bool s0 = r.neg[axw & 3], s1 = r.neg[(axw >> 2) & 3], s2 = r.neg[(axw >> 4) & 3];
      // near and far within each pair, then the pairs by the node's axis
      const int e_ln = s1 ? w.y : w.x, e_lf = s1 ? w.x : w.y;
      const bool h_ln = s1 ? h1 : h0, h_lf = s1 ? h0 : h1;
      const int e_rn = s2 ? w.w : w.z, e_rf = s2 ? w.z : w.w;
      const bool h_rn = s2 ? h3 : h2, h_rf = s2 ? h2 : h3;
      const int pe[4] = {s0 ? e_lf : e_rf, s0 ? e_ln : e_rn, s0 ? e_rf : e_lf, s0 ? e_rn : e_ln};
      const bool ph[4] = {s0 ? h_lf : h_rf, s0 ? h_ln : h_rn, s0 ? h_rf : h_lf, s0 ? h_rn : h_ln};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (ph[k]) { if (sp < kStack4) stack[sp++] = pe[k]; else ovf = 1; }
      }
    }
    t_out[i] = h.t;
    slot_out[i] = h.slot;
    b1_out[i] = h.b1;
    b2_out[i] = h.b2;
  }
  group_iters(i, n, pops, ovf, scratch);
}

}  // namespace

extern "C" int pbrt_bvh4_traverse(const void* nodes4, const void* meta4, const void* axs4,
                                  const void* tris, const void* seed, const void* seed_slots,
                                  const void* o, const void* d, const void* tmax,
                                  const void* anyhit, int n, void* t_out, void* slot_out,
                                  void* b1_out, void* b2_out, void* scratch, void* stream) {
  int blocks = (n + kThreads - 1) / kThreads;
  traverse4_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)nodes4, (const int4*)meta4, (const int*)axs4, (const float4*)tris,
      (const float4*)seed, (const int*)seed_slots, (const float*)o, (const float*)d,
      (const float*)tmax, (const uint8_t*)anyhit, n, (float*)t_out, (int*)slot_out,
      (float*)b1_out, (float*)b2_out, (int*)scratch);
  return (int)cudaGetLastError();
}
