// Shared device code of the BVH walks (bvh_traverse.cu, bvh4_traverse.cu,
// instance_traverse.cu): the ray setup, the slab test in its two forms, the
// naive-shear watertight triangle test, the per-1024-ray-group iters
// reduction, and the parts of the redesigned walks (B1, B2, B4/B5 and B6):
// their ray, the walk record, the stack, the visit that keeps the near child
// in a register, and the leaf.
// Their plain PyTorch versions are pbrt_tpu_torch/accel/traverse.py::_Rays,
// _iters and walk_records; the kernels must equal them bit for bit, so
// build with --fmad=false, keep 1/x IEEE, and keep min/max NaN-propagating
// like torch.minimum/maximum (fminf/fmaxf return the other operand, which
// would let an empty NaN box of the 4-wide walk pass its slab test).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bvh {

constexpr int kLeafTris = 8;    // traverse.py LEAF_TRIS
constexpr int kGroup = 1024;    // traverse.py GROUP
constexpr int kThreads = 256;      // a block of the first-design walk (B3)
// A block of the redesigned walks (B1, B2, B4/B5, B6): a small block frees its
// registers as soon as its own two warps are done, and B6's 65 registers
// (allocated as 72) fit 28 warps a SM in blocks of 64 against 24 in blocks
// of 256 (PERF.md section 6).
constexpr int kWalkThreads = 64;
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

// The ray setup of origin o and direction d.
__device__ __forceinline__ Ray derive(float ox, float oy, float oz,
                                      float dx, float dy, float dz) {
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz;
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
  return r;
}

__device__ __forceinline__ Ray make_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int i) {
  return derive(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1], d[3 * i + 2]);
}

// kMulSub: slab distances as lo*inv - o*inv (B1, B2, B3), else as
// (lo - o)*inv (B4, B5); the far distance is scaled by 1.00000024f.
template <bool kMulSub>
__device__ __forceinline__ bool slab(const Ray& r, float lx, float ly, float lz,
                                     float hx, float hy, float hz, float t_best) {
  float t0x, t1x, t0y, t1y, t0z, t1z;
  if (kMulSub) {
    t0x = lx * r.ix - r.oxi;
    t1x = hx * r.ix - r.oxi;
    t0y = ly * r.iy - r.oyi;
    t1y = hy * r.iy - r.oyi;
    t0z = lz * r.iz - r.ozi;
    t1z = hz * r.iz - r.ozi;
  } else {
    t0x = (lx - r.ox) * r.ix;
    t1x = (hx - r.ox) * r.ix;
    t0y = (ly - r.oy) * r.iy;
    t1y = (hy - r.oy) * r.iy;
    t0z = (lz - r.oz) * r.iz;
    t1z = (hz - r.oz) * r.iz;
  }
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
// On a hit: t = t_sc * (1/det) and, with kBary, b1 = e1 * (1/det) and
// b2 = e2 * (1/det): the operations of scene/intersect.py::kernel_bary.
template <bool kBary>
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
  if (kBary) {
    b1 = e1 * inv_det;
    b2 = e2 * inv_det;
  }
  return true;
}

// Per-ray closest-hit state; b1/b2 are carried only where kBary.
struct Hit {
  float t;
  int slot;
  float b1, b2;
};

// Test triangle `row` with slot `s`; any-hit rays keep t = 0 at a hit.
template <bool kBary>
__device__ __forceinline__ void test_tri(const Ray& r, const float4* row, int s, bool any,
                                         Hit& h) {
  float th, u, v;
  if (tri_test<kBary>(r, row, h.t, th, u, v)) {
    h.t = any ? 0.0f : th;
    h.slot = s;
    if (kBary) { h.b1 = u; h.b2 = v; }
  }
}

// The occluder seed: the 8 largest triangles, tested before the walk.
template <bool kBary>
__device__ __forceinline__ void test_seed(const Ray& r, const float4* __restrict__ seed,
                                          const int* __restrict__ seed_slots, bool any,
                                          Hit& h) {
  const int scnt = __ldg(seed_slots + kLeafTris);
  for (int j = 0; j < scnt; ++j) test_tri<kBary>(r, seed + 4 * j, __ldg(seed_slots + j), any, h);
}

// One leaf block: its first cnt of 8 triangle rows.
template <bool kBary>
__device__ __forceinline__ void test_leaf(const Ray& r, const float4* __restrict__ tris,
                                          int blk, int cnt, bool any, Hit& h) {
  const float4* rows = tris + (size_t)blk * kLeafTris * 4;
  for (int j = 0; j < kLeafTris && j < cnt; ++j)
    test_tri<kBary>(r, rows + 4 * j, blk * kLeafTris + j, any, h);
}

// Per 1024-ray group: max pops and any overflow (max/or are order-free).
// Called by every thread of the block, live or not.
__device__ __forceinline__ void group_iters(int i, int n, int pops, int ovf, int* scratch) {
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

// ---------------------------------------------------------------------------
// The redesigned walks: B1, B2, B4/B5 (walk_kernel) and B6 (instance_kernel).
// Each pop makes one dependent load (the popped word says what to load),
// the near child stays in a register, blocks are kWalkThreads small, and
// the leaf loop is serial: a shared-memory stack, loading all 8 rows first,
// persistent warps and dynamic fetch were measured slower on the card
// (PERF.md section 6).
// ---------------------------------------------------------------------------

// A walk word: ax | cnt<<2 | payload<<6. cnt 0: an interior node, payload
// its walk record; cnt 1-8: a leaf, payload its 8-triangle block; cnt 15
// (the instance walk): a top-tree leaf, payload its instance record.
constexpr int kRecFloat4 = 4;   // a walk record: 16 floats, 64 bytes

// A walk record (accel/traverse.py::walk_records): both children's boxes
// (left lo,hi, right lo,hi) in floats 0:12 and both children's words in
// 12:14, so a popped word names the one load its visit needs.
struct Rec {
  float4 a, b, c;
  int left, right;
};

__device__ __forceinline__ Rec load_rec(const float4* __restrict__ recs, int rec) {
  const float4* p = recs + (size_t)rec * kRecFloat4;
  Rec x;
  x.a = __ldg(p);
  x.b = __ldg(p + 1);
  x.c = __ldg(p + 2);
  int2 w = __ldg(reinterpret_cast<const int2*>(p + 3));
  x.left = w.x;
  x.right = w.y;
  return x;
}

// A walk's stack in the thread's local memory (L1-cached): cap entries
// at base. Shared memory, entry-major, measured no faster on the card
// (PERF.md section 6).
struct Stack {
  int* base;
  int cap, sp;
  __device__ __forceinline__ void push(int v, int& ovf) {
    if (sp < cap) base[sp++] = v; else ovf = 1;
  }
  __device__ __forceinline__ int pop() { return base[--sp]; }
};

// The redesigned walks' ray: the setup plus neg as bits (bit k set where
// the direction's k is < 0), so the near/far choice indexes no bool array.
// The first-design walk (B3) keeps Ray without it: it holds its Ray in
// local memory, and the larger one grew its frame from 448 to 464 bytes and
// changed its machine code.
struct WalkRay : Ray {
  int negm;
};

__device__ __forceinline__ WalkRay walk_ray(float ox, float oy, float oz,
                                            float dx, float dy, float dz) {
  WalkRay w;
  static_cast<Ray&>(w) = derive(ox, oy, oz, dx, dy, dz);
  w.negm = (int)w.neg[0] | ((int)w.neg[1] << 1) | ((int)w.neg[2] << 2);
  return w;
}

// Visit an interior record with the slab of kMulSub (the seedless walks'
// (lo - o)*inv by default), keeping the near child in a register: push the
// far child where hit, then take the near one as the next word where hit
// and the stack has room for it, as pushing and popping it would do (the
// same pops, order and overflows) -> whether w now holds the next word.
template <bool kMulSub = false>
__device__ __forceinline__ bool visit_next(const WalkRay& r, const Rec& x, int ax, float t_best,
                                           Stack& st, int& ovf, int& w) {
  bool hl = slab<kMulSub>(r, x.a.x, x.a.y, x.a.z, x.a.w, x.b.x, x.b.y, t_best);
  bool hr = slab<kMulSub>(r, x.b.z, x.b.w, x.c.x, x.c.y, x.c.z, x.c.w, t_best);
  bool swap = (r.negm >> ax) & 1;
  int near = swap ? x.right : x.left, far = swap ? x.left : x.right;
  bool h_near = swap ? hr : hl, h_far = swap ? hl : hr;
  if (h_far) st.push(far, ovf);
  if (h_near) {
    if (st.sp < st.cap) { w = near; return true; }
    ovf = 1;
  }
  return false;
}

// The redesigned walks' leaf: the first cnt of 8 triangle rows of block
// blk, in order, as test_leaf tests them -> whether any hit. The hit's
// stores stay inside the test's branch: through test_tri's return value B6
// compiled to 69 registers and ran 19% slower.
template <bool kBary>
__device__ __forceinline__ bool walk_leaf(const Ray& r, const float4* __restrict__ tris,
                                          int blk, int cnt, bool any, Hit& h) {
  const float4* rows = tris + (size_t)blk * kLeafTris * 4;
  bool hit = false;
  for (int j = 0; j < kLeafTris && j < cnt; ++j) {
    float th, u, v;
    if (tri_test<kBary>(r, rows + 4 * j, h.t, th, u, v)) {
      h.t = any ? 0.0f : th;
      h.slot = blk * kLeafTris + j;
      if (kBary) { h.b1 = u; h.b2 = v; }
      hit = true;
    }
  }
  return hit;
}

}  // namespace bvh
