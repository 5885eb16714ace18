// Shared device code of the BVH walks (bvh_traverse.cu, bvh4_traverse.cu):
// the ray setup, the slab test in its two forms, the naive-shear watertight
// triangle test, and the per-1024-ray-group iters reduction. Their plain
// PyTorch versions are pbrt_tpu_torch/accel/traverse.py::_Rays and _iters;
// the kernels must equal them bit for bit, so build with --fmad=false, keep
// 1/x IEEE, and keep min/max NaN-propagating like torch.minimum/maximum
// (fminf/fmaxf return the other operand, which would let an empty NaN box
// of the 4-wide walk pass its slab test).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bvh {

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

__device__ __forceinline__ Ray make_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int i) {
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
  return r;
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

}  // namespace bvh
