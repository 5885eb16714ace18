// kd-tree closest-hit / any-hit traversal for Hopper (sm_90a): "K1".
//
// Replaces no Pallas kernel. It replaces the XLA walk
// pbrt_tpu/accel/kdtree.py::intersect_kdtree (:90), a lax.while_loop that
// steps every ray of the wavefront one node at a time in lockstep, each ray
// carrying a todo stack of (node, tmin, tmax). See
// pbrt_tpu_torch/accel/kdtree.py for the contract and for
// intersect_kdtree_plain, the PyTorch version this kernel must match bit for
// bit in t, triangle, b1 and b2.
//
// Order of tests: the reference's, exactly, so ties resolve to the same
// triangle: the world-box clip with the far factor 1.00000024 and the 1e-20
// guards on 1/d; "behind" (tmin > t_best) tested before anything else; the
// near child below the split where o < split, or o == split and d <= 0;
// only-first (t_plane > tmax or t_plane <= 0) before only-second (t_plane <
// tmin); a leaf's prims in list order, kChunk at a time, an any-hit ray
// stopping after the chunk that hit; a push past kStack entries dropped (its
// count still rises) and a pop past them reading the last entry.
//
// What bounds it: latency. Each node's record decides the next address, so a
// ray's steps are a chain of dependent loads, and a launch lasts about as
// long as its slowest warps (a ray of the bench scene makes up to about a
// thousand node visits; the 1% of camera rays with the most visits, launched
// alone, take as long as the whole launch). A warp steps at the pace of the
// slowest load of its active lanes, so a warp whose 32 lanes all walk long
// chains (the grazing floor rays of a camera launch lie next to each other in
// pixel order) is far slower than one long ray among short ones. The design:
//   - rays spread over warps: lane l of warp w takes ray l * n_warps + w, so
//     a launch's neighbouring rays, which walk alike, go to different warps
//     and each long ray shares its warp with short ones;
//   - tables that stay in the 50 MB L2: 8-byte node records (pbrt-v3's
//     KdAccelNode: the split's bits or the prim offset, then the flags in 2
//     bits under the above child or the prim count; the below child is
//     node + 1), read with __ldg, and one vertex row a triangle (48 bytes),
//     reached through the leaf's prim indices, so that a triangle listed in
//     many leaves sits at one address;
//   - the ray's axis values picked with selects, not indexed from arrays in
//     local memory;
//   - a while-while loop: interior steps until a leaf, then the leaf's
//     chunks, so that a warp's lanes run the same kind of step together.
// The todo stack stays a private array in local memory (768 bytes): a stack
// in shared memory, whole or only its first 8 or 16 entries, cut the blocks
// an SM holds and was slower on every launch measured (PERF.md).
//
// Arithmetic: the watertight test of shapes/triangle.py::intersect_tri with
// its differences of products; build with --fmad=false, so that no product
// is fused into a sum and every value rounds as in the PyTorch version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStack = 64;     // kdtree.py KD_STACK
constexpr int kChunk = 4;      // kdtree.py KD_LEAF_CHUNK
constexpr int kThreads = 128;   // 32, 64 and 256 measured no faster (PERF.md)
constexpr int kLeaf = 3;

__device__ __forceinline__ float pick3(float x, float y, float z, int k) {
  return k == 0 ? x : (k == 1 ? y : z);
}

__device__ __forceinline__ float dop(float a, float b, float c, float d) {
  float cd = c * d;
  float err = (-c) * d + cd;
  return (a * b - cd) + err;
}

struct Ray {
  float ox, oy, oz;
  int kx, ky, kz;
  float sx, sy, sz;
};

// The watertight test of one triangle (p = 9 floats) against t_max.
__device__ __forceinline__ bool tri_test(const Ray& r, const float* p, float t_max, float& t,
                                         float& b1, float& b2) {
  float tx0 = p[0] - r.ox, ty0 = p[1] - r.oy, tz0 = p[2] - r.oz;
  float tx1 = p[3] - r.ox, ty1 = p[4] - r.oy, tz1 = p[5] - r.oz;
  float tx2 = p[6] - r.ox, ty2 = p[7] - r.oy, tz2 = p[8] - r.oz;
  float pz0 = pick3(tx0, ty0, tz0, r.kz), pz1 = pick3(tx1, ty1, tz1, r.kz),
        pz2 = pick3(tx2, ty2, tz2, r.kz);
  float x0 = pick3(tx0, ty0, tz0, r.kx) + r.sx * pz0, y0 = pick3(tx0, ty0, tz0, r.ky) + r.sy * pz0;
  float x1 = pick3(tx1, ty1, tz1, r.kx) + r.sx * pz1, y1 = pick3(tx1, ty1, tz1, r.ky) + r.sy * pz1;
  float x2 = pick3(tx2, ty2, tz2, r.kx) + r.sx * pz2, y2 = pick3(tx2, ty2, tz2, r.ky) + r.sy * pz2;
  float z0 = pz0 * r.sz, z1 = pz1 * r.sz, z2 = pz2 * r.sz;
  float e0 = dop(x1, y2, y1, x2);
  float e1 = dop(x2, y0, y2, x0);
  float e2 = dop(x0, y1, y0, x1);
  bool same = (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) || (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
  float det = (e0 + e1) + e2;
  float ts = (e0 * z0 + e1 * z1) + e2 * z2;
  bool t_ok = det > 0.0f ? (ts > 1e-4f * det && ts < t_max * det)
                         : (ts < 1e-4f * det && ts > t_max * det);
  if (!(same && det != 0.0f && t_ok)) return false;
  float inv_det = 1.0f / (det == 0.0f ? 1e-20f : det);
  t = ts * inv_det;
  b1 = e1 * inv_det;
  b2 = e2 * inv_det;
  return true;
}

__device__ __forceinline__ float guard_inv(float v) {
  return 1.0f / (fabsf(v) < 1e-20f ? (v < 0.0f ? -1e-20f : 1e-20f) : v);
}

__global__ void __launch_bounds__(kThreads)
kd_kernel(const int2* __restrict__ nodes, const int* __restrict__ prim_indices,
          const float4* __restrict__ tris, const float* __restrict__ o,
          const float* __restrict__ d, const float* __restrict__ tmax_in,
          const uint8_t* __restrict__ anyhit, int n, float wlo0, float wlo1, float wlo2,
          float whi0, float whi1, float whi2, float* __restrict__ t_out,
          int* __restrict__ tri_out, float* __restrict__ b1_out, float* __restrict__ b2_out) {
  // lane l of warp w takes ray l * n_warps + w (the grid holds 32 n_warps threads)
  const int g = blockIdx.x * kThreads + threadIdx.x, n_warps = (n + 31) / 32;
  if ((g >> 5) >= n_warps) return;
  const int i = (g & 31) * n_warps + (g >> 5);
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const bool any = anyhit[i] != 0;
  float t_best = tmax_in[i];
  int tri_best = -1;
  float b1b = 0.0f, b2b = 0.0f;

  const float ix = guard_inv(dx), iy = guard_inv(dy), iz = guard_inv(dz);
  const float tx0 = (wlo0 - ox) * ix, tx1 = (whi0 - ox) * ix;
  const float ty0 = (wlo1 - oy) * iy, ty1 = (whi1 - oy) * iy;
  const float tz0 = (wlo2 - oz) * iz, tz1 = (whi2 - oz) * iz;
  float tmin = fmaxf(fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1)), 0.0f);
  float tmax = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1)) * 1.00000024f;
  tmax = fminf(tmax, t_best);

  if (tmin <= tmax) {
    Ray r;
    r.ox = ox;
    r.oy = oy;
    r.oz = oz;
    const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
    r.kz = (ax >= ay && ax >= az) ? 0 : (ay >= az ? 1 : 2);
    r.kx = (r.kz + 1) % 3;
    r.ky = (r.kx + 1) % 3;
    const float dkz = pick3(dx, dy, dz, r.kz);
    r.sz = 1.0f / (dkz == 0.0f ? 1e-20f : dkz);
    r.sx = -pick3(dx, dy, dz, r.kx) * r.sz;
    r.sy = -pick3(dx, dy, dz, r.ky) * r.sz;

    int st_n[kStack];
    float st_t0[kStack], st_t1[kStack];
    int node = 0, sp = 0;
    while (true) {                       // from the root or a popped entry
      if (!(tmin > t_best)) {            // "behind" the best hit pops at once
        int2 rec = __ldg(nodes + node);
        // Interior steps until a leaf: tmin and t_best do not change on the
        // way down, so "behind" cannot become true here.
        while ((rec.y & 3) != kLeaf) {
          const int a = rec.y & 3;
          const float split = __int_as_float(rec.x);
          const float o_ax = pick3(ox, oy, oz, a), d_ax = pick3(dx, dy, dz, a);
          const float t_plane = (split - o_ax) * pick3(ix, iy, iz, a);
          const bool below_first = (o_ax < split) || (o_ax == split && d_ax <= 0.0f);
          const int above = rec.y >> 2;
          const int first = below_first ? node + 1 : above;
          const int second = below_first ? above : node + 1;
          const bool only_first = (t_plane > tmax) || (t_plane <= 0.0f);
          const bool only_second = !only_first && (t_plane < tmin);
          if (only_second) {
            node = second;
          } else if (only_first) {
            node = first;
          } else {
            if (sp < kStack) {           // a push past the stack is dropped
              st_n[sp] = second;
              st_t0[sp] = fmaxf(t_plane, tmin);
              st_t1[sp] = tmax;
            }
            ++sp;
            node = first;
            tmax = t_plane;
          }
          rec = __ldg(nodes + node);
        }
        // The leaf's prims, kChunk a step; "behind" is tested again before
        // each further chunk, as the reference's next step would.
        const int cnt = rec.y >> 2;
        const int* idx = prim_indices + rec.x;
        for (int c = 0; c < cnt; c += kChunk) {
          if (c > 0 && tmin > t_best) break;
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            if (c + k < cnt) {
              const int prim = __ldg(idx + c + k);
              const float4 q0 = __ldg(tris + 3 * prim), q1 = __ldg(tris + 3 * prim + 1),
                           q2 = __ldg(tris + 3 * prim + 2);
              const float p[9] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
              float t, b1, b2;
              if (tri_test(r, p, t_best, t, b1, b2)) {
                t_best = t;
                tri_best = prim;
                b1b = b1;
                b2b = b2;
              }
            }
          }
          if (any && tri_best >= 0) break;
        }
      }
      if ((any && tri_best >= 0) || sp <= 0) break;
      const int k = min(sp - 1, kStack - 1);   // a pop past the stack reads the last entry
      node = st_n[k];
      tmin = st_t0[k];
      tmax = st_t1[k];
      --sp;
    }
  }
  t_out[i] = t_best;
  tri_out[i] = tri_best;
  b1_out[i] = b1b;
  b2_out[i] = b2b;
}

}  // namespace

// K1 over n rays: nodes [M] int2 node records, prim_indices [P], tris [T*3]
// float4 vertex rows and the world box; outputs t, tri, b1, b2 [n]. Returns
// the launch's cudaError.
extern "C" int pbrt_kdtree_traverse(const void* nodes, const void* prim_indices, const void* tris,
                                    const void* o, const void* d, const void* tmax,
                                    const void* anyhit, int n, float wlo0, float wlo1, float wlo2,
                                    float whi0, float whi1, float whi2, void* t_out,
                                    void* tri_out, void* b1_out, void* b2_out, void* stream) {
  const int threads = (n + 31) / 32 * 32;
  kd_kernel<<<(threads + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const int2*)nodes, (const int*)prim_indices, (const float4*)tris, (const float*)o,
      (const float*)d, (const float*)tmax, (const uint8_t*)anyhit, n, wlo0, wlo1, wlo2, whi0,
      whi1, whi2, (float*)t_out, (int*)tri_out, (float*)b1_out, (float*)b2_out);
  return (int)cudaGetLastError();
}
