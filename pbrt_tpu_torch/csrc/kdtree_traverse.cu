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
// Design: one thread per ray walks the tree as a loop, with its own stack of
// kStack entries in local memory (768 bytes). Within the loop it keeps the
// reference's order exactly, so ties resolve to the same triangle: the
// world-box clip with the far factor 1.00000024 and the 1e-20 guards on
// 1/d; "behind" (tmin > t_best) tested before anything else; the near child
// below the split where o < split, or o == split and d <= 0; only-first
// (t_plane > tmax or t_plane <= 0) before only-second (t_plane < tmin); a
// leaf's prims in list order, kChunk at a time, an any-hit ray stopping
// after the chunk that hit; a push past the stack dropped (its count still
// rises) and a pop past it reading the last entry. A node is one 16-byte
// record, (flags, split bits, above child) or (3, prim offset, prim count);
// a leaf prim's vertices are 48 bytes in list order.
//
// What bounds it: latency. Each node's record decides the next address, the
// rays of a warp walk different nodes and leaves, and the stack lives in
// local memory, so the loads neither coalesce nor overlap. Its bound from
// bytes and operations is far below its time; this first kernel keeps the
// simple loop, and a later one can move the stack's top to registers, sort
// rays, or walk leaves warp-wide.
//
// Arithmetic: the watertight test of shapes/triangle.py::intersect_tri with
// its differences of products; build with --fmad=false, so that no product
// is fused into a sum and every value rounds as in the PyTorch version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStack = 64;     // kdtree.py KD_STACK
constexpr int kChunk = 4;      // kdtree.py KD_LEAF_CHUNK
constexpr int kThreads = 64;
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

__global__ void __launch_bounds__(kThreads)
kd_kernel(const int4* __restrict__ recs, const float4* __restrict__ leaf_tris,
          const int* __restrict__ prim_indices, const float* __restrict__ o,
          const float* __restrict__ d, const float* __restrict__ tmax_in,
          const uint8_t* __restrict__ anyhit, int n, float wlo0, float wlo1, float wlo2,
          float whi0, float whi1, float whi2, float* __restrict__ t_out,
          int* __restrict__ tri_out, float* __restrict__ b1_out, float* __restrict__ b2_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ov[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  const float dv[3] = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  const bool any = anyhit[i] != 0;
  float t_best = tmax_in[i];
  int tri_best = -1;
  float b1b = 0.0f, b2b = 0.0f;

  float inv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    inv[a] = 1.0f / (fabsf(dv[a]) < 1e-20f ? (dv[a] < 0.0f ? -1e-20f : 1e-20f) : dv[a]);
  const float lo[3] = {wlo0, wlo1, wlo2}, hi[3] = {whi0, whi1, whi2};
  float tn[3], tf[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float t0 = (lo[a] - ov[a]) * inv[a], t1 = (hi[a] - ov[a]) * inv[a];
    tn[a] = fminf(t0, t1);
    tf[a] = fmaxf(t0, t1);
  }
  float tmin = fmaxf(fmaxf(fmaxf(tn[0], tn[1]), tn[2]), 0.0f);
  float tmax = fminf(fminf(tf[0], tf[1]), tf[2]) * 1.00000024f;
  tmax = fminf(tmax, t_best);

  if (tmin <= tmax) {
    Ray r;
    r.ox = ov[0];
    r.oy = ov[1];
    r.oz = ov[2];
    float ax = fabsf(dv[0]), ay = fabsf(dv[1]), az = fabsf(dv[2]);
    r.kz = (ax >= ay && ax >= az) ? 0 : (ay >= az ? 1 : 2);
    r.kx = (r.kz + 1) % 3;
    r.ky = (r.kx + 1) % 3;
    float dz = pick3(dv[0], dv[1], dv[2], r.kz);
    r.sz = 1.0f / (dz == 0.0f ? 1e-20f : dz);
    r.sx = -pick3(dv[0], dv[1], dv[2], r.kx) * r.sz;
    r.sy = -pick3(dv[0], dv[1], dv[2], r.ky) * r.sz;

    int st_n[kStack];
    float st_t0[kStack], st_t1[kStack];
    int node = 0, sp = 0, cursor = 0;
    while (true) {
      const int4 rec = recs[node];
      bool pop;
      if (tmin > t_best) {
        pop = true;                      // behind the best hit
      } else if (rec.x == kLeaf) {
        const int cnt = rec.z;
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const int j = cursor + k;
          if (j < cnt) {
            const int s = rec.y + j;
            const float4 q0 = leaf_tris[3 * s], q1 = leaf_tris[3 * s + 1],
                         q2 = leaf_tris[3 * s + 2];
            const float p[9] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
            float t, b1, b2;
            if (tri_test(r, p, t_best, t, b1, b2)) {
              t_best = t;
              tri_best = s;
              b1b = b1;
              b2b = b2;
            }
          }
        }
        if (any && tri_best >= 0) break;
        cursor += kChunk;
        pop = cursor >= cnt;
        if (!pop) continue;              // the leaf's next chunk
      } else {
        const int a = rec.x;
        const float split = __int_as_float(rec.y);
        const float o_ax = ov[a], d_ax = dv[a];
        const float t_plane = (split - o_ax) * inv[a];
        const bool below_first = (o_ax < split) || (o_ax == split && d_ax <= 0.0f);
        const int first = below_first ? node + 1 : rec.z;
        const int second = below_first ? rec.z : node + 1;
        const bool only_first = (t_plane > tmax) || (t_plane <= 0.0f);
        const bool only_second = !only_first && (t_plane < tmin);
        if (only_second) {
          node = second;
        } else if (only_first) {
          node = first;
        } else {
          if (sp < kStack) {             // a push past the stack is dropped
            st_n[sp] = second;
            st_t0[sp] = fmaxf(t_plane, tmin);
            st_t1[sp] = tmax;
          }
          ++sp;
          node = first;
          tmax = t_plane;
        }
        continue;
      }
      if (pop) {
        if (any && tri_best >= 0) break;
        cursor = 0;
        if (sp <= 0) break;
        const int k = min(sp - 1, kStack - 1);   // a pop past the stack reads the last entry
        node = st_n[k];
        tmin = st_t0[k];
        tmax = st_t1[k];
        --sp;
      }
    }
  }
  t_out[i] = t_best;
  tri_out[i] = tri_best >= 0 ? prim_indices[tri_best] : -1;
  b1_out[i] = b1b;
  b2_out[i] = b2b;
}

}  // namespace

// K1 over n rays: recs [M] int4 node records, leaf_tris [P*3] float4, the
// world box; outputs t, tri, b1, b2 [n]. Returns the launch's cudaError.
extern "C" int pbrt_kdtree_traverse(const void* recs, const void* leaf_tris,
                                    const void* prim_indices, const void* o, const void* d,
                                    const void* tmax, const void* anyhit, int n, float wlo0,
                                    float wlo1, float wlo2, float whi0, float whi1, float whi2,
                                    void* t_out, void* tri_out, void* b1_out, void* b2_out,
                                    void* stream) {
  kd_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)recs, (const float4*)leaf_tris, (const int*)prim_indices, (const float*)o,
      (const float*)d, (const float*)tmax, (const uint8_t*)anyhit, n, wlo0, wlo1, wlo2, whi0,
      whi1, whi2, (float*)t_out, (int*)tri_out, (float*)b1_out, (float*)b2_out);
  return (int)cudaGetLastError();
}
