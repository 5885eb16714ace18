// Native BVH builder: binned-SAH / HLBVH / middle / equal-counts.
//
// TPU-native equivalent of the reference's Rust builders
// (accelerators/src/bvh/{sah.rs,hlbvh.rs,common.rs:27-37}): the build runs on
// the HOST at scene-compile time (geometry is static per scene; the device
// only ever sees the flattened arrays), so this is host-native C++ feeding
// the JAX/Pallas traversal kernels. Emits the depth-first "left child is the
// next node" flattened layout directly (bvh/mod.rs LinearBVHNode analog).
//
// C ABI only — loaded from Python via ctypes (no pybind11 in this image).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

static inline V3 vmin(const V3 &a, const V3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3 &a, const V3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Bounds {
  V3 lo{1e30f, 1e30f, 1e30f};
  V3 hi{-1e30f, -1e30f, -1e30f};
  void grow(const Bounds &b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  void grow(const V3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  V3 diag() const { return {hi.x - lo.x, hi.y - lo.y, hi.z - lo.z}; }
  float surface_area() const {
    V3 d = diag();
    if (d.x < 0 || d.y < 0 || d.z < 0) return 0.0f;
    return 2.0f * (d.x * d.y + d.x * d.z + d.y * d.z);
  }
  int max_axis() const {
    V3 d = diag();
    if (d.x > d.y && d.x > d.z) return 0;
    return d.y > d.z ? 1 : 2;
  }
  V3 offset(const V3 &p) const {
    V3 d = diag();
    return {d.x > 0 ? (p.x - lo.x) / d.x : 0.0f,
            d.y > 0 ? (p.y - lo.y) / d.y : 0.0f,
            d.z > 0 ? (p.z - lo.z) / d.z : 0.0f};
  }
};

struct PrimInfo {
  int id;
  Bounds b;
  V3 centroid;
  uint32_t morton;
};

struct Out {
  float *bounds_lo;
  float *bounds_hi;
  int32_t *right_child;
  int32_t *prim_offset;
  int32_t *prim_count;
  int32_t *axis;
  int n_nodes = 0;
  int capacity = 0;

  int emit(const Bounds &b) {
    int i = n_nodes++;
    bounds_lo[3 * i + 0] = b.lo.x;
    bounds_lo[3 * i + 1] = b.lo.y;
    bounds_lo[3 * i + 2] = b.lo.z;
    bounds_hi[3 * i + 0] = b.hi.x;
    bounds_hi[3 * i + 1] = b.hi.y;
    bounds_hi[3 * i + 2] = b.hi.z;
    right_child[i] = -1;
    prim_offset[i] = -1;
    prim_count[i] = 0;
    axis[i] = 0;
    return i;
  }
};

constexpr int kNumBuckets = 12;  // reference sah.rs binned SAH bucket count
constexpr float kTraversalCost = 1.0f;
constexpr float kIsectCost = 1.0f;

static inline uint32_t expand_bits10(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

// Recursive build over prims[s, e). split_method: 0=SAH 1=HLBVH(morton)
// 2=middle 3=equal.  Returns node index.  DFS order: node, left subtree,
// right subtree — so left child is implicitly node+1.
struct Builder {
  std::vector<PrimInfo> &prims;
  Out &out;
  int leaf_size;
  int split_method;

  Bounds range_bounds(int s, int e) const {
    Bounds b;
    for (int i = s; i < e; i++) b.grow(prims[i].b);
    return b;
  }
  Bounds centroid_bounds(int s, int e) const {
    Bounds b;
    for (int i = s; i < e; i++) b.grow(prims[i].centroid);
    return b;
  }

  int make_leaf(int node, int s, int e) {
    out.prim_offset[node] = s;
    out.prim_count[node] = e - s;
    return node;
  }

  // SAH binned split; returns mid in [s+1, e-1] or -1 to make a leaf.
  int sah_split(int s, int e, const Bounds &cb, int ax, const Bounds &nb) {
    V3 cd = cb.diag();
    float ext = ax == 0 ? cd.x : (ax == 1 ? cd.y : cd.z);
    if (ext <= 0) return (s + e) / 2;  // all centroids coincide on axis
    Bounds bb[kNumBuckets];
    int bc[kNumBuckets] = {0};
    auto bucket_of = [&](const V3 &c) {
      V3 off = cb.offset(c);
      float t = ax == 0 ? off.x : (ax == 1 ? off.y : off.z);
      int bkt = (int)(kNumBuckets * t);
      return std::min(bkt, kNumBuckets - 1);
    };
    for (int i = s; i < e; i++) {
      int bkt = bucket_of(prims[i].centroid);
      bc[bkt]++;
      bb[bkt].grow(prims[i].b);
    }
    // sweep costs
    float cost[kNumBuckets - 1];
    Bounds acc;
    int cnt = 0;
    for (int i = 0; i < kNumBuckets - 1; i++) {
      acc.grow(bb[i]);
      cnt += bc[i];
      cost[i] = cnt * acc.surface_area();
    }
    acc = Bounds();
    cnt = 0;
    for (int i = kNumBuckets - 1; i > 0; i--) {
      acc.grow(bb[i]);
      cnt += bc[i];
      cost[i - 1] += cnt * acc.surface_area();
    }
    float inv_sa = 1.0f / std::max(nb.surface_area(), 1e-30f);
    int best = 0;
    float best_cost = cost[0];
    for (int i = 1; i < kNumBuckets - 1; i++)
      if (cost[i] < best_cost) {
        best_cost = cost[i];
        best = i;
      }
    // Stop at leaf_size unconditionally: the TPU packet kernel's node visit
    // costs ~5x a leaf triangle test amortized over the packet (the CPU-era
    // SAH cost model with isect ~= traversal splits down to 1-tri leaves,
    // tripling node count and packet-union traversal iterations).
    if ((e - s) <= leaf_size) return -1;
    float split_cost = kTraversalCost + kIsectCost * best_cost * inv_sa;
    float leaf_cost = kIsectCost * (e - s);
    (void)split_cost; (void)leaf_cost;
    auto *pivot = std::partition(
        prims.data() + s, prims.data() + e,
        [&](const PrimInfo &p) { return bucket_of(p.centroid) <= best; });
    int mid = (int)(pivot - prims.data());
    if (mid == s || mid == e) mid = (s + e) / 2;
    return mid;
  }

  // Morton bit split (HLBVH topology) with midpoint fallback.
  int morton_split(int s, int e, int &bit) {
    while (bit >= 0) {
      uint32_t mask = 1u << bit;
      if ((prims[s].morton & mask) != (prims[e - 1].morton & mask)) {
        int lo = s, hi = e - 1;
        uint32_t first = prims[s].morton & mask;
        while (lo + 1 < hi) {
          int mid = (lo + hi) / 2;
          if ((prims[mid].morton & mask) == first)
            lo = mid;
          else
            hi = mid;
        }
        bit--;
        return hi;
      }
      bit--;
    }
    return (s + e) / 2;
  }

  int build(int s, int e, int bit) {
    Bounds nb = range_bounds(s, e);
    int node = out.emit(nb);
    int n = e - s;
    if (n <= 1 || (n <= leaf_size && split_method != 0))
      return make_leaf(node, s, e);

    Bounds cb = centroid_bounds(s, e);
    int ax = cb.max_axis();
    V3 cd = cb.diag();
    float ext = ax == 0 ? cd.x : (ax == 1 ? cd.y : cd.z);
    if (ext <= 0) {
      // degenerate cluster (coincident centroids): traversal unrolls at most
      // leaf_size prim tests per leaf, so split equally instead of emitting
      // an oversized leaf
      if (n <= leaf_size) return make_leaf(node, s, e);
      int mid = (s + e) / 2;
      out.axis[node] = ax;
      build(s, mid, bit);
      out.right_child[node] = build(mid, e, bit);
      return node;
    }

    int mid;
    int nbit = bit;
    switch (split_method) {
      case 1:
        mid = morton_split(s, e, nbit);
        break;
      case 2: {  // middle: partition by centroid vs midpoint on widest axis
        float pm = ax == 0 ? (cb.lo.x + cb.hi.x) : ax == 1 ? (cb.lo.y + cb.hi.y)
                                                           : (cb.lo.z + cb.hi.z);
        pm *= 0.5f;
        auto *pivot = std::partition(
            prims.data() + s, prims.data() + e, [&](const PrimInfo &p) {
              float c = ax == 0 ? p.centroid.x
                                : (ax == 1 ? p.centroid.y : p.centroid.z);
              return c < pm;
            });
        mid = (int)(pivot - prims.data());
        if (mid == s || mid == e) mid = (s + e) / 2;
        break;
      }
      case 3: {  // equal counts: nth_element on widest axis
        mid = (s + e) / 2;
        std::nth_element(prims.data() + s, prims.data() + mid, prims.data() + e,
                         [&](const PrimInfo &a, const PrimInfo &b) {
                           float ca = ax == 0 ? a.centroid.x
                                              : (ax == 1 ? a.centroid.y
                                                         : a.centroid.z);
                           float cb_ = ax == 0 ? b.centroid.x
                                               : (ax == 1 ? b.centroid.y
                                                          : b.centroid.z);
                           return ca < cb_;
                         });
        break;
      }
      default: {  // SAH
        if (n <= 2) {
          mid = (s + e) / 2;
        } else {
          mid = sah_split(s, e, cb, ax, nb);
          if (mid < 0) return make_leaf(node, s, e);
        }
        break;
      }
    }
    out.axis[node] = ax;
    build(s, mid, nbit);
    out.right_child[node] = build(mid, e, nbit);
    return node;
  }
};

}  // namespace

extern "C" {

// Build a BVH over n_prims AABBs.  Outputs sized by caller:
//   bounds_lo/hi: [2*n_prims * 3] f32, right/offset/count/axis: [2*n_prims],
//   prim_order: [n_prims].  Returns number of nodes (>0) or <0 on error.
int pbrt_bvh_build(const float *prim_lo, const float *prim_hi, int n_prims,
                   int leaf_size, int split_method, float *bounds_lo,
                   float *bounds_hi, int32_t *right_child, int32_t *prim_offset,
                   int32_t *prim_count, int32_t *axis, int32_t *prim_order) {
  if (n_prims <= 0) return -1;
  std::vector<PrimInfo> prims(n_prims);
  Bounds cb;
  for (int i = 0; i < n_prims; i++) {
    PrimInfo &p = prims[i];
    p.id = i;
    p.b.lo = {prim_lo[3 * i], prim_lo[3 * i + 1], prim_lo[3 * i + 2]};
    p.b.hi = {prim_hi[3 * i], prim_hi[3 * i + 1], prim_hi[3 * i + 2]};
    p.centroid = {0.5f * (p.b.lo.x + p.b.hi.x), 0.5f * (p.b.lo.y + p.b.hi.y),
                  0.5f * (p.b.lo.z + p.b.hi.z)};
    cb.grow(p.centroid);
  }
  for (int i = 0; i < n_prims; i++) {
    V3 off = cb.offset(prims[i].centroid);
    uint32_t qx = (uint32_t)std::min(1023.0f, std::max(0.0f, off.x * 1023.0f));
    uint32_t qy = (uint32_t)std::min(1023.0f, std::max(0.0f, off.y * 1023.0f));
    uint32_t qz = (uint32_t)std::min(1023.0f, std::max(0.0f, off.z * 1023.0f));
    prims[i].morton = expand_bits10(qx) | (expand_bits10(qy) << 1) |
                      (expand_bits10(qz) << 2);
  }
  if (split_method == 1) {
    std::stable_sort(prims.begin(), prims.end(),
                     [](const PrimInfo &a, const PrimInfo &b) {
                       return a.morton < b.morton;
                     });
  }
  Out out{bounds_lo, bounds_hi, right_child, prim_offset,
          prim_count, axis,      0,           2 * n_prims};
  Builder b{prims, out, std::max(1, leaf_size), split_method};
  b.build(0, n_prims, 29);
  for (int i = 0; i < n_prims; i++) prim_order[i] = prims[i].id;
  return out.n_nodes;
}

}  // extern "C"
