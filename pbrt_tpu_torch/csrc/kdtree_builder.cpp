// Native kd-tree builder (SAH over sorted bound edges), a copy of the
// reference's pbrt_tpu/native/kdtree_builder.cpp, so that both build the same
// tables bit for bit.
//
// The reference's Rust kd-tree (accelerators/src/kd_tree/mod.rs:
// isect_cost=80, traversal_cost=1, empty_bonus=0.5, packed KdAccelNode),
// built on the host at scene compile and walked by the port's
// accel/kdtree.py (csrc/kdtree_traverse.cu on the card). Leaves may hold
// any number of prims; the walks test them in chunks of 4. One change: a
// leaf past the node tables' end is not written (make_leaf).
#include <algorithm>
#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr float kIsectCost = 80.0f;
constexpr float kTraversalCost = 1.0f;
constexpr float kEmptyBonus = 0.5f;

struct BoundEdge {
  float t;
  int prim;
  bool start;
};

struct Out {
  int32_t *flags;        // [M] 0..2 split axis, 3 = leaf
  float *split_pos;      // [M]
  int32_t *above_child;  // [M] index of the "above" child (below = next)
  int32_t *prim_offset;  // [M] into prim_indices (leaf)
  int32_t *prim_count;   // [M] (leaf)
  int32_t *prim_indices; // [cap_indices]
  int n_nodes = 0;
  int n_indices = 0;
  int cap_nodes;
  int cap_indices;
};

struct Builder {
  const float *lo;
  const float *hi;
  int n_prims;
  int max_leaf;
  Out &out;
  std::vector<BoundEdge> edges[3];

  bool full() const {
    return out.n_nodes >= out.cap_nodes - 1;
  }

  int make_leaf(const int *prims, int np) {
    int node = out.n_nodes++;
    // The reference writes this leaf whether or not its tables have room,
    // past their end once a build overflows. Here an overflowing leaf is
    // not written: the build reports the overflow and is retried larger,
    // as the reference retries it.
    if (node >= out.cap_nodes) {
      overflow = true;
      return node;
    }
    out.flags[node] = 3;
    out.split_pos[node] = 0.0f;
    out.above_child[node] = -1;
    out.prim_offset[node] = out.n_indices;
    out.prim_count[node] = np;
    for (int i = 0; i < np && out.n_indices < out.cap_indices; i++)
      out.prim_indices[out.n_indices++] = prims[i];
    return node;
  }

  // node bounds nb (6 floats lo/hi), prims list, remaining depth.
  bool overflow = false;

  int build(float nbl[3], float nbh[3], std::vector<int> &prims, int depth,
            int bad_refines) {
    int np = (int)prims.size();
    // pbrt semantics: leaves may hold ANY number of prims (the device
    // traversal walks big leaves over several lockstep iterations with a
    // per-lane cursor); leaf when small enough / depth out / no good split
    if (np <= max_leaf || depth <= 0)
      return make_leaf(prims.data(), np);
    if (full()) {
      overflow = true;
      return make_leaf(prims.data(), np);
    }

    // SAH: try best split across axes (kd_tree/mod.rs build_tree)
    int best_axis = -1, best_offset = -1;
    float best_cost = 1e30f;
    float old_cost = kIsectCost * np;
    float d[3] = {nbh[0] - nbl[0], nbh[1] - nbl[1], nbh[2] - nbl[2]};
    float total_sa = 2.0f * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2]);
    float inv_sa = total_sa > 0 ? 1.0f / total_sa : 0.0f;
    int axis0 = 0;
    if (d[1] > d[0] && d[1] > d[2]) axis0 = 1;
    else if (d[2] > d[0]) axis0 = 2;

    int axis = axis0;
    for (int retry = 0; retry < 3 && depth > 0; retry++, axis = (axis + 1) % 3) {
      auto &ed = edges[axis];
      ed.clear();
      ed.reserve(2 * np);
      for (int p : prims) {
        ed.push_back({lo[3 * p + axis], p, true});
        ed.push_back({hi[3 * p + axis], p, false});
      }
      std::sort(ed.begin(), ed.end(), [](const BoundEdge &a, const BoundEdge &b) {
        if (a.t != b.t) return a.t < b.t;
        return (int)a.start > (int)b.start;  // starts before ends at same t
      });
      int below = 0, above = np;
      int o1 = (axis + 1) % 3, o2 = (axis + 2) % 3;
      for (int i = 0; i < (int)ed.size(); i++) {
        if (!ed[i].start) above--;
        float t = ed[i].t;
        if (t > nbl[axis] && t < nbh[axis]) {
          float below_sa = 2.0f * (d[o1] * d[o2]
                                   + (t - nbl[axis]) * (d[o1] + d[o2]));
          float above_sa = 2.0f * (d[o1] * d[o2]
                                   + (nbh[axis] - t) * (d[o1] + d[o2]));
          float pb = below_sa * inv_sa, pa = above_sa * inv_sa;
          float eb = (above == 0 || below == 0) ? kEmptyBonus : 0.0f;
          float cost = kTraversalCost
                       + kIsectCost * (1.0f - eb) * (pb * below + pa * above);
          if (cost < best_cost) {
            best_cost = cost;
            best_axis = axis;
            best_offset = i;
          }
        }
        if (ed[i].start) below++;
      }
      if (best_axis != -1) break;
    }

    if (best_cost > old_cost) bad_refines++;
    if (best_axis == -1 || (best_cost > 4.0f * old_cost && np < 16)
        || bad_refines == 3)
      return make_leaf(prims.data(), np);

    std::vector<int> below_prims, above_prims;
    auto &ed = edges[best_axis];
    float t_split = ed[best_offset].t;
    for (int i = 0; i < best_offset; i++)
      if (ed[i].start) below_prims.push_back(ed[i].prim);
    for (int i = best_offset + 1; i < (int)ed.size(); i++)
      if (!ed[i].start) above_prims.push_back(ed[i].prim);

    int node = out.n_nodes++;
    out.flags[node] = best_axis;
    out.split_pos[node] = t_split;
    out.prim_offset[node] = -1;
    out.prim_count[node] = 0;
    float save = nbh[best_axis];
    nbh[best_axis] = t_split;
    build(nbl, nbh, below_prims, depth - 1, bad_refines);
    nbh[best_axis] = save;
    save = nbl[best_axis];
    nbl[best_axis] = t_split;
    out.above_child[node] = build(nbl, nbh, above_prims, depth - 1, bad_refines);
    nbl[best_axis] = save;
    return node;
  }
};

}  // namespace

extern "C" {

// Returns n_nodes (>0) on success, -1 on error. n_indices written to
// *n_indices_out. Caller sizes: nodes arrays at cap_nodes, prim_indices at
// cap_indices. world bounds written to wb[6].
int pbrt_kdtree_build(const float *prim_lo, const float *prim_hi, int n_prims,
                      int max_leaf, int cap_nodes, int cap_indices,
                      int32_t *flags, float *split_pos, int32_t *above_child,
                      int32_t *prim_offset, int32_t *prim_count,
                      int32_t *prim_indices, int32_t *n_indices_out,
                      float *wb) {
  if (n_prims <= 0) return -1;
  float nbl[3] = {1e30f, 1e30f, 1e30f};
  float nbh[3] = {-1e30f, -1e30f, -1e30f};
  for (int i = 0; i < n_prims; i++)
    for (int a = 0; a < 3; a++) {
      nbl[a] = std::min(nbl[a], prim_lo[3 * i + a]);
      nbh[a] = std::max(nbh[a], prim_hi[3 * i + a]);
    }
  for (int a = 0; a < 3; a++) {
    wb[a] = nbl[a];
    wb[3 + a] = nbh[a];
  }
  Out out{flags, split_pos, above_child, prim_offset, prim_count,
          prim_indices, 0, 0, cap_nodes, cap_indices};
  Builder b{prim_lo, prim_hi, n_prims, std::max(1, max_leaf), out, {}};
  std::vector<int> prims(n_prims);
  for (int i = 0; i < n_prims; i++) prims[i] = i;
  int max_depth = (int)std::round(8.0 + 1.3 * std::log2((double)n_prims)) + 8;
  b.build(nbl, nbh, prims, max_depth, 0);
  *n_indices_out = out.n_indices;
  if (b.overflow || out.n_indices >= out.cap_indices) return -2;
  return out.n_nodes;
}

}  // extern "C"
