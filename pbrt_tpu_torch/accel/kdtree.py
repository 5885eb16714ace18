"""The SAH kd-tree: the native build, the plain PyTorch walk and the wrapper
of its CUDA kernel, K1 (port of pbrt_tpu/accel/kdtree.py).

Contract (the reference's intersect_kdtree, :90):
  inputs  rays o [N,3], d [N,3], t_max [N] f32 and a per-ray any-hit flag
          anyhit [N] u8, plus the tables of `build_kdtree` and the world
          triangles' vertices;
  outputs t [N] f32, tri [N] i32 (the hit's triangle row, -1 on a miss),
          b1, b2 [N] f32 of the hit (pbrt's watertight test,
          shapes/triangle.py::intersect_tri).
The walk is pbrt's todo-stack walk: clip to the world box (far factor
1.00000024), then per node a leaf test or the near child, pushing the far
child where the ray crosses the split. A leaf tests its prims in list
order, KD_LEAF_CHUNK at a time; an any-hit ray stops after the chunk that
hit, so its t and triangle are that chunk's closest. Each ray holds a
stack of KD_STACK (node, tmin, tmax) entries: a push past it is dropped,
and a pop past it reads the last entry, as the reference's scatter with
mode="drop" and its clamped gather do.

`intersect_kdtree` takes `intersect_kdtree_plain` (the reference's
lockstep walk as tensor ops) for CPU tensors only; for CUDA tensors it
launches csrc/kdtree_traverse.cu or raises. Nothing falls back, and a
builder that fails to build raises.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from pbrt_tpu_torch.accel import native
from pbrt_tpu_torch.accel.traverse import _check
from pbrt_tpu_torch.shapes.triangle import intersect_tri

KD_LEAF_CHUNK = 4    # prim tests per step of a leaf
MAX_KD_LEAF = 1      # the SAH leaf threshold (kd_tree default max_prims = 1)
KD_STACK = 64        # per-ray todo-stack entries
FAR_SCALE = 1.00000024
LEAF = 3             # flags value of a leaf


@dataclasses.dataclass
class KdTables:
    """The builder's host tables (the reference's KdTree, numpy):

    flags [M] i32        0 - 2 the split axis, 3 a leaf
    split_pos [M] f32
    above_child [M] i32  (the below child is node + 1)
    prim_offset [M] i32  into prim_indices (leaves)
    prim_count [M] i32   (leaves)
    prim_indices [P] i32 triangle rows, leaf by leaf (a prim may sit in many)
    world_lo, world_hi   [3] f32 the world box
    """
    flags: np.ndarray
    split_pos: np.ndarray
    above_child: np.ndarray
    prim_offset: np.ndarray
    prim_count: np.ndarray
    prim_indices: np.ndarray
    world_lo: np.ndarray
    world_hi: np.ndarray

    @property
    def n_nodes(self) -> int:
        return self.flags.shape[0]


def tree_depth(flags: np.ndarray, above_child: np.ndarray) -> int:
    """The most interior nodes on any path from the root to a leaf (0 for a
    tree that is one leaf): a walk's stack never holds more entries, since
    each entry is the far child of an interior node above the walk's node."""
    level, depth = np.zeros(1, np.int64), 0
    while True:
        inner = level[flags[level] != LEAF]
        if inner.size == 0:
            return depth
        depth += 1
        level = np.concatenate([inner + 1, above_child[inner].astype(np.int64)])


def node_records(tab: KdTables) -> np.ndarray:
    """The builder's tables as 8-byte node records [M,2] i32, pbrt-v3's
    KdAccelNode: word 0 the split's float bits (interior) or the prim
    offset (leaf); word 1 the flags in its low 2 bits and, above them, the
    above child (interior) or the prim count (leaf)."""
    leaf = tab.flags == LEAF
    high = np.where(leaf, tab.prim_count, tab.above_child).astype(np.int64)
    if high.size and (high.min() < 0 or high.max() >= 1 << 29):
        raise ValueError("a child index or prim count does not fit in 29 bits")
    w0 = np.where(leaf, tab.prim_offset, tab.split_pos.view(np.int32))
    w1 = (high << 2 | tab.flags).astype(np.int32)
    return np.ascontiguousarray(np.stack([w0, w1], -1), np.int32)


def node_fields(recs):
    """8-byte node records [K,2] i32 (numpy or torch) -> (flags, word 0,
    word 1 >> 2): word 0 holds the split's bits or the prim offset, the
    last the above child or the prim count."""
    return recs[:, 1] & 3, recs[:, 0], recs[:, 1] >> 2


@dataclasses.dataclass
class KdTree:
    """What the walks read, on one device (`from_tables`):

    nodes [M,2] i32      the 8-byte node records of `node_records`: one
                         8-byte load a node, the below child node + 1
    prim_indices [P] i32 as in KdTables: a leaf's triangle rows
    tris [T,12] f32      each world triangle's vertices once (p0 xyz, p1 xyz,
                         p2 xyz, 3 pad), reached through prim_indices
    world_lo, world_hi   [3] np.float32 the world box
    """
    nodes: torch.Tensor
    prim_indices: torch.Tensor
    tris: torch.Tensor
    world_lo: np.ndarray
    world_hi: np.ndarray

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def depth(self) -> int:
        """`tree_depth` of the records (read back to the host): it bounds
        the entries a walk pushes."""
        flags, _, high = node_fields(self.nodes.cpu().numpy())
        return tree_depth(flags, high)

    def device_bytes(self) -> int:
        """The bytes of the walk's tables on the device."""
        return sum(x.numel() * x.element_size() for x in (self.nodes, self.prim_indices,
                                                          self.tris))

    @classmethod
    def from_tables(cls, tab: KdTables, tri_p0, tri_p1, tri_p2) -> "KdTree":
        """The walks' tables from the builder's and the triangles' vertices
        [T,3] (tensors on the device the tree goes to)."""
        dev = tri_p0.device
        tris = torch.zeros((tri_p0.shape[0], 12), device=dev)
        tris[:, 0:3], tris[:, 3:6], tris[:, 6:9] = tri_p0, tri_p1, tri_p2
        return cls(torch.as_tensor(node_records(tab), device=dev),
                   torch.as_tensor(tab.prim_indices, dtype=torch.int32, device=dev), tris,
                   tab.world_lo, tab.world_hi)


def build_kdtree(prim_lo: np.ndarray, prim_hi: np.ndarray,
                 max_leaf: int = MAX_KD_LEAF) -> KdTables:
    """Host build by csrc/kdtree_builder.cpp over primitive boxes [T,3]
    (the reference's build, its tables bit for bit). A node or index table
    that overflows is retried with four times the room, three times; then,
    or on any other failure, it raises."""
    lib = native.load("kdtree_builder")
    fn = lib.pbrt_kdtree_build
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    fn.argtypes = [fp, fp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ip, fp, ip, ip, ip, ip, ip, fp]
    fn.restype = ctypes.c_int
    T = int(prim_lo.shape[0])
    lo = np.ascontiguousarray(prim_lo, np.float32)
    hi = np.ascontiguousarray(prim_hi, np.float32)
    cap_nodes = cap_idx = max(16 * T, 512)
    for _ in range(3):
        flags = np.empty(cap_nodes, np.int32)
        split = np.empty(cap_nodes, np.float32)
        above = np.empty(cap_nodes, np.int32)
        offs = np.empty(cap_nodes, np.int32)
        cnts = np.empty(cap_nodes, np.int32)
        idx = np.empty(cap_idx, np.int32)
        nidx = np.zeros(1, np.int32)
        wb = np.zeros(6, np.float32)
        m = fn(lo.ctypes.data_as(fp), hi.ctypes.data_as(fp), T, max_leaf,
               cap_nodes, cap_idx, flags.ctypes.data_as(ip),
               split.ctypes.data_as(fp), above.ctypes.data_as(ip),
               offs.ctypes.data_as(ip), cnts.ctypes.data_as(ip),
               idx.ctypes.data_as(ip), nidx.ctypes.data_as(ip),
               wb.ctypes.data_as(fp))
        if m == -2:
            cap_nodes *= 4
            cap_idx *= 4
            continue
        if m <= 0:
            raise RuntimeError(f"kd-tree build failed over {T} primitives")
        return KdTables(flags[:m], split[:m], above[:m], offs[:m], cnts[:m],
                        idx[:int(nidx[0])], wb[:3].copy(), wb[3:].copy())
    raise RuntimeError(f"kd-tree tables overflow over {T} primitives")


class KdCounts:
    """What a plain walk did: node visits (one a lockstep step a ray is
    live), summed and per ray (ray_visits [N] i64), and triangle tests, and
    which node records, leaf slots (prim indices) and triangles it needed
    read (a node behind the best hit needs none); a kernel's bound on the
    same rays is computed from them."""

    def __init__(self):
        self.visits = self.tri_tests = 0
        self.ray_visits = self.nodes = self.slots = self.prims = None

    def start(self, kd: KdTree, n: int):
        """-> the (nodes [M], slots [P], triangles [T]) bool masks a walk of
        n rays sets, made at the first call, and ray_visits."""
        if self.nodes is None:
            dev = kd.nodes.device
            self.nodes = torch.zeros(kd.n_nodes, dtype=torch.bool, device=dev)
            self.slots = torch.zeros(kd.prim_indices.shape[0], dtype=torch.bool, device=dev)
            self.prims = torch.zeros(kd.tris.shape[0], dtype=torch.bool, device=dev)
            self.ray_visits = torch.zeros(n, dtype=torch.int64, device=dev)
        return self.nodes, self.slots, self.prims

    def touched(self):
        """-> (node records, leaf slots tested, triangles tested), each
        counted once."""
        return tuple(0 if m is None else int(m.sum())
                     for m in (self.nodes, self.slots, self.prims))


def _clip(kd: KdTree, o, d, t_max):
    """The world-box clip -> (inv_d, tmin, tmax, live)."""
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-20,
                              torch.where(d < 0, -1e-20, 1e-20), d)
    lo = torch.as_tensor(kd.world_lo, device=o.device)
    hi = torch.as_tensor(kd.world_hi, device=o.device)
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    tmin = torch.clamp(torch.maximum(torch.maximum(tn[:, 0], tn[:, 1]), tn[:, 2]), min=0.0)
    tmax = torch.minimum(torch.minimum(tf[:, 0], tf[:, 1]), tf[:, 2]) * FAR_SCALE
    tmax = torch.minimum(tmax, t_max)
    return inv_d, tmin, tmax, tmin <= tmax


def intersect_kdtree_plain(kd: KdTree, o, d, t_max, anyhit, counts: KdCounts = None):
    """The reference's lockstep walk as tensor ops: every live ray takes one
    node a step, all rays together; a leaf of more than KD_LEAF_CHUNK prims
    takes several steps (a per-ray cursor). The rays that finished are
    dropped from the step's tensors once they are half of them (the walk of
    each ray is its own, so this changes no result). A leaf slot's prim
    index names the triangle row whose vertices it tests. -> (t, tri, b1,
    b2)."""
    n = o.shape[0]
    dev = o.device
    inv_d, tmin, tmax, active = _clip(kd, o, d, t_max)
    zi = torch.zeros(n, dtype=torch.int64, device=dev)
    st = {"o": o, "d": d, "inv_d": inv_d, "tmin": tmin, "tmax": tmax, "active": active,
          "anyhit": anyhit.to(torch.bool), "node": zi, "sp": zi, "cursor": zi,
          "st_n": torch.zeros((n, KD_STACK), dtype=torch.int64, device=dev),
          "st_t0": torch.zeros((n, KD_STACK), device=dev),
          "st_t1": torch.zeros((n, KD_STACK), device=dev),
          "t_best": t_max.clone(), "tri_best": zi - 1,
          "b1": torch.zeros(n, device=dev), "b2": torch.zeros(n, device=dev),
          "ids": torch.arange(n, device=dev)}
    out = {k: st[k].clone() for k in ("t_best", "tri_best", "b1", "b2")}

    def retire(keep):
        gone = st["ids"][~keep]
        for k in out:
            out[k][gone] = st[k][~keep]
        for k in list(st):
            st[k] = st[k][keep]

    retire(st["active"])
    pid = kd.prim_indices.to(torch.int64)
    marks = None if counts is None else counts.start(kd, n)
    while st["ids"].numel():
        o, d, inv_d = st["o"], st["d"], st["inv_d"]
        tmin, tmax, act, node, sp, cursor = (st[k] for k in (
            "tmin", "tmax", "active", "node", "sp", "cursor"))
        t_best, tri_best, b1b, b2b = st["t_best"], st["tri_best"], st["b1"], st["b2"]
        lanes = torch.arange(node.shape[0], device=dev)
        fl, word0, word1 = node_fields(kd.nodes[node])
        # word 1 >> 2 is a leaf's prim count and an interior node's above child
        fl, offs, high = fl.to(torch.int64), word0.to(torch.int64), word1.to(torch.int64)
        behind = tmin > t_best
        is_leaf = (fl == LEAF) & act & ~behind
        interior = act & ~is_leaf & ~behind
        for i in range(KD_LEAF_CHUNK):
            j = cursor + i
            valid = is_leaf & (j < high)
            sidx = torch.where(valid, offs + j, 0)
            prim = pid[sidx]
            tr = kd.tris[prim]
            hit, t, _, b1, b2 = intersect_tri(tr[:, 0:3], tr[:, 3:6], tr[:, 6:9], o, d, t_best)
            closer = valid & hit
            t_best = torch.where(closer, t, t_best)
            tri_best = torch.where(closer, prim, tri_best)
            b1b = torch.where(closer, b1, b1b)
            b2b = torch.where(closer, b2, b2b)
            if counts is not None:
                counts.tri_tests += int(valid.sum())
                marks[1][sidx[valid]] = True
                marks[2][prim[valid]] = True
        if counts is not None:
            counts.visits += int(act.sum())
            counts.ray_visits[st["ids"][act]] += 1
            marks[0][node[act & ~behind]] = True
        cursor_new = cursor + KD_LEAF_CHUNK
        leaf_done = is_leaf & (cursor_new >= high)

        ax = torch.clamp(fl, 0, 2)[:, None]
        o_ax = torch.gather(o, 1, ax)[:, 0]
        inv_ax = torch.gather(inv_d, 1, ax)[:, 0]
        d_ax = torch.gather(d, 1, ax)[:, 0]
        split = word0.view(torch.float32)
        t_plane = (split - o_ax) * inv_ax
        below_first = (o_ax < split) | ((o_ax == split) & (d_ax <= 0.0))
        below = node + 1
        above = high
        first = torch.where(below_first, below, above)
        second = torch.where(below_first, above, below)
        only_first = (t_plane > tmax) | (t_plane <= 0.0)
        # only_first takes priority where both hold, as in pbrt's if / else if
        only_second = (t_plane < tmin) & ~only_first
        push = interior & ~only_first & ~only_second
        wl = lanes[push & (sp < KD_STACK)]       # a push past the stack is dropped
        ws = sp[wl]
        st["st_n"][wl, ws] = second[wl]
        st["st_t0"][wl, ws] = torch.maximum(t_plane, tmin)[wl]
        st["st_t1"][wl, ws] = tmax[wl]
        sp = sp + push.to(torch.int64)
        node_i = torch.where(only_second, second, first)
        tmax_i = torch.where(push, t_plane, tmax)

        need_pop = leaf_done | (act & behind)
        done_hit = st["anyhit"] & (tri_best >= 0)
        need_pop = need_pop & ~done_hit
        act = act & ~(done_hit & (is_leaf | behind))
        can_pop = need_pop & (sp > 0)
        spm1 = torch.clamp(torch.clamp(sp - 1, min=0), max=KD_STACK - 1)   # clamped gather
        node_p = st["st_n"][lanes, spm1]
        tmin_p = st["st_t0"][lanes, spm1]
        tmax_p = st["st_t1"][lanes, spm1]
        st["sp"] = torch.where(can_pop, torch.clamp(sp - 1, min=0), sp)
        st["active"] = act & ~(need_pop & ~can_pop)
        st["node"] = torch.where(can_pop, node_p, torch.where(interior, node_i, node))
        st["tmin"] = torch.where(can_pop, tmin_p, tmin)
        st["tmax"] = torch.where(can_pop, tmax_p, torch.where(interior, tmax_i, tmax))
        st["cursor"] = torch.where(is_leaf & ~leaf_done, cursor_new, 0)
        st["t_best"], st["tri_best"], st["b1"], st["b2"] = t_best, tri_best, b1b, b2b
        live = int(st["active"].sum())
        if 2 * live <= st["active"].shape[0]:
            retire(st["active"])
    return out["t_best"], out["tri_best"].to(torch.int32), out["b1"], out["b2"]


def _launch(kd: KdTree, o, d, t_max, anyhit):
    n = o.shape[0]
    dev = o.device
    for name, x, dt, shp in (
            ("o", o, torch.float32, (n, 3)), ("d", d, torch.float32, (n, 3)),
            ("t_max", t_max, torch.float32, (n,)), ("anyhit", anyhit, torch.uint8, (n,)),
            ("nodes", kd.nodes, torch.int32, (kd.n_nodes, 2)),
            ("prim_indices", kd.prim_indices, torch.int32, (kd.prim_indices.shape[0],)),
            ("tris", kd.tris, torch.float32, (kd.tris.shape[0], 12))):
        _check(name, x, dt, shp, dev)
    out = [torch.empty(n, device=dev), torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, device=dev), torch.empty(n, device=dev)]
    if n == 0:
        return tuple(out)
    fn = native.load("kdtree_traverse").pbrt_kdtree_traverse
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_float] * 6
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    lo, hi = (float(v) for v in kd.world_lo), (float(v) for v in kd.world_hi)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(kd.nodes.data_ptr(), kd.prim_indices.data_ptr(), kd.tris.data_ptr(),
                 o.data_ptr(), d.data_ptr(), t_max.data_ptr(), anyhit.data_ptr(), n,
                 *lo, *hi, *(x.data_ptr() for x in out), stream)
    if err != 0:
        raise RuntimeError(f"pbrt_kdtree_traverse launch failed: cudaError {err}")
    intersect_kdtree.launches += 1
    return tuple(out)


def intersect_kdtree(kd: KdTree, o, d, t_max, anyhit):
    """Closest-hit / per-ray any-hit walk -> (t, tri, b1, b2). CPU tensors
    take `intersect_kdtree_plain`; CUDA tensors launch K1 or raise.
    `intersect_kdtree.launches` counts K1's launches."""
    if o.device.type == "cpu":
        return intersect_kdtree_plain(kd, o, d, t_max, anyhit)
    if o.device.type == "cuda":
        return _launch(kd, o, d, t_max, anyhit)
    raise NotImplementedError(f"no kd-tree walk for device {o.device}")


intersect_kdtree.launches = 0
