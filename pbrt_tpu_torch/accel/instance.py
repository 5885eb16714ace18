"""Two-level instance traversal: the instance world's tables, the plain
PyTorch walk and the wrapper of the CUDA kernel (port of
pbrt_tpu/accel/pallas_instance.py).

Contract (the TPU kernel `_kernel_inst`'s, without its layout):
  inputs  world rays o [N,3], d [N,3], t_max [N] and time [N] f32 (clipped
          to [0,1] by the walk), plus the tables of `pack_instance_world`;
  outputs t [N] f32, tri [N] i32 (the global triangle row of the hit, -1 on
          a miss), b1, b2 [N] f32, inst [N] i32 (-1 on a miss), and iters
          [ceil(N/1024)] i32 as `traverse` returns them: per 1024-ray group
          the largest per-ray pop count, bit 24 set on a stack overflow.
One node table holds the top tree over instance world bounds, whose leaves
(cnt == 15) enter an instance, followed by every prototype's subtree.
Entering pushes RESTORE, then the prototype root, and moves the lane's ray
into prototype space with its own matrix at its time: the matrix lerp
M0 + t (M1 - M0) when no instance is animated, else (`trs`) the slerp of
the keyframes' rotation with T and S lerped. Popping RESTORE returns to the
world ray. Directions are not renormalised, so hits keep the world t.

`instance_traverse` takes the plain version for CPU tensors only. For CUDA
tensors it launches csrc/instance_traverse.cu or raises; nothing falls back.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from pbrt_tpu_torch.accel.bvh import build_bvh
from pbrt_tpu_torch.accel.traverse import (GROUP, LEAF_TRIS, REC_FLOATS, WalkCounts, _call, _check,
                                           _iters, _Rays, leaf_blocks, node_depths, walk_records)

STACK = 96           # per-ray stack entries, in the kernel and the plain walk
RESTORE = -2         # stack sentinel: leave the current instance
ENTER = 15           # meta cnt of a top-tree leaf that enters an instance
PAYLOAD_MASK = 0x1FFFFFF
IMAT_STRIDE = 56     # per instance: w2p0[12], (w2p1 - w2p0)[12], then the TRS
                     # decomposition of both w2p keyframes:
                     # T0[3] T1[3] q0[4] q1[4] S0[9] S1[9]
IREC_STRIDE = 64     # an instance record: its imat row, then its prototype
                     # root's walk word (int32 bits) at IMAT_STRIDE


def _decompose_trs(m):
    """4x4 affine -> (T[3], q[4] xyzw, S[3,3]): polar iteration, then
    S = R^-1 M (float64)."""
    T = np.asarray(m, np.float64)[:3, 3].copy()
    M3 = np.asarray(m, np.float64)[:3, :3].copy()
    R = M3.copy()
    for _ in range(100):
        Rn = 0.5 * (R + np.linalg.inv(R.T))
        if np.abs(Rn - R).max() < 1e-9:
            R = Rn
            break
        R = Rn
    S = np.linalg.inv(R) @ M3
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                      (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        q[3] = (R[k, j] - R[j, k]) / s
    q = q / np.linalg.norm(q)
    return T, q, S


def _slerp_trs_host(d0, d1, t):
    """Host mirror of the walk's TRS interpolation (for motion bounds)."""
    T0, q0, S0 = d0
    T1, q1, S1 = d1
    if np.dot(q0, q1) < 0:
        q1 = -q1
    d = np.clip(np.dot(q0, q1), -1.0, 1.0)
    th = np.arccos(d)
    if np.sin(th) < 1e-4:
        q = (1 - t) * q0 + t * q1
    else:
        q = (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)
    q = q / np.linalg.norm(q)
    x, y, z, w = q
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                  [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                  [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
    m = np.eye(4)
    m[:3, :3] = R @ (S0 + t * (S1 - S0))
    m[:3, 3] = T0 + t * (T1 - T0)
    return m


def _aabb_transform(lo, hi, m):
    """World AABB of a prototype-space AABB under 4x4 m (prototype->world)."""
    corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    w = corners @ m[:3, :3].T + m[:3, 3]
    return w.min(0), w.max(0)


@dataclasses.dataclass
class InstanceBVH:
    """The instance world's tables on one device.

    metas [M] i32      ax | cnt<<2 | payload<<6: top tree first (root 0; a
                       leaf has cnt 15 and payload = instance id), then the
                       prototype subtrees (payload = right child or block)
    nodes [M,16] f32   both children's boxes (left lo,hi, right lo,hi)
    tris  [L*8,16] f32 prototype-space leaf blocks, shared by all instances
    order [L*8] i32    leaf slot -> global triangle row, -1 on padding
    imat  [I,56] f32   per-instance walk matrices (IMAT_STRIDE layout)
    iroot [I] i32      prototype root node of each instance
    ianim [I] i32      1 if the instance is animated
    i2w, w2p [I,2,16]  keyframe prototype->world / world->prototype, 4x4
                       row-major, for the shading frame
    stack_need         stack entries the walk needs: top depth + 1
                       (RESTORE) + deepest prototype depth + 1
    recs [R,16] f32    the kernel's walk records (traverse.walk_records),
    root_word          the word its walk starts from,
    irec [I,64] f32    its instance records: imat[i], then the walk word of
                       iroot[i]; all derived at construction
                       (`instance_records`), and
    recs_ms            the derivation's time in ms (set-up)
    """
    metas: torch.Tensor
    nodes: torch.Tensor
    tris: torch.Tensor
    order: torch.Tensor
    imat: torch.Tensor
    iroot: torch.Tensor
    ianim: torch.Tensor
    i2w: torch.Tensor
    w2p: torch.Tensor
    wlo: np.ndarray
    whi: np.ndarray
    stack_need: int
    recs: torch.Tensor = None
    root_word: int = 0
    irec: torch.Tensor = None
    recs_ms: float = 0.0

    def __post_init__(self):
        if self.recs is None:
            t0 = time.perf_counter()
            self.recs, self.root_word, self.irec = instance_records(
                self.metas, self.nodes, self.imat, self.iroot)   # waits for the device
            self.recs_ms = 1e3 * (time.perf_counter() - t0)

    def to(self, device) -> "InstanceBVH":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def instance_records(metas, nodes, imat, iroot):
    """The kernel's tables, derived from the instance world's -> (walk
    records, root word, instance records [I,64] f32). Top-tree leaves keep
    their ENTER words, so entering instance i reads one record: its walk
    matrix (imat[i]) and its prototype root's walk word."""
    recs, words = walk_records(metas, nodes)
    irec = torch.zeros((iroot.shape[0], IREC_STRIDE), dtype=torch.int32, device=metas.device)
    irec[:, :IMAT_STRIDE] = imat.contiguous().view(torch.int32)
    irec[:, IMAT_STRIDE] = words[iroot.to(torch.int64)].to(torch.int32)
    return recs, int(words[0]), irec.view(torch.float32)


def _tree_metas(bvh, node_base, leaf_cnt, leaf_payload):
    """Packed meta words of one tree placed at node_base: interior payloads
    are right children offset by node_base, leaf payloads leaf_payload."""
    cnts = np.asarray(bvh.prim_count, np.int64)
    leaf = cnts > 0
    payload = np.asarray(bvh.right_child, np.int64) + node_base
    payload[leaf] = leaf_payload
    cf = np.where(leaf, leaf_cnt, 0)
    return np.asarray(bvh.axis, np.int64) | (cf << 2) | (payload << 6)


def walk_stack_need(metas, iroot) -> int:
    """Stack entries the walk of a packed instance world needs: the top
    tree's depth + 1 (RESTORE) + the deepest prototype's depth + 1. The top
    tree ends where the first prototype subtree begins."""
    metas = np.asarray(metas, np.int64)
    cnts = (metas >> 2) & 15
    right = np.where(cnts > 0, 0, (metas >> 6) & PAYLOAD_MASK)
    depth = node_depths(right, cnts)
    n_top = int(np.min(iroot))
    return int(depth[:n_top].max()) + 1 + int(depth[n_top:].max()) + 1


def pack_instance_world(proto_tris, proto_gids, instances, device="cpu") -> InstanceBVH:
    """Build and pack the two-level structure (the reference's
    `pack_instance_world`, same words, blocks and slots).

    proto_tris: per prototype (lo [T,3], hi [T,3], p0, p1, p2 [T,3]) of its
      triangles in prototype space; proto_gids: per prototype [T] global
      triangle rows in the same order; instances: dicts {proto, m_p2w0,
      m_p2w1, m_w2p0, m_w2p1 (4x4), animated}.
    Raises if the walk would need more than the kernel's stack."""
    proto_pack, proto_bounds = [], []
    for (lo, hi, p0, p1, p2), gids in zip(proto_tris, proto_gids):
        eps = 1e-5 * np.maximum(np.abs(lo) + np.abs(hi), 1.0)
        bvh = build_bvh(lo - eps, hi + eps)
        proto_pack.append((bvh, p0, p1, p2, np.asarray(gids, np.int32)))
        root = np.asarray(bvh.packed)[0]
        proto_bounds.append((np.minimum(root[0:3], root[6:9]),
                             np.maximum(root[3:6], root[9:12])))

    # top tree over instance world bounds, one instance per leaf
    n_inst = len(instances)
    ilo = np.zeros((n_inst, 3), np.float32)
    ihi = np.zeros((n_inst, 3), np.float32)
    for i, inst in enumerate(instances):
        blo, bhi = proto_bounds[inst["proto"]]
        l0, h0 = _aabb_transform(blo, bhi, inst["m_p2w0"])
        l1, h1 = _aabb_transform(blo, bhi, inst["m_p2w1"])
        ilo[i] = np.minimum(l0, l1)
        ihi[i] = np.maximum(h0, h1)
        if inst.get("animated"):
            # slerped corner paths curve, so the keyframe union can miss
            # part of the sweep: sample the walk's own TRS path at 17
            # times and pad by the largest step between samples
            dp0 = _decompose_trs(inst["m_w2p0"])
            dp1 = _decompose_trs(inst["m_w2p1"])
            prev = None
            step = 0.0
            for tt in np.linspace(0.0, 1.0, 17):
                mt = np.linalg.inv(_slerp_trs_host(dp0, dp1, float(tt)))
                lt, ht = _aabb_transform(blo, bhi, mt)
                ilo[i] = np.minimum(ilo[i], lt)
                ihi[i] = np.maximum(ihi[i], ht)
                c = 0.5 * (lt + ht)
                if prev is not None:
                    step = max(step, float(np.abs(c - prev).max()))
                prev = c
            ilo[i] -= step
            ihi[i] += step
    top = build_bvh(ilo, ihi, leaf_size=1)
    tcnt = np.asarray(top.prim_count)
    if int(tcnt.max()) > 1:
        raise ValueError("the top tree must have one instance per leaf")
    tleaf = tcnt > 0
    bounds = [np.asarray(top.packed)[:, :12]]
    metas = [_tree_metas(top, 0, ENTER,
                         np.asarray(top.prim_order)[np.asarray(top.prim_offset)[tleaf]])]

    proto_root, blocks, order = [], [], []
    base = bounds[0].shape[0]
    n_blocks = 0
    for bvh, p0, p1, p2, gids in proto_pack:
        proto_root.append(base)
        cnts = np.asarray(bvh.prim_count)
        leaf_ids = np.nonzero(cnts > 0)[0]
        if int(cnts.max()) > LEAF_TRIS:
            raise ValueError(f"leaf with {int(cnts.max())} > {LEAF_TRIS} triangles")
        blk, slot_tri = leaf_blocks(np.asarray(bvh.prim_offset)[leaf_ids], cnts[leaf_ids],
                                    bvh.prim_order, p0, p1, p2)
        blocks.append(blk)
        order.append(np.where(slot_tri >= 0, gids[np.maximum(slot_tri, 0)], -1))
        bounds.append(np.asarray(bvh.packed)[:, :12])
        metas.append(_tree_metas(bvh, base, cnts, n_blocks + np.arange(len(leaf_ids))))
        base += cnts.shape[0]
        n_blocks += blk.shape[0]
    metas = np.concatenate(metas).astype(np.int32)
    iroot = np.asarray([proto_root[inst["proto"]] for inst in instances], np.int32)
    stack_need = walk_stack_need(metas, iroot)
    if stack_need > STACK:
        raise ValueError(f"the instance walk needs {stack_need} stack entries "
                         f"> the kernel's {STACK}")
    M = base
    if M >= (1 << 25):
        raise ValueError("instance-world node table too large")
    nodes = np.zeros((M, 16), np.float32)
    nodes[:, :12] = np.concatenate(bounds).astype(np.float32)
    if not blocks:
        blocks = [np.zeros((1, LEAF_TRIS, 16), np.float32)]
        order = [np.full(LEAF_TRIS, -1, np.int32)]
    tris = np.concatenate(blocks).reshape(-1, 16)

    imat = np.zeros((n_inst, IMAT_STRIDE), np.float32)
    i2w = np.zeros((n_inst, 2, 16), np.float32)
    w2p = np.zeros((n_inst, 2, 16), np.float32)
    ianim = np.zeros((n_inst,), np.int32)
    for i, inst in enumerate(instances):
        a = np.asarray(inst["m_w2p0"], np.float32)
        b = np.asarray(inst["m_w2p1"], np.float32)
        imat[i, 0:12] = a[:3, :].ravel()
        imat[i, 12:24] = (b - a)[:3, :].ravel()
        T0, q0, S0 = _decompose_trs(a)
        T1, q1, S1 = _decompose_trs(b)
        if np.dot(q0, q1) < 0:
            q1 = -q1           # sign-align so the walk's arc is the short one
        imat[i, 24:27] = T0
        imat[i, 27:30] = T1
        imat[i, 30:34] = q0
        imat[i, 34:38] = q1
        imat[i, 38:47] = S0.ravel()
        imat[i, 47:56] = S1.ravel()
        i2w[i, 0] = np.asarray(inst["m_p2w0"], np.float32).ravel()
        i2w[i, 1] = np.asarray(inst["m_p2w1"], np.float32).ravel()
        w2p[i, 0] = a.ravel()
        w2p[i, 1] = b.ravel()
        ianim[i] = 1 if inst.get("animated") else 0

    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device)
    return InstanceBVH(t(metas), t(nodes), t(tris),
                       t(np.concatenate(order).astype(np.int32)), t(imat), t(iroot),
                       t(ianim), t(i2w), t(w2p), ilo.min(0), ihi.max(0), stack_need)


# ---------------------------------------------------------------------------
# the walk's per-lane matrix, and the same TRS path for shading frames
# ---------------------------------------------------------------------------

def _walk_matrix(rows, tcl, trs: bool):
    """Gathered imat rows [n,56] and clipped times [n] -> the 12 entries of
    the lane's world->prototype 3x4 matrix, in the kernel's arithmetic."""
    c = [rows[:, j] for j in range(IMAT_STRIDE)]
    if not trs:
        return [c[j] + tcl * c[12 + j] for j in range(12)]
    T0, T1, q0, q1 = c[24:27], c[27:30], c[30:34], c[34:38]
    S0, S1 = c[38:47], c[47:56]
    dq = q0[0] * q1[0] + q0[1] * q1[1] + q0[2] * q1[2] + q0[3] * q1[3]
    dq = torch.clamp(dq, -1.0, 1.0)
    theta = torch.acos(dq)
    sth = torch.sin(theta)
    small = sth < 1e-4
    a = tcl * theta
    inv_s = 1.0 / torch.where(small, 1.0, sth)
    w1 = torch.where(small, tcl, torch.sin(a) * inv_s)
    w0 = torch.where(small, 1.0 - tcl, torch.sin(theta - a) * inv_s)
    q = [w0 * q0[j] + w1 * q1[j] for j in range(4)]
    qn = torch.rsqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
    x, y, z, w = (q[j] * qn for j in range(4))
    R9 = [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
          2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
          2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]
    Sv = [S0[j] + tcl * (S1[j] - S0[j]) for j in range(9)]
    M = []
    for r in range(3):
        for col in range(3):
            M.append(R9[3 * r] * Sv[col] + R9[3 * r + 1] * Sv[3 + col]
                     + R9[3 * r + 2] * Sv[6 + col])
        M.append(T0[r] + tcl * (T1[r] - T0[r]))
    return M


def trs_matrices_at(imat_rows, w):
    """The walk's TRS interpolation as full matrices, for shading frames.

    imat_rows [N,56] gathered per lane, w [N] clipped times -> (w2p [N,4,4],
    p2w [N,4,4]); p2w is the affine inverse of the interpolated w2p."""
    n = w.shape[0]
    M = torch.stack(_walk_matrix(imat_rows, w, True), -1).reshape(n, 3, 4)
    L, T = M[:, :, :3], M[:, :, 3]
    eye = torch.eye(4, dtype=w.dtype, device=w.device)
    w2p = eye.repeat(n, 1, 1)
    w2p[:, :3, :] = M
    # affine inverse: [L t]^-1 = [L^-1, -L^-1 t]
    Linv = torch.linalg.inv_ex(L + 1e-12 * eye[:3, :3]).inverse
    p2w = eye.repeat(n, 1, 1)
    p2w[:, :3, :3] = Linv
    p2w[:, :3, 3] = -torch.einsum("nij,nj->ni", Linv, T)
    return w2p, p2w


# ---------------------------------------------------------------------------
# plain PyTorch version: a lockstep walk with the kernel's arithmetic and
# order, so both agree bit for bit
# ---------------------------------------------------------------------------

def _xform(M, v, point: bool):
    """Rows of the 3x4 matrix M (12 lists) applied to v [n,3], left to right."""
    out = [M[4 * r] * v[:, 0] + M[4 * r + 1] * v[:, 1] + M[4 * r + 2] * v[:, 2]
           for r in range(3)]
    if point:
        out = [out[r] + M[4 * r + 3] for r in range(3)]
    return torch.stack(out, -1)


def instance_traverse_plain(ib: InstanceBVH, o, d, t_max, time, trs: bool,
                            counts: WalkCounts = None):
    """The kernel's walk as tensor ops: every ray pops one entry per step.
    counts, if given, adds up what the walk did."""
    n = o.shape[0]
    dev = o.device
    tcl = torch.clamp(time, 0.0, 1.0)
    cur_o, cur_d = o.clone(), d.clone()
    cur_inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    t_best = t_max.clone()
    slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    inst = slot.clone()
    b1 = torch.zeros(n, device=dev)
    b2 = torch.zeros(n, device=dev)
    stack = torch.zeros((n, STACK), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    pops = torch.zeros(n, dtype=torch.int32, device=dev)
    ovf = torch.zeros(n, dtype=torch.bool, device=dev)
    if counts is not None:
        counts.stack_height(sp)

    def push(lanes, spl, child, h):
        """Push child where h, in order; -> (new stack pointers, overflow)."""
        fits = spl < STACK
        put = h & fits
        stack[lanes[put], spl[put]] = child[put]
        return spl + put.to(torch.int64), h & ~fits

    while True:
        lane = torch.nonzero(sp > 0).squeeze(1)
        if lane.numel() == 0:
            break
        spl = sp[lane] - 1
        raw = stack[lane, spl]
        pops[lane] += 1
        leave = raw == RESTORE
        w = ib.metas[torch.clamp(raw, min=0)].to(torch.int64)
        ax, cnt, payload = w & 3, (w >> 2) & 15, (w >> 6) & PAYLOAD_MASK
        enter = ~leave & (cnt == ENTER)
        leaf = ~leave & (cnt > 0) & (cnt < ENTER)
        interior = ~leave & (cnt == 0)
        if counts is not None:
            counts.step(raw[~leave], interior[~leave], cnt[leaf], enter.sum())

        li = lane[leave]
        cur_o[li], cur_d[li] = o[li], d[li]
        cur_inst[li] = -1

        ei = torch.nonzero(enter).squeeze(1)
        if ei.numel():
            le, iid = lane[ei], payload[ei]
            M = _walk_matrix(ib.imat[iid], tcl[le], trs)
            cur_o[le] = _xform(M, o[le], True)
            cur_d[le] = _xform(M, d[le], False)
            cur_inst[le] = iid.to(torch.int32)
            always = torch.ones_like(le, dtype=torch.bool)
            spe, ov1 = push(le, spl[ei], torch.full_like(iid, RESTORE), always)
            spe, ov2 = push(le, spe, ib.iroot[iid].to(torch.int64), always)
            spl[ei] = spe
            ovf[le] |= ov1 | ov2

        fi = torch.nonzero(leaf).squeeze(1)
        if fi.numel():
            lf = lane[fi]
            r = _Rays(cur_o[lf], cur_d[lf])
            blk, c = payload[fi], cnt[fi]
            tb, sl, bb1, bb2, ins = t_best[lf], slot[lf], b1[lf], b2[lf], inst[lf]
            ci = cur_inst[lf]
            for j in range(LEAF_TRIS):
                s = blk * LEAF_TRIS + j
                hit, t, u, v = r.tri(ib.tris[s], tb, bary=True)
                ok = hit & (c > j)
                tb = torch.where(ok, t, tb)
                sl = torch.where(ok, s.to(torch.int32), sl)
                bb1 = torch.where(ok, u, bb1)
                bb2 = torch.where(ok, v, bb2)
                ins = torch.where(ok, ci, ins)
            t_best[lf], slot[lf], b1[lf], b2[lf], inst[lf] = tb, sl, bb1, bb2, ins

        ii = torch.nonzero(interior).squeeze(1)
        if ii.numel():
            lni = lane[ii]
            r = _Rays(cur_o[lni], cur_d[lni])
            node = raw[ii]
            rec = ib.nodes[node]
            tb = t_best[lni]
            hl = r.slab(rec[:, 0:6], tb, mul_sub=False)
            hr = r.slab(rec[:, 6:12], tb, mul_sub=False)
            swap = torch.gather(r.neg, 1, ax[ii, None]).squeeze(1)
            left, right = node + 1, payload[ii]
            near = torch.where(swap, right, left)
            far = torch.where(swap, left, right)
            spi, ov1 = push(lni, spl[ii], far, torch.where(swap, hl, hr))
            spi, ov2 = push(lni, spi, near, torch.where(swap, hr, hl))
            spl[ii] = spi
            ovf[lni] |= ov1 | ov2
        sp[lane] = spl
        if counts is not None:
            counts.stack_height(spl)

    return t_best, _global_tri(ib, slot), b1, b2, inst, _iters(pops, ovf)


def _global_tri(ib: InstanceBVH, slot):
    return torch.where(slot >= 0, ib.order[torch.clamp(slot, min=0).to(torch.int64)], -1)


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------

def _launch(ib: InstanceBVH, o, d, t_max, time, trs: bool):
    n = o.shape[0]
    dev = o.device
    M = ib.metas.shape[0]
    I = ib.iroot.shape[0]
    for name, x, dt, shp in (
            ("o", o, torch.float32, (n, 3)), ("d", d, torch.float32, (n, 3)),
            ("t_max", t_max, torch.float32, (n,)), ("time", time, torch.float32, (n,)),
            ("metas", ib.metas, torch.int32, (M,)),
            ("nodes", ib.nodes, torch.float32, (M, 16)),
            ("tris", ib.tris, torch.float32, (ib.tris.shape[0], 16)),
            ("order", ib.order, torch.int32, (ib.tris.shape[0],)),
            ("imat", ib.imat, torch.float32, (I, IMAT_STRIDE)),
            ("iroot", ib.iroot, torch.int32, (I,)),
            ("recs", ib.recs, torch.float32, (ib.recs.shape[0], REC_FLOATS)),
            ("irec", ib.irec, torch.float32, (I, IREC_STRIDE))):
        _check(name, x, dt, shp, dev)
    if ib.tris.shape[0] % LEAF_TRIS:
        raise ValueError("tris rows are not whole 8-triangle blocks")
    if ib.stack_need > STACK:
        raise ValueError(f"the instance walk needs {ib.stack_need} stack entries")
    if n >= (1 << 31) - GROUP:
        raise ValueError(f"{n} rays exceed the kernel's 32-bit ray index")
    g = -(-n // GROUP)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    b1 = torch.empty(n, dtype=torch.float32, device=dev)
    b2 = torch.empty(n, dtype=torch.float32, device=dev)
    inst = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.zeros(2 * g, dtype=torch.int32, device=dev)
    if n == 0:
        return t, slot, b1, b2, inst, scratch[:0]
    _call("instance_traverse", "pbrt_instance_traverse",
          [ib.recs, ib.tris, ib.irec, o, d, t_max, time],
          [t, slot, b1, b2, inst, scratch], n, [int(trs), ib.root_word], dev)
    instance_traverse.launches += 1
    return t, _global_tri(ib, slot), b1, b2, inst, scratch[:g] | (scratch[g:] << 24)


def instance_traverse(ib: InstanceBVH, o, d, t_max, time, trs: bool):
    """Closest instanced hit -> (t, tri, b1, b2, inst [N], iters
    [ceil(N/1024)]); trs selects the slerp path (any animated instance).

    CPU tensors take `instance_traverse_plain`; CUDA tensors launch the
    kernel or raise. `instance_traverse.launches` counts kernel launches."""
    if o.device.type == "cpu":
        return instance_traverse_plain(ib, o, d, t_max, time, trs)
    if o.device.type == "cuda":
        return _launch(ib, o, d, t_max, time, trs)
    raise NotImplementedError(f"no instance traversal for device {o.device}")


instance_traverse.launches = 0
