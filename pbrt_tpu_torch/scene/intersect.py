"""Scene intersection -> SurfaceInteraction (port of
pbrt_tpu/scene/intersect.py).

Both launches of a path-tracing bounce go through one traversal:
`intersect` (camera rays) and `intersect_pair` (the next rays' closest hit
and the NEE shadow rays' any-hit, in one 2N launch). The traversal returns
leaf slots, so hit attributes come from one row gather of `slot_attr`. A
world tree of up to BARY_ROUTE_NODES nodes takes the B1 walk, and the
barycentrics are recomputed per lane with the kernel's own naive-shear
arithmetic (`kernel_bary`); a larger tree takes the "packet" walk (the
reference's route through its B5 kernel), which returns them with the same
arithmetic. Scenes with instances add one instance-walk
launch after each traversal launch, bounded by the world hit; their hits
are keyed by triangle row instead, and instanced hits get their frame moved
to world. Scenes with quadrics add the quadric pass after the walks,
bounded by their hit: one batched op per quadric kind present over
[lanes, quadrics of the kind], in chunks of lanes; a quadric hit's frame
is evaluated for its lane alone. Scenes with alpha-masked triangles trace
every lane of a world walk closest-hit, then re-trace the lanes whose hit
is masked (alpha <= 0) from just past it, ALPHA_ROUNDS times: one more
launch of the route's walk each round; the shadow half of a pair launch
reads the shadow mask. Geometry is detached where the reference stops its
gradient, at the top of each entry: no autograd reaches the walks, the
barycentrics, the quadric pass or the frames.

Under `Accelerator "kdtree"` (flags.accel) every world walk is the
kd-tree's (accel/kdtree.py, K1 on the card): the closest hits, the shadow
rays' any-hits in the same pair launch, and the alpha re-traces. It returns
triangle rows and the watertight test's barycentrics, so hits are keyed by
`tri_attr` rows and no barycentric is recomputed.
"""
from __future__ import annotations

import torch

from pbrt_tpu_torch.accel.instance import instance_traverse, trs_matrices_at
from pbrt_tpu_torch.accel.kdtree import intersect_kdtree
from pbrt_tpu_torch.accel.traverse import far_miss_rays, traverse
from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.interaction import SurfaceInteraction, make_frame
from pbrt_tpu_torch.core.math import normalize
from pbrt_tpu_torch.scene.types import (AT_ALPHA, AT_HASN, AT_K, AT_LIGHT, AT_MAT, AT_N,
                                        AT_P0, AT_P1, AT_P2, AT_PRIM, AT_REV, AT_SALPHA, AT_UV)
from pbrt_tpu_torch.shapes import quadrics as Q
from pbrt_tpu_torch.shapes.triangle import triangle_shading
from pbrt_tpu_torch.textures import eval_texture

TINY = 1e-20
# the reference's SMEM_META_MAX: world trees with more nodes take the walk
# that returns barycentrics (variant "packet")
BARY_ROUTE_NODES = 1 << 15
# lanes x quadrics of one kind in one chunk of the quadric pass
QUAD_CHUNK = 1 << 20
ALPHA_ROUNDS = 3   # re-traces past alpha-masked hits per query


def kernel_bary(o, d, p0, p1, p2):
    """(b1, b2) of the hit triangle with the traversal's naive-shear math
    (not shapes/triangle.py's difference-of-products edge functions)."""
    ax, ay, az = torch.abs(d[:, 0]), torch.abs(d[:, 1]), torch.abs(d[:, 2])
    zero = torch.zeros_like(ax, dtype=torch.int64)
    kz = torch.where((ax >= ay) & (ax >= az), zero, torch.where(ay >= az, zero + 1, zero + 2))
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3

    def pick(v, k):
        return torch.where(k == 0, v[:, 0], torch.where(k == 1, v[:, 1], v[:, 2]))

    dpz = pick(d, kz)
    sz = 1.0 / torch.where(dpz == 0.0, TINY, dpz)
    sx = -pick(d, kx) * sz
    sy = -pick(d, ky) * sz

    def shear(p):
        t = p - o
        return pick(t, kx) + sx * pick(t, kz), pick(t, ky) + sy * pick(t, kz)

    x0, y0 = shear(p0)
    x1, y1 = shear(p1)
    x2, y2 = shear(p2)
    e1 = x2 * y0 - y2 * x0
    e2 = x0 * y1 - y0 * x1
    det = (x1 * y2 - y1 * x2) + e1 + e2
    inv_det = 1.0 / torch.where(det == 0.0, TINY, det)
    return e1 * inv_det, e2 * inv_det


def _keyed_attr(data, flags):
    """The attribute rows a world walk's hit ids index: triangle rows for
    the kd-tree's walk, leaf slots for the BVH's."""
    return data.tri_attr if flags.accel == "kdtree" else data.slot_attr


def _world_box(data, flags):
    """(lo, hi) of the world walk's root box, or None without one."""
    if flags.accel == "kdtree":
        return data.kd.world_lo, data.kd.world_hi
    return None if data.bvh is None else (data.bvh.wlo, data.bvh.whi)


def _closest(data, flags, o, d, t_max, anyhit):
    """(t [N], id [N], b1, b2) of the closest (or, per lane, any) world
    hit: the id a leaf slot, or a triangle row under the kd-tree; b1 and b2
    are None where the walk does not return them."""
    if flags.n_tris == 0:
        return (t_max, torch.full(t_max.shape, -1, dtype=torch.int32, device=o.device),
                None, None)
    if flags.accel == "kdtree":
        return intersect_kdtree(data.kd, o.contiguous(), d.contiguous(), t_max.contiguous(),
                                anyhit.to(torch.uint8).contiguous())
    args = (data.bvh, o.contiguous(), d.contiguous(), t_max.contiguous(),
            anyhit.to(torch.uint8).contiguous())
    if data.bvh.metas.shape[0] > BARY_ROUTE_NODES:
        return traverse(*args, variant="packet")[:4]
    t, slot, _ = traverse(*args)
    return t, slot, None, None


def _alpha_of_hit(data, flags, t, slot, b1, b2, o, d, shadow):
    """Alpha-mask value of each lane's world hit ([N]; 1 = opaque, and on
    misses and unmasked triangles); shadow [N] bool picks the shadow mask.
    The texture stage is gated to the kinds the masks reach: the other
    lanes' values are discarded, as the reference discards them."""
    attr = _keyed_attr(data, flags)[torch.clamp(slot, min=0).to(torch.int64)]
    aid = torch.where(shadow, attr[:, AT_SALPHA], attr[:, AT_ALPHA]).to(torch.int32)
    if b1 is None:
        b1, b2 = kernel_bary(o, d, attr[:, AT_P0:AT_P0 + 3], attr[:, AT_P1:AT_P1 + 3],
                             attr[:, AT_P2:AT_P2 + 3])
    b0 = 1.0 - b1 - b2
    tuv = attr[:, AT_UV:AT_UV + 6].reshape(-1, 3, 2)
    uv = b0[:, None] * tuv[:, 0] + b1[:, None] * tuv[:, 1] + b2[:, None] * tuv[:, 2]
    hit = slot >= 0
    p = o + torch.where(hit, t, 0.0)[:, None] * d   # finite on misses too
    a = eval_texture(data.tex, aid, uv, p, kinds=flags.alpha_kinds)[:, 0]
    return torch.where(hit & (aid >= 0), a, 1.0)


def _closest_alpha(data, flags, o, d, t_max, anyhit, shadow):
    """_closest, skipping alpha-masked surface points in scenes with
    masks: every lane closest-hit, then ALPHA_ROUNDS re-traces of the
    masked lanes from just past their hit (the others ride far-miss rays);
    a lane still masked after the last round misses."""
    if not flags.has_alpha or flags.n_tris == 0:
        return _closest(data, flags, o, d, t_max, anyhit)
    closest = torch.zeros_like(anyhit)
    t, slot, b1, b2 = _closest(data, flags, o, d, t_max, closest)
    fo, fd = far_miss_rays([_world_box(data, flags)], o.shape[0], o.device)
    t_off = torch.zeros_like(t)
    oo = o
    for _ in range(ALPHA_ROUNDS):
        masked = (slot >= 0) & (_alpha_of_hit(data, flags, t, slot, b1, b2, oo, d, shadow)
                                <= 0.0)
        step = t + 1e-4 * (1.0 + torch.abs(t))
        oo = torch.where(masked[:, None], oo + step[:, None] * d, oo)
        t_off = torch.where(masked, t_off + step, t_off)
        rem = torch.clamp(torch.where(masked, t_max - t_off, 1.0), min=0.0)
        m3 = masked[:, None]
        got = _closest(data, flags, torch.where(m3, oo, fo), torch.where(m3, d, fd), rem,
                       closest)
        t, slot = torch.where(masked, got[0], t), torch.where(masked, got[1], slot)
        if b1 is not None:
            b1, b2 = torch.where(masked, got[2], b1), torch.where(masked, got[3], b2)
    still = (slot >= 0) & (_alpha_of_hit(data, flags, t, slot, b1, b2, oo, d, shadow) <= 0.0)
    return torch.where(still, t_max, t + t_off), torch.where(still, -1, slot), b1, b2


def _instance_pass(data, flags, o, d, t, slot, b1, b2, time):
    """Fold the instance world's closest hits into the world hits (ids of
    the world walk, with their barycentrics, or None to compute them). The
    world t is the instance walk's t_max, so a tie keeps the world hit.
    -> (t, tri, b1, b2, inst): triangle rows of tri_attr, -1 on a miss."""
    n = o.shape[0]
    dev = o.device
    tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if flags.n_tris == 0:
        b1 = b2 = torch.zeros(n, device=dev)
    else:
        tri = slot if flags.accel == "kdtree" else torch.where(
            slot >= 0, data.bvh.order[torch.clamp(slot, min=0).to(torch.int64)], tri)
        if b1 is None:
            attr = data.tri_attr[torch.clamp(tri, min=0).to(torch.int64)]
            b1, b2 = kernel_bary(o, d, attr[:, AT_P0:AT_P0 + 3], attr[:, AT_P1:AT_P1 + 3],
                                 attr[:, AT_P2:AT_P2 + 3])
    ti, tri_i, b1i, b2i, inst_i, _ = instance_traverse(
        data.ibvh, o.contiguous(), d.contiguous(), t.contiguous(), time.contiguous(),
        flags.any_animated_inst)
    hit = tri_i >= 0
    return (torch.where(hit, ti, t), torch.where(hit, tri_i, tri), torch.where(hit, b1i, b1),
            torch.where(hit, b2i, b2), torch.where(hit, inst_i, -1))


def _affine(m, v, point):
    """m [..., 4, 4] applied to v [..., 3] (+ the translation for a point),
    component by component, so a batch of matrices against rays [N, 1, 3]
    and one matrix per lane round alike."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    rows = [m[..., i, 0] * x + m[..., i, 1] * y + m[..., i, 2] * z for i in range(3)]
    if point:
        rows = [r + m[..., i, 3] for i, r in enumerate(rows)]
    return torch.stack(rows, -1)


def _quadric_pass(quads, o, d, t_max):
    """Closest quadric hit of each lane below t_max -> (t [N], quadric row
    [N], -1 on a miss; t is t_max there). On equal t the lowest row wins,
    as in the reference's loop over the table with a strict <."""
    n = o.shape[0]
    best_t = torch.full((n,), vm.INF, device=o.device)
    best_q = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    for kind, (rows, w2o, qp) in quads.by_kind.items():
        step = max(1, QUAD_CHUNK // rows.shape[0])
        ts, js = [], []
        for s in range(0, n, step):
            oq = _affine(w2o, o[s:s + step, None], True)     # [chunk, Qk, 3]
            dq = _affine(w2o, d[s:s + step, None], False)
            hit, t = Q.intersect_quadric(kind, qp, oq, dq, t_max[s:s + step, None], full=False)
            t, j = torch.min(torch.where(hit, t, vm.INF), dim=1)   # first of equal minima
            ts.append(t)
            js.append(j)
        t, q = torch.cat(ts), rows[torch.cat(js)]
        better = (t < best_t) | ((t == best_t) & (q < best_q))
        best_t = torch.where(better, t, best_t)
        best_q = torch.where(better, q, best_q)
    found = best_t < vm.INF
    return torch.where(found, best_t, t_max), torch.where(found, best_q, -1)


def _quadric_eval(quads, qi, o, d):
    """World-space frame of each lane's hit on quadric row qi [N] ->
    (p, n, uv, dpdu, dpdv, p_err): every kind present is evaluated on
    every lane with the lane's parameters, and the lane's kind selected."""
    w2o, o2w = quads.w2o[qi], quads.o2w[qi]
    oo, od = _affine(w2o, o, True), _affine(w2o, d, False)
    qp = quads.params[qi]
    kind = quads.kind[qi]
    out = None
    for k in quads.by_kind:
        r = Q.intersect_quadric(k, qp, oo, od, vm.INF)[2:]
        if out is None:
            out = r
        else:
            sel = (kind == k)[:, None]
            out = [torch.where(sel, a, b) for a, b in zip(r, out)]
    p, n, uv, dpdu, dpdv, perr = out
    lin = o2w[:, :3, :3]
    pw = torch.einsum("nij,nj->ni", lin, p) + o2w[:, :3, 3]
    # normals by the inverse transpose: the w2o linear part, transposed
    nw = normalize(torch.einsum("nij,ni->nj", w2o[:, :3, :3], n))
    perr = torch.abs(torch.einsum("nij,nj->ni", torch.abs(lin), perr)) + 1e-5 * torch.abs(pw)
    return (pw, nw, uv, torch.einsum("nij,nj->ni", lin, dpdu),
            torch.einsum("nij,nj->ni", lin, dpdv), perr)


def dead_lane_rays(data, flags, n, device):
    """(o, d) [n,3] of rays that miss the world walk's and the instance
    world's root boxes (None without either): dead lanes retire on them."""
    inst = None if data.ibvh is None else (data.ibvh.wlo, data.ibvh.whi)
    boxes = [b for b in (_world_box(data, flags), inst) if b is not None]
    return far_miss_rays(boxes, n, device) if boxes else None


def intersect(data, flags, o, d, t_max, time=None) -> SurfaceInteraction:
    """Closest hit of the whole wavefront -> SurfaceInteraction. time [N]
    places animated instances (None: time 0; static scenes ignore it)."""
    n = o.shape[0]
    o, d, t_max = o.detach(), d.detach(), t_max.detach()
    no = torch.zeros(n, dtype=torch.bool, device=o.device)
    t, slot, b1, b2 = _closest_alpha(data, flags, o, d, t_max, no, no)
    tri = inst = None
    if flags.accel == "kdtree" and not flags.n_instances:
        tri, slot = slot, None
    if flags.n_instances:
        if time is None:
            time = torch.zeros(n, device=o.device)
        t, tri, b1, b2, inst = _instance_pass(data, flags, o, d, t, slot, b1, b2, time)
        slot = None
    q_t = q_id = None
    if flags.n_quadrics:
        q_t, q_id = _quadric_pass(data.quads, o, d, t)
    return _assemble_si(data, o, d, t, slot, tri=tri, b1=b1, b2=b2, inst=inst, time=time,
                        trs=flags.any_animated_inst, q_t=q_t, q_id=q_id)


def intersect_pair(data, flags, o_nx, d_nx, tmax_nx, active_nx,
                   o_sh, d_sh, dist_sh, active_sh, time=None):
    """One traversal launch for a bounce's next rays (closest hit) and NEE
    shadow rays (any-hit), plus one instance launch in scenes with
    instances, where both halves take the lane's time, and one quadric
    pass in scenes with quadrics. Dead lanes of either set are re-pointed
    at a ray that misses every root box, so they retire at the root, and
    their quadric pass is bounded at 0. -> (si_next [N], occluded [N])."""
    n = o_nx.shape[0]
    o_nx, d_nx, tmax_nx = o_nx.detach(), d_nx.detach(), tmax_nx.detach()
    o_sh, d_sh, dist_sh = o_sh.detach(), d_sh.detach(), dist_sh.detach()
    far = dead_lane_rays(data, flags, n, o_nx.device)
    if far is not None:
        fo, fd = far
        o_nx = torch.where(active_nx[:, None], o_nx, fo)
        d_nx = torch.where(active_nx[:, None], d_nx, fd)
        o_sh = torch.where(active_sh[:, None], o_sh, fo)
        d_sh = torch.where(active_sh[:, None], d_sh, fd)
    anyhit = torch.cat([torch.zeros_like(active_nx), torch.ones_like(active_sh)])
    o2, d2 = torch.cat([o_nx, o_sh]), torch.cat([d_nx, d_sh])
    t, slot, b1, b2 = _closest_alpha(data, flags, o2, d2, torch.cat([tmax_nx, dist_sh]),
                                     anyhit, anyhit)
    tri = inst = None
    if flags.n_instances:
        if time is None:
            time = torch.zeros(n, device=o_nx.device)
        t, tri, b1, b2, inst = _instance_pass(data, flags, o2, d2, t, slot, b1, b2,
                                              torch.cat([time, time]))
        occluded = tri[n:] >= 0
        tri, inst, slot = tri[:n], inst[:n], None
    else:
        occluded = slot[n:] >= 0
        slot = slot[:n]
        if flags.accel == "kdtree":
            tri, slot = slot, None
    q_t = q_id = None
    if flags.n_quadrics:
        q_t, q_id = _quadric_pass(data.quads, o2, d2,
                                  torch.where(torch.cat([active_nx, active_sh]), t, 0.0))
        occluded = occluded | (q_id[n:] >= 0)
        q_t, q_id = q_t[:n], q_id[:n]
    if b1 is not None:
        b1, b2 = b1[:n], b2[:n]
    si = _assemble_si(data, o_nx, d_nx, t[:n], slot, tri=tri, b1=b1, b2=b2, inst=inst,
                      time=time, trs=flags.any_animated_inst, q_t=q_t, q_id=q_id)
    return si, active_sh & occluded


def intersect_p(data, flags, o, d, t_max, time=None):
    """Any hit below t_max -> occluded [N] bool (the reference's
    intersect_p): the world walk with every lane any-hit (with alpha masks,
    closest-hit past the masked points, under the shadow masks), the
    instance walk and the quadric pass, each bounded by t_max."""
    n = o.shape[0]
    o, d, t_max = o.detach(), d.detach(), t_max.detach()
    yes = torch.ones(n, dtype=torch.bool, device=o.device)
    _, slot, _, _ = _closest_alpha(data, flags, o, d, t_max, yes, yes)
    occluded = slot >= 0
    if flags.n_instances:
        if time is None:
            time = torch.zeros(n, device=o.device)
        tri_i = instance_traverse(data.ibvh, o.contiguous(), d.contiguous(),
                                  t_max.contiguous(), time.contiguous(),
                                  flags.any_animated_inst)[1]
        occluded = occluded | (tri_i >= 0)
    if flags.n_quadrics:
        occluded = occluded | (_quadric_pass(data.quads, o, d, t_max)[1] >= 0)
    return occluded


def _instance_frame(ibvh, trs, inst, time, o, d, t, p, ng, ns, dpdu, dpdv, perr):
    """Move the frames of instanced hits from prototype space to world with
    the lane's instance transform at its time; t is world-metric already,
    so p comes from the ray."""
    n = o.shape[0]
    has_i = (inst >= 0)[:, None]
    ii = torch.clamp(inst, min=0).to(torch.int64)
    w = torch.clamp(time, 0.0, 1.0)
    if trs:
        Mw, Mi = trs_matrices_at(ibvh.imat[ii], w)
    else:
        A = ibvh.i2w[ii]
        Mi = (A[:, 0] + w[:, None] * (A[:, 1] - A[:, 0])).reshape(n, 4, 4)
        B = ibvh.w2p[ii]
        Mw = (B[:, 0] + w[:, None] * (B[:, 1] - B[:, 0])).reshape(n, 4, 4)
    lin = Mi[:, :3, :3]
    p_i = o + t[:, None] * d
    dpdu_i = torch.einsum("nij,nj->ni", lin, dpdu)
    dpdv_i = torch.einsum("nij,nj->ni", lin, dpdv)
    # normals transform by the inverse transpose: the w2p linear part, transposed
    ns_i = normalize(torch.einsum("nij,ni->nj", Mw[:, :3, :3], ns))
    ng_i = normalize(torch.einsum("nij,ni->nj", Mw[:, :3, :3], ng))
    perr_i = torch.einsum("nij,nj->ni", torch.abs(lin), perr) + 1e-5 * torch.abs(p_i)
    pick = lambda a, b: torch.where(has_i, a, b)
    return (pick(p_i, p), pick(vm.face_forward(ng_i, ns_i), ng), pick(ns_i, ns),
            pick(dpdu_i, dpdu), pick(dpdv_i, dpdv), pick(perr_i, perr))


def _assemble_si(data, o, d, tri_t, slot, tri=None, b1=None, b2=None, inst=None,
                 time=None, trs=False, q_t=None, q_id=None) -> SurfaceInteraction:
    """One attribute row per lane -> the full surface frame: a slot_attr
    row by leaf slot, or, in scenes with instances, a tri_attr row by
    triangle with the given barycentrics and the instance frame; lanes
    with a quadric hit (q_id >= 0, at q_t) take the quadric's frame."""
    n = o.shape[0]
    if tri is None:
        hit = slot >= 0
        if data.slot_attr is not None:
            attr = data.slot_attr[torch.clamp(slot, min=0).to(torch.int64)]
        else:
            attr = torch.zeros((n, AT_K), device=o.device)
    else:
        hit = tri >= 0
        attr = data.tri_attr[torch.clamp(tri, min=0).to(torch.int64)]
    tp0 = attr[:, AT_P0:AT_P0 + 3]
    tp1 = attr[:, AT_P1:AT_P1 + 3]
    tp2 = attr[:, AT_P2:AT_P2 + 3]
    if b1 is None:
        b1, b2 = kernel_bary(o, d, tp0, tp1, tp2)
    b0 = 1.0 - b1 - b2
    has_n = attr[:, AT_HASN] > 0.5
    tn = torch.where(has_n[:, None, None], attr[:, AT_N:AT_N + 9].reshape(n, 3, 3), 0.0)
    tuv = attr[:, AT_UV:AT_UV + 6].reshape(n, 3, 2)
    p, ng, uv, dpdu, dpdv, perr = triangle_shading(b0, b1, b2, tp0, tp1, tp2, tuv)
    ns_int = normalize(b0[:, None] * tn[:, 0] + b1[:, None] * tn[:, 1]
                       + b2[:, None] * tn[:, 2])
    ns_ok = has_n & ~(vm.length_squared(ns_int) < 1e-12)
    ns = torch.where(ns_ok[:, None], ns_int, ng)
    ng = vm.face_forward(ng, ns)
    prim = attr[:, AT_PRIM].to(torch.int32)
    material = attr[:, AT_MAT].to(torch.int32)
    light = attr[:, AT_LIGHT].to(torch.int32)
    rev = attr[:, AT_REV] > 0.5
    if q_id is not None:
        quads = data.quads
        use_q = q_id >= 0
        qi = torch.clamp(q_id, min=0)
        q = _quadric_eval(quads, qi, o, d)
        u3 = use_q[:, None]
        p, ng, ns, uv, dpdu, dpdv, perr = (torch.where(u3, a, b) for a, b in zip(
            (q[0], q[1], q[1], q[2], q[3], q[4], q[5]), (p, ng, ns, uv, dpdu, dpdv, perr)))
        prim = torch.where(use_q, quads.prim[qi], prim)
        material = torch.where(use_q, quads.material[qi], material)
        light = torch.where(use_q, quads.light[qi], light)
        rev = torch.where(use_q, quads.rev[qi], rev)
        hit = hit | use_q
        tri_t = torch.where(use_q, q_t, tri_t)
        if inst is not None:
            inst = torch.where(use_q, -1, inst)
    if inst is not None:
        p, ng, ns, dpdu, dpdv, perr = _instance_frame(data.ibvh, trs, inst, time, o, d, tri_t,
                                                      p, ng, ns, dpdu, dpdv, perr)
    ng = torch.where(rev[:, None], -ng, ng)
    ns = torch.where(rev[:, None], -ns, ns)

    # miss lanes get benign finite values
    up = torch.tensor([0.0, 0.0, 1.0], device=o.device).expand(n, 3)
    h3 = hit[:, None]

    def safe3(v, alt):
        return torch.where(h3, torch.nan_to_num(v, nan=0.0, posinf=0.0, neginf=0.0), alt)

    p, perr = safe3(p, 0.0), safe3(perr, 0.0)
    ng, ns = safe3(ng, up), safe3(ns, up)
    dpdu, dpdv = safe3(dpdu, up), safe3(dpdv, up)
    uv = torch.where(h3, torch.nan_to_num(uv), 0.0)
    ss, ts = make_frame(ns, dpdu)
    neg1 = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    return SurfaceInteraction(
        valid=hit, t=torch.where(hit, tri_t, 1e20), p=p, p_err=perr,
        wo=normalize(-d), ng=ng, ns=ns, ss=ss, ts=ts, uv=uv, dpdu=dpdu, dpdv=dpdv,
        prim=torch.where(hit, prim, neg1), material=torch.where(hit, material, neg1),
        area_light=torch.where(hit, light, neg1))
