"""Scene intersection -> SurfaceInteraction (port of the triangle path of
pbrt_tpu/scene/intersect.py).

Both launches of a path-tracing bounce go through one traversal:
`intersect` (camera rays) and `intersect_pair` (the next rays' closest hit
and the NEE shadow rays' any-hit, in one 2N launch). The traversal returns
leaf slots, so hit attributes come from one row gather of `slot_attr`, and
barycentrics are recomputed per lane with the kernel's own naive-shear
arithmetic (`kernel_bary`). Geometry is detached: no autograd reaches the
traversal.
"""
from __future__ import annotations

import torch

from pbrt_tpu_torch.accel.traverse import far_miss_rays, traverse
from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.interaction import SurfaceInteraction, make_frame
from pbrt_tpu_torch.core.math import normalize
from pbrt_tpu_torch.scene.types import (AT_HASN, AT_K, AT_LIGHT, AT_MAT, AT_N, AT_P0,
                                        AT_P1, AT_P2, AT_PRIM, AT_REV, AT_UV)
from pbrt_tpu_torch.shapes.triangle import triangle_shading

TINY = 1e-20


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


def _closest(data, flags, o, d, t_max, anyhit):
    """(t [N], slot [N]) of the closest (or, per lane, any) hit."""
    if flags.n_tris == 0:
        return t_max, torch.full(t_max.shape, -1, dtype=torch.int32, device=o.device)
    t, slot, _ = traverse(data.bvh, o.detach().contiguous(), d.detach().contiguous(),
                          t_max.detach().contiguous(), anyhit.to(torch.uint8).contiguous())
    return t, slot


def intersect(data, flags, o, d, t_max) -> SurfaceInteraction:
    """Closest hit of the whole wavefront -> SurfaceInteraction."""
    n = o.shape[0]
    t, slot = _closest(data, flags, o, d, t_max,
                       torch.zeros(n, dtype=torch.bool, device=o.device))
    return _assemble_si(data, o, d, t, slot)


def intersect_pair(data, flags, o_nx, d_nx, tmax_nx, active_nx,
                   o_sh, d_sh, dist_sh, active_sh):
    """One traversal launch for a bounce's next rays (closest hit) and NEE
    shadow rays (any-hit). Dead lanes of either set are re-pointed at a
    far-miss ray so they retire at the root. -> (si_next [N], occluded [N])."""
    n = o_nx.shape[0]
    if flags.n_tris > 0:
        fo, fd = far_miss_rays(data.bvh, n, o_nx.device)
        o_nx = torch.where(active_nx[:, None], o_nx, fo)
        d_nx = torch.where(active_nx[:, None], d_nx, fd)
        o_sh = torch.where(active_sh[:, None], o_sh, fo)
        d_sh = torch.where(active_sh[:, None], d_sh, fd)
    anyhit = torch.cat([torch.zeros_like(active_nx), torch.ones_like(active_sh)])
    t, slot = _closest(data, flags, torch.cat([o_nx, o_sh]), torch.cat([d_nx, d_sh]),
                       torch.cat([tmax_nx, dist_sh]), anyhit)
    occluded = active_sh & (slot[n:] >= 0)
    return _assemble_si(data, o_nx, d_nx, t[:n], slot[:n]), occluded


def _assemble_si(data, o, d, tri_t, slot) -> SurfaceInteraction:
    """One slot_attr row per lane -> the full surface frame."""
    n = o.shape[0]
    hit = slot >= 0
    if data.slot_attr is not None:
        attr = data.slot_attr[torch.clamp(slot, min=0).to(torch.int64)]
    else:
        attr = torch.zeros((n, AT_K), device=o.device)
    tp0 = attr[:, AT_P0:AT_P0 + 3]
    tp1 = attr[:, AT_P1:AT_P1 + 3]
    tp2 = attr[:, AT_P2:AT_P2 + 3]
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
    rev = (attr[:, AT_REV] > 0.5)[:, None]
    ng = torch.where(rev, -ng, ng)
    ns = torch.where(rev, -ns, ns)

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
        prim=torch.where(hit, attr[:, AT_PRIM].to(torch.int32), neg1),
        material=torch.where(hit, attr[:, AT_MAT].to(torch.int32), neg1),
        area_light=torch.where(hit, attr[:, AT_LIGHT].to(torch.int32), neg1))
