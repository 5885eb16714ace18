"""Surface interaction wavefront record, and the uv screen derivatives
from ray differentials (port of pbrt_tpu/core/interaction.py).

The derivatives feed only the image textures' filter width, so the path
integrator computes them only in scenes with an image texture; elsewhere
they stay None.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.math import normalize, cross, dot
from pbrt_tpu_torch.core.ray import Rays


@dataclasses.dataclass
class SurfaceInteraction:
    valid: torch.Tensor       # [N] bool, hit anything
    t: torch.Tensor           # [N]
    p: torch.Tensor           # [N,3]
    p_err: torch.Tensor       # [N,3]
    wo: torch.Tensor          # [N,3]
    ng: torch.Tensor          # [N,3] geometric normal
    ns: torch.Tensor          # [N,3] shading normal
    ss: torch.Tensor          # [N,3] shading tangent
    ts: torch.Tensor          # [N,3] shading bitangent
    uv: torch.Tensor          # [N,2]
    dpdu: torch.Tensor        # [N,3]
    dpdv: torch.Tensor        # [N,3]
    prim: torch.Tensor        # [N] int32 primitive id, -1 on a miss
    material: torch.Tensor    # [N] int32
    area_light: torch.Tensor  # [N] int32 light id or -1
    # uv screen derivatives ([N] each; None where not tracked)
    dudx: Optional[torch.Tensor] = None
    dvdx: Optional[torch.Tensor] = None
    dudy: Optional[torch.Tensor] = None
    dvdy: Optional[torch.Tensor] = None

    @property
    def duv(self):
        """(dudx, dvdx, dudy, dvdy), or None where not tracked."""
        return None if self.dudx is None else (self.dudx, self.dvdx, self.dudy, self.dvdy)

    def world_to_local(self, v):
        """World direction -> shading frame (z = ns)."""
        return torch.stack([dot(v, self.ss), dot(v, self.ts), dot(v, self.ns)], -1)

    def local_to_world(self, v):
        return v[..., 0:1] * self.ss + v[..., 1:2] * self.ts + v[..., 2:3] * self.ns

    def spawn_origin(self, w):
        """Robust ray origin offset along ng toward direction w."""
        return vm.offset_ray_origin(self.p, self.p_err + 1e-5, self.ng, w)


def _plane_hit(n, d_plane, o, d):
    """Where rays (o, d) meet the planes n.x = d_plane -> (points, ok)."""
    denom = dot(n, d)
    tt = (d_plane - dot(n, o)) / torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    return o + tt[:, None] * d, torch.abs(denom) > 1e-9


def compute_differentials(si: SurfaceInteraction, rays: Rays) -> SurfaceInteraction:
    """Fill dudx/dvdx/dudy/dvdy from the ray differentials: meet the
    auxiliary rays with the tangent plane at p, then solve dp = du dpdu +
    dv dpdv by least squares on the two axes where |n| is smallest. Lanes
    with degenerate geometry (or a miss) get zeros, which the image lookup
    reads as mip level 0."""
    if not rays.has_differentials:
        return si
    n, p = si.ng, si.p
    d_plane = dot(n, p)
    px, okx = _plane_hit(n, d_plane, rays.rx_o, rays.rx_d)
    py, oky = _plane_hit(n, d_plane, rays.ry_o, rays.ry_d)
    dpdx, dpdy = px - p, py - p
    an = torch.abs(n)
    use_yz = (an[:, 0] > an[:, 1]) & (an[:, 0] > an[:, 2])
    use_xz = ~use_yz & (an[:, 1] > an[:, 2])
    d0 = torch.where(use_yz, 1, 0)[:, None]
    d1 = torch.where(use_yz | use_xz, 2, 1)[:, None]

    def pick2(v):
        return torch.cat([torch.gather(v, 1, d0), torch.gather(v, 1, d1)], -1)

    a0, a1 = pick2(si.dpdu), pick2(si.dpdv)
    det = a0[:, 0] * a1[:, 1] - a1[:, 0] * a0[:, 1]
    ok = (torch.abs(det) > 1e-12) & okx & oky & si.valid
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1.0, det)

    def solve(b2):
        return ((b2[:, 0] * a1[:, 1] - b2[:, 1] * a1[:, 0]) * inv_det,
                (b2[:, 1] * a0[:, 0] - b2[:, 0] * a0[:, 1]) * inv_det)

    def clampf(v):
        return torch.where(ok, torch.clamp(torch.nan_to_num(v), -1e8, 1e8), 0.0)

    dudx, dvdx = solve(pick2(dpdx))
    dudy, dvdy = solve(pick2(dpdy))
    return dataclasses.replace(si, dudx=clampf(dudx), dvdx=clampf(dvdx),
                               dudy=clampf(dudy), dvdy=clampf(dvdy))


def specular_diff_rays(si: SurfaceInteraction, rays: Rays, wi, is_specular,
                       is_transmission, eta) -> Rays:
    """The differentials of the rays scattered by a specular bounce (pbrt's
    specular_reflect / specular_transmit with flat normals: dndx = dndy =
    0). Lanes that did not scatter specularly get zero auxiliary
    directions, which compute_differentials reads as degenerate."""
    if not rays.has_differentials:
        return rays
    n, p, wo = si.ns, si.p, si.wo
    d_plane = dot(si.ng, p)
    px = _plane_hit(si.ng, d_plane, rays.rx_o, rays.rx_d)[0]
    py = _plane_hit(si.ng, d_plane, rays.ry_o, rays.ry_d)[0]

    dwodx = -rays.rx_d - wo
    dwody = -rays.ry_d - wo
    ddndx = dot(dwodx, n)
    ddndy = dot(dwody, n)
    rx_refl = wi - dwodx + 2.0 * ddndx[:, None] * n
    ry_refl = wi - dwody + 2.0 * ddndy[:, None] * n

    ent = dot(wo, n) >= 0.0
    nf = torch.where(ent[:, None], n, -n)
    etaf = torch.where(ent, 1.0 / torch.clamp(eta, min=1e-6), eta)
    w_neg = -wo
    win = torch.where(torch.abs(dot(wi, nf)) < 1e-6, 1e-6, dot(wi, nf))
    dmudx = (etaf - (etaf * etaf * dot(w_neg, nf)) / win) * ddndx
    dmudy = (etaf - (etaf * etaf * dot(w_neg, nf)) / win) * ddndy
    rx_tran = wi + etaf[:, None] * dwodx - dmudx[:, None] * nf
    ry_tran = wi + etaf[:, None] * dwody - dmudy[:, None] * nf

    tm = is_transmission[:, None]
    keep = (is_specular & si.valid)[:, None]
    zero = torch.zeros_like(wi)
    return Rays(p, wi, torch.where(keep, px, p),
                torch.where(keep, torch.where(tm, rx_tran, rx_refl), zero),
                torch.where(keep, py, p),
                torch.where(keep, torch.where(tm, ry_tran, ry_refl), zero))


def make_frame(ns, dpdu):
    """Orthonormal shading frame from ns and dpdu."""
    ss = normalize(dpdu - ns * dot(ns, dpdu)[..., None])
    bad = vm.length_squared(ss) < 1e-12
    alt, _ = vm.coordinate_system(ns)
    ss = torch.where(bad[..., None], alt, ss)
    return ss, cross(ns, ss)
