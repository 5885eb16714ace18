"""Whitted ray tracing: direct light from every light at each hit, and
only perfectly specular reflection and transmission continue (port of
pbrt_tpu/integrators/whitted.py).

The recursion is the path integrator's bounce loop over the whole [N]
wavefront with masked lanes, with the same sampler dimension layout
(bounce_base) and counters. Each light's shadow rays take one any-hit
launch a bounce. `specular_walk` is the loop shared with the
directlighting integrator (direct.py), which supplies its own light
estimate at each hit.
"""
from __future__ import annotations

import torch

from pbrt_tpu_torch import lights as LT
from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.math import normalize
from pbrt_tpu_torch.core.sampling import power_heuristic
from pbrt_tpu_torch.integrators.common import bounce_base, camera_rays
from pbrt_tpu_torch.integrators.path import COUNTERS
from pbrt_tpu_torch.materials import bsdf as B
from pbrt_tpu_torch.materials import M_MIX, compute_lobes
from pbrt_tpu_torch.samplers import sample_2d, sample_dim
from pbrt_tpu_torch.scene.intersect import intersect, intersect_p


def specular_walk(cs, px, py, sample_idx, max_depth, direct):
    """The bounce loop of whitted and directlighting: emission where a ray
    escapes or hits an area light, direct(L, beta, si, lobes, active, base,
    cnt) -> L with the direct light at each hit added in, then the
    specular continuation. -> (L [N,3], p_film [N,2], ray_weight [N],
    counters)."""
    spec, data, flags = cs.sampler, cs.data, cs.flags
    n = px.shape[0]
    dev = px.device
    ftab = data.fourier if flags.has_fourier else None
    rays, ray_w, p_film = camera_rays(cs, px, py, sample_idx)
    o, d = rays.o, rays.d
    L = torch.zeros((n, 3), device=dev)
    beta = torch.ones((n, 3), device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    cnt = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in COUNTERS}
    cnt["camera_rays"] += n

    for bounce in range(max_depth + 1):
        base = bounce_base(bounce)
        wd = normalize(d)
        si = intersect(data, flags, o, wd, torch.full((n,), vm.INF, device=dev))
        if flags.has_infinite:
            esc = active & ~si.valid
            L = L + torch.where(esc[:, None], beta * LT.le_escaped(
                data.lights, flags.infinite_light_ids, wd), 0.0)
        if flags.has_area_lights:
            hit_l = active & si.valid & (si.area_light >= 0)
            le = LT.le_area(data.lights, si.area_light, si.ng, si.wo)
            L = L + torch.where(hit_l[:, None], beta * le, 0.0)
        active = active & si.valid
        cnt["valid_hits"] += active.sum()
        if bounce == max_depth:
            break

        u_mix = sample_dim(spec, px, py, sample_idx, base + 0) if M_MIX in flags.mat_kinds \
            else None
        lobes = compute_lobes(data.mats, data.tex, si.material, si.uv, si.p, None,
                              flags.has_tex_slot, flags.tex_kinds, u_mix, flags.bsdf_fams,
                              flags.mat_kinds)
        L = direct(L, beta, si, lobes, active, base, cnt)

        # only perfectly specular lanes continue
        u_lobe = sample_dim(spec, px, py, sample_idx, base + 4)
        u_dir = sample_2d(spec, px, py, sample_idx, base + 5)
        bs = B.bsdf_sample(lobes, si.world_to_local(si.wo), u_lobe, u_dir, ftab,
                           flags.bsdf_fams)
        wi_world = si.local_to_world(bs.wi)
        cos_w = vm.absdot(wi_world, si.ns)
        ok = active & bs.is_specular & (bs.pdf > 0.0) & ~B.black(bs.f)
        beta = torch.where(ok[:, None], beta * bs.f
                           * (cos_w / torch.clamp(bs.pdf, min=1e-12))[:, None], beta)
        active = ok
        cnt["bounce_rays"] += ok.sum()
        o = si.spawn_origin(wi_world)
        d = wi_world
    return L, p_film, ray_w, cnt


def direct_all_lights(cs, L, beta, si, lobes, active, u_light, cnt, mis):
    """L [N,3] plus beta times the light from every light at the hits: one
    sample each, its shadow ray traced at once; mis: weight each by the
    power heuristic against the BSDF's pdf (delta lights take 1), as
    directlighting's "all" strategy does; else unweighted, as whitted
    does."""
    data, flags = cs.data, cs.flags
    n = si.p.shape[0]
    ftab = data.fourier if flags.has_fourier else None
    wo_local = si.world_to_local(si.wo)
    for li in range(flags.n_lights):
        idx = torch.full((n,), li, dtype=torch.int64, device=si.p.device)
        ls = LT.sample_li(data.lights, idx, si.p, u_light, data.world_radius)
        wi_local = si.world_to_local(ls.wi)
        f = B.bsdf_f(lobes, wo_local, wi_local, ftab, flags.bsdf_fams) \
            * vm.absdot(ls.wi, si.ns)[:, None]
        ok = active & (ls.pdf > 0.0) & ~B.black(f) & ~B.black(ls.li)
        so = si.spawn_origin(ls.wi)
        to_l = ls.p_light - so
        dist = vm.length(to_l)
        sd = to_l / torch.clamp(dist, min=1e-12)[:, None]
        cnt["shadow_rays"] += ok.sum()
        occ = intersect_p(data, flags, so, sd, dist * (1 - 1e-3))
        if mis:
            pdf_b = B.bsdf_pdf(lobes, wo_local, wi_local, ftab, flags.bsdf_fams)
            w = torch.where(ls.is_delta, 1.0, power_heuristic(1.0, ls.pdf, 1.0, pdf_b))
            contrib = f * ls.li * (w / torch.clamp(ls.pdf, min=1e-12))[:, None]
        else:
            contrib = f * ls.li / torch.clamp(ls.pdf, min=1e-12)[:, None]
        L = L + torch.where((ok & ~occ)[:, None], beta * contrib, 0.0)
    return L


def li_whitted(cs, px, py, sample_idx, max_depth: int = 5, rr_threshold: float = 1.0):
    """Whitted radiance estimate for one sample of each lane -> (L [N,3],
    p_film [N,2], ray_weight [N], counters). rr_threshold is not read
    (no Russian roulette)."""
    def direct(L, beta, si, lobes, active, base, cnt):
        u_light = sample_2d(cs.sampler, px, py, sample_idx, base + 2)
        return direct_all_lights(cs, L, beta, si, lobes, active, u_light, cnt, mis=False)
    return specular_walk(cs, px, py, sample_idx, max_depth, direct)
