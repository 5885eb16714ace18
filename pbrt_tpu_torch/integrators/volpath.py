"""Volumetric path tracer: the path integrator with participating media
(port of pbrt_tpu/integrators/volpath.py).

A per-lane medium id rides the bounce loop, starting at the camera's
medium. Each bounce first samples a medium interaction on its segment
(closed-form homogeneous, delta-tracked grid: media/); lanes that scatter
in the medium take a Henyey-Greenstein direction, the others run the
surface pipeline (material, NEE, BSDF sample). A null ("none") material
is a medium interface: the lane crosses it, swaps its medium and keeps
its direction, which spends one bounce slot, as in the reference. NEE's
shadow rays take intersect_tr: up to TR_SEGMENTS closest-hit rounds, each
crossing a null interface and multiplying the segment's transmittance.

The medium decisions draw from the counter-hash stream keyed by pixel,
sample and bounce (hash4), not from sampler dimensions, so the bounce
dimension layout is the path integrator's. As in the reference, the
integrator evaluates no ray differentials and places animated instances
at time 0. Scenes without media skip the medium stages and trace their
shadow rays with one any-hit launch.
"""
from __future__ import annotations

import torch

from pbrt_tpu_torch import lights as LT
from pbrt_tpu_torch import media as MD
from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.math import dot, normalize
from pbrt_tpu_torch.core.sampling import power_heuristic
from pbrt_tpu_torch.integrators.common import (bounce_base, camera_rays, infinite_pdf_for_dir,
                                               light_pdf_for_dir, select_light)
from pbrt_tpu_torch.integrators.path import COUNTERS
from pbrt_tpu_torch.materials import bsdf as B
from pbrt_tpu_torch.materials import M_MIX, M_NONE, compute_lobes
from pbrt_tpu_torch.samplers import sample_2d, sample_dim
from pbrt_tpu_torch.samplers.hashing import hash3, hash_combine, u32, u32_to_float
from pbrt_tpu_torch.scene.intersect import intersect, intersect_p

TR_SEGMENTS = 4   # shadow-ray medium-boundary crossings (the reference's budget)


def _null_hit(data, si):
    """Hits on a null-material (medium interface) surface."""
    return (si.material < 0) | (data.mats.kind[torch.clamp(si.material, min=0).to(torch.int64)]
                                == M_NONE)


def intersect_tr(data, flags, cur_medium, o, d, dist, keys, pix_s):
    """Shadow-ray transmittance walk toward a light at distance dist: up to
    TR_SEGMENTS rounds of closest hit; a surface with a real material
    occludes, a null-material interface is crossed (the lane's medium
    swaps and the walk restarts from the boundary) while each segment's
    transmittance multiplies in. A lane still crossing after the budget
    is occluded (no light leaks). keys: the first hash key of the rounds'
    transmittance streams; pix_s: hash3 of (pixel x, y, sample).
    -> (tr [N,3], occluded [N])."""
    n = o.shape[0]
    tr = torch.ones((n, 3), device=o.device)
    occluded = torch.zeros(n, dtype=torch.bool, device=o.device)
    walking = torch.ones(n, dtype=torch.bool, device=o.device)
    remaining, medium = dist, cur_medium
    for k in range(TR_SEGMENTS):
        si = intersect(data, flags, o, d, remaining * (1.0 - 1e-3))
        hit = walking & si.valid
        is_null = _null_hit(data, si)
        occluded = occluded | (hit & ~is_null)
        seg = torch.where(hit, si.t, remaining)
        if flags.n_media > 0:
            t_seg = MD.transmittance(data.media, medium, o, d, seg,
                                     hash_combine(pix_s, keys + 2 * k),
                                     hash_combine(pix_s, keys + 2 * k + 1),
                                     flags.any_grid_media)
            tr = torch.where(walking[:, None], tr * t_seg, tr)
        passing = hit & is_null & ~occluded
        pm = data.prim_medium[torch.clamp(si.prim, min=0).to(torch.int64)]
        medium = torch.where(passing, torch.where(dot(d, si.ng) < 0.0, pm[:, 0], pm[:, 1]),
                             medium)
        o = torch.where(passing[:, None], si.spawn_origin(d), o)
        remaining = torch.where(passing, torch.clamp(remaining - si.t, min=0.0), remaining)
        walking = passing
    return tr, occluded | walking


def li_volpath(cs, px, py, sample_idx, max_depth: int = 5, rr_threshold: float = 1.0):
    """Radiance estimate for one sample of each lane with participating
    media -> (L [N,3], p_film [N,2], ray_weight [N], counters), the
    counters those of li_path."""
    spec, data, flags = cs.sampler, cs.data, cs.flags
    n = px.shape[0]
    dev = px.device
    media = flags.n_media > 0
    ftab = data.fourier if flags.has_fourier else None
    fams = flags.bsdf_fams
    pix_s = hash3(u32(px), u32(py), u32(sample_idx))

    rays, ray_w, p_film = camera_rays(cs, px, py, sample_idx)
    o, d = rays.o, rays.d
    L = torch.zeros((n, 3), device=dev)
    beta = torch.ones((n, 3), device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    specular_bounce = torch.ones(n, dtype=torch.bool, device=dev)
    prev_bsdf_pdf = torch.zeros(n, device=dev)
    prev_p = o
    eta_scale = torch.ones(n, device=dev)
    cur_medium = torch.full((n,), data.camera_medium, dtype=torch.int32, device=dev)
    cnt = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in COUNTERS}
    cnt["camera_rays"] += n

    for bounce in range(max_depth + 1):
        base = bounce_base(bounce)
        dn = normalize(d)
        si = intersect(data, flags, o, dn, torch.full((n,), vm.INF, device=dev))

        # the medium interaction on this segment
        if media:
            u_med = torch.stack([u32_to_float(hash_combine(pix_s, 0xD1 + bounce)),
                                 u32_to_float(hash_combine(pix_s, 0xE2 + bounce))], -1)
            ms = MD.sample_medium(data.media, cur_medium, o, dn, si.t,
                                  hash_combine(pix_s, 0xB0 + bounce),
                                  hash_combine(pix_s, 0xC0 + bounce * 7), u_med,
                                  flags.any_grid_media)
            in_medium = active & ms.sampled_medium
            beta = torch.where(active[:, None], beta * ms.weight, beta)
        else:
            in_medium = torch.zeros(n, dtype=torch.bool, device=dev)

        # emission on the lanes that reach a surface or escape
        surf_lane = active & ~in_medium
        if flags.has_infinite:
            esc = surf_lane & ~si.valid
            le_inf = LT.le_escaped(data.lights, flags.infinite_light_ids, dn)
            if bounce == 0:
                w = torch.ones(n, device=dev)
            else:
                w = torch.where(specular_bounce, 1.0, power_heuristic(
                    1.0, prev_bsdf_pdf, 1.0, infinite_pdf_for_dir(cs, dn, prev_p)))
            L = L + torch.where(esc[:, None], beta * le_inf * w[:, None], 0.0)
        if flags.has_area_lights:
            hit_l = surf_lane & si.valid & (si.area_light >= 0)
            le = LT.le_area(data.lights, si.area_light, si.ng, si.wo)
            if bounce == 0:
                w = torch.ones(n, device=dev)
            else:
                w = torch.where(specular_bounce, 1.0, power_heuristic(
                    1.0, prev_bsdf_pdf, 1.0,
                    light_pdf_for_dir(cs, prev_p, dn, si, si.area_light)))
            L = L + torch.where(hit_l[:, None], beta * le * w[:, None], 0.0)

        active = in_medium | (surf_lane & si.valid)
        cnt["valid_hits"] += active.sum()
        if bounce == max_depth:
            break

        # a null material is crossed: the lane swaps its medium
        is_null = surf_lane & si.valid & _null_hit(data, si)
        pm = data.prim_medium[torch.clamp(si.prim, min=0).to(torch.int64)]
        cur_medium = torch.where(is_null, torch.where(dot(dn, si.ng) < 0.0, pm[:, 0], pm[:, 1]),
                                 cur_medium)
        ref_p = torch.where(in_medium[:, None], ms.p, si.p) if media else si.p
        g = data.media.params[torch.clamp(cur_medium, min=0).to(torch.int64), 0] if media \
            else torch.zeros(n, device=dev)
        u_mix = sample_dim(spec, px, py, sample_idx, base + 0) if M_MIX in flags.mat_kinds \
            else None
        lobes = compute_lobes(data.mats, data.tex, si.material, si.uv, si.p, None,
                              flags.has_tex_slot, flags.tex_kinds, u_mix, fams, flags.mat_kinds)
        wo_local = si.world_to_local(si.wo)

        # NEE: the phase function in the medium, the BSDF on surfaces
        u_sel = sample_dim(spec, px, py, sample_idx, base + 1)
        u_light = sample_2d(spec, px, py, sample_idx, base + 2)
        if flags.n_lights > 0:
            light_idx, pmf, _ = select_light(cs, ref_p, u_sel)
            ls = LT.sample_li(data.lights, light_idx, ref_p, u_light, data.world_radius)
            p_phase = MD.hg_p(dot(-dn, ls.wi), g)
            wi_local = si.world_to_local(ls.wi)
            f_surf = B.bsdf_f(lobes, wo_local, wi_local, ftab, fams) \
                * vm.absdot(ls.wi, si.ns)[:, None]
            pdf_b_surf = B.bsdf_pdf(lobes, wo_local, wi_local, ftab, fams)
            f = torch.where(in_medium[:, None], p_phase[:, None], f_surf)
            pdf_b = torch.where(in_medium, p_phase, pdf_b_surf)
            cnt["shadow_rays"] += (active & ~is_null).sum()
            nee_ok = active & (ls.pdf > 0) & ~B.black(f) & ~B.black(ls.li) & (pmf > 0) \
                & ~is_null
            so = torch.where(in_medium[:, None], ref_p, si.spawn_origin(ls.wi))
            to_l = ls.p_light - so
            dist = vm.length(to_l)
            sd = to_l / torch.clamp(dist, min=1e-12)[:, None]
            if media:
                tr, occ = intersect_tr(data, flags, cur_medium, so, sd, dist,
                                       0xA100 + bounce * 16, pix_s)
            else:
                occ = intersect_p(data, flags, so, sd, dist * (1 - 1e-3))
                tr = 1.0
            w_l = torch.where(ls.is_delta, 1.0, power_heuristic(1.0, ls.pdf * pmf, 1.0, pdf_b))
            ld = f * ls.li * tr * (w_l / torch.clamp(ls.pdf * pmf, min=1e-12))[:, None]
            L = L + torch.where((nee_ok & ~occ)[:, None], beta * ld, 0.0)

        # the next direction: HG in the medium, the BSDF on surfaces
        u_lobe = sample_dim(spec, px, py, sample_idx, base + 4)
        u_dir = sample_2d(spec, px, py, sample_idx, base + 5)
        wi_med, p_med = MD.hg_sample(-dn, g, u_dir)
        bs = B.bsdf_sample(lobes, wo_local, u_lobe, u_dir, ftab, fams)
        wi_surf = si.local_to_world(bs.wi)
        ok_surf = (bs.pdf > 0) & ~B.black(bs.f)
        beta_surf = bs.f * (vm.absdot(wi_surf, si.ns) / torch.clamp(bs.pdf, min=1e-12))[:, None]
        pass_lane = in_medium | is_null
        wi = torch.where(in_medium[:, None], wi_med, torch.where(is_null[:, None], dn, wi_surf))
        # medium scatter: f / pdf = 1 (the phase function is its pdf); null: beta stays
        ok = pass_lane | ok_surf
        beta = torch.where((active & ok)[:, None],
                           beta * torch.where(pass_lane[:, None], 1.0, beta_surf), beta)
        active = active & ok
        cnt["bounce_rays"] += active.sum()
        specular_bounce = torch.where(pass_lane, is_null & specular_bounce, bs.is_specular)
        prev_bsdf_pdf = torch.where(in_medium, p_med,
                                    torch.where(is_null, prev_bsdf_pdf, bs.pdf))
        if bs.eta_scale is not None:
            eta_scale = eta_scale * torch.where(pass_lane, 1.0, bs.eta_scale)
        # a real transmission through a medium interface changes the medium too
        trans = is_null | (bs.is_transmission if bs.is_transmission is not None
                           else torch.zeros_like(is_null))
        crossed = ~in_medium & si.valid & trans
        cur_medium = torch.where(crossed & active,
                                 torch.where(dot(wi, si.ng) < 0.0, pm[:, 0], pm[:, 1]),
                                 cur_medium)
        p_scatter = ms.p if media else si.p
        prev_p = torch.where(in_medium[:, None], p_scatter, si.p)
        o = torch.where(in_medium[:, None], p_scatter, si.spawn_origin(wi))
        d = wi

        # Russian roulette
        if bounce > 3:
            rr_beta = vm.max_component(beta * eta_scale[:, None])
            u_rr = sample_dim(spec, px, py, sample_idx, base + 7)
            q = torch.clamp(1.0 - rr_beta, min=0.05)
            do_rr = rr_beta < rr_threshold
            survive = ~do_rr | (u_rr >= q)
            beta = torch.where((do_rr & survive)[:, None],
                               beta / torch.clamp(1.0 - q, min=1e-6)[:, None], beta)
            cnt["paths_terminated_rr"] += (active & ~survive).sum()
            active = active & survive
    return L, p_film, ray_w, cnt
