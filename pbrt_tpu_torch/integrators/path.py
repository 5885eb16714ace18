"""Wavefront unidirectional path tracer with NEE, MIS and Russian roulette
(port of pbrt_tpu/integrators/path.py without its subsurface and spectral
branches).

Every bounce runs intersect -> material -> NEE -> BSDF sample over the
whole [N] wavefront with masked lanes. The camera rays take one traversal
launch; each later bounce takes one merged launch for the next rays and
the shadow rays (scenes with instances add one instance-walk launch to
each; alpha masks add their re-trace launches). Sample dimensions are
static per bounce, so the estimate is a pure function of (pixel, sample
index): the differentiable replay of diff/ backpropagates through it.
In scenes with an image texture, the camera rays carry ray differentials
through specular bounces and every hit gets its uv screen derivatives
for the image filter; elsewhere nothing reads them and none is computed.
"""
from __future__ import annotations

import torch

from pbrt_tpu_torch import lights as LT
from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.interaction import compute_differentials, specular_diff_rays
from pbrt_tpu_torch.core.math import normalize
from pbrt_tpu_torch.core.sampling import power_heuristic
from pbrt_tpu_torch.integrators.common import (bounce_base, camera_rays, infinite_pdf_for_dir,
                                               light_pdf_for_dir, prepare_one_light)
from pbrt_tpu_torch.materials import bsdf as B
from pbrt_tpu_torch.materials import compute_lobes
from pbrt_tpu_torch.samplers import sample_2d, sample_dim
from pbrt_tpu_torch.scene.intersect import intersect, intersect_pair
from pbrt_tpu_torch.textures import T_IMAGEMAP

COUNTERS = ("camera_rays", "shadow_rays", "bounce_rays", "valid_hits",
            "paths_terminated_rr")


def li_path(cs, px, py, sample_idx, max_depth: int = 5, rr_threshold: float = 1.0):
    """Radiance estimate for one sample of each lane. Records an autograd
    tape where gradients are enabled and the scene's tables require them.

    -> (L [N,3], p_film [N,2], ray_weight [N], counters): counters are
    int64 device tensors (see COUNTERS) of live rays and hits."""
    spec, data, flags = cs.sampler, cs.data, cs.flags
    n = px.shape[0]
    dev = px.device
    track_diff = T_IMAGEMAP in flags.tex_kinds
    rays, ray_w, p_film = camera_rays(cs, px, py, sample_idx,
                                      spp_for_diff=spec.rounded_spp() if track_diff else None)
    o, d = rays.o, rays.d
    L = torch.zeros((n, 3), device=dev)
    beta = torch.ones((n, 3), device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    specular_bounce = torch.ones(n, dtype=torch.bool, device=dev)
    prev_bsdf_pdf = torch.zeros(n, device=dev)
    t_max = torch.full((n,), vm.INF, device=dev)
    cnt = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in COUNTERS}
    cnt["camera_rays"] += n

    # ray time places animated instances (the camera's time dimension)
    ray_time = sample_dim(spec, px, py, sample_idx, 4) if flags.n_instances > 0 else None
    si = intersect(data, flags, o, normalize(d), t_max, time=ray_time)
    diff_rays = rays
    for bounce in range(max_depth + 1):
        base = bounce_base(bounce)
        if track_diff:
            si = compute_differentials(si, diff_rays)
        if flags.has_infinite:
            esc = active & ~si.valid
            le_inf = LT.le_escaped(data.lights, flags.infinite_light_ids, normalize(d))
            if bounce == 0:
                w = torch.ones(n, device=dev)
            else:
                w = torch.where(specular_bounce, 1.0, power_heuristic(
                    1.0, prev_bsdf_pdf, 1.0, infinite_pdf_for_dir(cs, n, dev)))
            L = L + torch.where(esc[:, None], beta * le_inf * w[:, None], 0.0)
        if flags.has_area_lights:
            hit_l = active & si.valid & (si.area_light >= 0)
            le = LT.le_area(data.lights, si.area_light, si.ng, si.wo)
            if bounce == 0:
                w = torch.ones(n, device=dev)
            else:
                w = torch.where(specular_bounce, 1.0, power_heuristic(
                    1.0, prev_bsdf_pdf, 1.0, light_pdf_for_dir(cs, si, si.area_light)))
            L = L + torch.where(hit_l[:, None], beta * le * w[:, None], 0.0)

        active = active & si.valid
        cnt["valid_hits"] += active.sum()
        if bounce == max_depth:
            break

        lobes = compute_lobes(data.mats, data.tex, si.material, si.uv, si.p, si.duv,
                              flags.has_tex_slot, flags.tex_kinds)

        # NEE: light sample now, occlusion in the merged launch below
        u_sel = sample_dim(spec, px, py, sample_idx, base + 1)
        u_light = sample_2d(spec, px, py, sample_idx, base + 2)
        cnt["shadow_rays"] += active.sum()
        ld, o_sh, d_sh, dist_sh, nee_live = prepare_one_light(
            cs, si, lobes, active, u_sel, u_light)
        beta_nee = beta

        # BSDF sampling
        u_lobe = sample_dim(spec, px, py, sample_idx, base + 4)
        u_dir = sample_2d(spec, px, py, sample_idx, base + 5)
        bs = B.bsdf_sample(lobes, si.world_to_local(si.wo), u_lobe, u_dir)
        wi_world = si.local_to_world(bs.wi)
        cos_w = vm.absdot(wi_world, si.ns)
        ok = active & (bs.pdf > 0.0) & ~B.black(bs.f)
        cnt["bounce_rays"] += ok.sum()
        beta = torch.where(ok[:, None], beta * bs.f
                           * (cos_w / torch.clamp(bs.pdf, min=1e-12))[:, None], beta)
        active = ok
        specular_bounce = bs.is_specular
        if track_diff:
            # no transmission lobe is ported: every specular scatter reflects
            diff_rays = specular_diff_rays(si, diff_rays, wi_world, bs.is_specular & ok,
                                           torch.zeros_like(ok), lobes.eta)
        prev_bsdf_pdf = bs.pdf
        o = si.spawn_origin(wi_world)
        d = wi_world

        # Russian roulette (no transmission lobe: eta_scale stays 1)
        if bounce > 3:
            rr_beta = vm.max_component(beta)
            u_rr = sample_dim(spec, px, py, sample_idx, base + 7)
            q = torch.clamp(1.0 - rr_beta, min=0.05)
            do_rr = rr_beta < rr_threshold
            survive = ~do_rr | (u_rr >= q)
            beta = torch.where((do_rr & survive)[:, None],
                               beta / torch.clamp(1.0 - q, min=1e-6)[:, None], beta)
            cnt["paths_terminated_rr"] += (active & ~survive).sum()
            active = active & survive

        si, occluded = intersect_pair(data, flags, o, normalize(d), t_max, active,
                                      o_sh, d_sh, dist_sh, nee_live, time=ray_time)
        L = L + torch.where((nee_live & ~occluded)[:, None], beta_nee * ld, 0.0)
    return L, p_film, ray_w, cnt
