"""Shared integrator machinery: camera rays, light selection by the
"power", "uniform" or "spatial" strategy, NEE with MIS (delta lights take
weight 1) with or without its shadow ray, light pdfs (port of
pbrt_tpu/integrators/common.py).

Static sampler dimension layout (the reference's):
  0,1 film jitter | 2,3 lens | 4 time
  per bounce b (base = 5 + 16*b):
    +0 mix-material select | +1 light select | +2,3 light sample
    +4 bsdf lobe select    | +5,6 bsdf direction | +7 russian roulette
"""
from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch import lights as LT
from pbrt_tpu_torch.cameras import generate_rays
from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.sampling import power_heuristic
from pbrt_tpu_torch.lights.distrib import spatial_pdf, spatial_sample_discrete
from pbrt_tpu_torch.materials import bsdf as B
from pbrt_tpu_torch.samplers import sample_2d
from pbrt_tpu_torch.scene.intersect import intersect_p

CAMERA_DIMS = 5
BOUNCE_DIMS = 16


def bounce_base(bounce: int) -> int:
    return CAMERA_DIMS + BOUNCE_DIMS * bounce


def camera_rays(cs, px, py, sample_idx, spp_for_diff=None):
    """Primary rays for pixels (px, py) at sample_idx, through the lens
    where the camera has one -> (Rays, weight, p_film). spp_for_diff:
    None, no ray differentials; else the sample count they are scaled for
    (by 1/sqrt(spp) where it is over 1)."""
    u_film = sample_2d(cs.sampler, px, py, sample_idx, 0)
    p_film = torch.stack([px.to(torch.float32) + u_film[:, 0],
                          py.to(torch.float32) + u_film[:, 1]], -1)
    # the lens pair (dims 2, 3) only where the camera has a lens
    u_lens = sample_2d(cs.sampler, px, py, sample_idx, 2) if cs.camera.lens_radius > 0.0 \
        else None
    rays, w = generate_rays(cs.camera, p_film, spp_for_diff is not None, u_lens)
    if spp_for_diff is not None and spp_for_diff > 1:
        # the reference's float32 1/sqrt(spp)
        rays = rays.scaled_differentials(float(np.float32(1.0) / np.sqrt(np.float32(spp_for_diff))))
    return rays, w, p_film


def select_light(cs, p, u_sel):
    """Pick a light per lane at points p [N,3] -> (light_idx, pmf, u_remap)."""
    flags, data = cs.flags, cs.data
    if flags.light_strategy == "spatial" and data.light_spatial is not None:
        return spatial_sample_discrete(data.light_spatial, p, u_sel)
    if flags.light_strategy == "uniform":
        nl = flags.n_lights
        idx = torch.clamp((u_sel * nl).to(torch.int64), max=nl - 1)
        pmf = torch.full(u_sel.shape, 1.0 / nl, device=u_sel.device)
        return idx, pmf, torch.clamp(u_sel * nl - idx.to(torch.float32), max=0.99999994)
    return data.light_distr.sample_discrete(u_sel)


def select_light_pdf(cs, p, light_idx):
    """pmf that select_light at p picks light_idx (>= 0)."""
    flags, data = cs.flags, cs.data
    if flags.light_strategy == "spatial" and data.light_spatial is not None:
        return spatial_pdf(data.light_spatial, p, light_idx)
    if flags.light_strategy == "uniform":
        return torch.full(light_idx.shape, 1.0 / flags.n_lights, device=light_idx.device)
    return data.light_distr.discrete_pdf(light_idx)


def prepare_one_light(cs, si, lobes, active, u_sel, u_light):
    """NEE light-sample half without the occlusion trace.

    -> (ld [N,3], shadow origin, shadow direction, shadow t_max [N],
    contributes [N] bool); the caller traces the shadow ray."""
    data, flags = cs.data, cs.flags
    n = si.p.shape[0]
    if flags.n_lights == 0:
        z = torch.zeros(n, device=si.p.device)
        up = torch.tensor([0.0, 0.0, 1.0], device=si.p.device).expand(n, 3)
        return torch.zeros_like(si.p), si.p, up, z, torch.zeros_like(active)
    ftab = data.fourier if flags.has_fourier else None
    light_idx, pmf, _ = select_light(cs, si.p, u_sel)
    ls = LT.sample_li(data.lights, light_idx, si.p, u_light, data.world_radius)
    wi_local = si.world_to_local(ls.wi)
    wo_local = si.world_to_local(si.wo)
    f = B.bsdf_f(lobes, wo_local, wi_local, ftab, flags.bsdf_fams) \
        * vm.absdot(ls.wi, si.ns)[:, None]
    contributes = active & (ls.pdf > 0.0) & ~B.black(f) & ~B.black(ls.li) & (pmf > 0.0)

    o = si.spawn_origin(ls.wi)
    to_l = ls.p_light - o
    dist = vm.length(to_l)
    sd = to_l / torch.clamp(dist, min=1e-12)[:, None]

    pdf_b = B.bsdf_pdf(lobes, wo_local, wi_local, ftab, flags.bsdf_fams)
    w_l = torch.where(ls.is_delta, 1.0, power_heuristic(1.0, ls.pdf * pmf, 1.0, pdf_b))
    denom = torch.clamp(ls.pdf * pmf, min=1e-12)
    ld = torch.where(contributes[:, None], f * ls.li * (w_l / denom)[:, None], 0.0)
    return ld, o, sd, dist * (1.0 - 1e-3), contributes


def sample_one_light(cs, si, lobes, active, u_sel, u_light):
    """NEE with its shadow ray traced at once (one any-hit launch) ->
    ld [N,3], not yet weighted by the path throughput."""
    if cs.flags.n_lights == 0:
        return torch.zeros_like(si.p)
    ld, o, sd, dist, contributes = prepare_one_light(cs, si, lobes, active, u_sel, u_light)
    occluded = intersect_p(cs.data, cs.flags, o, sd, dist)
    return torch.where((contributes & ~occluded)[:, None], ld, 0.0)


def light_pdf_for_dir(cs, prev_p, wi, si_next, light_idx):
    """pdf (solid angle x selection pmf) that NEE at prev_p would have
    sampled the direction wi that hit area light light_idx at si_next."""
    data = cs.data
    hit_cos = vm.absdot(si_next.ng, si_next.wo)
    pdf = LT.pdf_li(data.lights, light_idx, si_next.t, hit_cos, wi)
    return pdf * select_light_pdf(cs, prev_p, torch.clamp(light_idx, min=0).to(torch.int64))


def infinite_pdf_for_dir(cs, wi, prev_p):
    """Combined pdf of NEE at prev_p picking any infinite light and
    sampling direction wi [N,3]."""
    data = cs.data
    n = wi.shape[0]
    total = torch.zeros(n, device=wi.device)
    for li in cs.flags.infinite_light_ids:
        idx = torch.full((n,), li, dtype=torch.int64, device=wi.device)
        one = torch.ones(n, device=wi.device)
        total = total + LT.pdf_li(data.lights, idx, one, one, wi) \
            * select_light_pdf(cs, prev_p, idx)
    return total
