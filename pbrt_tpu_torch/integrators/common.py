"""Shared integrator machinery: camera rays, NEE with MIS, light pdfs (port
of pbrt_tpu/integrators/common.py for power-based light selection).

Static sampler dimension layout (the reference's):
  0,1 film jitter | 2,3 lens | 4 time
  per bounce b (base = 5 + 16*b):
    +0 mix-material select | +1 light select | +2,3 light sample
    +4 bsdf lobe select    | +5,6 bsdf direction | +7 russian roulette
"""
from __future__ import annotations

import torch

from pbrt_tpu_torch import lights as LT
from pbrt_tpu_torch.cameras import generate_rays
from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.sampling import power_heuristic
from pbrt_tpu_torch.materials import bsdf as B
from pbrt_tpu_torch.samplers import sample_2d

CAMERA_DIMS = 5
BOUNCE_DIMS = 16


def bounce_base(bounce: int) -> int:
    return CAMERA_DIMS + BOUNCE_DIMS * bounce


def camera_rays(cs, px, py, sample_idx):
    """Primary rays for pixels (px, py) at sample_idx -> (o, d, weight, p_film)."""
    u_film = sample_2d(cs.sampler, px, py, sample_idx, 0)
    p_film = torch.stack([px.to(torch.float32) + u_film[:, 0],
                          py.to(torch.float32) + u_film[:, 1]], -1)
    o, d, w = generate_rays(cs.camera, p_film)
    return o, d, w, p_film


def prepare_one_light(cs, si, lobes, active, u_sel, u_light):
    """NEE light-sample half without the occlusion trace.

    -> (ld [N,3], shadow origin, shadow direction, shadow t_max [N],
    contributes [N] bool); the caller traces the shadow ray."""
    data = cs.data
    n = si.p.shape[0]
    if cs.flags.n_lights == 0:
        z = torch.zeros(n, device=si.p.device)
        up = torch.tensor([0.0, 0.0, 1.0], device=si.p.device).expand(n, 3)
        return torch.zeros_like(si.p), si.p, up, z, torch.zeros_like(active)
    light_idx, pmf, _ = data.light_distr.sample_discrete(u_sel)
    ls = LT.sample_li(data.lights, light_idx, si.p, u_light, data.world_radius)
    wi_local = si.world_to_local(ls.wi)
    wo_local = si.world_to_local(si.wo)
    f = B.bsdf_f(lobes, wo_local, wi_local) * vm.absdot(ls.wi, si.ns)[:, None]
    contributes = active & (ls.pdf > 0.0) & ~B.black(f) & ~B.black(ls.li) & (pmf > 0.0)

    o = si.spawn_origin(ls.wi)
    to_l = ls.p_light - o
    dist = vm.length(to_l)
    sd = to_l / torch.clamp(dist, min=1e-12)[:, None]

    pdf_b = B.bsdf_pdf(lobes, wo_local, wi_local)
    w_l = power_heuristic(1.0, ls.pdf * pmf, 1.0, pdf_b)
    denom = torch.clamp(ls.pdf * pmf, min=1e-12)
    ld = torch.where(contributes[:, None], f * ls.li * (w_l / denom)[:, None], 0.0)
    return ld, o, sd, dist * (1.0 - 1e-3), contributes


def light_pdf_for_dir(cs, si_next, light_idx):
    """pdf (solid angle x selection pmf) that NEE would have sampled the
    direction that hit area light light_idx at si_next."""
    data = cs.data
    hit_cos = vm.absdot(si_next.ng, si_next.wo)
    pdf = LT.pdf_li(data.lights, light_idx, si_next.t, hit_cos)
    return pdf * data.light_distr.discrete_pdf(torch.clamp(light_idx, min=0).to(torch.int64))


def infinite_pdf_for_dir(cs, n, device):
    """Combined pdf of NEE picking any (constant) infinite light and
    sampling a given direction."""
    data = cs.data
    total = torch.zeros(n, device=device)
    for li in cs.flags.infinite_light_ids:
        idx = torch.full((n,), li, dtype=torch.int64, device=device)
        one = torch.ones(n, device=device)
        total = total + LT.pdf_li(data.lights, idx, one, one) * data.light_distr.discrete_pdf(idx)
    return total
