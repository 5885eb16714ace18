"""Direct lighting: light at each hit with MIS, and perfectly specular
reflection and transmission continue (port of
pbrt_tpu/integrators/direct.py). In a spectral scene it carries sampled
spectra (specular_walk's spectral mode), which whitted never does.

strategy "all" samples every light at each hit (no selection pmf, the
power heuristic against the BSDF's pdf); "one" picks one light by the
scene's light strategy and traces its shadow ray at once, as the path
integrator's NEE does. The bounce loop is whitted's (whitted.py).
"""
from __future__ import annotations

import torch

from pbrt_tpu_torch.integrators.common import sample_one_light
from pbrt_tpu_torch.integrators.whitted import direct_all_lights, specular_walk
from pbrt_tpu_torch.samplers import sample_2d, sample_dim


def li_direct(cs, px, py, sample_idx, max_depth: int = 5, strategy: str = "all",
              rr_threshold: float = 1.0):
    """Direct-lighting radiance estimate for one sample of each lane ->
    (L [N,3], p_film [N,2], ray_weight [N], counters). Any strategy but
    "one" is "all", as in the reference; rr_threshold is not read."""
    spec = cs.sampler

    def direct(L, beta, si, lobes, active, base, cnt):
        u_light = sample_2d(spec, px, py, sample_idx, base + 2)
        if strategy == "one":
            u_sel = sample_dim(spec, px, py, sample_idx, base + 1)
            cnt["shadow_rays"] += active.sum()
            ld = sample_one_light(cs, si, lobes, active, u_sel, u_light)
            return L + torch.where(active[:, None], beta * ld, 0.0)
        return direct_all_lights(cs, L, beta, si, lobes, active, u_light, cnt, mis=True,
                                 spectral=cs.flags.spectral)
    return specular_walk(cs, px, py, sample_idx, max_depth, direct, spectral=cs.flags.spectral)
