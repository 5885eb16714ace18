"""Sampler "sobol": pbrt-v3's global Sobol' sampler (refsampler.py)."""
from __future__ import annotations

from refmath import only_params
from refsampler import Sobol


def make(params, resolution, seed):
    only_params("sobol sampler", params, ("pixelsamples",))
    spp = int(params["pixelsamples"][1][0]) if "pixelsamples" in params else 16
    return Sobol(spp, resolution)
