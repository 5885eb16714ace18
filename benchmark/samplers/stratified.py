"""Sampler "stratified": jittered xsamples x ysamples strata (refsampler.py)."""
from __future__ import annotations

from refmath import only_params
from refsampler import Stratified


def make(params, resolution, seed):
    only_params("stratified sampler", params, ("xsamples", "ysamples", "jitter", "dimensions"))
    g = lambda k, d: params[k][1][0] if k in params else d
    return Stratified(int(g("xsamples", 4)), int(g("ysamples", 4)), bool(g("jitter", True)), seed)
