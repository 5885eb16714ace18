"""AreaLightSource "diffuse": one-sided emission L from the front of each
triangle of the shapes it is attached to, sampled uniformly by area."""
from __future__ import annotations

import math

import numpy as np
import torch

from refmath import ONE_MINUS_EPS, cross, dot, luminance, normalize, only_params, rgb


def make(params, tris):
    """params: the directive's; tris [T,3,3]: the world-space triangles."""
    only_params("diffuse area light", params, ("L", "twosided"))
    if "twosided" in params and params["twosided"][1][0]:
        raise ValueError("scene: only one-sided diffuse area lights are read")
    return Diffuse(rgb(params, "L", 1.0), np.asarray(tris, np.float32))


class Diffuse:
    def __init__(self, L, tris):
        self.L, self.tris = L, tris
        t = tris.astype(np.float64)
        self.areas = 0.5 * np.linalg.norm(np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]), axis=-1)
        self.total = float(self.areas.sum())

    def power(self, world_radius):
        return self.total * math.pi * luminance(self.L)

    def setup(self, ref):
        self.tL = ref.tensor(self.L)
        self.t_tris = ref.tensor(self.tris)
        self.t_total = ref.tensor(self.total)
        self.cdf = ref.tensor(np.cumsum(self.areas) / self.total)

    def sample(self, ref, p, u2):
        """A point by area, seen from points p [N,3] -> (wi, Li, pdf by solid
        angle, the point)."""
        cdf = self.cdf
        k = torch.clamp(torch.searchsorted(cdf.float(), u2[:, 0].float().contiguous(), right=True),
                        max=cdf.shape[0] - 1)
        c_lo = torch.where(k > 0, cdf[torch.clamp(k - 1, min=0)], 0.0)
        c_hi = cdf[k]
        u0 = torch.clamp((u2[:, 0] - c_lo) / torch.clamp(c_hi - c_lo, min=1e-9), 0.0,
                         ONE_MINUS_EPS)
        su = torch.sqrt(torch.clamp(u0, min=0.0))
        b0, b1 = 1.0 - su, u2[:, 1] * su
        tri = self.t_tris[k]
        q = (b0[:, None] * tri[:, 0] + b1[:, None] * tri[:, 1] + (1 - b0 - b1)[:, None] * tri[:, 2])
        ng = normalize(cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]))
        to_ref = p - q
        d2 = torch.clamp(dot(to_ref, to_ref), min=1e-12)
        w = -to_ref / torch.sqrt(d2)[:, None]
        cos_l = dot(ng, -w)
        emits = cos_l > 1e-7
        pdf = torch.where(emits, d2 / torch.clamp(torch.abs(cos_l), min=1e-9) / self.total, 0.0)
        return w, torch.where(emits[:, None], self.tL, 0.0), pdf, q

    def hit(self, ref, h):
        """A ray's hit h on one of the light's triangles -> (emits [N], Le,
        pdf of that point by solid angle, before the light's pick)."""
        cos = dot(h["ng"], h["wo"])
        pdf = h["t"] ** 2 / torch.clamp(torch.abs(cos), min=1e-9) / self.t_total
        return cos > 0, self.tL, pdf
