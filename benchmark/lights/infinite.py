"""LightSource "infinite" of constant radiance L (no map): sampled
uniformly over the sphere, as the port samples a constant environment."""
from __future__ import annotations

import math

import torch

from refmath import luminance, only_params, rgb


def make(params, ctm):
    only_params("infinite light", params, ("L",))
    return Infinite(rgb(params, "L", 1.0))


class Infinite:
    def __init__(self, L):
        self.L = L

    def power(self, world_radius):
        return math.pi * world_radius * world_radius * luminance(self.L)

    def setup(self, ref):
        self.tL = ref.tensor(self.L)

    def sample(self, ref, p, u2):
        """Light samples at points p [N,3] -> (wi, Li, pdf, a target point
        beyond the scene)."""
        z = 1.0 - 2.0 * u2[:, 0]
        r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = 2.0 * math.pi * u2[:, 1]
        wi = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
        pdf = torch.full((p.shape[0],), 1.0 / (4.0 * math.pi), dtype=ref.dtype, device=ref.device)
        return wi, self.tL.expand(p.shape[0], 3), pdf, p + wi * (2.0 * ref.world_radius)

    def escape(self, ref, d, pmf):
        """Radiance along rays d that leave the scene, and the pdf of
        sampling their direction (pmf: the light's pick probability)."""
        return self.tL, pmf / (4.0 * math.pi)
