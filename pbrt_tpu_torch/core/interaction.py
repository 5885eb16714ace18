"""Surface interaction wavefront record (port of pbrt_tpu/core/interaction.py).

Ray differentials and the uv screen derivatives wait for textures: without
texture slots they do not change the radiance.
"""
from __future__ import annotations

import dataclasses

import torch

from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.math import normalize, cross, dot


@dataclasses.dataclass
class SurfaceInteraction:
    valid: torch.Tensor       # [N] bool, hit anything
    t: torch.Tensor           # [N]
    p: torch.Tensor           # [N,3]
    p_err: torch.Tensor       # [N,3]
    wo: torch.Tensor          # [N,3]
    ng: torch.Tensor          # [N,3] geometric normal
    ns: torch.Tensor          # [N,3] shading normal
    ss: torch.Tensor          # [N,3] shading tangent
    ts: torch.Tensor          # [N,3] shading bitangent
    uv: torch.Tensor          # [N,2]
    dpdu: torch.Tensor        # [N,3]
    dpdv: torch.Tensor        # [N,3]
    prim: torch.Tensor        # [N] int32 primitive id, -1 on a miss
    material: torch.Tensor    # [N] int32
    area_light: torch.Tensor  # [N] int32 light id or -1

    def world_to_local(self, v):
        """World direction -> shading frame (z = ns)."""
        return torch.stack([dot(v, self.ss), dot(v, self.ts), dot(v, self.ns)], -1)

    def local_to_world(self, v):
        return v[..., 0:1] * self.ss + v[..., 1:2] * self.ts + v[..., 2:3] * self.ns

    def spawn_origin(self, w):
        """Robust ray origin offset along ng toward direction w."""
        return vm.offset_ray_origin(self.p, self.p_err + 1e-5, self.ng, w)


def make_frame(ns, dpdu):
    """Orthonormal shading frame from ns and dpdu."""
    ss = normalize(dpdu - ns * dot(ns, dpdu)[..., None])
    bad = vm.length_squared(ss) < 1e-12
    alt, _ = vm.coordinate_system(ns)
    ss = torch.where(bad[..., None], alt, ss)
    return ss, cross(ns, ss)
