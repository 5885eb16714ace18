"""A wavefront of rays with optional ray differentials (port of
pbrt_tpu/core/ray.py): the auxiliary rays one pixel step over in x and in
y, which the texture stage turns into uv screen derivatives."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Rays:
    o: torch.Tensor                      # [N,3] origins
    d: torch.Tensor                      # [N,3] directions (not necessarily unit)
    rx_o: Optional[torch.Tensor] = None  # [N,3] the x-offset ray; None: not tracked
    rx_d: Optional[torch.Tensor] = None
    ry_o: Optional[torch.Tensor] = None  # [N,3] the y-offset ray
    ry_d: Optional[torch.Tensor] = None

    @property
    def has_differentials(self) -> bool:
        return self.rx_o is not None

    def scaled_differentials(self, s: float) -> "Rays":
        """Pull the auxiliary rays toward the main one by s (pbrt's
        scale_differentials, 1/sqrt(spp) for the camera rays)."""
        if self.rx_o is None:
            return self
        o, d = self.o, self.d
        return Rays(o, d, o + (self.rx_o - o) * s, d + (self.rx_d - d) * s,
                    o + (self.ry_o - o) * s, d + (self.ry_d - d) * s)
