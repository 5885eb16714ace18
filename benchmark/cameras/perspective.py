"""Camera "perspective": pbrt-v3's perspective camera, fov on the shorter
image axis, with its thin lens (lensradius, focaldistance) sampled by the
concentric map of sample dimensions 2 - 3."""
from __future__ import annotations

import math

import torch

from refmath import concentric, normalize, only_params, scalar


def make(params, cam_to_world, resolution, dtype, device):
    only_params("perspective camera", params, ("fov", "lensradius", "focaldistance"))
    return Perspective(params, cam_to_world, resolution, dtype, device)


class Perspective:
    def __init__(self, params, c2w, res, dtype, device):
        self.c2w = torch.as_tensor(c2w, dtype=dtype, device=device)
        self.res, self.dtype, self.device = res, dtype, device
        self.fov = scalar(params, "fov", 90.0)
        self.lens_radius = scalar(params, "lensradius", 0.0)
        self.focal = scalar(params, "focaldistance", 1e6)

    def rays(self, pf, st):
        """Film positions pf [N,2] (pixels) and the lanes' sample stream ->
        world-space (origin, direction) [N,3] each."""
        dt, dev = self.dtype, self.device
        p = torch.as_tensor(pf, dtype=dt, device=dev)
        tan_h = math.tan(math.radians(self.fov) / 2)
        aspect = self.res[0] / self.res[1]
        x0, x1, y0, y1 = ((-aspect, aspect, -1.0, 1.0) if aspect > 1
                          else (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect))
        sx = x0 + (x1 - x0) * p[:, 0] / self.res[0]
        sy = y1 - (y1 - y0) * p[:, 1] / self.res[1]
        d = normalize(torch.stack([sx * tan_h, sy * tan_h, torch.ones_like(sx)], -1))
        o = torch.zeros_like(d)
        if self.lens_radius > 0:
            pl = self.lens_radius * concentric(torch.as_tensor(st.d2(2), dtype=dt, device=dev))
            ft = self.focal / d[:, 2]
            focus = d * ft[:, None]
            o = torch.cat([pl, torch.zeros_like(pl[:, :1])], -1)
            d = normalize(focus - o)
        m = self.c2w
        return o @ m[:3, :3].T + m[:3, 3], d @ m[:3, :3].T
