"""Vector helpers of the plain reference, in plain PyTorch: every float
type the reference renders in (float32, and bfloat16 for its control)."""
from __future__ import annotations

import math

import numpy as np
import torch

GAMMA7 = 7 * 2.0 ** -24 / (1 - 7 * 2.0 ** -24)
ONE_MINUS_EPS = 1.0 - 2.0 ** -24
RGB_TO_Y = np.array([0.212671, 0.715160, 0.072169])


def rgb(params, key, default):
    """An RGB parameter of a directive, or the default grey."""
    if key not in params:
        return np.full(3, float(default))
    return np.asarray(params[key][1], np.float64)


def scalar(params, key, default):
    return float(params[key][1][0]) if key in params else float(default)


def luminance(L):
    return float(np.dot(np.asarray(L).astype(np.float32), RGB_TO_Y))


def only_params(where, params, known):
    """Refuse a directive's parameters that the reference does not read, so
    that a scene it cannot render fails loudly instead of rendering
    something else."""
    extra = sorted(set(params) - set(known))
    if extra:
        raise ValueError(f"scene: {where}: parameters {extra} are not read")


def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(v):
    return v / torch.sqrt(torch.clamp(dot(v, v), min=1e-20))[..., None]


def coordinate_system(v):
    sign = torch.where(v[..., 2] >= 0, 1.0, -1.0).to(v.dtype)
    a = -1.0 / (sign + v[..., 2])
    b = v[..., 0] * v[..., 1] * a
    return torch.stack([1.0 + sign * v[..., 0] ** 2 * a, sign * b, -sign * v[..., 0]], -1)


def next_float(x, up):
    """The next representable value above (up) or below x."""
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16, torch.float64: torch.int64}[x.dtype]
    xi = x.view(bits)
    step = torch.where(x >= 0, 1, -1) if up else torch.where(x > 0, -1, 1)
    out = (xi + step.to(bits)).view(x.dtype)
    tiny = torch.finfo(x.dtype).tiny * (1.0 if up else -1.0)
    return torch.where(torch.isinf(x), x, torch.where(x == 0, tiny, out))


def power_heuristic(f, g):
    d = f * f + g * g
    return torch.where(d > 0, f * f / torch.where(d > 0, d, 1.0), 0.0)


def concentric(u):
    """pbrt-v3's concentric map of [0,1)^2 [N,2] onto the unit disk."""
    ox, oy = 2.0 * u[:, 0] - 1.0, 2.0 * u[:, 1] - 1.0
    zero = (ox == 0) & (oy == 0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(use_x, (math.pi / 4) * (oy / torch.where(ox == 0, 1.0, ox)),
                        math.pi / 2 - (math.pi / 4) * (ox / torch.where(oy == 0, 1.0, oy)))
    return torch.stack([torch.where(zero, 0.0, r * torch.cos(theta)),
                        torch.where(zero, 0.0, r * torch.sin(theta))], -1)
