"""Material "mirror": perfect specular reflection of Kr (default 0.9)."""
from __future__ import annotations

import torch

from refmath import only_params, rgb

SPECULAR = True


def parse(params):
    only_params("mirror", params, ("Kr",))
    return {"Kr": rgb(params, "Kr", 0.9)}


def sample(m, wo, u_lobe, u_dir):
    """wo mirrored about the normal -> (wi, f, pdf, eta factor)."""
    wi = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], -1)
    aci = torch.clamp(torch.abs(wi[:, 2]), min=1e-9)[:, None]
    return wi, m["Kr"] / aci, torch.ones_like(wo[:, 0]), None
