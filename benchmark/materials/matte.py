"""Material "matte": Lambertian reflection of Kd (pbrt-v3's default
material, Kd 0.5); sigma other than 0 is not read."""
from __future__ import annotations

import math

import torch

from refmath import concentric, only_params, rgb

SPECULAR = False


def parse(params):
    only_params("matte", params, ("Kd", "sigma"))
    if "sigma" in params and params["sigma"][1][0] != 0.0:
        raise ValueError("scene: only Lambertian matte is read")
    return {"Kd": rgb(params, "Kd", 0.5)}


def f_pdf(m, wo, wi):
    """f [N,3] and pdf [N] of local directions wo, wi."""
    same = (wo[:, 2] * wi[:, 2]) > 0
    return (torch.where(same[:, None], m["Kd"] / math.pi, 0.0),
            torch.where(same, torch.abs(wi[:, 2]) / math.pi, 0.0))


def sample(m, wo, u_lobe, u_dir):
    """A cosine-weighted direction on wo's side -> (wi, f, pdf, eta factor)."""
    cd = concentric(u_dir)
    cz = torch.sqrt(torch.clamp(1.0 - cd[:, 0] ** 2 - cd[:, 1] ** 2, min=0.0))
    wi = torch.cat([cd, cz[:, None]], -1)
    wi = torch.where((wo[:, 2] < 0)[:, None], -wi, wi)
    f, pdf = f_pdf(m, wo, wi)
    return wi, f, pdf, None
