"""Material "plastic": pbrt-v3's Lambertian Kd under a glossy dielectric
coat Ks, Torrance-Sparrow reflection of a Trowbridge-Reitz distribution
with the Fresnel term of eta 1.5 (refmicrofacet.py, which notes where
that term departs from pbrt-v3's). Parameters and defaults are pbrt-v3's:
Kd 0.25, Ks 0.25, roughness 0.1, remaproughness true; textures and a
bumpmap are not read.

f is the sum of both lobes. As in the port, sampling picks a lobe
uniformly over the present ones (a colour that is not black): the diffuse
lobe where u_lobe is under its weight, a cosine-weighted direction on wo's
side, else the glossy lobe; the pdf is the mixture's at the direction
drawn, whichever lobe drew it."""
from __future__ import annotations

import math

import torch

import refmicrofacet as mf
from refmath import concentric, only_params, rgb

SPECULAR = False
ETA = 1.5
INV_PI = 1.0 / math.pi


def parse(params):
    only_params("plastic", params, ("Kd", "Ks", "roughness", "remaproughness"))
    au, av = mf.alphas(params, 0.1)
    return {"Kd": rgb(params, "Kd", 0.25), "Ks": rgb(params, "Ks", 0.25), "au": au, "av": av}


def _weights(m):
    """The lobe weights (diffuse, glossy) [N]: each present lobe's share."""
    wd = (m["Kd"] > 0).any(-1).to(m["Kd"].dtype)
    wg = (m["Ks"] > 0).any(-1).to(m["Kd"].dtype)
    total = torch.clamp(wd + wg, min=1e-9)
    return wd / total, wg / total


def f_pdf(m, wo, wi):
    """f [N,3] and pdf [N] of local directions wo, wi."""
    same = mf.same_hemisphere(wo, wi)
    ks = m["Ks"]
    f = torch.where(same[:, None], m["Kd"] * INV_PI, 0.0) + torch.where(
        (ks > 0).any(-1)[:, None],
        mf.glossy_f(wo, wi, m["au"], m["av"],
                    lambda c: ks * mf.fresnel_dielectric(c, torch.full_like(c, ETA))[:, None]),
        0.0)
    wd, wg = _weights(m)
    pdf = wd * torch.where(same, torch.abs(wi[:, 2]) * INV_PI, 0.0) \
        + wg * mf.glossy_pdf(wo, wi, m["au"], m["av"])
    return f, pdf


def sample(m, wo, u_lobe, u_dir):
    """A lobe by u_lobe, a direction by u_dir -> (wi, f, pdf, eta factor)."""
    wd, wg = _weights(m)
    cd = concentric(u_dir)
    cz = torch.sqrt(torch.clamp(1.0 - cd[:, 0] ** 2 - cd[:, 1] ** 2, min=0.0))
    wi_d = torch.cat([cd, cz[:, None]], -1)
    wi_d = torch.where((wo[:, 2] < 0)[:, None], -wi_d, wi_d)
    wi_g, ok_g = mf.sample_wi(wo, u_dir, m["au"], m["av"])
    diffuse = u_lobe < wd
    wi = torch.where(diffuse[:, None], wi_d, wi_g)
    f, pdf = f_pdf(m, wo, wi)
    # a lane with no lobe at all draws nothing
    none = (wd + wg) == 0
    ok = (diffuse | ok_g) & ~none
    return wi, torch.where(none[:, None], 0.0, f), torch.where(ok, pdf, 0.0), None
