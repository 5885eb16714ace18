"""Microfacet reflection of the plain reference, in plain PyTorch: the
Trowbridge-Reitz (GGX) distribution D, Smith's masking G, the dielectric
and conductor Fresnel terms, the sampling of a half vector, and pbrt-v3's
RoughnessToAlpha. It follows the glossy lobe that the port documents, step
for step, so that equal draws give equal pixels up to rounding. Where that
estimator departs from pbrt-v3, this does too:

  - the half vector is drawn from D |cos theta_h| over the whole
    distribution, with pdf D |cos theta_h| / (4 |wo . wh|), where pbrt-v3
    draws it from the visible normals by default (sampleVisibleArea);
  - the Fresnel term reads wi . wh, where pbrt-v3 first turns wh to the
    shading normal's side (Faceforward);
  - a dielectric's Fresnel term sees eta_t / eta_i = eta from the side wi
    lies on (plastic: 1.5), where pbrt-v3's plastic builds its
    FresnelDielectric(1.5, 1) the other way round;
  - an alpha is at least 1e-3, and an anisotropic alpha falls back to the
    isotropic roughness where it is 0.

Directions are in the shading frame (z the shading normal); alphas are [N],
colours [N,3].
"""
from __future__ import annotations

import math

import torch

from refmath import dot, normalize


def roughness_to_alpha(roughness, remap=True):
    """pbrt-v3's RoughnessToAlpha where remap, on the host (float64)."""
    if remap:
        x = math.log(max(roughness, 1e-3))
        roughness = (1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3
                     + 0.000640711 * x ** 4)
    return max(roughness, 1e-3)


def alphas(params, default):
    """(alpha_u, alpha_v) of a material's roughness parameters."""
    def get(key, fallback):
        v = float(params[key][1][0]) if key in params else 0.0
        return v if v > 0.0 else fallback
    rough = float(params["roughness"][1][0]) if "roughness" in params else default
    remap = bool(params["remaproughness"][1][0]) if "remaproughness" in params else True
    return (roughness_to_alpha(get("uroughness", rough), remap),
            roughness_to_alpha(get("vroughness", rough), remap))


def same_hemisphere(a, b):
    return a[:, 2] * b[:, 2] > 0


def _tan2(w):
    c2 = w[:, 2] * w[:, 2]
    return torch.clamp(1.0 - c2, min=0.0) / torch.clamp(c2, min=1e-9)


def _cos2_phi(w):
    sin_t = torch.sqrt(torch.clamp(1.0 - w[:, 2] * w[:, 2], min=0.0))
    cp = torch.where(sin_t == 0, 1.0, torch.clamp(w[:, 0] / torch.clamp(sin_t, min=1e-9),
                                                  -1.0, 1.0))
    return cp * cp


def distribution(wh, ax, ay):
    """Trowbridge-Reitz D(wh)."""
    t2 = _tan2(wh)
    c2 = wh[:, 2] * wh[:, 2]
    c2p = _cos2_phi(wh)
    e = (c2p / torch.clamp(ax * ax, min=1e-9) + (1.0 - c2p) / torch.clamp(ay * ay, min=1e-9)) * t2
    d = 1.0 / torch.clamp(math.pi * ax * ay * (c2 * c2) * (1.0 + e) ** 2, min=1e-12)
    return torch.where(torch.isinf(t2) | (c2 <= 0), 0.0, d)


def smith_lambda(w, ax, ay):
    abs_tan = torch.sqrt(torch.clamp(_tan2(w), min=1e-18))
    c2p = _cos2_phi(w)
    alpha = torch.sqrt(torch.clamp(c2p * ax * ax + (1.0 - c2p) * ay * ay, min=1e-12))
    lam = 0.5 * (-1.0 + torch.sqrt(1.0 + (alpha * abs_tan) ** 2))
    return torch.where(torch.isinf(abs_tan) | (abs_tan == 0) | torch.isnan(lam), 0.0, lam)


def masking(wo, wi, ax, ay):
    """Smith's G(wo, wi)."""
    return 1.0 / (1.0 + smith_lambda(wo, ax, ay) + smith_lambda(wi, ax, ay))


def fresnel_dielectric(cos_i, eta):
    """Unpolarised Fresnel reflectance; eta = eta_t / eta_i on the cos_i > 0
    side."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    enter = cos_i > 0
    ei, et = torch.where(enter, 1.0, eta), torch.where(enter, eta, 1.0)
    ci = torch.abs(cos_i)
    st = ei / et * torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    ct = torch.sqrt(torch.clamp(1.0 - st * st, min=0.0))
    rpa = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-9)
    rpe = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-9)
    return torch.where(st >= 1, 1.0, 0.5 * (rpa * rpa + rpe * rpe))


def fresnel_conductor(cos_i, eta, k):
    """pbrt-v3's FrConductor from outside (eta_i 1), per channel: cos_i [N],
    eta and k [N,3] -> [N,3]."""
    ci = torch.clamp(torch.abs(cos_i), 0.0, 1.0)[:, None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2, k2 = eta * eta, k * k
    t0 = eta2 - k2 - si2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * eta2 * k2, min=0.0))
    t1 = a2b2 + ci2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-9)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-9)
    return 0.5 * (rp + rs)


def half_vector(a, b):
    """(normalised a + b, where it has a length; +z elsewhere, and that it
    has)."""
    h = a + b
    ok = dot(h, h) > 1e-12
    up = torch.zeros_like(h)
    up[:, 2] = 1.0
    return normalize(torch.where(ok[:, None], h, up)), ok


def glossy_f(wo, wi, ax, ay, fresnel):
    """Torrance-Sparrow reflection D G F / (4 |cos_o| |cos_i|) [N,3];
    fresnel(cos of wi and wh) -> [N,3]."""
    co, ci = torch.abs(wo[:, 2]), torch.abs(wi[:, 2])
    wh, ok = half_vector(wi, wo)
    d = distribution(wh, ax, ay)
    g = masking(wo, wi, ax, ay)
    f = fresnel(dot(wi, wh)) * (d * g / torch.clamp(4.0 * co * ci, min=1e-9))[:, None]
    ok = ok & same_hemisphere(wo, wi) & (co > 0) & (ci > 0)
    return torch.where(ok[:, None], f, 0.0)


def glossy_pdf(wo, wi, ax, ay):
    """pdf of wi under half vectors drawn from D |cos theta_h|."""
    wh, _ = half_vector(wo, wi)
    p = distribution(wh, ax, ay) * torch.abs(wh[:, 2]) \
        / torch.clamp(4.0 * torch.abs(dot(wo, wh)), min=1e-9)
    return torch.where(same_hemisphere(wo, wi), p, 0.0)


def sample_wi(wo, u, ax, ay):
    """A reflected direction about a half vector drawn from D |cos theta_h|
    on wo's side -> (wi, whether it is a reflection on wo's side)."""
    flip = (wo[:, 2] < 0)[:, None]
    up = torch.where(flip, -wo, wo)
    u0, u1 = u[:, 0], u[:, 1]
    phi = torch.atan2(ay * torch.sin(2 * math.pi * u1 + 0.5 * math.pi),
                      ax * torch.cos(2 * math.pi * u1 + 0.5 * math.pi))
    phi = torch.where(torch.abs(ax - ay) < 1e-7, 2 * math.pi * u1, phi)
    c2p = torch.cos(phi) ** 2
    alpha2 = 1.0 / torch.clamp(c2p / torch.clamp(ax * ax, min=1e-12)
                               + (1.0 - c2p) / torch.clamp(ay * ay, min=1e-12), min=1e-12)
    tan2 = alpha2 * u0 / torch.clamp(1.0 - u0, min=1e-9)
    cos_h = 1.0 / torch.sqrt(1.0 + tan2)
    sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=1e-18))
    wh = torch.stack([sin_h * torch.cos(phi), sin_h * torch.sin(phi), cos_h], -1)
    wh = torch.where(same_hemisphere(up, wh)[:, None], wh, -wh)
    wh = torch.where(flip, -wh, wh)
    c = dot(wo, wh)
    wi = 2.0 * c[:, None] * wh - wo
    return wi, same_hemisphere(wo, wi) & (c > 0)
