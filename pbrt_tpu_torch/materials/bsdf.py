"""BSDF lobes for the slice's materials (port of pbrt_tpu/materials/bsdf.py).

Matte and plastic use two lobe families of the reference's fixed `Lobes`
block: the always-on Lambertian diffuse lobe and glossy microfacet
reflection with dielectric Fresnel and the Trowbridge-Reitz (GGX)
distribution. Sampling picks a lobe uniformly over the present ones, as
the reference does; the specular, transmission, Oren-Nayar, conductor,
FresnelBlend and Fourier families wait for their materials.

Directions are in the local shading frame (z = shading normal).
"""
from __future__ import annotations

import dataclasses

import torch

from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.math import vec3, dot, normalize, PI, INV_PI
from pbrt_tpu_torch.core.sampling import cosine_sample_hemisphere

N_LOBE_SLOTS = 5   # (diffuse, diffuse_t, glossy, glossy_t, specular)


@dataclasses.dataclass
class Lobes:
    kd: torch.Tensor        # [N,3] diffuse reflectance
    ks: torch.Tensor        # [N,3] glossy reflection weight
    rough_u: torch.Tensor   # [N] alpha_x
    rough_v: torch.Tensor   # [N] alpha_y
    eta: torch.Tensor       # [N] relative index of refraction


@dataclasses.dataclass
class BsdfSample:
    wi: torch.Tensor            # [N,3] local
    f: torch.Tensor             # [N,3]
    pdf: torch.Tensor           # [N]
    is_specular: torch.Tensor   # [N] bool


def black(c):
    return (c <= 0.0).all(-1)


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0


def fresnel_dielectric(cos_i, eta):
    """Unpolarized dielectric Fresnel; eta = eta_t/eta_i on the cos_i>0 side."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    eta_i = torch.where(entering, 1.0, eta)
    eta_t = torch.where(entering, eta, 1.0)
    ci = torch.abs(cos_i)
    sin_t = eta_i / eta_t * torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    ct = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_parl = (eta_t * ci - eta_i * ct) / torch.clamp(eta_t * ci + eta_i * ct, min=1e-9)
    r_perp = (eta_i * ci - eta_t * ct) / torch.clamp(eta_i * ci + eta_t * ct, min=1e-9)
    f = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(sin_t >= 1.0, 1.0, f)


def _tan2_theta(w):
    c2 = w[..., 2] * w[..., 2]
    return torch.clamp(1.0 - c2, min=0.0) / torch.clamp(c2, min=1e-9)


def _cos2_phi(w):
    sin_t = torch.sqrt(torch.clamp(1.0 - w[..., 2] ** 2, min=0.0))
    cp = torch.where(sin_t == 0.0, 1.0,
                     torch.clamp(w[..., 0] / torch.clamp(sin_t, min=1e-9), -1.0, 1.0))
    return cp * cp


def mf_d(wh, ax, ay):
    """Trowbridge-Reitz distribution D(wh)."""
    t2 = _tan2_theta(wh)
    c2 = wh[..., 2] ** 2
    c4 = c2 * c2
    c2p = _cos2_phi(wh)
    e = (c2p / torch.clamp(ax * ax, min=1e-9)
         + (1.0 - c2p) / torch.clamp(ay * ay, min=1e-9)) * t2
    d = 1.0 / torch.clamp(PI * ax * ay * c4 * (1.0 + e) ** 2, min=1e-12)
    return torch.where(torch.isinf(t2) | (c2 <= 0.0), 0.0, d)


def mf_lambda(w, ax, ay):
    abs_tan = torch.sqrt(torch.clamp(_tan2_theta(w), min=1e-18))
    c2p = _cos2_phi(w)
    alpha = torch.sqrt(torch.clamp(c2p * ax * ax + (1.0 - c2p) * ay * ay, min=1e-12))
    lam = 0.5 * (-1.0 + torch.sqrt(1.0 + (alpha * abs_tan) ** 2))
    return torch.where(torch.isinf(abs_tan) | (abs_tan == 0.0) | torch.isnan(lam), 0.0, lam)


def mf_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + mf_lambda(wo, ax, ay) + mf_lambda(wi, ax, ay))


def mf_sample_wh(wo, u, ax, ay):
    """Sample the full distribution D (pdf = D * |cos|)."""
    u0, u1 = u[..., 0], u[..., 1]
    phi = torch.atan2(ay * torch.sin(2 * PI * u1 + 0.5 * PI),
                      ax * torch.cos(2 * PI * u1 + 0.5 * PI))
    phi = torch.where(torch.abs(ax - ay) < 1e-7, 2 * PI * u1, phi)
    c2p = torch.cos(phi) ** 2
    alpha2 = 1.0 / torch.clamp(c2p / torch.clamp(ax * ax, min=1e-12)
                               + (1.0 - c2p) / torch.clamp(ay * ay, min=1e-12), min=1e-12)
    tan2 = alpha2 * u0 / torch.clamp(1.0 - u0, min=1e-9)
    cos_h = 1.0 / torch.sqrt(1.0 + tan2)
    sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=1e-18))
    wh = vec3(sin_h * torch.cos(phi), sin_h * torch.sin(phi), cos_h)
    return torch.where(same_hemisphere(wo, wh)[..., None], wh, -wh)


def roughness_to_alpha(rough):
    """pbrt's RoughnessToAlpha remap."""
    x = torch.log(torch.clamp(rough, min=1e-3))
    return 1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3 \
        + 0.000640711 * x ** 4


def _half_vector(wo, wi):
    h = wo + wi
    ok = vm.length_squared(h) > 1e-12
    up = torch.tensor([0.0, 0.0, 1.0], device=h.device)
    return normalize(torch.where(ok[..., None], h, up)), ok


def _glossy_f(lb: Lobes, wo, wi):
    """Torrance-Sparrow microfacet reflection, dielectric Fresnel."""
    co = torch.abs(wo[..., 2])
    ci = torch.abs(wi[..., 2])
    wh, wh_ok = _half_vector(wi, wo)
    d = mf_d(wh, lb.rough_u, lb.rough_v)
    g = mf_g(wo, wi, lb.rough_u, lb.rough_v)
    F = fresnel_dielectric(dot(wi, wh), lb.eta)
    f = lb.ks * F[..., None] * (d * g / torch.clamp(4.0 * co * ci, min=1e-9))[..., None]
    ok = same_hemisphere(wo, wi) & (co > 0) & (ci > 0) & wh_ok
    return torch.where(ok[..., None], f, 0.0)


def bsdf_f(lb: Lobes, wo, wi):
    """Total non-specular f."""
    f = torch.where(same_hemisphere(wo, wi)[..., None], lb.kd * INV_PI, 0.0)
    return f + torch.where((~black(lb.ks))[..., None], _glossy_f(lb, wo, wi), 0.0)


def _lobe_weights(lb: Lobes):
    """Uniform sampling weights over the present lobes, per slot
    (diffuse, diffuse_t, glossy, glossy_t, specular)."""
    present = torch.zeros(lb.kd.shape[:-1] + (N_LOBE_SLOTS,), device=lb.kd.device)
    present[..., 0] = (~black(lb.kd)).to(torch.float32)
    present[..., 2] = (~black(lb.ks)).to(torch.float32)
    total = torch.clamp(present.sum(-1, keepdim=True), min=1e-9)
    return present / total


def bsdf_pdf(lb: Lobes, wo, wi):
    """pdf of the non-specular sampling mixture."""
    w = _lobe_weights(lb)
    refl = same_hemisphere(wo, wi)
    pdf = w[..., 0] * torch.where(refl, torch.abs(wi[..., 2]) * INV_PI, 0.0)
    wh, _ = _half_vector(wo, wi)
    p_gl = mf_d(wh, lb.rough_u, lb.rough_v) * torch.abs(wh[..., 2]) \
        / torch.clamp(4.0 * torch.abs(dot(wo, wh)), min=1e-9)
    return pdf + w[..., 2] * torch.where(refl, p_gl, 0.0)


def bsdf_sample(lb: Lobes, wo, u_lobe, u2) -> BsdfSample:
    """Pick a lobe with u_lobe, a direction with u2."""
    w = _lobe_weights(lb)
    cdf = torch.cumsum(w, -1)
    sel = torch.clamp((cdf <= u_lobe[..., None]).sum(-1), 0, N_LOBE_SLOTS - 1)

    flip = (wo[..., 2] < 0.0)[..., None]
    wi_d = cosine_sample_hemisphere(u2)
    wi_d = torch.where(flip, -wi_d, wi_d)
    wh = mf_sample_wh(torch.where(flip, -wo, wo), u2, lb.rough_u, lb.rough_v)
    wh = torch.where(flip, -wh, wh)
    wi_g = 2.0 * dot(wo, wh)[..., None] * wh - wo

    # no specular lobe is present: a lane with no lobe at all lands in the
    # specular slot (weight 0) and gets f = 0, pdf = 0
    is_spec = sel == 4
    is_gloss = sel == 2
    wi = torch.where(is_gloss[..., None], wi_g, wi_d)
    f = torch.where(is_spec[..., None], 0.0, bsdf_f(lb, wo, wi))
    pdf = torch.where(is_spec, w[..., 4], bsdf_pdf(lb, wo, wi))
    valid = torch.where(is_gloss, same_hemisphere(wo, wi_g) & (dot(wo, wh) > 0), True)
    return BsdfSample(wi, f, torch.where(valid, pdf, 0.0), is_spec)
