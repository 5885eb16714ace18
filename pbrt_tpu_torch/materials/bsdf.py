"""BSDF lobes (port of pbrt_tpu/materials/bsdf.py).

Every surface's BSDF is one `Lobes` block of masked lobe families, as in
the reference:

  diffuse   : Lambertian / Oren-Nayar reflection + Lambertian transmission
  glossy    : microfacet reflection (dielectric or conductor Fresnel, or
              Ashikhmin-Shirley FresnelBlend) + microfacet transmission
  specular  : perfect reflection / transmission, with the coupled Fresnel
              R/T pair of smooth glass
  fourier   : a tabulated FourierBSDF (materials/fourier.py)

A family no material of the scene can populate is gated off statically:
`fams` = (diffuse transmission, glossy, glossy transmission, Oren-Nayar,
specular), the reference's `material_families`, and a gated-off family
issues no tensor op. Its fields of `Lobes` are None; so are the
glossy-kind, distribution and specular-Fresnel ids where every lane takes
the dielectric GGX default, and the conductor and blend colours where no
lane is a conductor or a blend. With `fams` None the gate is read from the
fields that are present. Sampling picks a lobe uniformly over the present
ones, as the reference does.

Directions are in the local shading frame (z = shading normal).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.math import vec3, dot, normalize, PI, INV_PI, ONE_MINUS_EPSILON
from pbrt_tpu_torch.core.sampling import cosine_sample_hemisphere

N_LOBE_SLOTS = 5   # (diffuse, diffuse_t, glossy, glossy_t, specular)
# microfacet distribution ids
DIST_GGX, DIST_BECKMANN = 0, 1
# glossy Fresnel kinds
GF_DIELECTRIC, GF_CONDUCTOR, GF_BLEND = 0, 1, 2
# specular Fresnel kinds
SF_DIELECTRIC, SF_CONDUCTOR, SF_NOOP = 0, 1, 2
ALL_FAMS = (True, True, True, True, True)

T = Optional[torch.Tensor]


@dataclasses.dataclass
class Lobes:
    kd: torch.Tensor           # [N,3] diffuse reflectance
    ks: T = None               # [N,3] glossy reflection weight (glossy)
    rough_u: T = None          # [N] alpha_x of the glossy reflection
    rough_v: T = None          # [N] alpha_y
    eta: T = None              # [N] relative index of refraction
    sigma: T = None            # [N] Oren-Nayar sigma in radians (oren)
    kt_diff: T = None          # [N,3] diffuse transmission (dift)
    glossy_kind: T = None      # [N] int GF_*; None: every lane dielectric
    dist: T = None             # [N] int DIST_*; None: every lane GGX
    eta3: T = None             # [N,3] conductor eta; None: no conductor
    k3: T = None               # [N,3] conductor k
    rd_blend: T = None         # [N,3] FresnelBlend diffuse colour; None: no blend
    kt_gloss: T = None         # [N,3] glossy transmission weight (glossy_t)
    rough_tu: T = None         # [N]
    rough_tv: T = None         # [N]
    spec_r: T = None           # [N,3] specular reflection weight (spec)
    spec_t: T = None           # [N,3] specular transmission weight
    spec_fresnel: T = None     # [N] int SF_*; None: every lane dielectric
    fourier_id: T = None       # [N] int fourier table id (-1 none); None: no table


@dataclasses.dataclass
class BsdfSample:
    wi: torch.Tensor            # [N,3] local
    f: torch.Tensor             # [N,3]
    pdf: torch.Tensor           # [N]
    is_specular: torch.Tensor   # [N] bool
    is_transmission: T = None   # [N] bool; None: no family transmits
    eta_scale: T = None         # [N] eta^2 factor for Russian roulette; None: all 1


def lobe_fams(lb: Lobes):
    """The family gate that the present fields of lb imply."""
    return (lb.kt_diff is not None, lb.ks is not None, lb.kt_gloss is not None,
            lb.sigma is not None, lb.spec_r is not None)


def black(c):
    return (c <= 0.0).all(-1)


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0


def reflect_z(wo):
    return vec3(-wo[..., 0], -wo[..., 1], wo[..., 2])


def refract(wi, n, eta_ratio):
    """Snell refraction; n on wi's side -> (ok, wt). The cos_t floor keeps
    reverse mode finite at the exact total-internal-reflection boundary."""
    cos_i = dot(n, wi)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = eta_ratio * eta_ratio * sin2_i
    ok = sin2_t < 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=1e-12))
    wt = eta_ratio[..., None] * (-wi) + (eta_ratio * cos_i - cos_t)[..., None] * n
    return ok, wt


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


def fresnel_conductor(cos_i, eta, k):
    """Conductor Fresnel per channel; eta, k [..., 3]."""
    ci = torch.clamp(torch.abs(cos_i), 0.0, 1.0)[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2 = eta * eta
    k2 = k * k
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


def schlick_fresnel(cos_i, rs):
    """Schlick's approximation with an rgb R0 (FresnelBlend)."""
    m = torch.clamp(1.0 - cos_i, 0.0, 1.0)
    return rs + (m ** 5)[..., None] * (1.0 - rs)


def _tan2_theta(w):
    c2 = w[..., 2] * w[..., 2]
    return torch.clamp(1.0 - c2, min=0.0) / torch.clamp(c2, min=1e-9)


def _cos2_phi(w):
    sin_t = torch.sqrt(torch.clamp(1.0 - w[..., 2] ** 2, min=0.0))
    cp = torch.where(sin_t == 0.0, 1.0,
                     torch.clamp(w[..., 0] / torch.clamp(sin_t, min=1e-9), -1.0, 1.0))
    return cp * cp


def mf_d(wh, ax, ay, dist=None):
    """Microfacet distribution D(wh): Trowbridge-Reitz (GGX), or per lane
    GGX / Beckmann by dist."""
    t2 = _tan2_theta(wh)
    c2 = wh[..., 2] ** 2
    c4 = c2 * c2
    c2p = _cos2_phi(wh)
    e = (c2p / torch.clamp(ax * ax, min=1e-9)
         + (1.0 - c2p) / torch.clamp(ay * ay, min=1e-9)) * t2
    d = 1.0 / torch.clamp(PI * ax * ay * c4 * (1.0 + e) ** 2, min=1e-12)
    if dist is not None:
        d_beck = torch.exp(-t2 * (c2p / torch.clamp(ax * ax, min=1e-9)
                                  + (1.0 - c2p) / torch.clamp(ay * ay, min=1e-9))) \
            / torch.clamp(PI * ax * ay * c4, min=1e-12)
        d = torch.where(dist == DIST_GGX, d, d_beck)
    return torch.where(torch.isinf(t2) | (c2 <= 0.0), 0.0, d)


def mf_lambda(w, ax, ay, dist=None):
    """Smith's Lambda; the sqrt floors keep reverse mode finite at normal
    incidence."""
    abs_tan = torch.sqrt(torch.clamp(_tan2_theta(w), min=1e-18))
    c2p = _cos2_phi(w)
    alpha = torch.sqrt(torch.clamp(c2p * ax * ax + (1.0 - c2p) * ay * ay, min=1e-12))
    lam = 0.5 * (-1.0 + torch.sqrt(1.0 + (alpha * abs_tan) ** 2))
    if dist is not None:
        a = 1.0 / torch.clamp(alpha * abs_tan, min=1e-9)
        lam_beck = torch.where(a >= 1.6, 0.0, (1.0 - 1.259 * a + 0.396 * a * a)
                               / torch.clamp(3.535 * a + 2.181 * a * a, min=1e-9))
        lam = torch.where(dist == DIST_GGX, lam, lam_beck)
    return torch.where(torch.isinf(abs_tan) | (abs_tan == 0.0) | torch.isnan(lam), 0.0, lam)


def mf_g(wo, wi, ax, ay, dist=None):
    return 1.0 / (1.0 + mf_lambda(wo, ax, ay, dist) + mf_lambda(wi, ax, ay, dist))


def mf_g1(w, ax, ay, dist=None):
    return 1.0 / (1.0 + mf_lambda(w, ax, ay, dist))


def mf_sample_wh(wo, u, ax, ay, dist=None):
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
    if dist is not None:
        tan2_b = -alpha2 * torch.log(torch.clamp(1.0 - u0, min=1e-38))
        cos_h = torch.where(dist == DIST_GGX, cos_h, 1.0 / torch.sqrt(1.0 + tan2_b))
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


def _oren_nayar_f(kd, sigma, wo, wi):
    s2 = sigma * sigma
    a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    b = 0.45 * s2 / (s2 + 0.09)
    sin_to = torch.sqrt(torch.clamp(1.0 - wo[..., 2] ** 2, min=0.0))
    sin_ti = torch.sqrt(torch.clamp(1.0 - wi[..., 2] ** 2, min=0.0))
    cos_dphi = (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1]) \
        / (torch.clamp(sin_ti, min=1e-9) * torch.clamp(sin_to, min=1e-9))
    max_cos = torch.where((sin_ti > 1e-4) & (sin_to > 1e-4),
                          torch.clamp(cos_dphi, min=0.0), 0.0)
    aci, aco = torch.abs(wi[..., 2]), torch.abs(wo[..., 2])
    big = aci > aco
    sin_alpha = torch.where(big, sin_to, sin_ti)
    tan_beta = torch.where(big, sin_ti / torch.clamp(aci, min=1e-9),
                           sin_to / torch.clamp(aco, min=1e-9))
    return kd * (INV_PI * (a + b * max_cos * sin_alpha * tan_beta))[..., None]


def _glossy_f(lb: Lobes, wo, wi):
    """Torrance-Sparrow microfacet reflection (dielectric or conductor
    Fresnel), or FresnelBlend on the blend lanes."""
    co = torch.abs(wo[..., 2])
    ci = torch.abs(wi[..., 2])
    wh, wh_ok = _half_vector(wi, wo)
    d = mf_d(wh, lb.rough_u, lb.rough_v, lb.dist)
    g = mf_g(wo, wi, lb.rough_u, lb.rough_v, lb.dist)
    cos_wh = dot(wi, wh)
    F = fresnel_dielectric(cos_wh, lb.eta)[..., None]
    if lb.eta3 is not None:
        F = torch.where((lb.glossy_kind == GF_CONDUCTOR)[..., None],
                        fresnel_conductor(cos_wh, lb.eta3, lb.k3), F)
    f = lb.ks * F * (d * g / torch.clamp(4.0 * co * ci, min=1e-9))[..., None]
    if lb.rd_blend is not None:
        diff_ab = (28.0 / (23.0 * PI)) * lb.rd_blend * (1.0 - lb.ks) \
            * (1.0 - (1.0 - 0.5 * ci) ** 5)[..., None] * (1.0 - (1.0 - 0.5 * co) ** 5)[..., None]
        spec_ab = (d / torch.clamp(4.0 * torch.abs(cos_wh) * torch.maximum(ci, co),
                                   min=1e-9))[..., None] * schlick_fresnel(cos_wh, lb.ks)
        f = torch.where((lb.glossy_kind == GF_BLEND)[..., None], diff_ab + spec_ab, f)
    ok = same_hemisphere(wo, wi) & (co > 0) & (ci > 0) & wh_ok
    return torch.where(ok[..., None], f, 0.0)


def _transmission_eta(lb: Lobes, wo):
    """eta_t / eta_i seen from wo's side."""
    return torch.where(wo[..., 2] > 0.0, lb.eta, 1.0 / torch.clamp(lb.eta, min=1e-9))


def _glossy_t_f(lb: Lobes, wo, wi):
    """Microfacet transmission (rough glass)."""
    co, ci = wo[..., 2], wi[..., 2]
    ok = (~same_hemisphere(wo, wi)) & (torch.abs(co) > 1e-7) & (torch.abs(ci) > 1e-7)
    eta = _transmission_eta(lb, wo)
    wh = normalize(wo + wi * eta[..., None])
    wh = torch.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    ok = ok & ~((dot(wo, wh) * dot(wi, wh)) > 0.0)
    d = mf_d(wh, lb.rough_tu, lb.rough_tv, lb.dist)
    g = mf_g(wo, wi, lb.rough_tu, lb.rough_tv, lb.dist)
    F = fresnel_dielectric(dot(wo, wh), lb.eta)
    denom = dot(wo, wh) + eta * dot(wi, wh)
    denom2 = torch.clamp(denom * denom, min=1e-12)
    val = lb.kt_gloss * ((1.0 - F) * d * g * torch.abs(dot(wi, wh)) * torch.abs(dot(wo, wh))
                         / torch.clamp(torch.abs(ci) * torch.abs(co) * denom2, min=1e-12)
                         / (eta * eta))[..., None]
    return torch.where(ok[..., None], val, 0.0)


def bsdf_f(lb: Lobes, wo, wi, ftab=None, fams=None):
    """Total non-specular f (specular lobes are deltas). ftab: the
    FourierTable where the scene has fourier materials."""
    dift, glossy, glossy_t, oren, _ = fams or lobe_fams(lb)
    refl = same_hemisphere(wo, wi)
    dif = lb.kd * INV_PI
    if oren:
        dif = torch.where((lb.sigma > 1e-5)[..., None], _oren_nayar_f(lb.kd, lb.sigma, wo, wi),
                          dif)
    f = torch.where(refl[..., None], dif, 0.0)
    if dift:
        f = f + torch.where((~refl)[..., None], lb.kt_diff * INV_PI, 0.0)
    if glossy:
        has = ~black(lb.ks)
        if lb.rd_blend is not None:
            has = has | ~black(lb.rd_blend)
        f = f + torch.where(has[..., None], _glossy_f(lb, wo, wi), 0.0)
    if glossy_t:
        f = f + torch.where((~black(lb.kt_gloss))[..., None], _glossy_t_f(lb, wo, wi), 0.0)
    if ftab is not None:
        from pbrt_tpu_torch.materials.fourier import eval_fourier
        f = f + eval_fourier(ftab, lb.fourier_id, wo, wi)
    return f


def _lobe_weights(lb: Lobes, fams, fourier):
    """Uniform sampling weights over the present lobes, per slot
    (diffuse, diffuse_t, glossy, glossy_t, specular); diffuse transmission
    and a fourier table ride the diffuse slot."""
    dift, glossy, glossy_t, _, spec = fams
    present = torch.zeros(lb.kd.shape[:-1] + (N_LOBE_SLOTS,), device=lb.kd.device)
    dif = ~black(lb.kd)
    if dift:
        dif = dif | ~black(lb.kt_diff)
    if fourier:
        dif = dif | (lb.fourier_id >= 0)
    present[..., 0] = dif.to(torch.float32)
    if glossy:
        gl = ~black(lb.ks)
        if lb.rd_blend is not None:
            gl = gl | ~black(lb.rd_blend)
        present[..., 2] = gl.to(torch.float32)
    if glossy_t:
        present[..., 3] = (~black(lb.kt_gloss)).to(torch.float32)
    if spec:
        present[..., 4] = (~black(lb.spec_r) | ~black(lb.spec_t)).to(torch.float32)
    total = torch.clamp(present.sum(-1, keepdim=True), min=1e-9)
    return present / total


def bsdf_pdf(lb: Lobes, wo, wi, ftab=None, fams=None):
    """pdf of the non-specular sampling mixture."""
    fams = fams or lobe_fams(lb)
    dift, glossy, glossy_t, _, _ = fams
    w = _lobe_weights(lb, fams, ftab is not None)
    refl = same_hemisphere(wo, wi)
    pd_refl = torch.abs(wi[..., 2]) * INV_PI
    p_dif = torch.where(refl, pd_refl, 0.0)
    if dift:
        # translucent: half reflection, half transmission within the slot
        p_dif = torch.where(~black(lb.kt_diff), 0.5 * pd_refl, p_dif)
    if ftab is not None:
        from pbrt_tpu_torch.materials.fourier import pdf_fourier
        p_dif = torch.where(lb.fourier_id >= 0, pdf_fourier(ftab, lb.fourier_id, wo, wi), p_dif)
    pdf = w[..., 0] * p_dif
    if glossy:
        wh, _ = _half_vector(wo, wi)
        p_gl = mf_d(wh, lb.rough_u, lb.rough_v, lb.dist) * torch.abs(wh[..., 2]) \
            / torch.clamp(4.0 * torch.abs(dot(wo, wh)), min=1e-9)
        pdf = pdf + w[..., 2] * torch.where(refl, p_gl, 0.0)
    if glossy_t:
        eta = _transmission_eta(lb, wo)
        wht = normalize(wo + wi * eta[..., None])
        # only a half vector that separates wo and wi can be sampled
        sep = (dot(wo, wht) * dot(wi, wht)) <= 0.0
        dwh_dwi = torch.abs((eta * eta * dot(wi, wht))
                            / torch.clamp((dot(wo, wht) + eta * dot(wi, wht)) ** 2, min=1e-12))
        p_gt = mf_d(wht, lb.rough_tu, lb.rough_tv, lb.dist) * torch.abs(wht[..., 2]) * dwh_dwi
        pdf = pdf + w[..., 3] * torch.where((~refl) & sep, p_gt, 0.0)
    return pdf


def bsdf_sample(lb: Lobes, wo, u_lobe, u2, ftab=None, fams=None) -> BsdfSample:
    """Pick a lobe with u_lobe, a direction with u2 (the reference's
    BSDF::sample_f over the fixed lobe slots)."""
    fams = fams or lobe_fams(lb)
    dift, glossy, glossy_t, _, spec = fams
    four = ftab is not None
    n = wo.shape[0]
    w = _lobe_weights(lb, fams, four)
    cdf = torch.cumsum(w, -1)
    sel = torch.clamp((cdf <= u_lobe[..., None]).sum(-1), 0, N_LOBE_SLOTS - 1)
    if dift or spec or four:
        # u_lobe remapped within the chosen slot, reused below
        lo = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1).gather(1, sel[:, None])[:, 0]
        wsel = w.gather(1, sel[:, None])[:, 0]
        u_re = torch.clamp((u_lobe - lo) / torch.clamp(wsel, min=1e-9), 0.0, ONE_MINUS_EPSILON)

    flip = (wo[..., 2] < 0.0)[..., None]
    wi_d = cosine_sample_hemisphere(u2)
    wi_d = torch.where(flip, -wi_d, wi_d)
    is_dif = sel <= 1 if dift or four else None
    trans = None
    if dift:
        go_trans = ~black(lb.kt_diff) & (u_re < 0.5)
        wi_d = torch.where(go_trans[..., None], vec3(wi_d[..., 0], wi_d[..., 1], -wi_d[..., 2]),
                           wi_d)
        trans = is_dif & go_trans
    if four:
        from pbrt_tpu_torch.materials.fourier import sample_fourier_bsdf
        four_l = lb.fourier_id >= 0
        wi_d = torch.where(four_l[..., None],
                           sample_fourier_bsdf(ftab, lb.fourier_id, wo, u2, u_re)[0], wi_d)
    if glossy_t or spec:
        cos_o = wo[..., 2]
        eta_t = torch.where(cos_o > 0.0, 1.0 / torch.clamp(lb.eta, min=1e-9), lb.eta)
    wi, valid = wi_d, None
    if glossy_t:
        wht = mf_sample_wh(torch.where(flip, -wo, wo), u2, lb.rough_tu, lb.rough_tv, lb.dist)
        wht = torch.where(flip, -wht, wht)
        ok_t, wi_t = refract(wo, torch.where((dot(wo, wht) < 0)[..., None], -wht, wht), eta_t)
        is_gt = sel == 3
        wi = torch.where(is_gt[..., None], wi_t, wi)
        valid = torch.where(is_gt, ok_t & ~same_hemisphere(wo, wi_t), True)
        trans = is_gt if trans is None else is_gt | trans
    if glossy:
        wh = mf_sample_wh(torch.where(flip, -wo, wo), u2, lb.rough_u, lb.rough_v, lb.dist)
        wh = torch.where(flip, -wh, wh)
        wi_g = 2.0 * dot(wo, wh)[..., None] * wh - wo
        is_gloss = sel == 2
        wi = torch.where(is_gloss[..., None], wi_g, wi)
        valid = torch.where(is_gloss, same_hemisphere(wo, wi_g) & (dot(wo, wh) > 0),
                            True if valid is None else valid)
    is_spec = sel == 4
    if spec:
        Fr = fresnel_dielectric(cos_o, lb.eta)
        has_sr, has_st = ~black(lb.spec_r), ~black(lb.spec_t)
        both = has_sr & has_st
        pr = torch.where(both, Fr, torch.where(has_sr, 1.0, 0.0))
        choose_r = u_re < pr
        nz = vec3(torch.zeros(n, device=wo.device), torch.zeros(n, device=wo.device),
                  torch.where(cos_o > 0, 1.0, -1.0))
        ok_st, wi_st = refract(wo, nz, eta_t)
        Fspec = Fr[..., None]
        if lb.spec_fresnel is not None:
            if lb.eta3 is not None:
                Fspec = torch.where((lb.spec_fresnel == SF_CONDUCTOR)[..., None],
                                    fresnel_conductor(cos_o, lb.eta3, lb.k3), Fspec)
            Fspec = torch.where((lb.spec_fresnel == SF_NOOP)[..., None], 1.0, Fspec)
        wi_s = torch.where(choose_r[..., None], reflect_z(wo), wi_st)
        aci_s = torch.clamp(torch.abs(wi_s[..., 2]), min=1e-9)[..., None]
        # transmission carries the radiance scale (eta_i/eta_t)^2
        f_s = torch.where(choose_r[..., None], lb.spec_r * Fspec / aci_s,
                          lb.spec_t * ((1.0 - Fr) * eta_t * eta_t)[..., None] / aci_s)
        pdf_s = torch.where(both, torch.where(choose_r, pr, 1.0 - pr), 1.0)
        wi = torch.where(is_spec[..., None], wi_s, wi)
        valid = torch.where(is_spec, torch.where(choose_r, True, ok_st),
                            True if valid is None else valid)
        spec_trans = ~choose_r & has_st
        trans = spec_trans & is_spec if trans is None else torch.where(is_spec, spec_trans, trans)
    if four:
        four_t = is_dif & four_l
        four_t = four_t & ~same_hemisphere(wo, wi)
        trans = four_t if trans is None else trans | four_t

    f_ns = bsdf_f(lb, wo, wi, ftab, fams)
    pdf_ns = bsdf_pdf(lb, wo, wi, ftab, fams)
    if spec:
        f = torch.where(is_spec[..., None], f_s, f_ns)
        pdf = torch.where(is_spec, pdf_s * w[..., 4], pdf_ns)
    else:
        # no specular lobe: a lane with no lobe at all lands in the
        # specular slot (weight 0) and gets f = 0, pdf = 0
        f = torch.where(is_spec[..., None], 0.0, f_ns)
        pdf = torch.where(is_spec, w[..., 4], pdf_ns)
    if valid is not None:
        pdf = torch.where(valid, pdf, 0.0)
    eta_scale = None
    if glossy_t or spec:
        # (path.rs eta_scale) entering multiplies by eta^2, leaving divides
        eta2 = lb.eta * lb.eta
        eta_rr = torch.where(cos_o > 0, eta2, 1.0 / torch.clamp(eta2, min=1e-9))
        both_t = is_spec | is_gt if glossy_t and spec else (is_spec if spec else is_gt)
        eta_scale = torch.where(trans & both_t, eta_rr, 1.0)
    return BsdfSample(wi, f, pdf, is_spec, trans, eta_scale)
