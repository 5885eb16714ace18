"""Separable BSSRDF: the measured media table, the tabulated photon beam
diffusion profile and its per-lane lookups (port of
pbrt_tpu/materials/bssrdf.py, the parts its path integrator reads).

Host, numpy float64, copied as the reference computes them: the
(rho, radius) beam-diffusion table (`build_bssrdf_table`: single and
multiple scattering, Catmull-Rom integrated), its inversion for
kdsubsurface's effective albedo (`invert_rho_eff`), and per material the
table collapsed along rho at each channel's albedo (`dense_channel_rows`),
so the device only interpolates along the 64 geometric radius knots.
Device, tensor code: the profile Sr(r) (`table_sr`), the polar pdf of its
sampling (`table_pdf_sr`) and the inversion of a channel's CDF row
(`table_sample_sr`), with the first Fresnel moment for the exit adapter.

The named media's sigma_a and sigma_s' (1/mm; Jensen et al. 2001 and
Narasimhan et al. 2006, the 47 entries the reference embeds) are read from
data_measured_ss.json beside this file, a copy of the reference's.
"""
from __future__ import annotations

import functools as _functools
import json as _json
import math
import os as _os

import numpy as np
import torch

with open(_os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                        "data_measured_ss.json")) as _f:
    # name -> (sigma_prime_s RGB, sigma_a RGB), 1/mm
    MEASURED_SS = {k: tuple(v) for k, v in _json.load(_f).items()}


def get_medium_scattering_properties(name: str):
    """(sigma_a, sigma_prime_s) RGB in 1/mm of a named medium (any case),
    or None."""
    for k, (sps, sa) in MEASURED_SS.items():
        if k.lower() == name.lower():
            return (np.asarray(sa, np.float32), np.asarray(sps, np.float32))
    return None


def subsurface_sigmas(sigma_a, sigma_s, scale=1.0):
    """(sigma_t, albedo rho) from absorption and scattering, scaled (host)."""
    st = (np.asarray(sigma_a) + np.asarray(sigma_s)) * scale
    rho = np.where(st > 0, np.asarray(sigma_s) * scale / np.maximum(st, 1e-12), 0.0)
    return st, rho


def kdsubsurface_remap(kd, mfp):
    """(sigma_t, rho) of a diffuse reflectance Kd and a mean free path: the
    albedo whose beam-diffusion effective albedo is Kd, sigma_t = 1 / mfp
    (host)."""
    kd = np.clip(np.asarray(kd, np.float32), 0.0, 1.0)
    return (np.full(3, 1.0 / max(float(mfp), 1e-6), np.float32),
            invert_rho_eff(kd).astype(np.float32))


def fresnel_moment1(eta):
    """First moment of the Fresnel reflectance (polynomial fit) of a
    tensor of relative indices; the powers are taken by repeated squaring,
    as the reference's integer powers are."""
    e2 = eta * eta
    e3, e4 = eta * e2, e2 * e2
    e5 = eta * e4
    lo = (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return torch.where(eta < 1.0, lo, hi)


# ---------------------------------------------------------------------------
# the tabulated beam-diffusion profile (tabulated_bssrdf.rs:505-688), host
# ---------------------------------------------------------------------------

PBD_SAMPLES = 100
N_RHO = 100
N_RADII = 64
_R0 = 2.5e-3
_RATIO = 1.2


def _np_fr_dielectric(cos_i, eta_i, eta_t):
    cos_i = np.clip(cos_i, -1.0, 1.0)
    flip = cos_i < 0
    ei = np.where(flip, eta_t, eta_i)
    et = np.where(flip, eta_i, eta_t)
    ci = np.abs(cos_i)
    sin_t2 = (ei / et) ** 2 * np.maximum(1.0 - ci * ci, 0.0)
    ct = np.sqrt(np.maximum(1.0 - sin_t2, 0.0))
    rpar = (et * ci - ei * ct) / np.maximum(et * ci + ei * ct, 1e-12)
    rper = (ei * ci - et * ct) / np.maximum(ei * ci + et * ct, 1e-12)
    fr = 0.5 * (rpar ** 2 + rper ** 2)
    return np.where(sin_t2 >= 1.0, 1.0, fr)


def _np_phase_hg(cos_t, g):
    d = 1.0 + g * g + 2.0 * g * cos_t
    return (1.0 / (4.0 * np.pi)) * (1.0 - g * g) / (d * np.sqrt(np.maximum(d, 1e-12)))


def _np_fm1(eta):
    e2, e3, e4, e5 = eta * eta, eta ** 3, eta ** 4, eta ** 5
    if eta < 1.0:
        return (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
                + 2.49277 * e4 - 0.68441 * e5)
    return (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
            - 1.27198 * e4 + 0.12746 * e5)


def _np_fm2(eta):
    e2, e3, e4, e5 = eta * eta, eta ** 3, eta ** 4, eta ** 5
    if eta < 1.0:
        return (0.27614 - 0.87350 * eta + 1.12077 * e2 - 0.65095 * e3
                - 0.07883 * e4 + 0.04860 * e5)
    return (-547.033 + 45.3087 / e3 - 218.725 / e2 + 458.843 / eta
            + 404.557 * eta - 189.519 * e2 + 54.9327 * e3 - 9.00603 * e4
            + 0.63942 * e5)


def beam_diffusion_ss(sigma_s, sigma_a, g, eta, r):
    """Single-scattering term (tabulated_bssrdf.rs:607)."""
    sigma_t = sigma_a + sigma_s
    rho = sigma_s / sigma_t
    t_crit = r * np.sqrt(max(eta * eta - 1.0, 0.0))
    i = np.arange(PBD_SAMPLES) + 0.5
    ti = t_crit - np.log(1.0 - i / PBD_SAMPLES) / sigma_t
    d = np.sqrt(r * r + ti * ti)
    cos_o = ti / d
    e = (rho * np.exp(-sigma_t * (d + t_crit)) / (d * d)
         * _np_phase_hg(cos_o, g)
         * (1.0 - _np_fr_dielectric(-cos_o, 1.0, eta)) * np.abs(cos_o))
    return float(e.sum() / PBD_SAMPLES)


def beam_diffusion_ms(sigma_s, sigma_a, g, eta, r):
    """Multiple-scattering dipole term (tabulated_bssrdf.rs:640)."""
    sigmap_s = sigma_s * (1.0 - g)
    sigmap_t = sigma_a + sigmap_s
    rhop = sigmap_s / sigmap_t
    d_g = (2.0 * sigma_a + sigmap_s) / (3.0 * sigmap_t * sigmap_t)
    sigma_tr = np.sqrt(sigma_a / d_g)
    fm1, fm2 = _np_fm1(eta), _np_fm2(eta)
    ze = -2.0 * d_g * (1.0 + 3.0 * fm2) / (1.0 - 2.0 * fm1)
    c_phi = 0.25 * (1.0 - 2.0 * fm1)
    c_e = 0.5 * (1.0 - 3.0 * fm2)
    i = np.arange(PBD_SAMPLES) + 0.5
    zr = -np.log(1.0 - i / PBD_SAMPLES) / sigmap_t
    zv = -zr + 2.0 * ze
    dr = np.sqrt(r * r + zr * zr)
    dv = np.sqrt(r * r + zv * zv)
    phi_d = (1.0 / (4.0 * np.pi)) / d_g * (np.exp(-sigma_tr * dr) / dr
                                           - np.exp(-sigma_tr * dv) / dv)
    edn = (1.0 / (4.0 * np.pi)) * (
        zr * (1.0 + sigma_tr * dr) * np.exp(-sigma_tr * dr) / dr ** 3
        - zv * (1.0 + sigma_tr * dv) * np.exp(-sigma_tr * dv) / dv ** 3)
    e = phi_d * c_phi + edn * c_e
    kappa = 1.0 - np.exp(-2.0 * sigmap_t * (dr + zr))
    return float((kappa * rhop * rhop * e).sum() / PBD_SAMPLES)


def _catmull_rom_weights(nodes, x):
    """(offset, w[4]) spline weights (core/src/interpolation.rs)."""
    n = len(nodes)
    if not (x >= nodes[0] and x <= nodes[-1]):
        return None
    i = np.searchsorted(nodes, x, side="right") - 1
    i = min(max(i, 0), n - 2)
    x0, x1 = nodes[i], nodes[i + 1]
    t = (x - x0) / (x1 - x0) if x1 > x0 else 0.0
    t2, t3 = t * t, t * t * t
    w = np.zeros(4)
    w[1] = 2 * t3 - 3 * t2 + 1
    w[2] = -2 * t3 + 3 * t2
    if i > 0:
        w0 = (t3 - 2 * t2 + t) * (x1 - x0) / (x1 - nodes[i - 1])
        w[0] = -w0
        w[2] += w0
    else:
        w0 = t3 - 2 * t2 + t
        w[1] -= w0
        w[2] += w0
    if i + 2 < n:
        w3 = (t3 - t2) * (x1 - x0) / (nodes[i + 2] - x0)
        w[3] = w3
        w[1] -= w3
    else:
        w3 = t3 - t2
        w[2] += w3
        w[3] -= w3
    return i - 1, w


def _integrate_catmull_rom(x, v):
    """(cdf, total) of the piecewise spline (interpolation.rs
    integrate_catmull_rom)."""
    n = len(x)
    cdf = np.zeros(n)
    total = 0.0
    for i in range(n - 1):
        x0, x1 = x[i], x[i + 1]
        f0, f1 = v[i], v[i + 1]
        width = x1 - x0
        if i > 0:
            d0 = width * (v[i + 1] - v[i - 1]) / (x1 - x[i - 1])
        else:
            d0 = f1 - f0
        if i + 2 < n:
            d1 = width * (v[i + 2] - v[i]) / (x[i + 2] - x0)
        else:
            d1 = f1 - f0
        total += ((d0 - d1) * (1.0 / 12.0) + (f0 + f1) * 0.5) * width
        cdf[i + 1] = total
    return cdf, total


@_functools.lru_cache(maxsize=4)
def build_bssrdf_table(g: float = 0.0, eta: float = 1.33):
    """(rho[100], radii[64], profile[100,64], cdf[100,64], rho_eff[100]) —
    the reference's BSSRDFTable::compute_beam_diffusion."""
    radii = np.zeros(N_RADII)
    radii[1] = _R0
    for i in range(2, N_RADII):
        radii[i] = radii[i - 1] * _RATIO
    rho = (1.0 - np.exp(-8.0 * np.arange(N_RHO) / (N_RHO - 1))) \
        / (1.0 - np.exp(-8.0))
    profile = np.zeros((N_RHO, N_RADII))
    cdf = np.zeros((N_RHO, N_RADII))
    rho_eff = np.zeros(N_RHO)
    for i, rh in enumerate(rho):
        if rh > 0:
            for j, r in enumerate(radii):
                profile[i, j] = 2.0 * np.pi * r * (
                    beam_diffusion_ss(rh, 1.0 - rh, g, eta, r)
                    + beam_diffusion_ms(rh, 1.0 - rh, g, eta, r))
        cdf[i], rho_eff[i] = _integrate_catmull_rom(radii, profile[i])
    return rho, radii, profile, cdf, rho_eff


def invert_rho_eff(rho_eff_target, g=0.0, eta=1.33):
    """Albedo rho whose EFFECTIVE albedo matches the target
    (subsurface_from_diffuse / invert_catmull_rom). Vector over channels."""
    rho, _, _, _, rho_eff = build_bssrdf_table(g, eta)
    return np.interp(np.clip(rho_eff_target, 0.0, rho_eff[-1]), rho_eff, rho)


def dense_channel_rows(sigma_t, rho_ch, g=0.0, eta=1.33):
    """Per-channel (profile[3,64], cdf[3,64], rho_eff[3]) rows at the
    material's albedos: the (rho, radius) table collapsed along rho with
    Catmull-Rom weights so device code only interpolates in radius."""
    rho, radii, profile, cdf, rho_eff = build_bssrdf_table(g, eta)
    prow = np.zeros((3, N_RADII), np.float32)
    crow = np.zeros((3, N_RADII), np.float32)
    reff = np.zeros((3,), np.float32)
    for c in range(3):
        wr = _catmull_rom_weights(rho, float(np.clip(rho_ch[c], 0.0, 1.0)))
        if wr is None:
            continue
        off, w = wr
        for k in range(4):
            idx = off + k
            if 0 <= idx < N_RHO and w[k] != 0.0:
                prow[c] += w[k] * profile[idx]
                crow[c] += w[k] * cdf[idx]
                reff[c] += w[k] * rho_eff[idx]
    # numerical guard: CDFs must be monotone for inversion
    crow = np.maximum.accumulate(np.maximum(crow, 0.0), axis=1)
    return prow, crow, reff


def radii_knots():
    """The table's 64 radius knots (float32)."""
    _, radii, _, _, _ = build_bssrdf_table()
    return np.asarray(radii, np.float32)


# ---------------------------------------------------------------------------
# per-lane lookups of the collapsed rows
# ---------------------------------------------------------------------------

_LOG_RATIO = float(np.float32(np.log(_RATIO)))


def _radius_interp(rows, r_opt):
    """Linear interpolation of per-lane rows [N,64] at optical radii
    r_opt [N]: past knot 1 the knots are geometric, so the index is
    log(r / r0) / log(ratio) + 1."""
    li = torch.log(torch.clamp(r_opt, min=1e-12) / _R0) / _LOG_RATIO + 1.0
    li = torch.clamp(torch.where(r_opt <= _R0, r_opt / _R0, li), 0.0, N_RADII - 1.001)
    i0 = li.to(torch.int64)
    fr = li - i0.to(li.dtype)
    v0 = torch.gather(rows, 1, i0[:, None])[:, 0]
    v1 = torch.gather(rows, 1, torch.clamp(i0 + 1, max=N_RADII - 1)[:, None])[:, 0]
    return v0 * (1.0 - fr) + v1 * fr


def table_sr(prof_rows, sigma_t, r):
    """Sr(r) [N,3] from per-lane rows [N,3,64], sigma_t [N,3] and
    distances r [N]."""
    out = []
    for c in range(3):
        st = sigma_t[:, c]
        r_opt = r * st
        v = _radius_interp(prof_rows[:, c], r_opt)
        v = torch.where(r_opt > 1e-9, v / (2.0 * math.pi * torch.clamp(r_opt, min=1e-9)), v)
        out.append(torch.clamp(v * st * st, min=0.0))
    return torch.stack(out, -1)


def table_pdf_sr(prof_rows, rhoeff, sigma_t, r):
    """The polar pdf of table_sample_sr per channel [N,3] at radii r [N]."""
    out = []
    for c in range(3):
        st = sigma_t[:, c]
        r_opt = r * st
        v = _radius_interp(prof_rows[:, c], r_opt)
        v = torch.where(r_opt > 1e-9, v / (2.0 * math.pi * torch.clamp(r_opt, min=1e-9)), 0.0)
        out.append(torch.clamp(v * st * st / torch.clamp(rhoeff[:, c], min=1e-9), min=0.0))
    return torch.stack(out, -1)


def table_sample_sr(cdf_rows, rhoeff, sigma_t_ch, radii, u):
    """Invert each lane's channel CDF row [N,64] (monotone) at u [N] ->
    world radius [N]; rhoeff, sigma_t_ch [N] are the channel's, radii the
    [64] knots."""
    target = u * torch.clamp(rhoeff, min=1e-12)
    idx = torch.clamp((cdf_rows < target[:, None]).to(torch.int64).sum(-1) - 1, 0, N_RADII - 2)
    c0 = torch.gather(cdf_rows, 1, idx[:, None])[:, 0]
    c1 = torch.gather(cdf_rows, 1, (idx + 1)[:, None])[:, 0]
    r0, r1 = radii[idx], radii[idx + 1]
    fr = torch.clamp((target - c0) / torch.clamp(c1 - c0, min=1e-12), 0.0, 1.0)
    r_opt = r0 + fr * (r1 - r0)
    return r_opt / torch.clamp(sigma_t_ch, min=1e-9)
