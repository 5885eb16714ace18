"""Colour conversions (port of pbrt_tpu/core/spectrum.py): the host
helpers that the .pbrt front end needs, luminance, the sRGB transfer, and
the sampled-spectrum mode.

A spectrum on the device is a [..., C] tensor: C = 3 (RGB) by default, and
C = N_SPECTRAL_SAMPLES under `Integrator ... "bool spectral" "true"`, where
the integrators widen material and light colours at their boundaries
(rgb_to_spectrum, materials.lift_lobes) and narrow the radiance back to RGB
at the film (spectrum_to_rgb). The lift mixes seven smooth basis spectra
(white, cyan, magenta, yellow, red, green, blue) by the sorted channels of
the colour, as Smits' method does; each basis is solved on the host as the
smoothest spectrum whose film RGB equals its target colour (_solve_bases).
"""
from __future__ import annotations

import numpy as np
import torch

N_SPECTRAL_SAMPLES = 60
LAMBDA_START, LAMBDA_END = 400.0, 700.0

XYZ_TO_RGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311]], np.float32)
RGB_TO_Y = (0.212671, 0.715160, 0.072169)


def luminance(rgb):
    """Y of linear RGB [..., 3] (the reference's RGBSpectrum::y()), summed
    in channel order as the reference's reduction adds."""
    return rgb[..., 0] * RGB_TO_Y[0] + rgb[..., 1] * RGB_TO_Y[1] + rgb[..., 2] * RGB_TO_Y[2]


def xyz_to_rgb(xyz):
    return np.asarray(xyz, np.float32) @ XYZ_TO_RGB.T


def _g(x, alpha, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    t = (x - mu) / s
    return alpha * np.exp(-0.5 * t * t)


def cie_xyz_bar(lam):
    """CIE 1931 matching values at wavelengths lam [nm] (analytic fits of
    Wyman, Sloan and Shirley 2013)."""
    lam = np.asarray(lam, np.float64)
    x = _g(lam, 1.056, 599.8, 37.9, 31.0) + _g(lam, 0.362, 442.0, 16.0, 26.7) \
        + _g(lam, -0.065, 501.1, 20.4, 26.2)
    y = _g(lam, 0.821, 568.8, 46.9, 40.5) + _g(lam, 0.286, 530.9, 16.3, 31.1)
    z = _g(lam, 1.217, 437.0, 11.8, 36.0) + _g(lam, 0.681, 459.0, 26.0, 13.8)
    return np.stack([x, y, z], -1)


def blackbody(lam_nm, t_kelvin):
    """Planck's law at wavelength lam [nm], temperature T [K]."""
    lam = np.asarray(lam_nm, np.float64) * 1e-9
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    return (2.0 * h * c * c) / (lam ** 5 * np.expm1((h * c) / (lam * kb * t_kelvin)))


def blackbody_normalized_rgb(t_kelvin, scale=1.0):
    """RGB of a blackbody at T normalized to a peak of 1, times scale."""
    lam = np.linspace(360.0, 830.0, 128)
    le = blackbody(lam, t_kelvin)
    lam_max = 2.8977721e-3 / t_kelvin * 1e9
    le = le / blackbody(np.array([lam_max]), t_kelvin)[0]
    xyz = (cie_xyz_bar(lam) * le[:, None]).sum(0) / cie_xyz_bar(lam)[:, 1].sum()
    rgb = np.asarray(xyz, np.float32) @ XYZ_TO_RGB.T
    return np.maximum(rgb * scale, 0.0).astype(np.float32)


def spd_to_rgb(lambdas, values):
    """Piecewise-linear SPD samples -> RGB."""
    lambdas = np.asarray(lambdas, np.float64)
    values = np.asarray(values, np.float64)
    order = np.argsort(lambdas)
    lambdas, values = lambdas[order], values[order]
    lam = np.linspace(360.0, 830.0, 471)
    v = np.interp(lam, lambdas, values, left=values[0], right=values[-1])
    bar = cie_xyz_bar(lam)
    xyz = (bar * v[:, None]).sum(0) / bar[:, 1].sum()
    rgb = np.asarray(xyz, np.float32) @ XYZ_TO_RGB.T
    return np.maximum(rgb, 0.0).astype(np.float32)


def gamma_correct(v):
    """Linear -> sRGB transfer of a tensor."""
    return torch.where(v <= 0.0031308, 12.92 * v,
                       1.055 * torch.pow(torch.clamp(v, min=1e-8), 1.0 / 2.4) - 0.055)


def inverse_gamma_correct(v):
    """sRGB -> linear transfer of a tensor."""
    return torch.where(v <= 0.04045, v / 12.92, torch.pow((v + 0.055) / 1.055, 2.4))


# ---- sampled spectra ----

_SPECTRAL_CACHE = {}


def spectral_lambdas():
    """Bin-centre wavelengths [nm] of the sampled representation."""
    i = np.arange(N_SPECTRAL_SAMPLES) + 0.5
    return LAMBDA_START + (LAMBDA_END - LAMBDA_START) * i / N_SPECTRAL_SAMPLES


def _solve_bases(Q, At, targets):
    """Smoothest-metamer bases: min s^T Q s subject to At s = target, for
    each target. An active-set loop clamps the negative bins to 0 and
    solves again on the free bins, so the film RGB of a saturated basis
    stays exact (numpy float64)."""
    C = Q.shape[0]
    bases = []
    for t in targets:
        free = np.ones(C, bool)
        s = np.zeros(C)
        for _ in range(6):
            F = np.flatnonzero(free)
            Qf = Q[np.ix_(F, F)]
            Af = At[:, F]
            KKTf = np.block([[Qf, Af.T], [Af, np.zeros((3, 3))]])
            rhs = np.concatenate([np.zeros(len(F)), t])
            try:
                sol = np.linalg.solve(KKTf, rhs)[:len(F)]
            except np.linalg.LinAlgError:
                break
            s = np.zeros(C)
            s[F] = sol
            neg = s < -1e-9
            if not neg.any():
                break
            free &= ~neg
        bases.append(np.maximum(s, 0.0))
    return np.stack(bases)


def _spectral_tables():
    """(to_rgb [C,3], illuminant bases [7,C], reflectance bases [7,C]),
    float32 numpy, solved once. The illuminant bases map to their target
    RGB under the film's conversion; the reflectance bases do so once
    multiplied by the white illuminant basis, so a white light's first
    bounce gives the RGB render's colour."""
    if "tabs" in _SPECTRAL_CACHE:
        return _SPECTRAL_CACHE["tabs"]
    C = N_SPECTRAL_SAMPLES
    bar = cie_xyz_bar(spectral_lambdas())
    y_int = bar[:, 1].sum()
    # the film's operator: rgb = (s @ bar / y_int) @ XYZ_TO_RGB^T
    A = (bar / y_int).astype(np.float64) @ XYZ_TO_RGB.astype(np.float64).T
    D = np.zeros((C - 2, C))
    for i in range(C - 2):
        D[i, i:i + 3] = (1.0, -2.0, 1.0)
    Q = D.T @ D + 1e-6 * np.eye(C)
    targets = np.array([[1, 1, 1], [0, 1, 1], [1, 0, 1], [1, 1, 0],
                        [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64)
    illum = _solve_bases(Q, A.T, targets)
    refl = _solve_bases(Q, (A * illum[0][:, None]).T, targets)
    tabs = (A.astype(np.float32), illum.astype(np.float32), refl.astype(np.float32))
    _SPECTRAL_CACHE["tabs"] = tabs
    return tabs


def _device_table(i, device):
    key = (i, str(device))
    if key not in _SPECTRAL_CACHE:
        _SPECTRAL_CACHE[key] = torch.as_tensor(_spectral_tables()[i], device=device)
    return _SPECTRAL_CACHE[key]


def spectrum_to_rgb(s):
    """[..., C] sampled spectrum -> [..., 3] linear RGB (the film's side)."""
    return s @ _device_table(0, s.device)


def rgb_to_spectrum(rgb, clamp: bool = True, reflectance: bool = False):
    """[..., 3] RGB -> [..., C] sampled spectrum: the smallest channel's
    share of white, the middle one's excess of the secondary of the two
    larger channels, and the largest one's excess of its primary (ties: R
    is smallest before G before B; among the two larger, the first of a
    tie takes the middle). reflectance: the reflectance bases (material
    colours), else the illuminant bases (emission)."""
    B = _device_table(2 if reflectance else 1, rgb.device)
    w, c, m, y, r, g, b = (B[i] for i in range(7))
    R, G, Bl = rgb[..., 0:1], rgb[..., 1:2], rgb[..., 2:3]

    def mix(lo, mid_c, mid_s, hi_c, hi_s):
        return lo * w + (mid_c - lo) * mid_s + (hi_c - mid_c) * hi_s

    s_r = torch.where(G <= Bl, mix(R, G, c, Bl, b), mix(R, Bl, c, G, g))
    s_g = torch.where(R <= Bl, mix(G, R, m, Bl, b), mix(G, Bl, m, R, r))
    s_b = torch.where(R <= G, mix(Bl, R, y, G, g), mix(Bl, G, y, R, r))
    r_min = (R <= G) & (R <= Bl)
    g_min = (G <= R) & (G <= Bl) & ~r_min
    s = torch.where(r_min, s_r, torch.where(g_min, s_g, s_b))
    return torch.clamp(s, min=0.0) if clamp else s
