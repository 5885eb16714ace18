"""Host colour conversions that the .pbrt front end needs (port of the numpy
helpers of pbrt_tpu/core/spectrum.py), and luminance. The device spectrum
is RGB."""
from __future__ import annotations

import numpy as np

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
