"""FourierBSDF: the binary .bsdf table reader and its wavefront evaluation
(port of pbrt_tpu/materials/fourier.py).

The file is pbrt-v3's "SCATFUN" format (a header, the mu grid, a cdf block
and sparse per-(mu_i, mu_o) Fourier coefficient lists). As in the
reference, the table is densified at scene build into one
[n_mu, n_mu, m, 3] array (m capped at M_CAP harmonics), so a wavefront
evaluates with a Catmull-Rom 4x4 gather and a cosine series over the
table's largest order: a lane whose own series is shorter reads zeros past
its end. Sampling draws mu_i from the piecewise-linear marginal of the
luminance a0 grid (closed-form inversion per segment) and the azimuth by a
fixed-depth bisection of the series' analytic CDF. Every gather index is
clamped into its table.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

M_CAP = 128
PHI_BISECT = 20


@dataclasses.dataclass
class FourierTable:
    """Dense tables, leading axis the table id (one per fourier material).
    a0y is the luminance 0th coefficient (i = mu_i, j = mu_o) and cdf its
    running trapezoid integral over mu_i, built from the densified
    coefficients."""
    mu: torch.Tensor     # [B, K] zenith-cosine grid (padded strictly increasing)
    a: torch.Tensor      # [B, K, K, m, 3] cosine-series coefficients
    eta: torch.Tensor    # [B]
    n_mu: torch.Tensor   # [B] int valid grid size
    a0y: torch.Tensor    # [B, K, K]
    cdf: torch.Tensor    # [B, K, K]


def read_bsdf_file(path: str):
    """Parse one .bsdf file -> dict(mu [n], a [n,n,m,3], eta, m_max)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != b"SCATFUN\x01":
        raise ValueError(f"{path}: bad magic")
    (flags, n_mu, n_coeffs, m_max, n_channels, n_bases,
     _u0, _u1, _u2) = struct.unpack_from("<9i", raw, 8)
    (eta,) = struct.unpack_from("<f", raw, 8 + 36)
    off = 8 + 36 + 4 + 16   # magic, 9 ints, eta, 4 unused ints
    if flags != 1 or n_bases != 1 or n_channels not in (1, 3):
        raise ValueError(f"{path}: unsupported layout "
                         f"(flags={flags} bases={n_bases} ch={n_channels})")
    mu = np.frombuffer(raw, "<f4", n_mu, off)
    off += 4 * n_mu
    off += 4 * n_mu * n_mu   # the file's cdf block (the sampler builds its own)
    oal = np.frombuffer(raw, "<i4", 2 * n_mu * n_mu, off).reshape(-1, 2)
    off += 8 * n_mu * n_mu
    a = np.frombuffer(raw, "<f4", n_coeffs, off)
    m_cap = min(m_max, M_CAP)
    dense = np.zeros((n_mu, n_mu, m_cap, 3), np.float32)
    for idx in range(n_mu * n_mu):
        o, ln = oal[idx]
        if ln <= 0:
            continue
        i, j = idx // n_mu, idx % n_mu
        m = min(ln, m_cap)
        if n_channels == 1:
            dense[i, j, :m, :] = a[o:o + m, None]
        else:
            # channel order Y, R, B; G from the luminance fit
            y, r, b = a[o:o + m], a[o + ln:o + ln + m], a[o + 2 * ln:o + 2 * ln + m]
            dense[i, j, :m, 0] = r
            dense[i, j, :m, 1] = 1.39829 * y - 0.100913 * r - 0.297375 * b
            dense[i, j, :m, 2] = b
    return dict(mu=mu.copy(), a=dense, eta=float(eta), m_max=m_max)


def fourier_tables(tables: list) -> dict:
    """Host: the read tables -> padded numpy arrays (keys mu, a, eta, n_mu,
    a0y, cdf); a scene without a table gets the reference's 2-node
    placeholder."""
    if not tables:
        return dict(mu=np.array([[-1.0, 1.0]], np.float32),
                    a=np.zeros((1, 2, 2, 1, 3), np.float32), eta=np.ones(1, np.float32),
                    n_mu=np.full(1, 2, np.int32), a0y=np.zeros((1, 2, 2), np.float32),
                    cdf=np.zeros((1, 2, 2), np.float32))
    K = max(t["mu"].shape[0] for t in tables)
    m_max = max(t["a"].shape[2] for t in tables)
    B = len(tables)
    mu = np.ones((B, K), np.float32)
    a = np.zeros((B, K, K, m_max, 3), np.float32)
    eta = np.ones(B, np.float32)
    nm = np.zeros(B, np.int32)
    a0y = np.zeros((B, K, K), np.float32)
    cdf = np.zeros((B, K, K), np.float32)
    for b, t in enumerate(tables):
        n = t["mu"].shape[0]
        mu[b, :n] = t["mu"]
        mu[b, n:] = t["mu"][-1] + np.arange(1, K - n + 1)   # strictly increasing
        a[b, :n, :n, :t["a"].shape[2]] = t["a"]
        eta[b] = t["eta"]
        nm[b] = n
        r0, g0, b0 = t["a"][:, :, 0, 0], t["a"][:, :, 0, 1], t["a"][:, :, 0, 2]
        y0 = np.maximum((g0 + 0.100913 * r0 + 0.297375 * b0) / 1.39829, 0.0)
        a0y[b, :n, :n] = y0
        dmu = np.diff(t["mu"]).astype(np.float64)
        seg = 0.5 * (y0[:-1, :] + y0[1:, :]) * dmu[:, None]
        cdf[b, 1:n, :n] = np.cumsum(seg, axis=0)
        cdf[b, n:, :n] = cdf[b, n - 1, :n]
    return dict(mu=mu, a=a, eta=eta, n_mu=nm, a0y=a0y, cdf=cdf)


def table_on(t: dict, device) -> FourierTable:
    return FourierTable(*(torch.as_tensor(np.array(t[k]), device=device)
                          for k in ("mu", "a", "eta", "n_mu", "a0y", "cdf")))


def _lane_take(rows, idx):
    """rows [N, K] gathered at per-lane idx [N]."""
    return rows.gather(1, idx[:, None])[:, 0]


def _catmull_rom_weights(nodes, n_valid, x):
    """Per-lane interval and the 4 spline weights over the padded node grid
    -> (first offset idx-1 [N], weights [N, 4])."""
    K = nodes.shape[1]
    idx = (nodes <= x[:, None]).sum(1) - 1
    idx = torch.minimum(torch.clamp(idx, min=0), n_valid - 2)
    x0 = _lane_take(nodes, idx)
    x1 = _lane_take(nodes, torch.clamp(idx + 1, max=K - 1))
    t = torch.clamp((x - x0) / torch.clamp(x1 - x0, min=1e-12), 0.0, 1.0)
    t2, t3 = t * t, t * t * t
    w1 = 2 * t3 - 3 * t2 + 1
    w2 = -2 * t3 + 3 * t2
    has_m1 = idx > 0
    has_p2 = idx + 2 < n_valid
    xm1 = _lane_take(nodes, torch.clamp(idx - 1, min=0))
    x2v = _lane_take(nodes, torch.clamp(idx + 2, max=K - 1))
    d0 = t3 - 2 * t2 + t
    d1 = t3 - t2
    dx = x1 - x0
    w0 = torch.where(has_m1, -d0 * dx / torch.clamp(x1 - xm1, min=1e-12), 0.0)
    w1 = w1 + torch.where(has_m1, 0.0, -d0)
    w2c = w2 + torch.where(has_m1, d0 * dx / torch.clamp(x1 - xm1, min=1e-12), d0)
    w3 = torch.where(has_p2, d1 * dx / torch.clamp(x2v - x0, min=1e-12), 0.0)
    w1c = w1 + torch.where(has_p2, -d1 * dx / torch.clamp(x2v - x0, min=1e-12), -d1)
    w2c = w2c + torch.where(has_p2, 0.0, d1)
    return idx - 1, torch.stack([w0, w1c, w2c, w3], -1)


def _cos_dphi(wo, wi):
    """cos of the azimuth difference of (-wi, wo)."""
    mu_i, mu_o = -wi[:, 2], wo[:, 2]
    sin_i = torch.sqrt(torch.clamp(1 - mu_i * mu_i, min=0.0))
    sin_o = torch.sqrt(torch.clamp(1 - mu_o * mu_o, min=0.0))
    cos_phi_i = torch.where(sin_i > 1e-6, -wi[:, 0] / torch.clamp(sin_i, min=1e-12), 1.0)
    sin_phi_i = torch.where(sin_i > 1e-6, -wi[:, 1] / torch.clamp(sin_i, min=1e-12), 0.0)
    cos_phi_o = torch.where(sin_o > 1e-6, wo[:, 0] / torch.clamp(sin_o, min=1e-12), 1.0)
    sin_phi_o = torch.where(sin_o > 1e-6, wo[:, 1] / torch.clamp(sin_o, min=1e-12), 0.0)
    return torch.clamp(cos_phi_i * cos_phi_o + sin_phi_i * sin_phi_o, -1.0, 1.0)


def _blend_ak(tab: FourierTable, tid, mu_i, mu_o):
    """Catmull-Rom 4x4 blend of the coefficient table -> ak [N, m, 3]."""
    nodes = tab.mu[tid]
    n_valid = tab.n_mu[tid]
    oi, wi = _catmull_rom_weights(nodes, n_valid, mu_i)
    oj, wj = _catmull_rom_weights(nodes, n_valid, mu_o)
    K = nodes.shape[1]
    ak = 0.0
    for a4 in range(4):
        for b4 in range(4):
            ii = torch.clamp(oi + a4, 0, K - 1)
            jj = torch.clamp(oj + b4, 0, K - 1)
            ak = ak + (wi[:, a4] * wj[:, b4])[:, None, None] * tab.a[tid, ii, jj]
    return ak


def _series(ak, cos_phi):
    """sum_k ak[:, k] cos(k phi) by the double-angle recurrence; ak [N, m]
    or [N, m, 3]."""
    m = ak.shape[1]
    bc = (lambda c: c[:, None]) if ak.dim() == 3 else (lambda c: c)
    c_km1 = torch.ones_like(cos_phi)
    c_k = cos_phi
    out = ak[:, 0] * bc(c_km1)
    if m > 1:
        out = out + ak[:, 1] * bc(c_k)
    for k in range(2, m):
        c_next = 2.0 * cos_phi * c_k - c_km1
        out = out + ak[:, k] * bc(c_next)
        c_km1, c_k = c_k, c_next
    return out


def _ak_lum(ak):
    """Luminance coefficients from the rgb ones (inverse of the G fit)."""
    return (ak[:, :, 1] + 0.100913 * ak[:, :, 0] + 0.297375 * ak[:, :, 2]) / 1.39829


def eval_fourier(tab: FourierTable, table_id, wo, wi):
    """f(wo, wi) [N,3] for per-lane table ids; 0 where table_id < 0."""
    tid = torch.clamp(table_id, min=0).to(torch.int64)
    mu_i = -wi[:, 2]
    ak = _blend_ak(tab, tid, mu_i, wo[:, 2])
    out = _series(ak, _cos_dphi(wo, wi)) / torch.clamp(torch.abs(mu_i), min=1e-6)[:, None]
    return torch.where((table_id >= 0)[:, None], torch.clamp(out, min=0.0), 0.0)


def _mu_marginal(tab: FourierTable, tid, mu_o):
    """The piecewise-linear marginal over mu_i at mu_o -> (nodes [N,K],
    density y [N,K], cdf [N,K], total [N])."""
    nodes = tab.mu[tid]
    n_valid = tab.n_mu[tid]
    K = nodes.shape[1]
    j = (nodes <= mu_o[:, None]).sum(1) - 1
    j = torch.minimum(torch.clamp(j, min=0), n_valid - 2)
    j1 = torch.clamp(j + 1, max=K - 1)
    x0 = _lane_take(nodes, j)
    x1 = _lane_take(nodes, j1)
    t = torch.clamp((mu_o - x0) / torch.clamp(x1 - x0, min=1e-12), 0.0, 1.0)
    y = (1 - t)[:, None] * tab.a0y[tid, :, j] + t[:, None] * tab.a0y[tid, :, j1]
    cdf = (1 - t)[:, None] * tab.cdf[tid, :, j] + t[:, None] * tab.cdf[tid, :, j1]
    total = _lane_take(cdf, (n_valid - 1).to(torch.int64))
    return nodes, y, cdf, total


def _segment(nodes, y, n_valid, i):
    """Segment i's ends and density at its ends."""
    K = nodes.shape[1]
    i = torch.minimum(torch.clamp(i, min=0), n_valid - 2)
    i1 = torch.clamp(i + 1, max=K - 1)
    return i, _lane_take(nodes, i), _lane_take(nodes, i1), _lane_take(y, i), _lane_take(y, i1)


def sample_fourier_bsdf(tab: FourierTable, table_id, wo, u2, u_flip):
    """Importance-sample the FourierBSDF -> (wi [N,3], pdf [N]); the pdf
    is also pdf_fourier's of the returned direction."""
    tid = torch.clamp(table_id, min=0).to(torch.int64)
    mu_o = wo[:, 2]
    nodes, y, cdf, total = _mu_marginal(tab, tid, mu_o)
    n_valid = tab.n_mu[tid].to(torch.int64)
    u = u2[:, 0] * torch.clamp(total, min=1e-12)
    i, x0, x1, yl, yr = _segment(nodes, y, n_valid, (cdf <= u[:, None]).sum(1) - 1)
    cl = _lane_take(cdf, i)
    dx = torch.clamp(x1 - x0, min=1e-12)
    du = torch.clamp(u - cl, min=0.0)
    k_slope = (yr - yl) / dx
    # 0.5 k s^2 + yl s = du, in its stable form
    disc = torch.sqrt(torch.clamp(yl * yl + 2.0 * k_slope * du, min=0.0))
    s = torch.minimum(torch.clamp(2.0 * du / torch.clamp(yl + disc, min=1e-12), min=0.0), dx)
    mu_i = x0 + s
    pdf_mu = (yl + k_slope * s) / torch.clamp(total, min=1e-12)

    ak_y = _ak_lum(_blend_ak(tab, tid, mu_i, mu_o))
    m = ak_y.shape[1]
    a0 = torch.clamp(ak_y[:, 0], min=1e-12)
    v = torch.clamp(u2[:, 1], max=0.999999)

    def cdf_phi(phi):
        """(a0 phi + sum_k ak sin(k phi) / k) / (pi a0) on [0, pi]."""
        cos1 = torch.cos(phi)
        acc = a0 * phi
        s_km1 = torch.zeros_like(phi)
        s_k = torch.sin(phi)
        if m > 1:
            acc = acc + ak_y[:, 1] * s_k
        for k in range(2, m):
            s_next = 2.0 * cos1 * s_k - s_km1
            acc = acc + ak_y[:, k] * s_next / k
            s_km1, s_k = s_k, s_next
        return acc / (np.pi * a0)

    lo = torch.zeros_like(mu_o)
    hi = torch.full_like(mu_o, np.pi)
    for _ in range(PHI_BISECT):
        mid = 0.5 * (lo + hi)
        below = cdf_phi(mid) < v
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    phi = 0.5 * (lo + hi)
    phi = torch.where(u_flip < 0.5, -phi, phi)
    fy = torch.clamp(_series(ak_y, torch.cos(phi)), min=0.0)
    pdf = pdf_mu * (fy / (2.0 * np.pi * a0))

    # wo's azimuth turned by phi, then negated
    sin_i = torch.sqrt(torch.clamp(1 - mu_i * mu_i, min=0.0))
    sin_o = torch.sqrt(torch.clamp(1 - mu_o * mu_o, min=0.0))
    cpo = torch.where(sin_o > 1e-6, wo[:, 0] / torch.clamp(sin_o, min=1e-12), 1.0)
    spo = torch.where(sin_o > 1e-6, wo[:, 1] / torch.clamp(sin_o, min=1e-12), 0.0)
    sp, cp = torch.sin(phi), torch.cos(phi)
    wi = -torch.stack([sin_i * (cp * cpo - sp * spo), sin_i * (sp * cpo + cp * spo), mu_i], -1)
    return wi, torch.where((table_id >= 0) & (total > 1e-12), pdf, 0.0)


def pdf_fourier(tab: FourierTable, table_id, wo, wi):
    """Density of sample_fourier_bsdf at (wo, wi) [N]."""
    tid = torch.clamp(table_id, min=0).to(torch.int64)
    mu_i, mu_o = -wi[:, 2], wo[:, 2]
    nodes, y, cdf, total = _mu_marginal(tab, tid, mu_o)
    n_valid = tab.n_mu[tid].to(torch.int64)
    _, x0, x1, yl, yr = _segment(nodes, y, n_valid, (nodes <= mu_i[:, None]).sum(1) - 1)
    t = torch.clamp((mu_i - x0) / torch.clamp(x1 - x0, min=1e-12), 0.0, 1.0)
    pdf_mu = (yl + (yr - yl) * t) / torch.clamp(total, min=1e-12)
    ak_y = _ak_lum(_blend_ak(tab, tid, mu_i, mu_o))
    a0 = torch.clamp(ak_y[:, 0], min=1e-12)
    fy = torch.clamp(_series(ak_y, _cos_dphi(wo, wi)), min=0.0)
    pdf = pdf_mu * fy / (2.0 * np.pi * a0)
    return torch.where((table_id >= 0) & (total > 1e-12), pdf, 0.0)
