"""The realistic camera: a lens system of spherical elements (port of
pbrt_tpu/cameras/realistic.py).

Lens table rows, front to rear: curvature radius, thickness, eta and
aperture diameter in mm; radius 0 is the aperture stop. The built-in
prescription is the 50 mm double-Gauss design. `focus_lens_system` sets
the rear gap by the reference's bisection on where an off-axis film ray
crosses the axis, then bounds the exit pupil per film radius bin by
tracing seeded ray grids: host work, done once per scene with the same
float32 trace as the rays. The bisection steps the gap the wrong way, so
it ends at its 1e-4 m floor, no seeded ray passes, and every ray weighs 0:
the reference's images are black, and so are the port's (ROADMAP.md C).
`trace_from_film` steps the elements rear to front as an unrolled loop,
each step branch-free over the wavefront.

As in the reference, a `lensfile` is opened relative to the process's
working directory (not the scene file's), and a file that cannot be read
gives the built-in lens.
"""
from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.core.math import normalize

# 50 mm double-Gauss prescription (radius, thickness, eta, diameter), mm
DGAUSS_50MM = np.array([
    [58.950, 7.520, 1.670, 50.4],
    [169.660, 0.240, 1.000, 50.4],
    [38.550, 8.050, 1.670, 46.0],
    [81.540, 6.550, 1.699, 40.0],
    [25.500, 11.410, 1.000, 36.0],
    [0.0, 9.000, 0.000, 34.2],
    [-28.990, 2.360, 1.603, 34.0],
    [81.540, 12.130, 1.658, 40.0],
    [-40.770, 0.380, 1.000, 40.0],
    [874.130, 6.440, 1.717, 46.0],
    [-79.460, 72.228, 1.000, 46.0],
], np.float64)
FILM_DIAG = 0.035    # metres
PUPIL_BINS = 32      # exit pupil bounds per film radius bin
PUPIL_RAYS = 512     # seeded rays a bin


def load_lens_system(params: dict) -> np.ndarray:
    """[n,4] rows (curvature radius, thickness, eta, aperture radius), in
    metres, front to rear, the stop's aperture clamped by
    "aperturediameter" (mm)."""
    fname = params.get("lensfile", [""])[0] if "lensfile" in params else ""
    table = None
    if fname:
        try:
            rows = []
            with open(fname) as f:
                for line in f:
                    line = line.split("#")[0].strip()
                    if line:
                        rows.append([float(x) for x in line.split()])
            table = np.asarray(rows, np.float64)
        except OSError:
            table = None
    if table is None:
        table = DGAUSS_50MM.copy()
    lens = np.zeros_like(table)
    lens[:, 0] = table[:, 0] * 1e-3
    lens[:, 1] = table[:, 1] * 1e-3
    lens[:, 2] = np.where(table[:, 2] == 0.0, 0.0, table[:, 2])
    lens[:, 3] = table[:, 3] * 1e-3 / 2.0
    ap = params.get("aperturediameter")
    if ap is not None:
        for i in range(len(lens)):
            if lens[i, 0] == 0.0:
                lens[i, 3] = min(lens[i, 3], float(ap[0]) * 1e-3 / 2.0)
    return lens


def _sum3(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def trace_from_film(lens, o, d):
    """Rays from the film (at z = 0, the lens toward -z) through the
    elements, rear to front: o, d [N,3] -> (ok [N], origin, direction) in
    camera space (+z toward the scene)."""
    element_z = 0.0
    ok = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    zvec = lambda z: torch.tensor([0.0, 0.0, z], device=o.device)
    for i in range(len(lens) - 1, -1, -1):
        radius, thickness, eta, ap_r = (float(lens[i, j]) for j in range(4))
        element_z -= thickness
        is_stop = radius == 0.0
        if is_stop:
            t = (element_z - o[:, 2]) / torch.where(torch.abs(d[:, 2]) < 1e-12, 1e-12, d[:, 2])
        else:
            oc = o - zvec(element_z + radius)
            a = _sum3(d, d)
            b = 2.0 * _sum3(oc, d)
            c = _sum3(oc, oc) - radius * radius
            disc = b * b - 4 * a * c
            has = disc >= 0.0
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            q = torch.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
            t0 = q / torch.where(a == 0, 1e-12, a)
            t1 = c / torch.where(q == 0, 1e-12, q)
            use_closer = (d[:, 2] > 0.0) ^ (radius < 0.0)
            t = torch.where(use_closer, torch.minimum(t0, t1), torch.maximum(t0, t1))
            ok = ok & has & (t > 0.0)
        p = o + d * t[:, None]
        r2 = p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]
        ok = ok & (r2 <= ap_r * ap_r)
        if not is_stop:
            n = normalize(p - zvec(element_z + radius))
            n = torch.where((_sum3(n, -d) < 0.0)[:, None], -n, n)
            eta_i = eta if eta != 0 else 1.0
            eta_t = float(lens[i - 1, 2]) if i > 0 and lens[i - 1, 2] != 0 else 1.0
            ratio = eta_i / eta_t if eta_t != 0 else eta_i
            wi = -normalize(d)
            cos_i = _sum3(n, wi)
            sin2_t = ratio * ratio * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
            tir = sin2_t >= 1.0
            cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
            wt = ratio * (-wi) + (ratio * cos_i - cos_t)[:, None] * n
            ok = ok & ~tir
            d = normalize(wt)
        o = p
    flip = torch.tensor([1.0, 1.0, -1.0], device=o.device)
    return ok, o * flip, normalize(d * flip)


def _normalize_np(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def _trace_np(lens, o, d):
    """trace_from_film on the host: float64 arrays in, float32 trace,
    float64 arrays out."""
    ok, oc, dc = trace_from_film(lens, torch.as_tensor(np.asarray(o, np.float32)),
                                 torch.as_tensor(np.asarray(d, np.float32)))
    return ok.numpy(), oc.numpy().astype(np.float64), dc.numpy().astype(np.float64)


def focus_thick_lens(lens, focus_distance):
    """The lens with its rear gap (film to rear element) set by 40 steps of
    bisection in [1e-4, 0.3] m, so that a film ray toward a quarter of the
    rear aperture crosses the axis at focus_distance."""
    rear_ap = float(lens[-1, 3])
    lens2 = lens.copy()
    lo_gap, hi_gap = 1e-4, 0.3
    for _ in range(40):
        mid = 0.5 * (lo_gap + hi_gap)
        lens2[-1, 1] = mid
        d = _normalize_np(np.array([[rear_ap * 0.25, 0.0, -(mid + 1e-4)]]))
        ok, o2, d2 = _trace_np(lens2, np.zeros((1, 3)), d)
        if not ok[0]:
            hi_gap = mid
            continue
        t_axis = -o2[0, 0] / d2[0, 0] if abs(d2[0, 0]) > 1e-12 else 1e9
        z_cross = o2[0, 2] + t_axis * d2[0, 2]
        if z_cross > focus_distance:
            lo_gap = mid
        else:
            hi_gap = mid
    lens2[-1, 1] = 0.5 * (lo_gap + hi_gap)
    return lens2


def focus_lens_system(lens, focus_distance):
    """Focus, then bound the exit pupil -> (focused lens [n,4], bounds
    [PUPIL_BINS,4] f32: x0, x1, y0, y1 on the rear element's plane, per
    film radius bin, padded by a tenth of the rear aperture; the whole
    rear aperture where no seeded ray got through)."""
    lens = focus_thick_lens(lens, focus_distance)
    rear_ap = float(lens[-1, 3])
    rear_z = -float(lens[-1, 1])
    bounds = np.zeros((PUPIL_BINS, 4), np.float32)
    rng = np.random.default_rng(0)
    for b in range(PUPIL_BINS):
        r0 = b / PUPIL_BINS * FILM_DIAG / 2.0
        r1 = (b + 1) / PUPIL_BINS * FILM_DIAG / 2.0
        n = PUPIL_RAYS
        fx = rng.uniform(r0, r1, n)
        lx = rng.uniform(-1.5 * rear_ap, 1.5 * rear_ap, (n, 2))
        o = np.stack([fx, np.zeros(n), np.zeros(n)], -1)
        d = np.stack([lx[:, 0] - fx, lx[:, 1], np.full(n, rear_z)], -1)
        ok, _, _ = _trace_np(lens, o, _normalize_np(d))
        if ok.any():
            sel = lx[ok]
            pad = 0.1 * rear_ap
            bounds[b] = [sel[:, 0].min() - pad, sel[:, 0].max() + pad,
                         sel[:, 1].min() - pad, sel[:, 1].max() + pad]
        else:
            bounds[b] = [-rear_ap, rear_ap, -rear_ap, rear_ap]
    return lens, bounds


def realistic_rays(spec, p_film, u_lens):
    """Raster positions [N,2] and lens samples [N,2] -> camera-space
    (origin [N,3], direction [N,3], weight [N]): the film point (the image
    turned 180 degrees), a point of its bin's exit pupil bounds turned to
    the film point's azimuth, and the trace through the lens. A ray the
    lens stops weighs 0; one that passes weighs 1 with simple weighting,
    else cos^4 times the bounds' area over the rear distance squared."""
    lens, bounds = spec.lens_elements, spec.exit_pupil
    film_diag = FILM_DIAG
    resx, resy = spec.resolution
    n = p_film.shape[0]
    dev = p_film.device
    aspect = resy / resx
    film_w = film_diag / np.sqrt(1.0 + aspect * aspect)
    film_h = film_w * aspect
    sx = (p_film[:, 0] / resx - 0.5) * float(np.float32(film_w))
    sy = -((p_film[:, 1] / resy - 0.5) * float(np.float32(film_h)))
    px, py = -sx, -sy
    r_film = torch.sqrt(px * px + py * py)
    nb = bounds.shape[0]
    bin_idx = torch.clamp((r_film / (film_diag / 2.0) * nb).to(torch.int64), 0, nb - 1)
    bb = torch.as_tensor(bounds, device=dev)[bin_idx]
    lx = bb[:, 0] + u_lens[:, 0] * (bb[:, 1] - bb[:, 0])
    ly = bb[:, 2] + u_lens[:, 1] * (bb[:, 3] - bb[:, 2])
    far = r_film > 1e-9
    rm = torch.clamp(r_film, min=1e-9)
    sin_r = torch.where(far, py / rm, 0.0)
    cos_r = torch.where(far, px / rm, 1.0)
    plx = cos_r * lx - sin_r * ly
    ply = sin_r * lx + cos_r * ly
    rear_z = -float(lens[-1, 1])
    o = torch.stack([px, py, torch.zeros(n, device=dev)], -1)
    d = normalize(torch.stack([plx - px, ply - py, torch.full((n,), rear_z, device=dev)], -1))
    ok, oc, dc = trace_from_film(lens, o, d)
    if spec.simple_weighting:
        w = torch.where(ok, 1.0, 0.0)
    else:
        area = torch.abs((bb[:, 1] - bb[:, 0]) * (bb[:, 3] - bb[:, 2]))
        c2 = torch.abs(d[:, 2]) * torch.abs(d[:, 2])
        w = torch.where(ok, c2 * c2 * area / (rear_z * rear_z + 1e-12), 0.0)
    return oc, dc, w
