"""The "spatial" light-selection strategy (port of pbrt_tpu/lights/distrib.py):
a voxel grid over the scene's bounds where each voxel holds a
Distribution1D over the lights, weighted by an unoccluded Li / pdf
estimate of each light at 128 Halton points in the voxel, with a floor of
0.001 of the voxel's mean so that no light gets probability 0.

As in the reference, the whole [V, L] table is built once at scene build,
every voxel's points and every light as one wavefront (in chunks that
bound its memory), and a lane looks its voxel's row up with one gather and
a row-wise CDF inversion.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_tpu_torch.core.math import ONE_MINUS_EPSILON
from pbrt_tpu_torch.samplers.lds import radical_inverse

N_SAMPLES = 128
# the table's budget of V * L entries: the widest axis takes 64 voxels
# until the table would pass it, then shrinks cubically
TABLE_BUDGET = 1 << 22
CHUNK = 1 << 20   # sample points per sample_li wavefront of the build


@dataclasses.dataclass
class SpatialLightDistrib:
    func: torch.Tensor        # [V, L] per-voxel light weights
    cdf: torch.Tensor         # [V, L+1]
    func_int: torch.Tensor    # [V]
    lo: torch.Tensor          # [3] world bound min
    inv_extent: torch.Tensor  # [3] 1 / extent (0 where degenerate)
    nvox: tuple               # voxels per axis (x, y, z)


def default_spatial_voxels(n_lights: int) -> int:
    side = int(round((TABLE_BUDGET / max(n_lights, 1)) ** (1.0 / 3.0)))
    return max(8, min(64, side))


def _voxel_counts(lo, hi, max_voxels):
    diag = np.maximum(hi - lo, 0.0)
    bmax = float(diag.max())
    if bmax <= 0.0:
        return np.ones(3, np.int64)
    return np.maximum(1, np.round(diag / bmax * max_voxels)).astype(np.int64)


def build_spatial_distrib(lights, world_center, world_radius, n_lights, max_voxels=None,
                          device="cpu") -> SpatialLightDistrib:
    """The whole voxel grid over the cube world_center +- world_radius;
    max_voxels: the widest axis's resolution (None: default_spatial_voxels)."""
    from pbrt_tpu_torch.lights import sample_li
    if max_voxels is None:
        max_voxels = default_spatial_voxels(n_lights)
    wc = np.asarray(world_center, np.float32)
    wr = float(world_radius)
    lo, hi = wc - wr, wc + wr
    nv = _voxel_counts(lo, hi, max_voxels)
    V = int(nv.prod())
    iz, iy, ix = np.meshgrid(np.arange(nv[2]), np.arange(nv[1]), np.arange(nv[0]),
                             indexing="ij")
    corner = np.stack([ix, iy, iz], -1).reshape(V, 3).astype(np.float32)
    samp = np.arange(N_SAMPLES, dtype=np.int64)
    u_pos = torch.stack([radical_inverse(b, samp) for b in (2, 3, 5)], -1).numpy()
    u_li = torch.stack([radical_inverse(b, samp) for b in (7, 11)], -1).numpy()
    extent = (hi - lo).astype(np.float32)
    t01 = (corner[:, None, :] + u_pos[None].astype(np.float32)) / nv.astype(np.float32)
    pts = torch.as_tensor((lo.astype(np.float32) + t01 * extent).reshape(V * N_SAMPLES, 3),
                          device=device)
    u_d = torch.as_tensor(u_li, device=device).repeat(V, 1)
    y = torch.tensor([0.212671, 0.715160, 0.072169], device=device)
    cols = []
    for li in range(n_lights):
        parts = []
        for c in range(0, pts.shape[0], CHUNK):
            p, u = pts[c:c + CHUNK], u_d[c:c + CHUNK]
            ls = sample_li(lights, torch.full((p.shape[0],), li, dtype=torch.int64,
                                              device=device), p, u, wr)
            lum = (ls.li * y).sum(-1)
            parts.append(torch.where(ls.pdf > 0.0, lum / torch.clamp(ls.pdf, min=1e-20), 0.0))
        cols.append(torch.cat(parts).reshape(V, N_SAMPLES).sum(1))
    contrib = torch.stack(cols, 1)
    avg = contrib.sum(1, keepdim=True) / (N_SAMPLES * n_lights)
    contrib = torch.maximum(contrib, torch.where(avg > 0.0, 1e-3 * avg, 1.0))
    cdf = torch.cat([torch.zeros((V, 1), device=device),
                     torch.cumsum(contrib, -1) / n_lights], -1)
    func_int = cdf[:, -1].clone()
    cdf = cdf / torch.where(func_int > 0.0, func_int, 1.0)[:, None]
    cdf[:, -1] = 1.0
    inv_ext = np.where(extent > 0.0, 1.0 / np.maximum(extent, 1e-20), 0.0).astype(np.float32)
    return SpatialLightDistrib(contrib, cdf, func_int, torch.as_tensor(lo.astype(np.float32),
                                                                       device=device),
                               torch.as_tensor(inv_ext, device=device),
                               tuple(int(v) for v in nv))


def _voxel_index(sd: SpatialLightDistrib, p):
    """World points [N,3] -> flat voxel ids [N], clamped into the grid
    (a NaN coordinate takes voxel 0 along its axis)."""
    t = (p - sd.lo) * sd.inv_extent
    nx, ny, nz = sd.nvox
    idx = [torch.clamp(torch.nan_to_num(t[:, a] * float(n), nan=0.0), 0.0, n - 1.0)
           .to(torch.int64) for a, n in enumerate(sd.nvox)]
    return idx[0] + nx * (idx[1] + ny * idx[2])


def spatial_sample_discrete(sd: SpatialLightDistrib, p, u):
    """Per-lane light pick from the voxel at p -> (light_idx, pmf, u_remap)."""
    v = _voxel_index(sd, p)
    row = sd.cdf[v]
    L = row.shape[1] - 1
    offset = (row[:, 1:L] <= u[:, None]).sum(-1)
    pmf = spatial_pdf(sd, p, offset, voxel=v)
    c0 = row.gather(1, offset[:, None])[:, 0]
    c1 = row.gather(1, (offset + 1)[:, None])[:, 0]
    ok = c1 > c0
    du = torch.where(ok, (u - c0) / torch.where(ok, c1 - c0, 1.0), 0.0)
    return offset, pmf, torch.clamp(du, max=ONE_MINUS_EPSILON)


def spatial_pdf(sd: SpatialLightDistrib, p, light_idx, voxel=None):
    """The pmf the voxel at p gives light light_idx (clamped into range)."""
    v = _voxel_index(sd, p) if voxel is None else voxel
    L = sd.func.shape[1]
    fi = sd.func_int[v]
    f = sd.func[v, torch.clamp(light_idx, 0, L - 1)]
    return torch.where(fi > 0.0, f / torch.where(fi > 0.0, fi * L, 1.0), 0.0)
