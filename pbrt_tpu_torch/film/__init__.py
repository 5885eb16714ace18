"""Film: filter-weighted radiance accumulation and unfiltered splats (port
of pbrt_tpu/film/__init__.py).

The deposit is deterministic on every device: the (pixel, weight,
radiance) entries of a wavefront are stably sorted by pixel, laid out in a
dense [pixels, rank] table with no two entries in one cell, and summed
along the rank axis in a fixed order. Float atomics (CUDA index_add_) would
add in a different order on every run. Splats (BDPT's light paths that
reach the camera) go to the nearest pixel with the same ordered sum; only
a film made with splats has their buffer, so a path film develops as
before, op for op.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pbrt_tpu_torch.core.spectrum import RGB_TO_Y
from pbrt_tpu_torch.filters import FilterSpec, build_table


SPLAT_CHUNK = 64   # the splat sum's ranks a table (_ordered_sum)


@dataclasses.dataclass(frozen=True)
class FilmSpec:
    full_resolution: Tuple[int, int] = (640, 480)   # (x, y)
    crop_window: Tuple[float, float, float, float] = (0.0, 1.0, 0.0, 1.0)
    filter: FilterSpec = dataclasses.field(default_factory=FilterSpec)
    filename: str = "out.png"
    scale: float = 1.0
    max_sample_luminance: float = float("inf")

    @property
    def pixel_bounds(self):
        """Cropped integer pixel bounds (x0, x1, y0, y1)."""
        rx, ry = self.full_resolution
        c = self.crop_window
        x0 = int(np.ceil(rx * c[0]))
        x1 = max(x0 + 1, int(np.ceil(rx * c[1])))
        y0 = int(np.ceil(ry * c[2]))
        y1 = max(y0 + 1, int(np.ceil(ry * c[3])))
        return (x0, x1, y0, y1)

    @property
    def cropped_resolution(self):
        x0, x1, y0, y1 = self.pixel_bounds
        return (x1 - x0, y1 - y0)

    @property
    def sample_bounds(self):
        """Pixel bounds grown by the filter radius: where samples are made."""
        x0, x1, y0, y1 = self.pixel_bounds
        rx, ry = self.filter.radius
        return (int(np.floor(x0 + 0.5 - rx)), int(np.ceil(x1 - 0.5 + rx)),
                int(np.floor(y0 + 0.5 - ry)), int(np.ceil(y1 - 0.5 + ry)))


def make_film(params: dict, filt: FilterSpec, options=None) -> FilmSpec:
    """From a .pbrt Film ParamSet dict and the run options."""
    xres = int(params.get("xresolution", [640])[0])
    yres = int(params.get("yresolution", [480])[0])
    crop = params.get("cropwindow", [0.0, 1.0, 0.0, 1.0])
    filename = str(params.get("filename", ["out.png"])[0])
    if options is not None:
        if options.quick:
            xres = max(1, xres // 4)
            yres = max(1, yres // 4)
        if options.outfile:
            filename = options.outfile
        if options.crop_window is not None:
            crop = list(options.crop_window)
    return FilmSpec((xres, yres), tuple(float(c) for c in crop), filt, filename,
                    scale=float(params.get("scale", [1.0])[0]),
                    max_sample_luminance=float(params.get(
                        "maxsampleluminance", [float("inf")])[0]))


@dataclasses.dataclass
class FilmState:
    rgb_sum: torch.Tensor     # [H, W, 3]
    weight_sum: torch.Tensor  # [H, W]
    splat: Optional[torch.Tensor] = None   # [H, W, 3]; None on a film without splats

    @staticmethod
    def zeros(spec: FilmSpec, device, splats: bool = False) -> "FilmState":
        w, h = spec.cropped_resolution
        return FilmState(torch.zeros((h, w, 3), device=device),
                         torch.zeros((h, w), device=device),
                         torch.zeros((h, w, 3), device=device) if splats else None)


def _ordered_sum(key, vals, n_keys, chunk=None):
    """Per-key sums of vals [E, C] in a fixed order: stable sort by key,
    scatter into a dense [n_keys, rank] table, sum over rank. chunk: the
    most ranks a table holds; deeper keys take one table a chunk of ranks,
    the chunks' sums added in order (bounds the memory where many entries
    share a key)."""
    order = torch.sort(key, stable=True).indices
    k = key[order]
    v = vals[order]
    first = torch.searchsorted(k, k, right=False)
    rank = torch.arange(k.shape[0], device=k.device) - first
    width = int(rank.max()) + 1 if k.shape[0] else 1
    if chunk is None or width <= chunk:
        table = torch.zeros((n_keys, width, vals.shape[1]), dtype=vals.dtype,
                            device=vals.device)
        table[k, rank] = v
        return table.sum(1)
    out = torch.zeros((n_keys, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    for r0 in range(0, width, chunk):
        sel = (rank >= r0) & (rank < r0 + chunk)
        table = torch.zeros((n_keys, chunk, vals.shape[1]), dtype=vals.dtype,
                            device=vals.device)
        table[k[sel], rank[sel] - r0] = v[sel]
        out = out + table.sum(1)
    return out


def add_samples(spec: FilmSpec, state: FilmState, p_film, L, ray_weight, table) -> FilmState:
    """Deposit a wavefront of samples. p_film [N,2] raster coordinates in
    full-resolution space, L [N,3], ray_weight [N], table [16,16]."""
    x0, x1, y0, y1 = spec.pixel_bounds
    H, W = state.rgb_sum.shape[:2]
    rx, ry = spec.filter.radius
    kx = int(np.floor(2.0 * rx)) + 1
    ky = int(np.floor(2.0 * ry)) + 1

    # NaN/inf radiance is dropped; bright outliers clamp to max luminance
    finite = torch.isfinite(L).all(-1) & torch.isfinite(ray_weight)
    L = torch.where(finite[:, None], L, 0.0)
    if np.isfinite(spec.max_sample_luminance):
        ly = L[:, 0] * RGB_TO_Y[0] + L[:, 1] * RGB_TO_Y[1] + L[:, 2] * RGB_TO_Y[2]
        f = torch.where(ly > spec.max_sample_luminance,
                        spec.max_sample_luminance / torch.clamp(ly, min=1e-20), 1.0)
        L = L * f[:, None]

    pdx = p_film[:, 0] - 0.5
    pdy = p_film[:, 1] - 0.5
    px0 = torch.ceil(pdx - rx).to(torch.int64)
    py0 = torch.ceil(pdy - ry).to(torch.int64)
    pxe = torch.floor(pdx + rx).to(torch.int64)
    pye = torch.floor(pdy + ry).to(torch.int64)
    ntab = table.shape[0]
    keys, vals = [], []
    for j in range(ky):
        for i in range(kx):
            px = px0 + i
            py = py0 + j
            fx = torch.clamp((torch.abs(px.to(torch.float32) - pdx) / rx * ntab)
                             .to(torch.int64), max=ntab - 1)
            fy = torch.clamp((torch.abs(py.to(torch.float32) - pdy) / ry * ntab)
                             .to(torch.int64), max=ntab - 1)
            w = table[fy, fx] * ray_weight
            ok = finite & (px <= pxe) & (py <= pye) & \
                (px >= x0) & (px < x1) & (py >= y0) & (py < y1)
            keys.append(((py - y0) * W + (px - x0))[ok])
            vals.append(torch.cat([w[:, None] * L, w[:, None]], 1)[ok])
    sums = _ordered_sum(torch.cat(keys), torch.cat(vals), H * W)
    return FilmState(state.rgb_sum + sums[:, :3].view(H, W, 3),
                     state.weight_sum + sums[:, 3].view(H, W), state.splat)


def add_splats(spec: FilmSpec, state: FilmState, p_film, v) -> FilmState:
    """Splat deposits [N,3] at raster positions p_film [N,2]: the nearest
    pixel, unfiltered, scaled by develop's splat_scale; non-finite values
    and positions off the cropped film are dropped, and so are zero
    values, which change no sum."""
    x0, x1, y0, y1 = spec.pixel_bounds
    H, W = state.splat.shape[:2]
    ok = torch.isfinite(v).all(-1) & (v != 0.0).any(-1)
    px = torch.floor(p_film[:, 0]).to(torch.int64)
    py = torch.floor(p_film[:, 1]).to(torch.int64)
    ok = ok & (px >= x0) & (px < x1) & (py >= y0) & (py < y1)
    sums = _ordered_sum(((py - y0) * W + (px - x0))[ok], v[ok], H * W, chunk=SPLAT_CHUNK)
    return FilmState(state.rgb_sum, state.weight_sum, state.splat + sums.view(H, W, 3))


def develop(spec: FilmSpec, state: FilmState, splat_scale: float = 1.0):
    """Final [H, W, 3] linear RGB: the filtered samples plus splat_scale
    times the splats, where the film has them."""
    w = state.weight_sum[..., None]
    rgb = torch.where(w > 0.0, state.rgb_sum / torch.clamp(w, min=1e-20), 0.0)
    if state.splat is not None:
        rgb = rgb + splat_scale * state.splat
    return torch.clamp(rgb * spec.scale, min=0.0)
