"""Render driver: CompiledScene -> image (port of
pbrt_tpu/render.py::render_sampler_integrator without checkpoints,
previews or the stats report).

All pixels of the film's sample bounds, in Morton order, times k sample
indices make one wavefront pass of about `wavefront_size` lanes; each
pass deposits into the film, and the host loops over passes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pbrt_tpu_torch.film import FilmState, add_samples, develop
from pbrt_tpu_torch.filters import build_table
from pbrt_tpu_torch.integrators.path import COUNTERS, li_path


@dataclasses.dataclass
class Options:
    """Run-shape options of the CLI."""
    quick: bool = False
    outfile: str = ""
    crop_window: Optional[Tuple[float, float, float, float]] = None
    wavefront_size: int = 1 << 17
    seed: int = 0


def morton2(x, y, bits=16):
    m = np.zeros_like(x, dtype=np.uint64)
    for b in range(bits):
        m |= (((x >> b) & 1).astype(np.uint64) << np.uint64(2 * b)) \
            | (((y >> b) & 1).astype(np.uint64) << np.uint64(2 * b + 1))
    return m


def sample_pixels(film):
    """All pixel coordinates of the film's sample bounds in Morton order."""
    x0, x1, y0, y1 = film.sample_bounds
    xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
    xs = xs.ravel().astype(np.int32)
    ys = ys.ravel().astype(np.int32)
    order = np.argsort(morton2(xs - x0, ys - y0), kind="stable")
    return xs[order], ys[order]


@torch.no_grad()
def render_sampler_integrator(cs, options: Optional[Options] = None):
    """-> (image [H,W,3] linear RGB tensor on the scene's device,
    counters {name: int} summed over all passes, number of passes). An
    ordinary render records no autograd tape (diff/ records one)."""
    options = options or Options()
    if cs.integrator_kind != "path":
        raise NotImplementedError(f"integrator {cs.integrator_kind!r} is not ported")
    dev = cs.device
    px_np, py_np = sample_pixels(cs.film)
    n_pix = px_np.shape[0]
    px = torch.as_tensor(px_np, device=dev)
    py = torch.as_tensor(py_np, device=dev)
    spp = cs.sampler.rounded_spp()
    if options.quick:
        spp = max(1, spp // 4)
    max_depth = int(cs.integrator_params.get("maxdepth", [5])[0])
    rr = float(cs.integrator_params.get("rrthreshold", [1.0])[0])
    k = max(1, min(spp, options.wavefront_size // max(n_pix, 1)))
    table = torch.as_tensor(build_table(cs.film.filter), device=dev)

    film = FilmState.zeros(cs.film, dev)
    totals = {c: torch.zeros((), dtype=torch.int64, device=dev) for c in COUNTERS}
    s = passes = 0
    while s < spp:
        kk = min(k, spp - s)
        pxs = px.repeat(kk)
        pys = py.repeat(kk)
        sidx = (s + torch.arange(kk, device=dev).repeat_interleave(n_pix)).to(torch.int32)
        L, p_film, ray_w, cnt = li_path(cs, pxs, pys, sidx, max_depth=max_depth,
                                        rr_threshold=rr)
        film = add_samples(cs.film, film, p_film, L, ray_w, table)
        for c in COUNTERS:
            totals[c] += cnt[c]
        s += kk
        passes += 1
    return develop(cs.film, film), {c: int(v) for c, v in totals.items()}, passes


def render_file(path: str, options: Optional[Options] = None, device="cuda"):
    """Parse, render and write one scene file -> (output path, image)."""
    from pbrt_tpu_torch.io.image_io import write_image
    from pbrt_tpu_torch.scene.build import load_scene
    options = options or Options()
    cs = load_scene(path, options, device=device, seed=options.seed)
    img, _, _ = render_sampler_integrator(cs, options)
    out = options.outfile or cs.film.filename
    write_image(out, img.cpu().numpy())
    return out, img
