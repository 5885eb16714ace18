"""Render driver: CompiledScene -> image (port of pbrt_tpu/render.py
without checkpoints, previews or the stats report).

`render` sends an SPPM, BDPT or MLT scene to its own driver
(integrators/sppm.py, bdpt.py, mlt.py) and every other to
render_sampler_integrator, whose radiance function `li_fn`
picks as the reference's _li_fn does: path, volpath, whitted,
directlighting with its strategy, and li_path with maxdepth alone for a
kind it does not name. All pixels of the film's sample bounds, in Morton
order, times k sample indices make one wavefront pass of about
`wavefront_size` lanes; each pass deposits into the film, and the host
loops over passes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from pbrt_tpu_torch.film import FilmState, add_samples, develop
from pbrt_tpu_torch.filters import build_table
from pbrt_tpu_torch.integrators.bdpt import render_bdpt
from pbrt_tpu_torch.integrators.direct import li_direct
from pbrt_tpu_torch.integrators.mlt import render_mlt
from pbrt_tpu_torch.integrators.path import COUNTERS, li_path
from pbrt_tpu_torch.integrators.sppm import render_sppm
from pbrt_tpu_torch.integrators.volpath import li_volpath
from pbrt_tpu_torch.integrators.whitted import li_whitted


@dataclasses.dataclass
class Options:
    """Run-shape options of the CLI."""
    quick: bool = False
    outfile: str = ""
    crop_window: Optional[Tuple[float, float, float, float]] = None
    wavefront_size: int = 1 << 17
    seed: int = 0
    sppm_radius: float = 0.0   # over 0: SPPM's initial radius, in place of the scene's


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


def li_fn(cs):
    """The scene's radiance function li(cs, px, py, sample_idx) -> (L,
    p_film, ray_weight, counters), its parameters bound."""
    kind, p = cs.integrator_kind, cs.integrator_params
    max_depth = int(p.get("maxdepth", [5])[0])
    rr = float(p.get("rrthreshold", [1.0])[0])
    if kind == "path":
        return functools.partial(li_path, max_depth=max_depth, rr_threshold=rr)
    if kind == "volpath":
        return functools.partial(li_volpath, max_depth=max_depth, rr_threshold=rr)
    if kind == "whitted":
        return functools.partial(li_whitted, max_depth=max_depth)
    if kind == "directlighting":
        return functools.partial(li_direct, max_depth=max_depth,
                                 strategy=str(p.get("strategy", ["all"])[0]))
    return functools.partial(li_path, max_depth=max_depth)


DRIVERS = {"sppm": render_sppm, "bdpt": render_bdpt, "mlt": render_mlt}


def render(cs, options: Optional[Options] = None):
    """-> (image [H,W,3] linear RGB tensor on the scene's device, counters
    {name: int}, number of passes), by the scene's integrator: SPPM, BDPT
    and MLT by their own drivers (their counters and passes are theirs:
    SPPM's grid overflows and iterations, MLT's mutations and target
    evaluations), every other by render_sampler_integrator (the live-ray
    counters summed over all passes)."""
    driver = DRIVERS.get(cs.integrator_kind, render_sampler_integrator)
    return driver(cs, options)


@torch.no_grad()
def render_sampler_integrator(cs, options: Optional[Options] = None):
    """-> (image [H,W,3] linear RGB tensor on the scene's device,
    counters {name: int} summed over all passes, number of passes). An
    ordinary render records no autograd tape (diff/ records one)."""
    options = options or Options()
    li = li_fn(cs)
    dev = cs.device
    px_np, py_np = sample_pixels(cs.film)
    n_pix = px_np.shape[0]
    px = torch.as_tensor(px_np, device=dev)
    py = torch.as_tensor(py_np, device=dev)
    spp = cs.sampler.rounded_spp()
    if options.quick:
        spp = max(1, spp // 4)
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
        L, p_film, ray_w, cnt = li(cs, pxs, pys, sidx)
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
    img, _, _ = render(cs, options)
    out = options.outfile or cs.film.filename
    write_image(out, img.cpu().numpy())
    return out, img
