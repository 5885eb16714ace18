"""Render driver: CompiledScene -> image (port of pbrt_tpu/render.py).

`render` sends an SPPM, BDPT or MLT scene to its own driver
(integrators/sppm.py, bdpt.py, mlt.py), any other scene with
`Options.devices` over 1 to the sharded render (parallel/mesh.py), and
every other to render_sampler_integrator, whose radiance function `li_fn`
picks as the reference's _li_fn does: path, volpath, whitted,
directlighting with its strategy, and li_path with maxdepth alone for a
kind it does not name. All pixels of the film's sample bounds, in Morton
order, times k sample indices make one wavefront pass of about
`wavefront_size` lanes; each pass deposits into the film, and the host
loops over passes: it resumes from a checkpoint, saves one and writes a
preview image every so many passes where the options ask, and reports the
render's statistics into utils/stats.py's STATS.
"""
from __future__ import annotations

import functools
import time
from typing import Optional

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
from pbrt_tpu_torch.io.image_io import write_image
from pbrt_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from pbrt_tpu_torch.utils.options import Options
from pbrt_tpu_torch.utils.stats import STATS, merge_device_counters


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


def render(cs, options: Optional[Options] = None, verbose=False):
    """-> (image [H,W,3] linear RGB tensor on the scene's device, counters
    {name: int}, number of passes), by the scene's integrator: SPPM, BDPT
    and MLT by their own drivers (their counters and passes are theirs:
    SPPM's grid overflows and iterations, MLT's mutations and target
    evaluations), every other by render_sampler_integrator (the live-ray
    counters summed over all passes), sharded over ranks where
    options.devices is over 1 (render_sharded; on CUDA one rank a card,
    as many as there are)."""
    options = options or Options()
    driver = DRIVERS.get(cs.integrator_kind)
    if driver is not None:
        return driver(cs, options)
    if options.devices > 1:
        from pbrt_tpu_torch.parallel.mesh import n_ranks_for, render_sharded
        return render_sharded(cs, n_ranks_for(options.devices, cs.device), options, verbose)
    return render_sampler_integrator(cs, options, verbose)


def report_render(cs, img, totals, n_pix, spp, passes, lanes, seconds, options):
    """A sampler integrator's render of n_pix pixels into STATS: its device
    counters (where options.stats_device), camera rays, passes, lanes a
    pass, Mpaths/s, film pixels and the lit share of the image."""
    if options.stats_device:
        merge_device_counters(STATS, totals)
    STATS.report_counter("Integrator/Camera rays traced", n_pix * spp)
    STATS.report_counter("Integrator/Sample batches", passes)
    STATS.report_counter("Integrator/Wavefront size", lanes)
    STATS.report_distribution("Performance/Mpaths per second",
                              n_pix * spp / max(seconds, 1e-9) / 1e6)
    STATS.report_counter("Memory/Film pixels",
                         cs.film.full_resolution[0] * cs.film.full_resolution[1])
    STATS.report_ratio("Film/Nonzero pixels", float((img.sum(-1) > 0).sum()),
                       float(img.shape[0] * img.shape[1]))


def resume_state(cs, options, verbose, spp):
    """(film, sample cursor) to start from: options.checkpoint_path's
    where options.resume and it holds a checkpoint, else empty."""
    film, s = FilmState.zeros(cs.film, cs.device), 0
    if options.checkpoint_path and options.resume:
        loaded = load_checkpoint(options.checkpoint_path, cs.device)
        if loaded is not None:
            film, s, _ = loaded
            if verbose:
                print(f"  resumed from {options.checkpoint_path} at spp {s}/{spp}")
    return film, s


def after_pass(cs, film, s, spp, passes, options):
    """The preview image and the checkpoint due after a pass, none after
    the last: the preview to options.preview_path, else the output file,
    and written first, so a render killed once its checkpoint is there
    leaves a whole preview."""
    if s >= spp:
        return
    if options.preview_every and passes % options.preview_every == 0:
        write_image(options.preview_path or options.outfile or cs.film.filename,
                    develop(cs.film, film).cpu().numpy())
    if options.checkpoint_path and options.checkpoint_every \
            and passes % options.checkpoint_every == 0:
        save_checkpoint(options.checkpoint_path, film, s)


@torch.no_grad()
def render_sampler_integrator(cs, options: Optional[Options] = None, verbose=False):
    """-> (image [H,W,3] linear RGB tensor on the scene's device,
    counters {name: int} summed over this run's passes, number of passes).
    A pass is clamped to the samples left, so a resumed render equals a
    straight-through one bit for bit. An ordinary render records no
    autograd tape (diff/ records one)."""
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

    film, s = resume_state(cs, options, verbose, spp)
    totals = {c: torch.zeros((), dtype=torch.int64, device=dev) for c in COUNTERS}
    passes = 0
    t0 = time.time()
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
        if verbose:
            float(film.weight_sum[0, 0])   # waits for the pass
            el = time.time() - t0
            print(f"  spp {s}/{spp}  ({el:.1f}s, {n_pix * s / max(el, 1e-9) / 1e6:.2f} Mpaths/s)")
        after_pass(cs, film, s, spp, passes, options)
    img = develop(cs.film, film)
    totals = {c: int(v) for c, v in totals.items()}
    report_render(cs, img, totals, n_pix, spp, passes, n_pix * k, time.time() - t0, options)
    return img, totals, passes


def render_file(path: str, options: Optional[Options] = None, device="cuda", verbose=False):
    """Parse, render and write one scene file -> (output path, image)."""
    from pbrt_tpu_torch.scene.build import load_scene
    options = options or Options()
    cs = load_scene(path, options, device=device, seed=options.seed)
    img, _, _ = render(cs, options, verbose)
    out = options.outfile or cs.film.filename
    write_image(out, img.cpu().numpy())
    return out, img
