"""A render and a gradient step sharded over several ranks (port of
pbrt_tpu/parallel/mesh.py and of the sharded differentiable step of
__graft_entry__.py::dryrun_multichip).

The reference shards the ray wavefront over a JAX device mesh from one
controller (shard_map) and sums the films with psum. Here each rank is a
process of its own, joined by torch.distributed: the calling process is
rank 0 and starts the others, each of which loads the scene again from its
source (`CompiledScene.source`; the builds are deterministic, so every
rank holds the same tables). The estimator is the reference's: the pixels
are permuted by a fixed seed and padded by repetition to a multiple of the
ranks, a pass takes k = wavefront_size x ranks // pixels sample indices,
and each rank traces its contiguous share of the pass's lanes; the films
and the counters are summed over the ranks after every pass. Checkpoints,
resumes and previews are rank 0's.

The backend follows one rule: NCCL where every rank has a card of its own
(rank r on cuda:r), else gloo, whose ranks (on the CPU, or sharing one
card) reduce through host memory. The ranks meet in a file:// store under
a temporary directory (no TCP port, so renders running side by side never
collide), and every collective has a timeout, so a rank that fails makes
the others fail instead of hang.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pbrt_tpu_torch.core.spectrum import luminance
from pbrt_tpu_torch.diff import DiffParams, get_params, with_params
from pbrt_tpu_torch.film import FilmState, add_samples, develop
from pbrt_tpu_torch.filters import build_table
from pbrt_tpu_torch.integrators.path import COUNTERS, li_path
from pbrt_tpu_torch.render import after_pass, li_fn, resume_state, sample_pixels
from pbrt_tpu_torch.utils.options import Options
from pbrt_tpu_torch.utils.stats import STATS, merge_device_counters

TIMEOUT_S = 600.0   # a collective's limit: a rank that fails ends the others by then


def n_ranks_for(devices: int, device) -> int:
    """The ranks of a render asked for `devices`: on CUDA one a card, as
    many cards as there are at most (the reference's jax.devices()[:n]);
    on the CPU as many processes as asked."""
    if torch.device(device).type == "cuda":
        return max(1, min(devices, torch.cuda.device_count()))
    return max(1, devices)


def backend_for(device, n_ranks: int) -> str:
    """NCCL where each rank has a card of its own, else gloo."""
    device = torch.device(device)
    if device.type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device, rank: int, backend: str):
    """Rank 0 renders on the scene's device; under NCCL rank r on cuda:r,
    under gloo every rank on the scene's device (the CPU, or one card
    shared)."""
    device = torch.device(device)
    if backend == "nccl" and rank > 0:
        return torch.device("cuda", rank)
    return device


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of t over the ranks; gloo sums a card's tensor through
    host memory."""
    if t.is_cuda and dist.get_backend() == "gloo":
        h = t.cpu()
        dist.all_reduce(h)
        return h.to(t.device)
    dist.all_reduce(t)
    return t


def _rank_main(rank, n_ranks, init, backend, timeout, source, device, task, args):
    """A rank started by run_ranks: join the group, load the scene, run
    the task."""
    dev = rank_device(device, rank, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, world_size=n_ranks, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        loader, a, kw = source
        task(loader(*a, device=dev, **kw), rank, n_ranks, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(cs, n_ranks: int, task, args=(), timeout: float = TIMEOUT_S):
    """task(cs, rank, n_ranks, *args) on n_ranks ranks, this process rank 0
    with cs, the others started here (spawned) with the scene loaded from
    cs.source -> rank 0's result. Raises where a rank fails or outlives
    the timeout."""
    if cs.source is None:
        raise ValueError("a sharded render loads the scene on every rank: build it with "
                         "load_scene or load_scene_string")
    backend = backend_for(cs.device, n_ranks)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="pbrt_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(r, n_ranks, init, backend, timeout,
                                                      cs.source, str(cs.device), task, args))
                 for r in range(1, n_ranks)]
        for p in procs:
            p.start()
        try:
            dist.init_process_group(backend, init_method=init, world_size=n_ranks, rank=0,
                                    timeout=datetime.timedelta(seconds=timeout))
            try:
                out = task(cs, 0, n_ranks, *args)
            finally:
                dist.destroy_process_group()
        finally:
            for p in procs:
                p.join(timeout)
                if p.is_alive():
                    p.kill()
                    p.join()
    failed = [p.exitcode for p in procs if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"a rank of the sharded run failed (exit codes {failed})")
    return out


def _pad_to(a, m):
    pad = (-len(a)) % m
    return np.concatenate([a, a[:pad]]) if pad else a


@torch.no_grad()
def _render_rank(cs, rank, n_ranks, options, verbose):
    """One rank's part of render_sharded; rank 0 returns the render."""
    li = li_fn(cs)
    dev = cs.device
    px, py = sample_pixels(cs.film)
    order = np.random.default_rng(0).permutation(len(px))
    px = torch.as_tensor(_pad_to(px[order], n_ranks), device=dev)
    py = torch.as_tensor(_pad_to(py[order], n_ranks), device=dev)
    n_pix = px.shape[0]
    spp = cs.sampler.rounded_spp()
    if options.quick:
        spp = max(1, spp // 4)
    k = max(1, min(spp, options.wavefront_size * n_ranks // max(n_pix, 1)))
    table = torch.as_tensor(build_table(cs.film.filter), device=dev)
    film, s = resume_state(cs, options, verbose, spp) if rank == 0 \
        else (FilmState.zeros(cs.film, dev), 0)
    s = int(all_reduce(torch.tensor([s], dtype=torch.int64, device=dev)))   # rank 0's cursor
    totals = torch.zeros(len(COUNTERS), dtype=torch.int64, device=dev)
    H, W = film.weight_sum.shape
    passes = 0
    t0 = time.time()
    while s < spp:
        kk = min(k, spp - s)
        share = kk * n_pix // n_ranks
        lane = torch.arange(rank * share, (rank + 1) * share, device=dev)
        pix = lane % n_pix
        sidx = (s + lane // n_pix).to(torch.int32)
        L, p_film, ray_w, cnt = li(cs, px[pix], py[pix], sidx)
        local = add_samples(cs.film, FilmState.zeros(cs.film, dev), p_film, L, ray_w, table)
        summed = all_reduce(torch.cat([local.rgb_sum.reshape(-1), local.weight_sum.reshape(-1)]))
        film = FilmState(film.rgb_sum + summed[:H * W * 3].view(H, W, 3),
                         film.weight_sum + summed[H * W * 3:].view(H, W))
        totals += all_reduce(torch.stack([cnt[c] for c in COUNTERS]))
        s += kk
        passes += 1
        if rank == 0:
            if verbose:
                float(film.weight_sum[0, 0])   # waits for the pass
                print(f"  spp {s}/{spp} over {n_ranks} ranks ({time.time() - t0:.1f}s)")
            after_pass(cs, film, s, spp, passes, options)
    if rank != 0:
        return None
    img = develop(cs.film, film)
    totals = {c: int(v) for c, v in zip(COUNTERS, totals.tolist())}
    if options.stats_device:   # the reference's sharded render reports its counters alone
        merge_device_counters(STATS, totals)
    return img, totals, passes


def render_sharded(cs, n_ranks: int, options: Options = None, verbose=False,
                   timeout: float = TIMEOUT_S):
    """A sampler integrator's render over n_ranks ranks -> (image [H,W,3]
    linear RGB on the scene's device, counters summed over the ranks and
    passes, number of passes), the reference's estimator: within float
    summation order of render_sampler_integrator's image where the padded
    pixels are none."""
    return run_ranks(cs, n_ranks, _render_rank, (options or Options(), verbose), timeout)


def film_loss_grad(cs, px, py, sidx, max_depth: int = 4):
    """The loss sum(luminance(film.rgb_sum)) of the film of the lanes
    (px, py, sidx) (int32 tensors on the scene's device) under li_path,
    and its gradient with respect to every DiffParams leaf -> (loss,
    DiffParams)."""
    leaves = DiffParams(*(t.detach().clone().requires_grad_(True) for t in get_params(cs)))
    L, p_film, w, _ = li_path(with_params(cs, leaves), px, py, sidx, max_depth=max_depth)
    table = torch.as_tensor(build_table(cs.film.filter), device=px.device)
    film = add_samples(cs.film, FilmState.zeros(cs.film, px.device), p_film, L, w, table)
    loss = luminance(film.rgb_sum).sum()
    loss.backward()
    return loss.detach(), DiffParams(*(t.grad if t.grad is not None else torch.zeros_like(t)
                                       for t in leaves))


def _grad_rank(cs, rank, n_ranks, px, py, sidx, max_depth):
    """One rank's part of sharded_grad: its contiguous share of the
    (pixel, sample) lanes, then the loss and the gradients summed."""
    lanes = len(px) * len(sidx)
    lo, hi = rank * lanes // n_ranks, (rank + 1) * lanes // n_ranks
    to = lambda a: torch.as_tensor(a[lo:hi], dtype=torch.int32, device=cs.device)
    loss, grads = film_loss_grad(cs, to(np.tile(px, len(sidx))), to(np.tile(py, len(sidx))),
                                 to(np.repeat(sidx, len(px))), max_depth)
    loss = all_reduce(loss.reshape(1))[0]
    return loss, DiffParams(*(all_reduce(g.contiguous()) for g in grads))


def sharded_grad(cs, px, py, sidx, n_ranks: int, max_depth: int = 4,
                 timeout: float = TIMEOUT_S):
    """One differentiable step over n_ranks ranks: every pixel (px, py:
    int arrays) at every sample index of sidx, the lanes split over the
    ranks; each rank's film loss sum(luminance(rgb_sum)) backpropagated
    under diff.with_params, then the losses and the parameter gradients
    summed over the ranks -> (loss, DiffParams) on the scene's device. The
    loss is linear in the film, so this is the gradient of the summed
    film's loss (film_loss_grad of all the lanes at once)."""
    return run_ranks(cs, n_ranks, _grad_rank, (np.asarray(px), np.asarray(py),
                                               np.asarray(sidx), max_depth), timeout)
