"""Metropolis light transport in primary sample space, every chain of the
wavefront in lockstep (port of pbrt_tpu/integrators/mlt.py).

A chain's state is one primary sample vector u [U]; the target evaluates
a whole [n_chains, U] matrix at once. The default target is BDPT's path
space with one (s, t) strategy a lane, drawn from u's last column and
scaled by the lane's strategy count; a chain explores the path depth its
bootstrap index gives (index % (maxdepth + 1)). "string target" "path"
drives li_path from u instead. Each step proposes a large step (fresh
uniforms) or a Gaussian perturbation (Box-Muller, sigma) of every column,
splats both the proposal and the current state with their expected
weights, and accepts by a hashed uniform.

As in the reference: the bootstrap evaluates chunks of 16,384 uniform
vectors and reads their luminances back once; b is their mean (times the
depth count for the BDPT target); the chain starts are drawn on the host
with numpy (a float32 cumsum, default_rng(7), searchsorted), so they are
the reference's whenever the weights are. The per-dimension draws are
one hash over a [chains, U] key grid, bit-equal to the reference's
column loop.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from pbrt_tpu_torch.core.spectrum import luminance
from pbrt_tpu_torch.film import FilmState, add_splats, develop
from pbrt_tpu_torch.integrators.bdpt import _bdpt_sample
from pbrt_tpu_torch.integrators.common import BOUNCE_DIMS, CAMERA_DIMS
from pbrt_tpu_torch.integrators.path import li_path
from pbrt_tpu_torch.samplers.hashing import hash3, hash_combine, u32, u32_to_float
from pbrt_tpu_torch.utils.stats import STATS

SIGMA = 0.01
P_LARGE = 0.3
BOOT_CHUNK = 16384
PSS_SALT = 0xB007   # the bootstrap vectors' (and so the chain starts') hash salt


def _n_dims(max_depth):
    return CAMERA_DIMS + BOUNCE_DIMS * (max_depth + 1)


def _n_dims_bdpt(max_depth):
    """The BDPT target's dimensions: the camera, light and connection
    streams and one strategy-selection dimension (the last column)."""
    D = max_depth + 1
    return 5 + 8 * D + 5 + 8 * (D - 1) + 4 * (D + 2) + 1


def _film_positions(cs, u):
    """Film positions from u's first two columns over the sample bounds
    -> (p_film [N,2], px, py)."""
    x0, x1, y0, y1 = cs.film.sample_bounds
    fx = x0 + u[:, 0] * (x1 - x0)
    fy = y0 + u[:, 1] * (y1 - y0)
    return (torch.stack([fx, fy], -1), torch.clamp(fx.to(torch.int32), x0, x1 - 1),
            torch.clamp(fy.to(torch.int32), y0, y1 - 1))


def _eval_bdpt_target(cs, u, max_depth, depth_lane):
    """L_{s,t}(u) [N,3] and the raster positions [N,2]: one BDPT strategy
    a lane among its depth's depth + 2, times that count."""
    n_u = u.shape[1]
    p_film, px, py = _film_positions(cs, u)
    cols = u.t().contiguous()   # a dimension's draws as one contiguous row
    n_str = torch.where(depth_lane == 0, 1, depth_lane + 2)
    s_lane = torch.where(depth_lane == 0, 0, torch.minimum(
        (u[:, -1] * n_str.to(torch.float32)).to(torch.int32), n_str - 1))
    t_lane = torch.where(depth_lane == 0, 2, depth_lane + 2 - s_lane)
    L, raster, _, _ = _bdpt_sample(cs, px, py, torch.zeros_like(px), max_depth + 1,
                                   sampler_fn=lambda dim: cols[min(dim, n_u - 2)],
                                   p_film_override=p_film, st_select=(s_lane, t_lane))
    L = L * n_str.to(torch.float32)[:, None]
    return torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0), raster


def _eval_target(cs, u, max_depth):
    """L(u) [N,3] of li_path driven by u, and the film positions [N,2]."""
    n_u = u.shape[1]
    p_film, px, py = _film_positions(cs, u)
    cols = u.t().contiguous()
    L = li_path(cs, px, py, torch.zeros_like(px), max_depth=max_depth,
                sampler_fn=lambda dim: cols[min(dim, n_u - 1)], p_film_override=p_film)[0]
    return torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0), p_film


def pss_vectors(index, n_u):
    """The uniform primary sample vectors [N, n_u] of bootstrap indices
    index [N] (u32 words)."""
    dims = torch.arange(n_u, dtype=torch.int64, device=index.device)
    return u32_to_float(hash3(index[:, None], dims[None, :], PSS_SALT))


def bootstrap(eval_lanes, n_bootstrap, n_u, n_depths, dev):
    """The bootstrap's luminances, float32 numpy [n_bootstrap]: uniform
    vectors of indices 0 .. n_bootstrap - 1 in chunks of BOOT_CHUNK, index
    i exploring path depth i % n_depths; read back once."""
    chunk = min(n_bootstrap, BOOT_CHUNK)
    ws = []
    for i0 in range(0, n_bootstrap, chunk):
        idx = u32(torch.arange(chunk, dtype=torch.int64, device=dev) + i0)
        ws.append(luminance(eval_lanes(pss_vectors(idx, n_u),
                                       (idx % n_depths).to(torch.int32))[0]))
    return torch.cat(ws)[:n_bootstrap].cpu().numpy()


def chain_starts(w_boot, n_chains, n_depths):
    """Host: bootstrap indices drawn in proportion to the weights w_boot
    (float32 numpy), as the reference draws them -> (starts uint32 [C],
    depth of each chain int32 [C])."""
    cdf = np.cumsum(w_boot)
    cdf /= cdf[-1]
    rng = np.random.default_rng(7)
    starts = np.searchsorted(cdf, rng.uniform(size=n_chains)).astype(np.uint32)
    return starts, (starts % n_depths).astype(np.int32)


def propose(u_cur, step, sigma=SIGMA, p_large=P_LARGE):
    """The step's proposals -> (u_prop [C, U], large [C] bool): a large
    step draws every column afresh, else each column moves by a Gaussian
    of deviation sigma and wraps into [0, 1)."""
    n, n_u = u_cur.shape
    ci = torch.arange(n, dtype=torch.int64, device=u_cur.device)
    large = u32_to_float(hash3(ci, step, 1)) < p_large
    dims = torch.arange(n_u, dtype=torch.int64, device=u_cur.device)
    key = hash_combine(hash_combine(ci, step)[:, None], dims[None, :])   # hash3(ci, step, dim)
    fresh = u32_to_float(hash_combine(key, 2))
    g1 = u32_to_float(hash_combine(key, 3))
    g2 = u32_to_float(hash_combine(key, 4))
    gauss = torch.sqrt(-2.0 * torch.log(torch.clamp(g1, min=1e-12))) \
        * torch.cos(2.0 * np.pi * g2)
    pert = u_cur + sigma * gauss
    pert = pert - torch.floor(pert)
    return torch.where(large[:, None], fresh, pert), large


def mlt_step(cs, film, chains, step, b, eval_t, sigma=SIGMA, p_large=P_LARGE):
    """One Metropolis step of every chain. chains: (u [C,U], L [C,3],
    y [C], p_film [C,2]) of the current states; b: the normalisation, a
    float32 tensor on the chains' device; eval_t: u -> (L, p_film) ->
    (film, the chains after the step, accepted [C] bool)."""
    u_cur, L_cur, y_cur, pf_cur = chains
    u_prop, large = propose(u_cur, step, sigma, p_large)
    L_prop, pf_prop = eval_t(u_prop)
    y_prop = luminance(L_prop)
    a = torch.clamp(y_prop / torch.clamp(y_cur, min=1e-12), 0.0, 1.0)
    # both states splat, with their expected weights
    w_new = (a + large.to(torch.float32)) / torch.clamp(y_prop / b + p_large, min=1e-12)
    w_old = (1.0 - a) / torch.clamp(y_cur / b + p_large, min=1e-12)
    film = add_splats(cs.film, film, pf_prop, w_new[:, None] * L_prop)
    film = add_splats(cs.film, film, pf_cur, w_old[:, None] * L_cur)
    ci = torch.arange(u_cur.shape[0], dtype=torch.int64, device=u_cur.device)
    acc = u32_to_float(hash3(ci, step, 5)) < a
    chains = (torch.where(acc[:, None], u_prop, u_cur), torch.where(acc[:, None], L_prop, L_cur),
              torch.where(acc, y_prop, y_cur), torch.where(acc[:, None], pf_prop, pf_cur))
    return film, chains, acc


@torch.no_grad()
def render_mlt(cs, options=None):
    """-> (image [H,W,3] linear RGB tensor on the scene's device, counters
    {"mutations_accepted", "mutations", "bootstrap_samples": int}, number
    of target evaluations: the bootstrap chunks, the chain starts and one
    a step). Reports the acceptance rate, the mutations, the bootstrap
    samples and the chains' seconds into STATS."""
    from pbrt_tpu_torch.utils.options import Options
    options = options or Options()
    p = cs.integrator_params
    dev = cs.device
    max_depth = int(p.get("maxdepth", [5])[0])
    n_bootstrap = int(p.get("bootstrapsamples", [65536])[0])
    n_chains = int(p.get("chains", [4096])[0])
    mutations_pp = int(p.get("mutationsperpixel", [100])[0])
    sigma = float(p.get("sigma", [SIGMA])[0])
    p_large = float(p.get("largestepprobability", [P_LARGE])[0])
    if options.quick:
        n_bootstrap //= 8
        mutations_pp = max(4, mutations_pp // 8)
    target = str(p.get("target", ["bdpt"])[0])
    W, H = cs.film.cropped_resolution
    n_pix = W * H
    n_steps = max(1, mutations_pp * n_pix // n_chains)
    n_depths = max_depth + 1
    if target == "bdpt":
        n_u = _n_dims_bdpt(max_depth)
        eval_lanes = lambda u, depth: _eval_bdpt_target(cs, u, max_depth, depth)
    else:
        n_u = _n_dims(max_depth)
        eval_lanes = lambda u, depth: _eval_target(cs, u, max_depth)

    w_boot = bootstrap(eval_lanes, n_bootstrap, n_u, n_depths, dev)
    passes = -(-n_bootstrap // min(n_bootstrap, BOOT_CHUNK))
    b = float(w_boot.mean())
    if target == "bdpt":
        b *= n_depths   # a bootstrap sample explores one depth of n_depths
    counters = {"mutations_accepted": 0, "mutations": 0, "bootstrap_samples": n_bootstrap}
    if b <= 0:
        return torch.zeros((H, W, 3), device=dev), counters, passes

    starts, depth_np = chain_starts(w_boot, n_chains, n_depths)
    depth = torch.as_tensor(depth_np, device=dev)
    eval_t = lambda u: eval_lanes(u, depth)
    u_cur = pss_vectors(torch.as_tensor(starts.astype(np.int64), device=dev), n_u)
    L_cur, pf_cur = eval_t(u_cur)
    chains = (u_cur, L_cur, luminance(L_cur), pf_cur)
    b_t = torch.tensor(b, dtype=torch.float32, device=dev)
    film = FilmState.zeros(cs.film, dev, splats=True)
    n_acc = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.time()
    for step in range(1, n_steps + 1):
        film, chains, acc = mlt_step(cs, film, chains, step, b_t, eval_t, sigma, p_large)
        n_acc += acc.sum()
    counters.update(mutations_accepted=int(n_acc), mutations=n_steps * n_chains)
    STATS.report_ratio("Integrator/Acceptance rate", counters["mutations_accepted"],
                       counters["mutations"])
    STATS.report_counter("Integrator/MLT mutations", counters["mutations"])
    STATS.report_counter("Integrator/MLT bootstrap samples", n_bootstrap)
    STATS.report_distribution("Performance/MLT render seconds", time.time() - t0)
    # splat weights carry 1/b: the image is the splats over the mutations a pixel
    scale = 1.0 / max(n_steps * n_chains / n_pix, 1e-9)
    return develop(cs.film, film, splat_scale=scale), counters, passes + 1 + n_steps
