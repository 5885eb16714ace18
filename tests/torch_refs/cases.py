"""The cases whose reference outputs are committed beside this file: the
scene texts, lanes and seeds that make_refs.py feeds to pbrt_tpu and that
the port's tests feed to pbrt_tpu_torch.

Each case is stored as <name>.npz holding its scene text ("scene"), its
lanes ("px", "py", "s"), its seed and the reference's outputs; a test
asserts that its own scene text equals the stored one before it compares.
"""
from __future__ import annotations

import os
import re

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_LANES = 1024
DEPTH = 3
VOLPATH_KNOT = (6, 3)   # tests/test_torch_volpath.py's 36-triangle knot


def integrator_line(kind, depth=DEPTH, strategy=None):
    line = f'Integrator "{kind}" "integer maxdepth" {depth}'
    return line + (f' "string strategy" "{strategy}"' if strategy else "")


# (name, scene, integrator kind, directlighting strategy) of the li cases
LI_CASES = [(f"{kind}{'_' + st if st else ''}_{scene}", scene, kind, st)
            for scene in ("point", "knot")
            for kind, st in (("whitted", None), ("directlighting", "all"),
                             ("directlighting", "one"))]
BDPT_SCENES = ("point", "env", "knot", "fog", "murk")
# the hook cases, on the knot scene: st_filter keeps (s, t) = (2, 2)
BDPT_HOOKS = ("st_filter", "st_select", "sampler_fn")
ST_FILTER = (2, 2)
HOOK_DIMS = 96        # the sampler_fn table's dimensions (BDPT at depth 3 reads < 90)
RENDER_CASE = ("render_bdpt_env", "env", 16, 4)   # name, scene, resolution, spp


def case_scene(name_scene, kind, strategy=None, res=None, spp=None):
    """The scene text of a case: a calibration scene of
    pbrt_tpu_torch/scene/bench.py (the reference tests' scenes, and a
    36-triangle knot with an area light and a glass sphere)."""
    from pbrt_tpu_torch.scene.bench import calibration_scene
    return calibration_scene(name_scene, integrator_line(kind, strategy=strategy), res, spp)


def case_lanes(text, seed):
    """The lanes of a case: N_LANES (px, py, sample) from the seed, within
    the scene's resolution and sample count."""
    res = int(re.search(r'xresolution" \[(\d+)\]', text).group(1))
    spp = int(re.search(r'pixelsamples" (\d+)', text).group(1))
    rng = np.random.default_rng(seed)
    return (rng.integers(0, res, N_LANES).astype(np.int32),
            rng.integers(0, res, N_LANES).astype(np.int32),
            rng.integers(0, spp, N_LANES).astype(np.int32))


def hook_inputs(seed, res):
    """The hook cases' inputs from a seed: the sampler table [N, HOOK_DIMS]
    (sampler_fn reads its column dim), the film positions, and the (s, t)
    each lane selects."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(0, 1, (N_LANES, HOOK_DIMS)).astype(np.float32)
    p_film = rng.uniform(0, res, (N_LANES, 2)).astype(np.float32)
    D = DEPTH + 1
    pairs = np.array([(s, t) for s in range(0, D + 1) for t in range(1, D + 2)
                      if s + t >= 2 and s + t <= D + 2 and not (s < 2 and t == 1)], np.int32)
    pick = pairs[rng.integers(0, len(pairs), N_LANES)]
    return table, p_film, pick[:, 0].copy(), pick[:, 1].copy()


def tr_inputs(grid, n=N_LANES, seed=3):
    """The intersect_tr case's shadow rays (tests/test_torch_volpath.py):
    from inside the knot's box (or the fog) toward points on the area
    light -> (o [n,3], d [n,3], dist [n], medium [n], pixel words 3 x [n])."""
    from pbrt_tpu_torch.scene.bench import SMOKE_BOX
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(SMOKE_BOX[0]), np.asarray(SMOKE_BOX[1])
    o = rng.uniform(lo + 0.05, hi - 0.05, (n, 3)).astype(np.float32)
    target = np.concatenate([rng.uniform(-0.9, 0.9, (n, 1)), np.full((n, 1), 3.999),
                             rng.uniform(-0.9, 0.9, (n, 1))], 1).astype(np.float32)
    to_l = target - o
    dist = np.linalg.norm(to_l, axis=1).astype(np.float32)
    d = (to_l / dist[:, None]).astype(np.float32)
    mid = np.full(n, 1 if grid else 0, np.int32)
    pix = [rng.integers(0, 64, n).astype(np.uint32) for _ in range(3)]
    return o, d, dist, mid, pix


def load(name):
    """A committed reference case -> dict of its arrays (scene as str)."""
    with np.load(os.path.join(HERE, name + ".npz")) as z:
        out = {k: z[k] for k in z.files}
    out["scene"] = str(out["scene"])
    return out


# ---- MLT and SPPM (tests/test_torch_mlt.py, tests/test_torch_sppm.py) ----
MLT_SCENES = ("point", "knot")
SMALL_RES = 16
# the whole render_mlt case: bootstrap samples, chains, mutations a pixel
# (4 steps of 256 chains on the 16x16 film)
MLT_RENDER = ("render_mlt_point", "point", (1024, 256, 4))
SPPM_SCENES = {"point": 0.25, "knot": 1.0}   # scene: initial radius
SPPM_PHOTONS = 16384   # photons an iteration of the one-iteration cases
SPPM_ITERATION = 1                           # the iteration index of the one-iteration cases
SPPM_RENDER = ("render_sppm_point", "point", 4)   # name, scene, iterations


def mlt_line(target="bdpt", bootstrap=None, chains=None, mutations=None, depth=DEPTH):
    line = f'Integrator "mlt" "integer maxdepth" {depth} "string target" "{target}"'
    for k, v in (("bootstrapsamples", bootstrap), ("chains", chains),
                 ("mutationsperpixel", mutations)):
        if v is not None:
            line += f' "integer {k}" {v}'
    return line


def sppm_line(radius, iterations=1, photons=SPPM_PHOTONS, depth=DEPTH):
    return (f'Integrator "sppm" "integer maxdepth" {depth} "integer numiterations" {iterations} '
            f'"float radius" {radius} "integer photonsperiteration" {photons}')


def small_scene(name_scene, line):
    """A calibration scene at SMALL_RES under an MLT or SPPM line."""
    from pbrt_tpu_torch.scene.bench import calibration_scene
    return calibration_scene(name_scene, line, res=SMALL_RES)


def mlt_inputs(seed, n_dims, n=N_LANES):
    """A target evaluation's inputs from a seed: the primary sample
    vectors u [n, n_dims] and each lane's path depth [n] (0 - DEPTH)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, n_dims)).astype(np.float32),
            rng.integers(0, DEPTH + 1, n).astype(np.int32))
