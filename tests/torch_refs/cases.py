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


# ---- li_path on the moving, environment and realistic cameras, the kd-tree
# and subsurface knots (tests/test_torch_cameras.py, test_torch_kdtree.py,
# test_torch_subsurface.py) ----
CAL_KNOT_LINE = 'Material "plastic" "rgb Kd" [0.3 0.3 0.7] "rgb Ks" [0.3 0.3 0.3]'
PATH_CASES = ("path_moving", "path_environment", "path_realistic", "path_kdtree",
              "path_subsurface", "path_kdsubsurface")


def path_case_scene(name):
    """The scene text of a PATH_CASES case: the knot calibration scene
    under path at DEPTH with its camera, accelerator or knot changed."""
    from pbrt_tpu_torch.scene import bench as Bn
    line = integrator_line("path")
    if name == "path_kdtree":
        return Bn.kdtree_calibration_scene(line)
    text = Bn.calibration_scene("knot", line)
    variant = {"path_moving": dict(motion=Bn.CAMERA_MOTION),
               "path_environment": dict(camera=Bn.ENV_CAMERA),
               "path_realistic": dict(camera=Bn.REALISTIC_CAMERA),
               "path_subsurface": dict(knot_material=Bn.SUBSURFACE_KNOT),
               "path_kdsubsurface": dict(knot_material=Bn.KDSUBSURFACE_KNOT)}[name]
    return Bn.scene_variant(text, knot_line=CAL_KNOT_LINE, **variant)


def open_lens(load_lens_system, trace_np, normalize_np):
    """The realistic camera of path_realistic opened (bench.open_lens)
    with the given package's load_lens_system, float32 trace and
    normalize -> (lens [n,4], bounds [32,4] f32)."""
    from pbrt_tpu_torch.scene import bench as Bn
    return Bn.open_lens(load_lens_system, trace_np, normalize_np)


# ---- spectral mode (tests/test_torch_spectral.py): li_path and li_direct
# under "bool spectral" "true", and MLT's path target ----
SPECTRAL = ' "bool spectral" "true"'
# name: (calibration scene, integrator kind, directlighting strategy)
SPECTRAL_CASES = {"spectral_path_knot": ("knot", "path", None),
                  "spectral_path_env": ("env", "path", None),
                  "spectral_directlighting_all_knot": ("knot", "directlighting", "all"),
                  "spectral_directlighting_one_knot": ("knot", "directlighting", "one"),
                  "spectral_directlighting_all_env": ("env", "directlighting", "all"),
                  "spectral_mlt_path_knot": ("knot", "mlt", None)}


def spectral_case_scene(name):
    """The scene text of a SPECTRAL_CASES case: its calibration scene
    under its integrator at DEPTH with the spectral flag (the MLT case at
    SMALL_RES under the path target)."""
    scene, kind, strategy = SPECTRAL_CASES[name]
    if kind == "mlt":
        return small_scene(scene, mlt_line("path") + SPECTRAL)
    return case_scene(scene, kind, strategy).replace(
        integrator_line(kind, strategy=strategy),
        integrator_line(kind, strategy=strategy) + SPECTRAL)


# ---- the forms under "bool spectral" "true" that the port refused before
# its spectral mode (tests/test_torch_path.py, tests/test_torch_integrators.py):
# the reference's images of those it renders spectrally, in SPECTRAL_FORMS.npz
# as <form>_scene and <form>_image ----
SPECTRAL_FORMS = "spectral_forms"
PATH_SMOKE = """
Camera "perspective" "float fov" 45
Film "image" "integer xresolution" [8] "integer yresolution" [8] "string filename" "{OUT}"
Sampler "random" "integer pixelsamples" 1
Integrator "path" "integer maxdepth" 1
WorldBegin
LightSource "infinite" "rgb L" [0.5 0.5 0.5]
WorldEnd
"""
INTEGRATOR_SMOKE = """LookAt 0 0 5  0 0 0  0 1 0
Camera "perspective" "float fov" 45
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Sampler "random" "integer pixelsamples" 2
Integrator "path" "integer maxdepth" 1
WorldBegin
LightSource "infinite" "rgb L" [0.5 0.5 0.5]
AttributeBegin
  Material "matte" "rgb Kd" [0.2 0.6 0.3]
  Shape "trianglemesh" "integer indices" [0 1 2] "point P" [-1 -1 0  1 -1 0  0 1 0]
  Shape "loopsubdiv" "integer levels" 1 "integer indices" [0 1 2 0 2 3]
    "point P" [-1 -1 -1  1 -1 -1  1 1 -1  -1 1 -1]
AttributeEnd
WorldEnd
"""
SPECTRAL_DIRECTIVES = (
    'Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 0 1 0 0 0 1 0]',
    'Material "glass"\nShape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 0 1 0 0 0 1 0]',
    'Material "uber" "rgb Kd" [0.6 0.4 0.3]\nShape "sphere" "float radius" 0.5',
    'MakeNamedMaterial "skin" "string type" "matte" "rgb Kd" [0.6 0.4 0.3]\n'
    'NamedMaterial "skin"\nShape "trianglemesh" "integer indices" [0 1 2] '
    '"point P" [0 0 0 1 0 0 0 1 0]',
    'LightSource "point" "point from" [0 2 0] "rgb I" [3 3 3]\nShape "trianglemesh" '
    '"integer indices" [0 1 2] "point P" [0 0 0 1 0 0 0 1 0]')
SPECTRAL_PATH_OPTIONS = (
    'Integrator "directlighting" "string strategy" "one" "bool spectral" "true"',
    'Integrator "path" "string lightsamplestrategy" "uniform" "bool spectral" "true"')
SPECTRAL_INTEGRATOR_FORMS = ('Integrator "path" "bool spectral" "true"',
                             'Integrator "directlighting" "bool spectral" "true"')


def directive_scene(directive):
    """PATH_SMOKE with a world directive under path and the spectral flag."""
    return PATH_SMOKE.replace("{OUT}", "x.png").replace(
        "WorldEnd", directive + "\nWorldEnd").replace(
        "WorldBegin", 'Integrator "path" "bool spectral" "true"\nWorldBegin')


def option_scene(line):
    """PATH_SMOKE under another Integrator line."""
    return PATH_SMOKE.replace("{OUT}", "x.png").replace("WorldBegin", line + "\nWorldBegin")


def integrator_form_scene(line):
    """INTEGRATOR_SMOKE under another Integrator line."""
    return INTEGRATOR_SMOKE.replace("WorldBegin", line + "\nWorldBegin")


def spectral_form_scenes():
    """{form: scene text} of the forms the reference renders spectrally."""
    out = {f"directive_{i}": directive_scene(d) for i, d in enumerate(SPECTRAL_DIRECTIVES)}
    out.update({f"option_{i}": option_scene(line) for i, line in enumerate(SPECTRAL_PATH_OPTIONS)})
    out.update({f"integrator_{i}": integrator_form_scene(line)
                for i, line in enumerate(SPECTRAL_INTEGRATOR_FORMS)})
    return out


def spectral_form_image(text):
    """The reference's image of a spectral form's scene text."""
    with np.load(os.path.join(HERE, SPECTRAL_FORMS + ".npz")) as z:
        name = next(k[:-6] for k in z.files if k.endswith("_scene") and str(z[k]) == text)
        return z[name + "_image"]
