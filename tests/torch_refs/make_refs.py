"""Write the reference outputs of the port's integrator tests: pbrt_tpu,
jitted on the CPU, on the cases of cases.py, one <name>.npz each beside
this file.

    JAX_PLATFORMS=cpu python tests/torch_refs/make_refs.py [name ...]

With names, only those cases are written. The whitted and
directlighting cases store L, p_film and the live-ray counters of 1,024
lanes at depth 3; the BDPT cases store _bdpt_sample's L, p_film, splat
positions and values and counters; the volpath cases the same as li, and
the intersect_tr cases the transmittance and occlusion of 1,024 shadow
rays; render_bdpt_env the developed 16x16 image.

The MLT target cases store _eval_bdpt_target's L and raster positions, or
_eval_target's L and li_path's outputs under both hooks, for 1,024 seeded
primary sample vectors. render_mlt_point runs render_mlt with its jitted
functions recorded: the bootstrap weights, the chain starts, the first
Metropolis step run again eagerly with its locals kept (the proposal, the
acceptance), and the image. The SPPM iteration cases run _sppm_iteration
jitted for its outputs, and once more eagerly with its locals and the
first _deposit call's inputs (its live photons' rows) and outputs kept;
render_sppm_point stores
the 4-iteration image and the overflow count. The path cases (PATH_CASES)
store li_path's L, p_film, ray weights and counters of 1,024 lanes at
depth 3; path_realistic's camera has its lens opened (cases.open_lens).
The spectral cases (SPECTRAL_CASES) store li_path's or li_direct's
outputs the same way under "bool spectral" "true", and the MLT one
_eval_target's L and film positions; spectral_forms the reference's
render (pbrt_tpu.render.render) of each spectral form's scene
(cases.spectral_form_scenes).
"""
from __future__ import annotations

import functools
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

from torch_refs import cases as C  # noqa: E402

COUNT_KEYS = ("camera_rays", "shadow_rays", "bounce_rays", "valid_hits")


def _counts(cnt):
    return {f"cnt_{k}": np.int64(round(float(cnt[k]))) for k in COUNT_KEYS}


def _save(name, **arrays):
    np.savez_compressed(os.path.join(HERE, name + ".npz"), **arrays)
    print("wrote", name, flush=True)


def li_case(name, scene, kind, strategy, seed):
    from pbrt_tpu.scene import load_scene_string
    text = C.case_scene(scene, kind, strategy)
    jcs = load_scene_string(text)
    if kind == "whitted":
        from pbrt_tpu.integrators.whitted import li_whitted as li
        kw = {}
    else:
        from pbrt_tpu.integrators.direct import li_direct as li
        kw = {"strategy": strategy}
    px, py, s = C.case_lanes(text, seed)
    f = jax.jit(lambda a, b, c: li(jcs, a, b, c, max_depth=C.DEPTH, with_stats=True, **kw))
    L, p_film, _, cnt = f(jnp.asarray(px), jnp.asarray(py), jnp.asarray(s))
    _save(name, scene=text, px=px, py=py, s=s, seed=seed, L=np.asarray(L),
          p_film=np.asarray(p_film), **_counts(cnt))


def path_case(name, seed):
    from pbrt_tpu.integrators.path import li_path
    from pbrt_tpu.scene import load_scene_string
    text = C.path_case_scene(name)
    jcs = load_scene_string(text)
    if name == "path_realistic":
        from pbrt_tpu.cameras import realistic as JR
        lens, bounds = C.open_lens(JR.load_lens_system, JR._trace_from_film_np, JR.normalize_np)
        object.__setattr__(jcs.camera, "lens_elements", lens)
        object.__setattr__(jcs.camera, "_exit_pupil", bounds)
    px, py, s = C.case_lanes(text, seed)
    f = jax.jit(lambda a, b, c: li_path(jcs, a, b, c, max_depth=C.DEPTH, with_stats=True))
    L, p_film, w, cnt = f(jnp.asarray(px), jnp.asarray(py), jnp.asarray(s))
    _save(name, scene=text, px=px, py=py, s=s, seed=seed, L=np.asarray(L),
          p_film=np.asarray(p_film), w=np.asarray(w), **_counts(cnt))


def volpath_case(name, grid, seed):
    from pbrt_tpu.integrators.volpath import li_volpath
    from pbrt_tpu.scene import load_scene
    from pbrt_tpu_torch.scene.bench import write_volpath_scene
    d = tempfile.mkdtemp()
    path = write_volpath_scene(d, large=False, grid=grid, knot=C.VOLPATH_KNOT)
    jcs = load_scene(path)
    rng = np.random.default_rng(seed)
    px, py, s = (rng.integers(0, 64, C.N_LANES).astype(np.int32),
                 rng.integers(0, 64, C.N_LANES).astype(np.int32),
                 rng.integers(0, 4, C.N_LANES).astype(np.int32))
    f = jax.jit(lambda a, b, c: li_volpath(jcs, a, b, c, max_depth=C.DEPTH, with_stats=True))
    L, p_film, _, cnt = f(jnp.asarray(px), jnp.asarray(py), jnp.asarray(s))
    _save(name, scene=open(path).read(), px=px, py=py, s=s, seed=seed, L=np.asarray(L),
          p_film=np.asarray(p_film), **_counts(cnt))


def intersect_tr_case(name, grid):
    from pbrt_tpu.integrators.volpath import intersect_tr
    from pbrt_tpu.scene import load_scene
    from pbrt_tpu_torch.scene.bench import write_volpath_scene
    path = write_volpath_scene(tempfile.mkdtemp(), large=False, grid=grid, knot=C.VOLPATH_KNOT)
    jcs = load_scene(path)
    o, d, dist, mid, pix = C.tr_inputs(grid)
    tr, occ = intersect_tr(jcs.data, jcs.flags, jnp.asarray(mid), jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(dist), 0xA100, tuple(jnp.asarray(p) for p in pix))
    _save(name, scene=open(path).read(), o=o, d=d, dist=dist, mid=mid, pix=np.stack(pix),
          seed=3, tr=np.asarray(tr), occ=np.asarray(occ))


def bdpt_case(name, scene, seed, hook=None):
    from pbrt_tpu.integrators.bdpt import _bdpt_sample
    from pbrt_tpu.scene import load_scene_string
    text = C.case_scene(scene, "bdpt")
    jcs = load_scene_string(text)
    px, py, s = C.case_lanes(text, seed)
    D = C.DEPTH + 1
    extra = {}
    if hook is None:
        f = jax.jit(lambda a, b, c: _bdpt_sample(jcs, a, b, c, D, with_stats=True))
        L, p_film, sp, sv, cnt = f(jnp.asarray(px), jnp.asarray(py), jnp.asarray(s))
        extra = dict(splat_p=np.asarray(sp), splat_v=np.asarray(sv), **_counts(cnt))
    elif hook == "st_filter":
        f = jax.jit(lambda a, b, c: _bdpt_sample(jcs, a, b, c, D, st_filter=C.ST_FILTER))
        L, p_film, sp, sv = f(jnp.asarray(px), jnp.asarray(py), jnp.asarray(s))
        extra = dict(splat_p=np.asarray(sp), splat_v=np.asarray(sv))
    else:
        res = jcs.film.full_resolution[0]
        table, p_over, s_sel, t_sel = C.hook_inputs(seed, res)
        extra = dict(table=table, p_over=p_over, s_sel=s_sel, t_sel=t_sel)
        if hook == "st_select":
            f = jax.jit(lambda a, b, c, ss, tt: _bdpt_sample(jcs, a, b, c, D,
                                                            st_select=(ss, tt)))
            L, p_film, _, _ = f(jnp.asarray(px), jnp.asarray(py), jnp.asarray(s),
                                jnp.asarray(s_sel), jnp.asarray(t_sel))
        else:
            def run(a, b, c, tab, po):
                return _bdpt_sample(jcs, a, b, c, D, sampler_fn=lambda dim: tab[:, dim],
                                    p_film_override=po)
            L, p_film, sp, sv = jax.jit(run)(jnp.asarray(px), jnp.asarray(py), jnp.asarray(s),
                                              jnp.asarray(table), jnp.asarray(p_over))
            extra.update(splat_p=np.asarray(sp), splat_v=np.asarray(sv))
    _save(name, scene=text, px=px, py=py, s=s, seed=seed, L=np.asarray(L),
          p_film=np.asarray(p_film), **extra)


def render_case():
    from pbrt_tpu.integrators.bdpt import render_bdpt
    from pbrt_tpu.scene import load_scene_string
    name, scene, res, spp = C.RENDER_CASE
    text = C.case_scene(scene, "bdpt", res=res, spp=spp)
    img = render_bdpt(load_scene_string(text))
    _save(name, scene=text, seed=0, image=np.asarray(img, np.float32))


def _recorded(codes, fn, *args):
    """Call fn(*args) under sys.setprofile -> (its result, {code: {"call":
    the arguments of its first call, "return": that call's result,
    "locals": the frame's locals as its last call returned}}) for each
    code object in codes."""
    got = {c: {} for c in codes}

    def prof(frame, event, arg):
        rec = got.get(frame.f_code)
        if rec is None:
            return
        if event == "call" and "call" not in rec:
            rec["call"] = dict(frame.f_locals)
        elif event == "return":
            rec.setdefault("return", arg)
            rec["locals"] = dict(frame.f_locals)

    sys.setprofile(prof)
    try:
        out = fn(*args)
    finally:
        sys.setprofile(None)
    return out, got


def mlt_target_case(name, scene, target, seed):
    from pbrt_tpu.integrators import mlt as M
    from pbrt_tpu.integrators.path import li_path
    from pbrt_tpu.scene import load_scene_string
    text = C.small_scene(scene, C.mlt_line(target))
    jcs = load_scene_string(text)
    if target == "bdpt":
        u, depth = C.mlt_inputs(seed, M._n_dims_bdpt(C.DEPTH))
        L, raster = jax.jit(lambda a, b: M._eval_bdpt_target(jcs, a, C.DEPTH, b))(
            jnp.asarray(u), jnp.asarray(depth))
        _save(name, scene=text, seed=seed, L=np.asarray(L), p_film=np.asarray(raster))
        return
    u, _ = C.mlt_inputs(seed, M._n_dims(C.DEPTH))
    L_eval, p_eval = jax.jit(lambda a: M._eval_target(jcs, a, C.DEPTH))(jnp.asarray(u))
    # li_path under both hooks at film positions of their own
    p_over = np.random.default_rng(seed + 1).uniform(0, C.SMALL_RES, (C.N_LANES, 2)).astype(
        np.float32)
    px, py = (p_over[:, k].astype(np.int32) for k in (0, 1))

    def run(a, b, tab, po):
        U = tab.shape[1]
        return li_path(jcs, a, b, jnp.zeros_like(a), max_depth=C.DEPTH,
                       sampler_fn=lambda d: tab[:, min(d, U - 1)], p_film_override=po,
                       with_stats=True)
    L, p_film, ray_w, cnt = jax.jit(run)(jnp.asarray(px), jnp.asarray(py), jnp.asarray(u),
                                         jnp.asarray(p_over))
    _save(name, scene=text, seed=seed, L_eval=np.asarray(L_eval), p_eval=np.asarray(p_eval),
          p_over=p_over, px=px, py=py, L=np.asarray(L), p_film=np.asarray(p_film),
          ray_w=np.asarray(ray_w), **_counts(cnt))


def mlt_render_case():
    """render_mlt with its jitted eval_t and mlt_step recorded, then the
    first step run again eagerly on its recorded inputs."""
    from pbrt_tpu.core.spectrum import luminance
    from pbrt_tpu.integrators import mlt as M
    from pbrt_tpu.scene import load_scene_string
    name, scene, (n_boot, n_chains, mpp) = C.MLT_RENDER
    text = C.small_scene(scene, C.mlt_line("bdpt", n_boot, n_chains, mpp))
    jcs = load_scene_string(text)
    rec = {"eval": []}
    real_jit = jax.jit

    def jit(fn=None, **kw):
        if fn is None:
            return functools.partial(jit, **kw)
        jf = real_jit(fn, **kw)
        if getattr(fn, "__name__", "") == "mlt_step":
            rec["step_fn"] = fn

            def step(*a):
                rec.setdefault("step_in", jax.tree.map(np.asarray, a))
                return jf(*a)
            return step
        if getattr(fn, "__name__", "") == "eval_t":
            def ev(*a):
                out = jf(*a)
                rec["eval"].append((jax.tree.map(np.asarray, a), jax.tree.map(np.asarray, out)))
                return out
            return ev
        return jf

    jax.jit = jit
    try:
        img = M.render_mlt(jcs)
    finally:
        jax.jit = real_jit
    n_chunks = len(rec["eval"]) - 1
    w_boot = np.concatenate([np.asarray(luminance(jnp.asarray(out[0])))
                             for _, out in rec["eval"][:n_chunks]])[:n_boot]
    (u0, depth_lane), (L0, pf0) = rec["eval"][n_chunks]
    fn = rec["step_fn"]
    closure = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    film, u_in, L_in, y_in, pf_in, step = rec["step_in"]
    out, got = _recorded([fn.__code__], fn, jax.tree.map(jnp.asarray, film),
                         *(jnp.asarray(x) for x in (u_in, L_in, y_in, pf_in, step)))
    loc = got[fn.__code__]["locals"]
    film_out, u_out, L_out, y_out, pf_out, n_acc = out
    np.testing.assert_array_equal(u_in, u0)
    _save(name, scene=text, seed=0, image=np.asarray(img, np.float32), w_boot=w_boot,
          b=np.float64(closure["b"]), u0=u0, depth_lane=np.asarray(depth_lane), L0=L0, pf0=pf0,
          y_in=y_in, step=step, u_prop=np.asarray(loc["u_prop"]),
          large=np.asarray(loc["large"]), L_prop=np.asarray(loc["L_prop"]),
          pf_prop=np.asarray(loc["pf_prop"]), a=np.asarray(loc["a"]),
          acc=np.asarray(loc["acc"]), splat=np.asarray(film_out.splat),
          u_out=np.asarray(u_out), n_acc=np.float32(n_acc))


def sppm_iteration_case(name, scene):
    """One _sppm_iteration jitted (its outputs), and the same eagerly with
    its locals and its first _deposit call recorded."""
    from pbrt_tpu.integrators import sppm as S
    from pbrt_tpu.render import _sample_pixels
    from pbrt_tpu.scene import load_scene_string
    r0 = C.SPPM_SCENES[scene]
    text = C.small_scene(scene, C.sppm_line(r0))
    jcs = load_scene_string(text)
    px, py = _sample_pixels(jcs)
    n = px.shape[0]
    state = (jnp.full((n,), r0, jnp.float32), jnp.zeros((n, 3), jnp.float32),
             jnp.zeros((n, 3), jnp.float32), jnp.zeros((n,), jnp.float32))
    it = jnp.int32(C.SPPM_ITERATION)
    args = (jnp.asarray(px), jnp.asarray(py), it, *state)
    r_new, ld_sum, tau, n_ph, ovf = jax.jit(functools.partial(
        S._sppm_iteration, jcs, C.DEPTH, C.SPPM_PHOTONS))(*args)
    codes = (S._sppm_iteration.__code__, S._deposit.__code__)
    _, got = _recorded(codes, S._sppm_iteration, jcs, C.DEPTH, C.SPPM_PHOTONS, *args)
    loc, dep_in = got[codes[0]]["locals"], got[codes[1]]["call"]
    phi, m_count, overflow = got[codes[1]]["return"]
    si = loc["si_keep"]
    live = np.asarray(dep_in["ph_active"])   # the rows a deposit reads
    lobes = {f"lobe_{k}": np.asarray(v) for k, v in loc["vp_lobes"]._asdict().items()}
    _save(name, scene=text, px=px, py=py, radius=np.float32(r0), it=np.int32(C.SPPM_ITERATION),
          vp_valid=np.asarray(loc["vp_valid"]), vp_p=np.asarray(loc["vp_p"]),
          vp_wo=np.asarray(loc["vp_wo"]), vp_beta=np.asarray(loc["vp_beta"]),
          ld=np.asarray(loc["ld"]), vp_ns=np.asarray(si.ns), vp_ss=np.asarray(si.ss),
          vp_ts=np.asarray(si.ts), vp_cell=np.asarray(loc["vp_cell"]),
          order=np.asarray(loc["order"]), sorted_cell=np.asarray(loc["sorted_cell"]),
          cell_size=np.asarray(loc["cell_size"]),
          ph_p=np.asarray(dep_in["ph_p"])[live], ph_beta=np.asarray(dep_in["ph_beta"])[live],
          ph_dir=np.asarray(dep_in["ph_dir"])[live], ph_index=np.nonzero(live)[0],
          phi=np.asarray(phi), m_count=np.asarray(m_count), overflow=np.asarray(overflow),
          out_radius=np.asarray(r_new), out_ld=np.asarray(ld_sum), out_tau=np.asarray(tau),
          out_n=np.asarray(n_ph), out_overflow=np.asarray(ovf), **lobes)


def sppm_render_case():
    from pbrt_tpu.integrators.sppm import render_sppm
    from pbrt_tpu.scene import load_scene_string
    from pbrt_tpu.utils.stats import STATS
    name, scene, iterations = C.SPPM_RENDER
    text = C.small_scene(scene, C.sppm_line(C.SPPM_SCENES[scene], iterations,
                                            photons=-1))
    key = "SPPM/Grid cell overflows (deposits skipped)"
    STATS.counters.pop(key, None)
    img = render_sppm(load_scene_string(text))
    _save(name, scene=text, seed=0, image=np.asarray(img, np.float32),
          overflow=np.float64(STATS.counters.get(key, 0.0)))


def spectral_case(name, seed):
    from pbrt_tpu.integrators import mlt as M
    from pbrt_tpu.integrators.direct import li_direct
    from pbrt_tpu.integrators.path import li_path
    from pbrt_tpu.scene import load_scene_string
    _, kind, strategy = C.SPECTRAL_CASES[name]
    text = C.spectral_case_scene(name)
    jcs = load_scene_string(text)
    assert jcs.flags.spectral
    if kind == "mlt":
        u, _ = C.mlt_inputs(seed, M._n_dims(C.DEPTH))
        L, p_film = jax.jit(lambda a: M._eval_target(jcs, a, C.DEPTH))(jnp.asarray(u))
        _save(name, scene=text, seed=seed, L=np.asarray(L), p_film=np.asarray(p_film))
        return
    li, kw = (li_path, {}) if kind == "path" else (li_direct, {"strategy": strategy})
    px, py, s = C.case_lanes(text, seed)
    f = jax.jit(lambda a, b, c: li(jcs, a, b, c, max_depth=C.DEPTH, with_stats=True, **kw))
    L, p_film, w, cnt = f(jnp.asarray(px), jnp.asarray(py), jnp.asarray(s))
    _save(name, scene=text, px=px, py=py, s=s, seed=seed, L=np.asarray(L),
          p_film=np.asarray(p_film), w=np.asarray(w), **_counts(cnt))


def spectral_forms_case():
    from pbrt_tpu.render import render
    from pbrt_tpu.scene import load_scene_string
    out = {}
    for form, text in C.spectral_form_scenes().items():
        jcs = load_scene_string(text)
        assert jcs.flags.spectral, form
        out[f"{form}_scene"] = text
        out[f"{form}_image"] = np.asarray(render(jcs), np.float32)
    _save(C.SPECTRAL_FORMS, **out)


def all_cases():
    out = {}
    for i, (name, scene, kind, st) in enumerate(C.LI_CASES):
        out[name] = functools.partial(li_case, name, scene, kind, st, 10 + i)
    for grid in (False, True):
        name = "volpath_grid" if grid else "volpath_homogeneous"
        out[name] = functools.partial(volpath_case, name, grid, 4)
        name = "intersect_tr_grid" if grid else "intersect_tr_homogeneous"
        out[name] = functools.partial(intersect_tr_case, name, grid)
    for i, scene in enumerate(C.BDPT_SCENES):
        out[f"bdpt_{scene}"] = functools.partial(bdpt_case, f"bdpt_{scene}", scene, 20 + i)
    for i, hook in enumerate(C.BDPT_HOOKS):
        out[f"bdpt_{hook}"] = functools.partial(bdpt_case, f"bdpt_{hook}", "knot", 30 + i, hook)
    out[C.RENDER_CASE[0]] = render_case
    for i, scene in enumerate(C.MLT_SCENES):
        for j, target in enumerate(("bdpt", "path")):
            out[f"mlt_{target}_{scene}"] = functools.partial(
                mlt_target_case, f"mlt_{target}_{scene}", scene, target, 40 + 2 * i + j)
    out[C.MLT_RENDER[0]] = mlt_render_case
    for scene in C.SPPM_SCENES:
        out[f"sppm_iteration_{scene}"] = functools.partial(sppm_iteration_case,
                                                           f"sppm_iteration_{scene}", scene)
    out[C.SPPM_RENDER[0]] = sppm_render_case
    for i, name in enumerate(C.PATH_CASES):
        out[name] = functools.partial(path_case, name, 50 + i)
    for i, name in enumerate(C.SPECTRAL_CASES):
        out[name] = functools.partial(spectral_case, name, 60 + i)
    out[C.SPECTRAL_FORMS] = spectral_forms_case
    return out


if __name__ == "__main__":
    todo = all_cases()
    for name in sys.argv[1:] or list(todo):
        todo[name]()
