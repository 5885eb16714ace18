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
    return out


if __name__ == "__main__":
    todo = all_cases()
    for name in sys.argv[1:] or list(todo):
        todo[name]()
