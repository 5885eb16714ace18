"""Shading-side modules of the port against pbrt_tpu on identical inputs:
hit assembly, materials, BSDFs, lights, camera, filters and film, at
rtol 1e-5 / atol 1e-6 unless a test states otherwise."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import jax_bench_scene, jax_scene_arrays, rays_at_knot

from pbrt_tpu import lights as JL
from pbrt_tpu.cameras import CameraSamples, generate_rays as j_generate_rays
from pbrt_tpu.film import FilmState as JFilm, add_samples as j_add, develop as j_develop
from pbrt_tpu.filters import build_table as j_table, make_filter as j_make_filter
from pbrt_tpu.materials import bsdf as JB, compute_lobes as j_compute_lobes
from pbrt_tpu.scene.intersect import (_assemble_si as j_assemble, intersect as j_intersect,
                                      kernel_bary as j_kernel_bary)
from pbrt_tpu_torch import lights as LT
from pbrt_tpu_torch.accel.traverse import traverse
from pbrt_tpu_torch.cameras import generate_rays
from pbrt_tpu_torch.film import FilmState, add_samples, develop, make_film
from pbrt_tpu_torch.filters import build_table, make_filter
from pbrt_tpu_torch.materials import bsdf as B, compute_lobes
from pbrt_tpu_torch.scene.bridge import from_jax_arrays
from pbrt_tpu_torch.scene.intersect import _assemble_si, intersect, kernel_bary

RTOL, ATOL = 1e-5, 1e-6
FAMS = (False, True, False, False, False)   # matte + plastic: diffuse, glossy


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def scenes():
    jcpu, jcs = jax_bench_scene(large=False)
    arrays, specs = jax_scene_arrays(jcs)
    return jcpu, jcs, from_jax_arrays(arrays, specs, "cpu")


@pytest.fixture(scope="module")
def hits(scenes):
    _, _, cs = scenes
    n = 2048
    o, d = rays_at_knot(n, seed=21)
    tm = np.full(n, np.inf, np.float32)
    t, slot, _ = traverse(cs.data.bvh, torch.as_tensor(o), torch.as_tensor(d),
                          torch.as_tensor(tm), torch.zeros(n, dtype=torch.uint8))
    return o, d, tm, t, slot


SI_FIELDS = ("valid", "t", "p", "p_err", "wo", "ng", "ns", "ss", "ts", "uv",
             "dpdu", "dpdv", "prim", "material", "area_light")


def test_assemble_si_matches_reference(scenes, hits):
    _, jcs, cs = scenes
    o, d, tm, t, slot = hits
    si = _assemble_si(cs.data, torch.as_tensor(o), torch.as_tensor(d), t, slot)
    q_id = jnp.full((o.shape[0],), -1, jnp.int32)
    ref = j_assemble(jcs.data, jcs.flags, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                     jnp.asarray(t.numpy()), jnp.asarray(slot.numpy()), None, None,
                     jnp.asarray(t.numpy()), q_id, slot=jnp.asarray(slot.numpy()))
    assert int(si.valid.sum()) > 1000
    for f in SI_FIELDS:
        close(getattr(si, f), getattr(ref, f))


def test_kernel_bary_matches_reference(scenes, hits):
    _, _, cs = scenes
    o, d, _, _, slot = hits
    attr = cs.data.slot_attr[torch.clamp(slot, min=0).long()]
    p = [attr[:, i:i + 3] for i in (0, 3, 6)]
    got = kernel_bary(torch.as_tensor(o), torch.as_tensor(d), *p)
    want = j_kernel_bary(jnp.asarray(o), jnp.asarray(d), *(jnp.asarray(x.numpy()) for x in p))
    for g, w in zip(got, want):
        close(g, w)


def test_intersect_matches_reference_walk(scenes):
    """End to end against the reference's CPU path: its XLA walk computes
    barycentrics with difference-of-products edge functions, the kernel
    path with plain products, so positions are held to atol 1e-4 (the
    floor spans 20 units) and lanes that hit a different triangle of an
    exact tie are not compared."""
    jcpu, _, cs = scenes
    n = 2048
    o, d = rays_at_knot(n, seed=22)
    tm = np.full(n, np.inf, np.float32)
    si = intersect(cs.data, cs.flags, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tm))
    ref = j_intersect(jcpu.data, jcpu.flags, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
    close(si.valid, ref.valid)
    same = si.valid.numpy() & (si.prim.numpy() == np.asarray(ref.prim))
    assert same.sum() > 1000
    close(si.t[same], np.asarray(ref.t)[same], rtol=4e-6, atol=4e-6)
    for f in ("p", "ng", "ns", "uv", "dpdu", "dpdv"):
        close(getattr(si, f)[same], np.asarray(getattr(ref, f))[same], rtol=1e-4, atol=1e-4)
    for f in ("material", "area_light"):
        close(getattr(si, f), getattr(ref, f))


def test_compute_lobes_matches_reference(scenes):
    _, jcs, cs = scenes
    n = 512
    mat = np.random.default_rng(2).integers(-1, cs.data.mats.kind.shape[0], n).astype(np.int32)
    lb = compute_lobes(cs.data.mats, cs.data.tex, torch.as_tensor(mat), torch.zeros((n, 2)),
                       torch.zeros((n, 3)), None, cs.flags.has_tex_slot, cs.flags.tex_kinds)
    z2 = jnp.zeros((n, 2))
    ref = j_compute_lobes(jcs.data.mats, jcs.data.tex, jnp.asarray(mat), z2, jnp.zeros((n, 3)),
                          jnp.zeros(n), (False,) * 10)
    for f in ("kd", "ks", "rough_u", "rough_v", "eta"):
        close(getattr(lb, f), getattr(ref, f))


def _lobes(n, seed):
    rng = np.random.default_rng(seed)
    kd = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    ks = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    kd[::5] = 0.0
    ks[::3] = 0.0
    ks[1::7] = 0.0
    kd[1::7] = 0.0                       # some lanes with no lobe at all
    # Isotropic, as matte and plastic are, and alpha >= 0.1 (the bench's
    # plastic has alpha 0.46). The two libraries' rsqrt differ by 1-2 ulps
    # in a normalized half vector; D reads it through 1 - cos^2, so with
    # alpha_x != alpha_y, or near the peak of an alpha 0.015 lobe, that
    # grows to 1e-4 .. 2e-3 relative (measured).
    ru = rng.uniform(0.1, 0.8, n).astype(np.float32)
    rv = ru
    eta = rng.uniform(1.2, 2.0, n).astype(np.float32)
    t = B.Lobes(*(torch.as_tensor(a) for a in (kd, ks, ru, rv, eta)))
    j = JB.Lobes.zeros(n)._replace(kd=jnp.asarray(kd), ks=jnp.asarray(ks),
                                   rough_u=jnp.asarray(ru), rough_v=jnp.asarray(rv),
                                   eta=jnp.asarray(eta))
    return t, j


def _dirs(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_bsdf_f_and_pdf_match_reference():
    n = 4096
    lb, jl = _lobes(n, 3)
    wo, wi = _dirs(n, 4), _dirs(n, 5)
    two, twi, jwo, jwi = torch.as_tensor(wo), torch.as_tensor(wi), jnp.asarray(wo), jnp.asarray(wi)
    close(B.bsdf_f(lb, two, twi), JB.bsdf_f(jl, jwo, jwi, fams=FAMS))
    close(B.bsdf_pdf(lb, two, twi), JB.bsdf_pdf(jl, jwo, jwi, fams=FAMS))


def test_bsdf_sample_matches_reference():
    n = 4096
    lb, jl = _lobes(n, 6)
    wo = _dirs(n, 7)
    rng = np.random.default_rng(8)
    u_lobe = rng.uniform(0, 1, n).astype(np.float32)
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    bs = B.bsdf_sample(lb, torch.as_tensor(wo), torch.as_tensor(u_lobe), torch.as_tensor(u2))
    ref = JB.bsdf_sample(jl, jnp.asarray(wo), jnp.asarray(u_lobe), jnp.asarray(u2), fams=FAMS)
    # The GGX warp's atan2/sin/cos round differently in XLA and PyTorch, so
    # sampled directions agree to 2e-5. f and pdf are compared where the
    # reference's own direction is fed back into the port: sampled
    # directions sit at the glossy lobe's peak, where the rsqrt ulps above
    # reach 2.4e-5 relative (measured), so they are held at rtol 1e-4.
    close(bs.is_specular, ref.is_specular)
    close(bs.wi, ref.wi, atol=2e-5)
    ok = np.asarray(ref.pdf) > 0
    assert ok.mean() > 0.5 and np.mean((bs.pdf.numpy() > 0) == ok) >= 0.999
    two, rwi = torch.as_tensor(wo), torch.as_tensor(np.array(ref.wi))
    close(B.bsdf_f(lb, two, rwi)[ok], np.asarray(ref.f)[ok], rtol=1e-4)
    close(B.bsdf_pdf(lb, two, rwi)[ok], np.asarray(ref.pdf)[ok], rtol=1e-4)


def test_sample_li_and_pdf_li_match_reference(scenes):
    _, jcs, cs = scenes
    n = 2048
    rng = np.random.default_rng(9)
    ref_p = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    idx = rng.integers(0, cs.flags.n_lights, n)
    jd = jcs.data
    ls = LT.sample_li(cs.data.lights, torch.as_tensor(idx), torch.as_tensor(ref_p),
                      torch.as_tensor(u2), cs.data.world_radius)
    ref = JL.sample_li(jd.lights, jd, jnp.asarray(idx, jnp.int32), jnp.asarray(ref_p),
                       jnp.asarray(u2), jd.world_center, jd.world_radius)
    for f in ("wi", "li", "pdf", "p_light"):
        close(getattr(ls, f), getattr(ref, f), rtol=2e-5)
    hit_t = rng.uniform(0.1, 5, n).astype(np.float32)
    hit_cos = rng.uniform(0, 1, n).astype(np.float32)
    got = LT.pdf_li(cs.data.lights, torch.as_tensor(idx), torch.as_tensor(hit_t),
                    torch.as_tensor(hit_cos))
    want = JL.pdf_li(jd.lights, jd, jnp.asarray(idx, jnp.int32), jnp.asarray(ref_p),
                     jnp.asarray(_dirs(n, 10)), jnp.asarray(hit_t), jnp.asarray(hit_cos),
                     jd.world_radius)
    close(got, want)


def test_light_emission_matches_reference(scenes):
    _, jcs, cs = scenes
    n = 1024
    rng = np.random.default_rng(11)
    idx = rng.integers(-1, cs.flags.n_lights, n)
    ng, wo = _dirs(n, 12), _dirs(n, 13)
    got = LT.le_area(cs.data.lights, torch.as_tensor(idx), torch.as_tensor(ng), torch.as_tensor(wo))
    want = JL.le_area(jcs.data.lights, jnp.asarray(idx, jnp.int32), jnp.asarray(ng), jnp.asarray(wo))
    close(got, want)
    close(LT.le_escaped(cs.data.lights, cs.flags.infinite_light_ids, torch.as_tensor(wo)),
          JL.le_escaped(jcs.data.lights, jnp.asarray(wo)))


def test_generate_rays_matches_reference(scenes):
    _, jcs, cs = scenes
    n = 4096
    rng = np.random.default_rng(14)
    p_film = rng.uniform(0, 64, (n, 2)).astype(np.float32)
    got, w = generate_rays(cs.camera, torch.as_tensor(p_film), differentials=True)
    rays, jw = j_generate_rays(jcs.camera, CameraSamples(jnp.asarray(p_film), jnp.zeros((n, 2)),
                                                         jnp.zeros(n)))
    for k in ("o", "d", "rx_o", "rx_d", "ry_o", "ry_d"):
        close(getattr(got, k), getattr(rays, k))
    close(w, jw)


@pytest.mark.parametrize("kind", ["box", "triangle", "gaussian", "mitchell", "sinc"])
def test_filter_table_matches_reference(kind):
    params = {"xwidth": [1.5], "ywidth": [1.0]} if kind != "box" else {}
    got = build_table(make_filter(kind, params))
    want = np.asarray(j_table(j_make_filter(kind, params)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["box", "gaussian"])
def test_film_matches_reference(kind):
    params = {"xresolution": [24], "yresolution": [16], "cropwindow": [0.1, 0.9, 0.0, 1.0]}
    spec = make_film(params, make_filter(kind, {}))
    from pbrt_tpu.film import make_film as j_make_film
    jspec = j_make_film(params, j_make_filter(kind, {}))
    n = 3000
    rng = np.random.default_rng(15)
    p_film = (rng.uniform(-1, 1, (n, 2)) * [13, 9] + [12, 8]).astype(np.float32)
    L = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    L[::97] = np.inf
    w = rng.uniform(0.5, 1, n).astype(np.float32)
    table = build_table(spec.filter)
    st = add_samples(spec, FilmState.zeros(spec, "cpu"), torch.as_tensor(p_film),
                     torch.as_tensor(L), torch.as_tensor(w), torch.as_tensor(table))
    js = j_add(jspec, JFilm.zeros(jspec), jnp.asarray(p_film), jnp.asarray(L), jnp.asarray(w),
               table=jnp.asarray(table))
    close(st.rgb_sum, js.rgb_sum, rtol=1e-5, atol=1e-5)   # another summation order
    close(st.weight_sum, js.weight_sum, rtol=1e-5, atol=1e-5)
    close(develop(spec, st), j_develop(jspec, js), rtol=1e-5, atol=1e-5)
