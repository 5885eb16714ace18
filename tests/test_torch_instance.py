"""Instances and animated shapes: the port's instance world against
pbrt_tpu's on the scenes of tests/test_instancing.py (copied here), the
plain instance walk against the Pallas kernel in interpret mode, and the
port's own renders of instanced and baked scenes. CPU only, at a small size."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import pallas_tables
from test_torch_traverse import decode_walk_tables

from pbrt_tpu.accel.pallas_instance import (intersect_instances,
                                            trs_matrices_at as j_trs_matrices_at)
from pbrt_tpu.scene import load_scene_string as j_load_scene_string
from pbrt_tpu.scene.intersect import intersect as j_intersect
from pbrt_tpu_torch.accel import instance as I
from pbrt_tpu_torch.accel.instance import (IMAT_STRIDE, instance_traverse,
                                           trs_matrices_at)
from pbrt_tpu_torch.accel.traverse import WalkCounts
from pbrt_tpu_torch.render import render_sampler_integrator
from pbrt_tpu_torch.scene import load_scene_string
from pbrt_tpu_torch.scene.intersect import intersect

HEAD = """
LookAt 0 6 6  0 0 0  0 1 0
Camera "perspective" "float fov" 45
Film "image" "integer xresolution" [24] "integer yresolution" [24]
Sampler "02sequence" "integer pixelsamples" 8
Integrator "path" "integer maxdepth" 2
WorldBegin
LightSource "infinite" "rgb L" [0.8 0.8 0.8]
AttributeBegin
  Material "matte" "rgb Kd" [0.5 0.5 0.5]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-20 -1 -20  20 -1 -20  20 -1 20  -20 -1 20]
AttributeEnd
"""

# a small pyramid prototype (4 triangles)
PYRAMID = """
  Shape "trianglemesh" "integer indices" [0 1 2  0 2 3  0 3 1  1 3 2]
    "point P" [0 1 0  -0.5 0 -0.5  0.5 0 -0.5  0 0 0.5]
"""

OFFSETS = [(-2, 0), (0, 0), (2, 0), (-1, -2), (1, -2)]
XFORM = "Translate 1 0.5 0\n  Rotate 40 0 1 0\n  Rotate 25 1 0 0\n  Scale 1.6 0.7 1.1\n"
OBJECT = 'ObjectBegin "pyr"\n  Material "matte" "rgb Kd" [0.7 0.3 0.2]\n' + PYRAMID + 'ObjectEnd\n'


def instances(offsets=OFFSETS):
    return "".join(f'AttributeBegin\n  Translate {x} 0 {z}\n  ObjectInstance "pyr"\nAttributeEnd\n'
                   for x, z in offsets)


ROTATED = 'AttributeBegin\n  ' + XFORM + '  ObjectInstance "pyr"\nAttributeEnd\n'
MOVING = ('AttributeBegin\n  Material "matte" "rgb Kd" [0.8 0.2 0.2]\n'
          '  ActiveTransform StartTime\n  Translate -1.5 0 0\n'
          '  ActiveTransform EndTime\n  Translate 1.5 0 0\n  Rotate 90 0 0 1\n'
          '  ActiveTransform All\n' + PYRAMID + 'AttributeEnd\n')
DEFINED_UNDER_CTM = ('AttributeBegin\nTranslate 0 0.8 0\n' + OBJECT + 'AttributeEnd\n'
                     'AttributeBegin\n  Translate 1 0 0\n  ObjectInstance "pyr"\nAttributeEnd\n')

SCENES = {
    "instanced": HEAD + OBJECT + instances() + "WorldEnd\n",
    "rotated": HEAD + OBJECT + ROTATED + "WorldEnd\n",
    "moving": HEAD + MOVING + "WorldEnd\n",
    "defined_under_ctm": HEAD + DEFINED_UNDER_CTM + "WorldEnd\n",
}
# the walk's scenes: static instances, and the same plus an animated shape
STATIC = HEAD + OBJECT + instances() + ROTATED + "WorldEnd\n"
ANIMATED = HEAD + OBJECT + instances() + ROTATED + MOVING + "WorldEnd\n"


def j_scene(text):
    with pallas_tables():
        cs = j_load_scene_string(text)
    return dataclasses.replace(cs, flags=dataclasses.replace(cs.flags, use_pallas=False))


def shell_rays(n, seed, t_lo=0.0, t_hi=1.0):
    """Rays from a shell of radius 6 toward the pyramids, times in [t_lo, t_hi)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = 6.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    o[:, 1] = np.abs(o[:, 1])
    aim = rng.uniform([-2.5, -1.0, -2.5], [2.5, 1.2, 1.5], (n, 3)).astype(np.float32)
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    time = rng.uniform(t_lo, t_hi, n).astype(np.float32)
    return o, d.astype(np.float32), time


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pack_instance_world_matches_reference(name):
    """Every table of the instance world bit-equal to pbrt_tpu's, in the
    reference's layout; and the same flags and triangle rows."""
    jcs = j_scene(SCENES[name])
    cs = load_scene_string(SCENES[name], device="cpu")
    ib, jb = cs.data.ibvh, jcs.data.ibvh
    M = ib.metas.shape[0]
    np.testing.assert_array_equal(ib.metas.numpy(), np.asarray(jb.metas))
    jnodes = np.asarray(jb.nodes).reshape(-1, 16)
    np.testing.assert_array_equal(ib.nodes.numpy(), jnodes[:M])
    assert not jnodes[M:].any()
    np.testing.assert_array_equal(ib.tris.numpy(), np.asarray(jb.tris).reshape(-1, 16))
    np.testing.assert_array_equal(ib.imat.numpy().reshape(-1), np.asarray(jb.imat))
    for f in ("order", "iroot", "ianim", "i2w", "w2p"):
        np.testing.assert_array_equal(getattr(ib, f).numpy(), np.asarray(getattr(jb, f)), f)
    np.testing.assert_array_equal(ib.wlo, np.asarray(jb.wlo))
    np.testing.assert_array_equal(ib.whi, np.asarray(jb.whi))
    for f in ("n_instances", "n_world_tris", "any_animated_inst", "n_tris"):
        assert getattr(cs.flags, f) == getattr(jcs.flags, f), f
    np.testing.assert_array_equal(cs.data.tri_attr.numpy(), np.asarray(jcs.data.tri_attr))
    np.testing.assert_array_equal(cs.data.world_center, np.asarray(jcs.data.world_center))


@pytest.mark.parametrize("name", ["instanced", "rotated"])
def test_instance_records_decode_to_tables(name):
    """The kernel's walk records decode to metas and nodes (top tree and
    prototypes), and instance record i holds imat[i] and the walk word of
    iroot[i]."""
    ib = load_scene_string(SCENES[name], device="cpu").data.ibvh
    irec = ib.irec.numpy()
    np.testing.assert_array_equal(irec[:, :IMAT_STRIDE], ib.imat.numpy())
    roots = {0: ib.root_word}
    for i, (node, word) in enumerate(zip(ib.iroot.tolist(), irec[:, IMAT_STRIDE].view(np.int32))):
        assert roots.setdefault(node, int(word)) == word, i
    named = decode_walk_tables(ib.recs, roots, ib.metas, ib.nodes)
    assert sorted(named) == list(range(ib.metas.shape[0]))


def test_kernel_stack_holds_the_plain_walk():
    """The packer's bound on the walk's stack (top depth + 1 + the deepest
    prototype's depth + 1) holds the most entries the plain walk held on
    1,024 shell rays of the static bench instance world (64 knots), and
    fits the kernel's stack of STACK entries."""
    from pbrt_tpu_torch.scene.bench import build_instanced_bench_scene
    ib = build_instanced_bench_scene(False, "cpu").data.ibvh
    rng = np.random.default_rng(44)
    o = rng.normal(size=(1024, 3))
    o = 12.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    o[:, 1] = np.abs(o[:, 1])
    d = rng.uniform([-6.0, -1.0, -6.0], [6.0, 1.2, 6.0], (1024, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    counts = WalkCounts(ib.metas)
    I.instance_traverse_plain(ib, *(torch.as_tensor(a, dtype=torch.float32) for a in (o, d)),
                              torch.full((1024,), float("inf")), torch.zeros(1024), False, counts)
    assert counts.enters > 0
    assert 4 <= counts.max_stack <= ib.stack_need <= I.STACK


def _walk_close(got, want, hit_t, t_tol):
    """Equal inst and triangle on >= 99.9% of rays, every mismatch a tie
    (both hit at the same t); t within t_tol max(1, t); b1/b2 within 1e-5
    where the triangle agrees."""
    t, tri, b1, b2, inst = (x.numpy() for x in got)
    jth, jinst = want
    jt, jtri, jb1, jb2, jinst = (np.asarray(x) for x in (jth.t, jth.tri, jth.b1, jth.b2, jinst))
    np.testing.assert_array_equal(tri >= 0, jtri >= 0)
    assert int((tri >= 0).sum()) >= hit_t
    same = (tri == jtri) & (inst == jinst)
    assert same.mean() >= 0.999
    hit = tri >= 0
    assert np.all(np.abs(t[hit] - jt[hit]) <= t_tol * np.maximum(1.0, jt[hit]))
    both = same & hit
    np.testing.assert_allclose(b1[both], jb1[both], rtol=0, atol=1e-5)
    np.testing.assert_allclose(b2[both], jb2[both], rtol=0, atol=1e-5)


@pytest.mark.parametrize("trs", [False, True])
def test_plain_walk_matches_interpret_kernel(trs):
    """2,048 rays, the static path on the static scene and the slerp path
    on the animated one, against `intersect_instances(interpret=True)`;
    times run past [0, 1] to exercise the clip. t is held to 1e-6 max(1, t)
    on the static path and to 1e-5 max(1, t) on the slerp path: XLA's and
    torch's CPU acos, sin and rsqrt round differently (on 100,000 float32
    inputs from a seed they disagree on about 19%, 5% and 30% of them), so
    the two walks' matrices differ in the last bit."""
    text = ANIMATED if trs else STATIC
    jcs = j_scene(text)
    cs = load_scene_string(text, device="cpu")
    assert cs.flags.any_animated_inst == trs
    n = 2048
    o, d, time = shell_rays(n, seed=40 + trs, t_lo=-0.25, t_hi=1.25)
    tm = np.full(n, 1e30, np.float32)
    jtime = jnp.asarray(time) if trs else None
    want = intersect_instances(jcs.data.ibvh, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                               time=jtime, interpret=True, trs=trs)
    tt = torch.as_tensor(time) if trs else torch.zeros(n)
    got = instance_traverse(cs.data.ibvh, torch.as_tensor(o), torch.as_tensor(d),
                            torch.as_tensor(tm), tt, trs)
    assert int((got[4] >= 0).sum()) > 100
    _walk_close(got[:5], want, 300, 1e-5 if trs else 1e-6)
    assert not bool(torch.any(got[5] & (1 << 24)))


def test_trs_matrices_at_matches_reference():
    cs = load_scene_string(ANIMATED, device="cpu")
    rows = cs.data.ibvh.imat.numpy()
    rng = np.random.default_rng(5)
    idx = rng.integers(0, rows.shape[0], 256)
    w = rng.uniform(0, 1, 256).astype(np.float32)
    got = trs_matrices_at(torch.as_tensor(rows[idx]), torch.as_tensor(w))
    want = jax.jit(j_trs_matrices_at)(jnp.asarray(rows[idx]), jnp.asarray(w))
    assert rows.shape[1] == IMAT_STRIDE
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), rtol=1e-6, atol=1e-6)


def test_intersect_matches_reference_on_instances():
    """The port's intersect against pbrt_tpu's on the static instanced
    scene, at the tolerances of tests/test_torch_shading.py; lanes that hit
    a different primitive of a tie are not compared."""
    jcs = j_scene(STATIC)
    cs = load_scene_string(STATIC, device="cpu")
    n = 2048
    o, d, _ = shell_rays(n, seed=40)
    tm = np.full(n, 1e30, np.float32)
    si = intersect(cs.data, cs.flags, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tm))
    ref = jax.jit(lambda *r: j_intersect(jcs.data, jcs.flags, *r))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
    np.testing.assert_array_equal(si.valid.numpy(), np.asarray(ref.valid))
    same = si.valid.numpy() & (si.prim.numpy() == np.asarray(ref.prim))
    assert same.sum() > 1000 and (si.prim.numpy() >= 1).sum() > 100
    np.testing.assert_allclose(si.t.numpy()[same], np.asarray(ref.t)[same], rtol=4e-6, atol=4e-6)
    for f in ("p", "ng", "ns", "uv", "dpdu", "dpdv", "p_err"):
        np.testing.assert_allclose(getattr(si, f).numpy()[same], np.asarray(getattr(ref, f))[same],
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    for f in ("material", "area_light"):
        np.testing.assert_array_equal(getattr(si, f).numpy(), np.asarray(getattr(ref, f)))


def test_instanced_render_matches_baked():
    """The port alone: shared-prototype instances render as the same scene
    with the geometry written out, as pbrt_tpu is held in
    tests/test_instancing.py."""
    baked = HEAD + "".join('AttributeBegin\n  Material "matte" "rgb Kd" [0.7 0.3 0.2]\n'
                           f'  Translate {x} 0 {z}\n' + PYRAMID + 'AttributeEnd\n'
                           for x, z in OFFSETS) + "WorldEnd\n"
    cs_i = load_scene_string(SCENES["instanced"], device="cpu")
    cs_b = load_scene_string(baked, device="cpu")
    assert cs_i.flags.n_instances == len(OFFSETS) and cs_b.flags.n_instances == 0
    assert cs_i.data.tri_attr.shape[0] == 2 + 4
    img_i, _, _ = render_sampler_integrator(cs_i)
    img_b, _, _ = render_sampler_integrator(cs_b)
    np.testing.assert_allclose(img_i.numpy(), img_b.numpy(), rtol=2e-4, atol=2e-4)


def test_instance_only_scene_renders():
    """No world triangles at all: every hit comes from the instance walk."""
    text = HEAD.split("AttributeBegin")[0] + OBJECT + instances() + MOVING + "WorldEnd\n"
    cs = load_scene_string(text, device="cpu")
    assert cs.flags.n_tris == 0 and cs.flags.n_instances == len(OFFSETS) + 1
    img, cnt, _ = render_sampler_integrator(cs)
    assert bool(torch.isfinite(img).all()) and cnt["valid_hits"] > 0
    assert float(img.min()) < 0.5 * float(img.max())
