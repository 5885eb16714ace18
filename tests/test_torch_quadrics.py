"""Quadrics and curves against pbrt_tpu on the CPU: intersect_quadric per kind
on seeded object-space rays, the host build, bounds and tessellation, the
batched quadric pass and intersect_p over a table of all six kinds, curve
tessellation, the front end's tables of a scene with every new shape, and
an animated quadric, which stays at its start transform as in the
reference."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import jax_scene_arrays, pallas_tables

from pbrt_tpu.core.transform import Transform as JTransform
from pbrt_tpu.scene import load_scene_string as j_load_scene_string
from pbrt_tpu.scene.api import Api as JApi
from pbrt_tpu.scene.intersect import _quadric_pass as j_quadric_pass, intersect_p as j_intersect_p
from pbrt_tpu.scene.paramset import ParamSet as JParamSet
from pbrt_tpu.scene.parser import parse_string as j_parse_string
from pbrt_tpu.shapes import quadrics as JQ
from pbrt_tpu.shapes.curve import curve_records as j_curve_records
from pbrt_tpu_torch.core.transform import Transform, rotate, translate
from pbrt_tpu_torch.render import Options, render_sampler_integrator
from pbrt_tpu_torch.scene import load_scene_string
from pbrt_tpu_torch.scene.api import Api
from pbrt_tpu_torch.scene.bench import quadric_scene_text
from pbrt_tpu_torch.scene.bridge import from_jax_arrays, tables_from_jax_arrays
from pbrt_tpu_torch.scene.build import build_tables
from pbrt_tpu_torch.scene import intersect as I
from pbrt_tpu_torch.scene.intersect import _affine
from pbrt_tpu_torch.scene.paramset import ParamSet
from pbrt_tpu_torch.scene.parser import parse_string
from pbrt_tpu_torch.scene.types import QuadricTable
from pbrt_tpu_torch.shapes import quadrics as Q
from pbrt_tpu_torch.shapes.curve import curve_records

EDGE = 1e-5
# per kind: (whole, clipped) parameters
PARAMS = {
    "sphere": ({"radius": [1.0]},
               {"radius": [1.2], "zmin": [-0.5], "zmax": [0.8], "phimax": [270.0]}),
    "cylinder": ({"radius": [1.0], "zmin": [-1.0], "zmax": [1.0]},
                 {"radius": [0.7], "zmin": [-0.3], "zmax": [0.9], "phimax": [200.0]}),
    "disk": ({"radius": [1.0], "height": [0.2]},
             {"radius": [1.1], "innerradius": [0.4], "height": [-0.1], "phimax": [300.0]}),
    "cone": ({"radius": [1.0], "height": [1.5]},
             {"radius": [0.8], "height": [1.2], "phimax": [250.0]}),
    "paraboloid": ({"radius": [1.0], "zmin": [0.0], "zmax": [1.0]},
                   {"radius": [0.9], "zmin": [0.3], "zmax": [1.1], "phimax": [290.0]}),
    "hyperboloid": ({"p1": [1.0, 0.0, 0.0], "p2": [0.0, 1.0, 1.5]},
                    {"p1": [0.6, 0.0, -0.5], "p2": [0.0, 0.9, 1.0], "phimax": [300.0]}),
}
HIT_FIELDS = ("p", "n", "uv", "dpdu", "dpdv", "p_err")


def _rays(lo, hi, n, seed):
    """Object-space rays from a shell of radius 3 around the bounds' centre
    toward points inside the bounds grown by 20%; a quarter of them with a
    finite t_max."""
    rng = np.random.default_rng(seed)
    c, h = 0.5 * (lo + hi), 0.6 * (hi - lo) + 1e-3
    o = rng.normal(size=(n, 3))
    o = c + 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = c + rng.uniform(-1, 1, (n, 3)) * h - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(np.arange(n) % 4 == 3, rng.uniform(1.0, 5.0, n), np.inf)
    return o.astype(np.float32), d.astype(np.float32), t_max.astype(np.float32)


def _edge_margin(qtype, qp, p):
    """Distance (in object units or radians) of object-space points p to the
    nearest clip edge of the quadric: its z range, radial range (disk) and
    phi range (the seam at 0 counts when phimax < 2 pi)."""
    qp = qp.astype(np.float64)
    p = p.astype(np.float64)
    big = np.full(p.shape[0], np.inf)
    phimax = {Q.SPHERE: qp[3], Q.CYLINDER: qp[3], Q.DISK: qp[3], Q.CONE: qp[2],
              Q.PARABOLOID: qp[3], Q.HYPERBOLOID: qp[3]}[qtype]
    if qtype == Q.HYPERBOLOID:
        v = (p[:, 2] - qp[2]) / max(qp[6] - qp[2], 1e-9)
        pr = (1 - v)[:, None] * qp[0:3] + v[:, None] * qp[4:7]
        phi = np.arctan2(pr[:, 0] * p[:, 1] - p[:, 0] * pr[:, 1],
                         p[:, 0] * pr[:, 0] + p[:, 1] * pr[:, 1])
    else:
        phi = np.arctan2(p[:, 1], p[:, 0])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    m = np.abs(phi - phimax)
    if phimax < 2 * np.pi - 1e-6:
        m = np.minimum(m, np.minimum(phi, 2 * np.pi - phi))
    z = p[:, 2]
    if qtype == Q.SPHERE:
        whole = qp[1] <= -qp[0] + 1e-7 and qp[2] >= qp[0] - 1e-7 and phimax >= 2 * np.pi - 1e-6
        zm = big if whole else np.minimum(np.abs(z - qp[1]), np.abs(z - qp[2]))
    elif qtype in (Q.CYLINDER, Q.PARABOLOID):
        zm = np.minimum(np.abs(z - qp[1]), np.abs(z - qp[2]))
    elif qtype == Q.DISK:
        r = np.hypot(p[:, 0], p[:, 1])
        zm = np.minimum(np.abs(r - qp[1]), np.abs(r - qp[2]) if qp[2] > 0 else big)
    elif qtype == Q.CONE:
        zm = np.minimum(np.abs(z), np.abs(z - qp[1]))
    else:
        zm = np.minimum(np.abs(z - min(qp[2], qp[6])), np.abs(z - max(qp[2], qp[6])))
    return np.minimum(m, zm)


@pytest.mark.parametrize("clipped", [False, True], ids=["whole", "clipped"])
@pytest.mark.parametrize("kind", list(PARAMS))
def test_intersect_quadric_matches_reference(kind, clipped):
    """4,096 object-space rays: equal hit masks except within 1e-5 of a clip
    edge; on common hits t within 1e-6 relative, p, n, dpdu and dpdv within
    1e-5, uv within 2e-5 and p_err within 1e-6 relative. The sphere's v is
    (theta - theta_min) / max(theta_max - theta_min, 1e-6) in the reference,
    whose theta range is negative, so v is (theta - theta_min) * 1e6: it is
    compared as theta - theta_min."""
    qtype, qp, area = Q.build_quadric(kind, PARAMS[kind][clipped])
    jt, jqp, jarea = JQ.build_quadric(kind, PARAMS[kind][clipped])
    assert qtype == jt and area == jarea and np.array_equal(qp, jqp)
    lo, hi = Q.quadric_object_bounds(qtype, qp)
    jlo, jhi = JQ.quadric_object_bounds(qtype, jqp)
    assert np.array_equal(lo, jlo) and np.array_equal(hi, jhi)
    o, d, t_max = _rays(lo, hi, 4096, seed=qtype + 10 * clipped)
    got = Q.intersect_quadric(qtype, torch.as_tensor(qp), torch.as_tensor(o), torch.as_tensor(d),
                              torch.as_tensor(t_max))
    want = JQ.intersect_quadric(qtype, jnp.asarray(qp), jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(t_max))
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    hit, jhit = got[0], want[0]
    # lanes whose hit point (on either side) lies at a clip edge may differ
    edge = np.zeros(len(hit), bool)
    for h, res in ((hit, got), (jhit, want)):
        edge |= h & (_edge_margin(qtype, qp, res[2]) < EDGE)
    assert np.array_equal(hit[~edge], jhit[~edge])
    assert edge.sum() <= 10
    both = hit & jhit & ~edge
    assert both.sum() >= 300, both.sum()
    if qtype == Q.SPHERE:
        dth = max(qp[5] - qp[4], np.float32(1e-6))
        for res in (got, want):
            res[4] = res[4] * np.array([1.0, dth], np.float32)
    np.testing.assert_allclose(got[1][both], want[1][both], rtol=1e-6)
    for k, f in enumerate(HIT_FIELDS):
        g, w = got[2 + k][both], want[2 + k][both]
        if f == "p_err":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-5 if f == "uv" else 1e-5,
                                       err_msg=f)
    # the pass's form: hit and t alone, over [N, 1] rays against a [1, 8] table
    h2, t2 = Q.intersect_quadric(qtype, torch.as_tensor(qp)[None], torch.as_tensor(o)[:, None],
                                 torch.as_tensor(d)[:, None], torch.as_tensor(t_max)[:, None],
                                 full=False)
    assert np.array_equal(h2[:, 0].numpy(), hit)
    assert np.array_equal(t2[:, 0].numpy()[hit], got[1][hit])


@pytest.mark.parametrize("kind", list(PARAMS))
def test_tessellate_quadric_matches_reference(kind):
    """The emitter tessellation of the clipped shape under a rotation and a
    translation, both windings: equal to pbrt_tpu's."""
    qtype, qp, _ = Q.build_quadric(kind, PARAMS[kind][True])
    m = (translate([0.5, -1.0, 2.0]) * rotate(35.0, [1.0, 2.0, 0.5])).m
    for flip in (False, True):
        got = Q.tessellate_quadric(qtype, qp, m, flip_normal=flip)
        want = JQ.tessellate_quadric(qtype, qp, m, flip_normal=flip)
        assert got.dtype == want.dtype and got.shape[0] > 1000
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ctype", ["flat", "ribbon", "cylinder"])
def test_curve_records_match_reference(ctype):
    """Two cubic segments under a rotation: vertices, faces and normals of
    each segment's mesh equal to pbrt_tpu's."""
    pts = [str(x) for x in np.random.default_rng(3).uniform(-1, 1, 21)]
    ps, jps = ParamSet(), JParamSet()
    for p in (ps, jps):
        p.declare("point", "P", pts)
        p.declare("string", "type", [ctype])
        p.declare("float", "width0", ["0.2"])
        p.declare("float", "width1", ["0.05"])
        if ctype == "ribbon":
            p.declare("normal", "N", ["0", "0", "1", "0", "1", "1"])
    m = rotate(20.0, [0.0, 1.0, 1.0]).m
    got, want = curve_records(ps, Transform(m)), j_curve_records(jps, JTransform(m))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.mesh.indices, w.mesh.indices)
        np.testing.assert_array_equal(g.mesh.p, w.mesh.p)
        assert (g.mesh.n is None) == (w.mesh.n is None) == (ctype != "cylinder")
        if g.mesh.n is not None:
            np.testing.assert_array_equal(g.mesh.n, w.mesh.n)


@pytest.fixture(scope="module")
def scene():
    """(the scene text, pbrt_tpu's scene with kernel tables, the port's
    scene on those tables)."""
    text = quadric_scene_text(res=32, spp=4, n_grass=1)
    with pallas_tables():
        jcs = j_load_scene_string(text)
    arrays, specs = jax_scene_arrays(jcs)
    return text, jcs, from_jax_arrays(arrays, specs, device="cpu")


def test_front_end_tables_equal_bridge(scene):
    """The port's front end on the scene with every new shape and light
    (six quadric kinds, a cylinder baked into two instances, an emitting
    sphere tessellated for NEE, three curve types) gives pbrt_tpu's tables."""
    text, jcs, cs = scene
    api = Api()
    parse_string(text, api)
    got = build_tables(api.scene)
    want = tables_from_jax_arrays(jax_scene_arrays(jcs)[0])
    assert set(got) == set(want)
    assert got["n_quadrics"] == 8 and sorted(set(got["quad_kind"])) == list(range(6))
    assert got["n_tris"] == 2 + 2 + 64 + 64 + 512
    for k in want:
        if k == "bvh":
            for f in ("metas", "nodes", "tris", "order", "seed", "seed_slots"):
                assert torch.equal(getattr(got[k], f), getattr(want[k], f)), f
        else:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert tuple(cs.data.quads.by_kind) == tuple(range(6))
    assert cs.data.lights.kinds == (0, 1, 4, 5, 6)


def _world_rays(n, seed):
    """Rays from a shell of radius 6 around the origin toward points in the
    box [-2.5, 2.5] x [-1.1, 2] x [-2.5, 2.5]."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 6.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform([-2.5, -1.1, -2.5], [2.5, 2.0, 2.5], (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _sequential_pass(quads, o, d, t_max):
    """The reference's loop over the table, one quadric at a time with the
    running t as its bound and a strict <, on the port's arithmetic."""
    best_t, best_q = t_max.clone(), torch.full(t_max.shape, -1, dtype=torch.int64)
    for qi in range(quads.kind.shape[0]):
        m = quads.w2o[qi]
        hit, t = Q.intersect_quadric(int(quads.kind[qi]), quads.params[qi], _affine(m, o, True),
                                     _affine(m, d, False), best_t, full=False)
        closer = hit & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_q = torch.where(closer, qi, best_q)
    return best_t, best_q


@pytest.mark.parametrize("chunk", [1 << 20, 37])
def test_quadric_pass_is_the_sequential_loop(scene, monkeypatch, chunk):
    """The batched pass (one op per kind over [lanes, quadrics], in chunks of
    lanes) equals the reference's loop over the table bit for bit on the
    same arithmetic, ties included: the table gets copies of two rows
    appended, and the lower row keeps every tied hit."""
    _, _, cs = scene
    q = cs.data.quads
    dup = [0, 6]
    fields = ("kind", "o2w", "w2o", "params", "prim", "material", "light", "rev")
    quads = QuadricTable(*(torch.cat([getattr(q, f), getattr(q, f)[dup]]) for f in fields))
    monkeypatch.setattr(I, "QUAD_CHUNK", chunk)
    n = 4096
    o, d = (torch.as_tensor(a) for a in _world_rays(n, seed=7))
    t_max = torch.as_tensor(np.where(np.arange(n) % 3 == 2, 4.0, np.inf).astype(np.float32))
    q_t, q_id = I._quadric_pass(quads, o, d, t_max)
    s_t, s_id = _sequential_pass(quads, o, d, t_max)
    assert torch.equal(q_id, s_id) and torch.equal(q_t, s_t)
    assert int((q_id >= 0).sum()) > 400 and not bool((q_id >= q.kind.shape[0]).any())
    assert bool((q_id == 0).any()) and bool((q_id == 6).any())


def test_quadric_pass_and_intersect_p_match_reference(scene):
    """4,096 rays through the scene's table of eight quadrics of all six
    kinds against the reference's jitted loop: the same quadric row on >=
    99.9% of lanes, t within 3e-5 relative there; intersect_p's occlusion
    flags (triangles, quadrics) equal on >= 99.9%. Far rays against small
    quadrics make the f32 discriminant cancel: each package's t is off the
    float64 root by up to 1-2e-5 relative, and XLA contracts the
    reference's loop body into FMAs, so t is not held to 1e-6 here (the
    object-space test holds it on eager arithmetic)."""
    _, jcs, cs = scene
    n = 4096
    o, d = _world_rays(n, seed=5)
    t_max = np.where(np.arange(n) % 3 == 2, 4.0, np.inf).astype(np.float32)
    q_t, q_id = I._quadric_pass(cs.data.quads, torch.as_tensor(o), torch.as_tensor(d),
                                torch.as_tensor(t_max))
    jq_t, jq_id = jax.jit(lambda *r: j_quadric_pass(jcs.data, jcs.flags, *r))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    q_t, q_id, jq_t, jq_id = q_t.numpy(), q_id.numpy(), np.asarray(jq_t), np.asarray(jq_id)
    same = q_id == jq_id
    assert same.mean() >= 0.999 and (q_id >= 0).sum() > 400
    np.testing.assert_allclose(q_t[same], jq_t[same], rtol=3e-5)
    jflags = dataclasses.replace(jcs.flags, use_pallas=False)
    t_p = np.minimum(t_max, 1e30)
    occ = I.intersect_p(cs.data, cs.flags, torch.as_tensor(o), torch.as_tensor(d),
                        torch.as_tensor(t_p)).numpy()
    jocc = np.asarray(jax.jit(lambda *r: j_intersect_p(jcs.data, jflags, *r))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_p)))
    assert (occ == jocc).mean() >= 0.999 and 500 < occ.sum() < n - 500


ANIMATED = """
LookAt 0 0 5  0 0 0  0 1 0
Camera "perspective" "float fov" 30
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "02sequence" "integer pixelsamples" 2
Integrator "path" "integer maxdepth" 2
WorldBegin
LightSource "point" "point from" [2 3 4] "rgb I" [25 25 25]
AttributeBegin
  Translate 0.3 0 0
  {MOTION}
  Shape "sphere" "float radius" 1
AttributeEnd
WorldEnd
"""


def test_animated_quadric_stays_at_its_start_transform():
    """A sphere moved over the shutter is a static shape at its start
    transform in both front ends (no prototype, no instance), and renders
    as the sphere that does not move."""
    moving = ANIMATED.replace("{MOTION}", "ActiveTransform EndTime\n  Translate 0 0.5 0\n"
                              "  ActiveTransform All")
    api, japi = Api(), JApi()
    parse_string(moving, api)
    j_parse_string(moving, japi)
    for a in (api, japi):
        assert len(a.scene.shapes) == 1 and not a.scene.prototypes and not a.scene.instances
    np.testing.assert_array_equal(api.scene.shapes[0].o2w, japi.scene.shapes[0].o2w)
    assert api.scene.shapes[0].o2w[0, 3] == np.float32(0.3) and api.scene.shapes[0].o2w[1, 3] == 0
    imgs = [render_sampler_integrator(load_scene_string(t, device="cpu"), Options())[0]
            for t in (moving, ANIMATED.replace("{MOTION}", ""))]
    assert float(imgs[0].sum()) > 0 and torch.equal(imgs[0], imgs[1])
