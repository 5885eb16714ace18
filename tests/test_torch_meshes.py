"""PLY meshes and Loop subdivision surfaces against pbrt_tpu: the reader and
the subdivider on the same inputs, a .pbrt scene of plymesh and loopsubdiv
shapes through both front ends, and that scene on the route the reference
takes through its B5 kernel (the "packet" walk, forced here by lowering
BARY_ROUTE_NODES below the small tree). CPU only, at a small size."""
import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import jax_scene_arrays, pallas_tables, rays_at_knot

from pbrt_tpu.scene import load_scene_string as j_load_scene_string
from pbrt_tpu.scene.intersect import intersect_pair as j_intersect_pair
from pbrt_tpu.shapes.loopsubdiv import loop_subdivide as j_loop_subdivide
from pbrt_tpu.shapes.ply import read_ply as j_read_ply
from pbrt_tpu_torch.render import Options, render_sampler_integrator
from pbrt_tpu_torch.scene import intersect as I
from pbrt_tpu_torch.scene import load_scene_string
from pbrt_tpu_torch.scene.api import Api
from pbrt_tpu_torch.scene.bench import write_knot_ply
from pbrt_tpu_torch.scene.bridge import tables_from_jax_arrays
from pbrt_tpu_torch.scene.build import build_tables
from pbrt_tpu_torch.scene.parser import parse_string
from pbrt_tpu_torch.shapes.loopsubdiv import loop_subdivide
from pbrt_tpu_torch.shapes.ply import read_ply, write_ply
from pbrt_tpu_torch.shapes.triangle import make_knot_mesh

FORMATS = ("ascii", "binary_little_endian", "binary_big_endian")


def _grid(n=4, seed=0):
    """An open (n x n)-quad grid over [-3, 3]^2 at y ~ 0 with seeded bumps:
    every outer edge is a boundary edge."""
    rng = np.random.default_rng(seed)
    x, z = np.meshgrid(np.linspace(-3, 3, n + 1), np.linspace(-3, 3, n + 1), indexing="ij")
    p = np.stack([x, 0.2 * rng.uniform(-1, 1, x.shape), z], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    a = (i * (n + 1) + j).reshape(-1)
    quads = np.stack([a, a + 1, a + n + 2, a + n + 1], -1)
    return p.astype(np.float32), quads.astype(np.int32)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("layout", ["bare", "normals_uv", "quads"])
def test_read_ply_matches_reference(tmp_path, fmt, layout):
    """Vertices, normals, uv and fanned faces equal to pbrt_tpu's reader on
    files written with numpy: triangles alone, triangles with normals and
    uv, and quads with both."""
    if layout == "quads":
        p, faces = _grid(3, seed=1)
    else:
        m = make_knot_mesh(6, 4, 0.45)
        p, faces = m.p, m.indices
    rng = np.random.default_rng(2)
    attrs = {} if layout == "bare" else dict(normals=rng.normal(size=p.shape),
                                             uv=rng.uniform(size=(len(p), 2)))
    path = str(tmp_path / "m.ply")
    write_ply(path, p, faces, fmt=fmt, **attrs)
    got, want = read_ply(path), j_read_ply(path)
    assert got[3].shape == (len(faces) * (faces.shape[1] - 2), 3)
    assert (got[1] is None) == (got[2] is None) == (layout == "bare")
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("mesh", ["closed_knot", "open_grid"])
def test_loop_subdivide_matches_reference(mesh, levels):
    if mesh == "closed_knot":
        m = make_knot_mesh(12, 6, 0.45)
        p, f = m.p, m.indices
    else:
        p, quads = _grid(4)
        f = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
    got, want = loop_subdivide(p, f, levels), j_loop_subdivide(p, f, levels)
    assert got[1].shape == (len(f) * 4 ** levels, 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _mesh_scene(dirname):
    """A small scene of PLY and Loop-subdivision meshes: an area light from
    an ascii PLY quad, the knot from a binary PLY file with normals and uv
    under a rotation, a subdivided open grid as the floor under a
    handedness-swapping scale, and a PLY file that is missing."""
    write_knot_ply(f"{dirname}/knot.ply", 24, 8)
    write_ply(f"{dirname}/light.ply", [[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
              [[0, 1, 2, 3]])
    p, quads = _grid(4)
    p[:, 1] -= 1.0
    f = np.concatenate([quads[:, [0, 2, 1]], quads[:, [0, 3, 2]]])
    return f"""
LookAt 0 3 5  0 0 0  0 1 0
Camera "perspective" "float fov" 40
Film "image" "integer xresolution" [32] "integer yresolution" [32]
Sampler "02sequence" "integer pixelsamples" 1
Integrator "path" "integer maxdepth" 2
WorldBegin
LightSource "infinite" "rgb L" [0.3 0.35 0.4]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 8 8]
  Translate 0 4 0
  Shape "plymesh" "string filename" "light.ply"
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [0.6 0.4 0.3]
  Rotate 30 0 1 0
  Shape "plymesh" "string filename" "knot.ply"
AttributeEnd
AttributeBegin
  Material "plastic" "rgb Kd" [0.3 0.3 0.7] "rgb Ks" [0.3 0.3 0.3]
  Scale 1 1 -1
  Shape "loopsubdiv" "integer levels" [2] "integer indices" [{" ".join(map(str, f.reshape(-1)))}]
    "point P" [{" ".join(repr(float(x)) for x in p.reshape(-1))}]
AttributeEnd
Shape "plymesh" "string filename" "missing.ply"
WorldEnd
"""


@pytest.fixture(scope="module")
def mesh_scenes(tmp_path_factory):
    """(scene text, its directory, pbrt_tpu's scene with kernel tables)."""
    d = str(tmp_path_factory.mktemp("meshes"))
    text = _mesh_scene(d)
    with pallas_tables():
        jcs = j_load_scene_string(text, cwd=d)
    return text, d, jcs


def test_mesh_scene_tables_match_reference(mesh_scenes, caplog):
    """Every table of the port's front end equals pbrt_tpu's (triangle and
    slot attributes, kernel tables, lights and materials), and the missing
    PLY file is logged and adds no shape."""
    text, d, jcs = mesh_scenes
    api = Api()
    api.cwd = d
    with caplog.at_level(logging.WARNING):
        parse_string(text, api, d)
    assert "missing.ply" in caplog.text
    assert len(api.scene.shapes) == 3 and api.scene.shapes[2].mesh.transform_swaps_handedness
    got = build_tables(api.scene)
    want = tables_from_jax_arrays(jax_scene_arrays(jcs)[0])
    assert set(got) == set(want)
    assert got["n_tris"] == 2 + 24 * 8 * 2 + 32 * 16 and got["n_lights"] == 2
    for k in want:
        if k == "bvh":
            for f in ("metas", "nodes", "tris", "order", "seed", "seed_slots"):
                assert torch.equal(getattr(got[k], f), getattr(want[k], f)), f
        else:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def _close_si(si, ref, lanes):
    """The tolerances of tests/test_torch_shading.py against the reference's
    XLA walk, on the given lanes: lanes that hit another primitive of a tie
    are not compared."""
    valid = si.valid.numpy()
    np.testing.assert_array_equal(valid[lanes], np.asarray(ref.valid)[lanes])
    same = lanes & valid & (si.prim.numpy() == np.asarray(ref.prim))
    assert same.sum() > 250
    np.testing.assert_allclose(si.t.numpy()[same], np.asarray(ref.t)[same], rtol=4e-6, atol=4e-6)
    for f in ("p", "ng", "ns", "uv", "dpdu", "dpdv"):
        np.testing.assert_allclose(getattr(si, f).numpy()[same], np.asarray(getattr(ref, f))[same],
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    for f in ("material", "area_light"):
        np.testing.assert_array_equal(getattr(si, f).numpy()[lanes],
                                      np.asarray(getattr(ref, f))[lanes])


def test_packet_route_matches_reference_walk(mesh_scenes, monkeypatch):
    """With every world tree on the "packet" walk, the port's intersect and
    intersect_pair agree with pbrt_tpu's intersect_pair on its XLA walk
    (whose next-ray half is its intersect), and the walk taken is the one
    that returns barycentrics."""
    text, d, jcs = mesh_scenes
    jcpu = dataclasses.replace(jcs, flags=dataclasses.replace(jcs.flags, use_pallas=False))
    cs = load_scene_string(text, device="cpu", cwd=d)
    variants = []

    def spy(*a, variant="queue"):
        variants.append(variant)
        return traverse(*a, variant=variant)
    traverse = I.traverse
    monkeypatch.setattr(I, "traverse", spy)
    monkeypatch.setattr(I, "BARY_ROUTE_NODES", 0)
    n = 1024
    o, dr = rays_at_knot(2 * n, seed=51)
    rng = np.random.default_rng(52)
    tm = np.full(n, np.inf, np.float32)
    dist = np.where(rng.uniform(size=n) < 0.5, np.inf, rng.uniform(0.5, 4.0, n)).astype(np.float32)
    act_nx, act_sh = rng.uniform(size=n) < 0.9, rng.uniform(size=n) < 0.9
    pair = (o[:n], dr[:n], tm, act_nx, o[n:], dr[n:], dist, act_sh)
    ref, ref_occ = jax.jit(lambda *r: j_intersect_pair(jcpu.data, jcpu.flags, *r))(
        *(jnp.asarray(a) for a in pair))
    si = I.intersect(cs.data, cs.flags, *(torch.as_tensor(a) for a in pair[:3]))
    _close_si(si, ref, np.ones(n, bool))
    si2, occ = I.intersect_pair(cs.data, cs.flags, *(torch.as_tensor(a) for a in pair))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref_occ))
    assert 50 < int(occ.sum()) < n - 50
    # the reference's XLA walk traces inactive lanes too; the port re-points
    # them at a ray that misses, so only active lanes are compared
    _close_si(si2, ref, act_nx)
    assert variants == ["packet", "packet"]


def test_packet_route_render_equals_b1_route(mesh_scenes, monkeypatch):
    """The port's CPU render with the "packet" route forced equals the
    render on the B1 route on >= 99.9% of pixels: the route returns the
    barycentrics kernel_bary computes, so only rounding-edge culls differ."""
    text, d, _ = mesh_scenes
    opts = Options(wavefront_size=1024)
    cs = load_scene_string(text, opts, device="cpu", cwd=d)
    assert cs.data.bvh.metas.shape[0] <= I.BARY_ROUTE_NODES
    b1_route, cnt, _ = render_sampler_integrator(cs, opts)
    monkeypatch.setattr(I, "BARY_ROUTE_NODES", 0)
    packet_route, _, _ = render_sampler_integrator(cs, opts)
    assert b1_route.shape == (32, 32, 3) and float(b1_route.sum()) > 0
    assert cnt["valid_hits"] > 800
    same = torch.all(b1_route == packet_route, dim=-1).float().mean()
    assert float(same) >= 0.999
