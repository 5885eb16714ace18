"""The kd-tree against pbrt_tpu: the native build's tables, the watertight
triangle test, the plain walk (intersect_kdtree_plain) against the
reference's intersect_kdtree, the scene's kd route and li_path over it
(against the reference outputs committed in tests/torch_refs), and the CLI.
K1, the walk's CUDA kernel, is held bit-equal to the plain walk in
tests/test_torch_cuda.py (on the card).

Tolerances: the reference's XLA walk may contract the difference of
products of its edge functions into an FMA, which the port's plain walk
(like K1) does not, so t is held within 1e-6 max(1, t) and the triangles
equal on 99.9% of rays, each other ray a tie on an edge two triangles
share.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import hold_ref, rays_at_knot
from torch_refs import cases as C

from pbrt_tpu.accel.kdtree import KdTree as JKdTree, build_kdtree as j_build_kdtree, \
    intersect_kdtree as j_intersect_kdtree
from pbrt_tpu.shapes.triangle import intersect_tri as j_intersect_tri
from pbrt_tpu_torch.accel import kdtree as K
from pbrt_tpu_torch.integrators.path import li_path
from pbrt_tpu_torch.io.image_io import read_png
from pbrt_tpu_torch.scene import load_scene_string
from pbrt_tpu_torch.scene.bench import calibration_scene, deep_kd_case, kdtree_calibration_scene
from pbrt_tpu_torch.shapes.triangle import intersect_tri, make_knot_mesh

TABLES = ("flags", "split_pos", "above_child", "prim_offset", "prim_count", "prim_indices")


def _soup():
    """tests/test_accel.py's triangle soup, and 4,096 rays from its origins'
    box toward points near the soup's triangles."""
    rng = np.random.default_rng(7)
    T = 800
    c = rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    p1 = c + rng.uniform(-0.08, 0.08, (T, 3)).astype(np.float32)
    p2 = c + rng.uniform(-0.08, 0.08, (T, 3)).astype(np.float32)
    tp = np.stack([c, p1, p2], 1)
    o = rng.uniform(-3, 3, (4096, 3)).astype(np.float32)
    d = c[rng.integers(0, T, 4096)] + rng.normal(0, 0.03, (4096, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return tp, np.minimum(np.minimum(c, p1), p2), np.maximum(np.maximum(c, p1), p2), o, d


def _knot(n_u, n_v):
    tp = make_knot_mesh(n_u, n_v, scale=0.45)
    tp = tp.p[tp.indices].astype(np.float32)
    lo, hi = tp.min(1), tp.max(1)
    eps = 1e-5 * np.maximum(np.abs(lo) + np.abs(hi), 1.0)
    return tp, lo - eps, hi + eps


@pytest.mark.parametrize("which", ["soup", "knot"])
def test_tables_equal_reference(which):
    """The native build's tables bit-equal to the reference's, on the soup
    and on a 36-triangle knot (the reference's builder overflows its node
    table on larger knots: see test_builder_survives_overflow)."""
    if which == "soup":
        tp, lo, hi, _, _ = _soup()
    else:
        tp, lo, hi = _knot(6, 3)
    kd, jkd = K.build_kdtree(lo, hi), j_build_kdtree(lo, hi)
    for name in TABLES:
        assert np.array_equal(getattr(kd, name), np.asarray(getattr(jkd, name))), name
    assert np.array_equal(kd.world_lo, np.asarray(jkd.world_lo))
    assert np.array_equal(kd.world_hi, np.asarray(jkd.world_hi))


def test_builder_survives_overflow():
    """A first build that outgrows its node table (the 4,608-triangle knot:
    297,517 nodes against room for 73,728) is retried larger and gives
    whole tables; the reference's builder writes past its table's end
    there (ROADMAP.md C)."""
    _, lo, hi = _knot(96, 24)
    kd = K.build_kdtree(lo, hi)
    assert kd.n_nodes == 297_517
    leaf = kd.flags == K.LEAF
    offs, cnt = kd.prim_offset[leaf], kd.prim_count[leaf]
    assert (offs + cnt).max() <= kd.prim_indices.shape[0]
    assert np.all(kd.above_child[~leaf] > np.nonzero(~leaf)[0])


def test_intersect_tri_matches_reference():
    """The watertight test on 65,536 seeded ray-triangle pairs: the same
    hits on 99.9%, t and the barycentrics within 1e-5 where both hit."""
    rng = np.random.default_rng(3)
    n = 65536
    p = rng.uniform(-1, 1, (3, n, 3)).astype(np.float32)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = (p.mean(0) + rng.normal(0, 0.2, (n, 3)) - o).astype(np.float32)
    d[::9, 1] = 0.0
    tm = np.full(n, np.inf, np.float32)
    tm[::4] = 2.0
    got = intersect_tri(*(torch.as_tensor(a) for a in (p[0], p[1], p[2], o, d, tm)))
    want = j_intersect_tri(*(jnp.asarray(a) for a in (p[0], p[1], p[2], o, d, tm)))
    hit, jhit = got[0].numpy(), np.asarray(want[0])
    assert np.mean(hit == jhit) >= 0.999 and hit.mean() > 0.3
    both = hit & jhit
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy()[both], np.asarray(b)[both], rtol=1e-5, atol=1e-5)


def _shared_edge(tp, a, b):
    """Whether triangles a and b share two vertex positions."""
    return sum(any(np.array_equal(v, w) for w in tp[b]) for v in tp[a]) >= 2


@pytest.mark.parametrize("which", ["soup", "knot"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_walk_matches_reference(which, any_hit):
    """intersect_kdtree_plain against the reference's walk on the same
    tables (the port's, bit-equal to the reference's build above; on the
    4,608-triangle knot, whose build the reference cannot finish): 4,096
    rays, t within 1e-6 max(1, t), the barycentrics within 1e-4 (the
    soup's triangles are small, so their edge functions' rounding weighs
    more), the triangles equal on 99.9% and each other ray a tie on a
    shared edge; any-hit rays stop after the 4-prim chunk that hit, as
    there. The counts: the distinct triangles tested are at most the leaf
    slots tested, and the per-ray visits sum to the visits."""
    if which == "soup":
        tp, lo, hi, o, d = _soup()
    else:
        tp, lo, hi = _knot(96, 24)
        o, d = rays_at_knot(4096, seed=5)
    n = o.shape[0]
    tm = np.full(n, np.inf, np.float32)
    tm[::5] = 2.5
    tab = K.build_kdtree(lo, hi)
    jkd = JKdTree(*(jnp.asarray(getattr(tab, f)) for f in TABLES),
                  jnp.asarray(tab.world_lo), jnp.asarray(tab.world_hi))
    T = torch.as_tensor
    kd = K.KdTree.from_tables(tab, T(tp[:, 0]), T(tp[:, 1]), T(tp[:, 2]))
    counts = K.KdCounts()
    t, tri, b1, b2 = K.intersect_kdtree_plain(kd, T(o), T(d), T(tm),
                                              T(np.full(n, any_hit, np.uint8)), counts)
    jh = j_intersect_kdtree(jkd, *(jnp.asarray(tp[:, i]) for i in range(3)), jnp.asarray(o),
                            jnp.asarray(d), jnp.asarray(tm), any_hit=any_hit)
    tri, jtri = tri.numpy(), np.asarray(jh.tri)
    assert np.array_equal(tri >= 0, jtri >= 0) and (tri >= 0).mean() > 0.2
    same = tri == jtri
    assert same.mean() >= 0.999
    for i in np.nonzero(~same)[0]:
        assert _shared_edge(tp, tri[i], jtri[i]), i
    hit = tri >= 0
    t, jt = t.numpy()[hit], np.asarray(jh.t)[hit]
    assert np.all(np.abs(t - jt) <= 1e-6 * np.maximum(1.0, np.abs(jt)))
    for a, b in ((b1, jh.b1), (b2, jh.b2)):
        assert np.all(np.abs(a.numpy()[hit & same] - np.asarray(b)[hit & same]) <= 1e-4)
    assert counts.visits > n and counts.tri_tests > 0
    nodes, slots, prims = counts.touched()
    assert 0 < nodes <= min(kd.n_nodes, counts.visits)
    assert 0 < slots <= min(kd.prim_indices.shape[0], counts.tri_tests)
    assert 0 < prims <= min(tp.shape[0], slots)
    assert counts.ray_visits.shape == (n,) and int(counts.ray_visits.sum()) == counts.visits


def _depth_by_recursion(tab, node=0):
    if tab.flags[node] == K.LEAF:
        return 0
    return 1 + max(_depth_by_recursion(tab, node + 1),
                   _depth_by_recursion(tab, int(tab.above_child[node])))


@pytest.mark.parametrize("which", ["soup", "knot"])
def test_node_records_decode_to_the_tables(which):
    """The 8-byte node records give back the builder's flags, split, above
    child, prim offset and prim count on every node of the soup's and the
    4,608-triangle knot's trees; the triangle table holds each triangle's
    vertices once, and the tree's depth is the longest root-to-leaf chain
    of interior nodes (by recursion on the soup)."""
    if which == "soup":
        tp, lo, hi, _, _ = _soup()
    else:
        tp, lo, hi = _knot(96, 24)
    tab = K.build_kdtree(lo, hi)
    T = torch.as_tensor
    kd = K.KdTree.from_tables(tab, T(tp[:, 0]), T(tp[:, 1]), T(tp[:, 2]))
    assert kd.nodes.shape == (tab.n_nodes, 2) and kd.nodes.dtype == torch.int32
    flags, word0, high = K.node_fields(kd.nodes.numpy())
    leaf = tab.flags == K.LEAF
    assert np.array_equal(flags, tab.flags) and leaf.any() and (~leaf).any()
    assert np.array_equal(word0[~leaf].view(np.float32), tab.split_pos[~leaf])
    assert np.array_equal(high[~leaf], tab.above_child[~leaf])
    assert np.array_equal(word0[leaf], tab.prim_offset[leaf])
    assert np.array_equal(high[leaf], tab.prim_count[leaf])
    assert np.array_equal(kd.prim_indices.numpy(), tab.prim_indices)
    assert np.array_equal(kd.tris.numpy()[:, :9], tp.reshape(-1, 9))
    assert kd.device_bytes() == 8 * tab.n_nodes + 4 * tab.prim_indices.size + 48 * tp.shape[0]
    if which == "soup":
        assert kd.depth == _depth_by_recursion(tab) > 5


@pytest.mark.parametrize("any_hit", [False, True])
def test_deep_tree_walk_matches_reference(any_hit):
    """On bench.deep_kd_case's hand-built 72-level tree, whose diagonal
    rays push past the 64-entry stack (the drop and clamp rules decide
    their hits), the plain walk against the reference's walk on the same
    tables, closest and any-hit: the same triangle on every ray, t within
    1e-6 max(1, t), the barycentrics within 1e-5."""
    tab, tp, o, d, tm, _ = deep_kd_case()
    n = o.shape[0]
    T = torch.as_tensor
    kd = K.KdTree.from_tables(tab, T(tp[:, 0]), T(tp[:, 1]), T(tp[:, 2]))
    assert kd.depth == 72
    t, tri, b1, b2 = K.intersect_kdtree_plain(kd, T(o), T(d), T(tm),
                                              T(np.full(n, any_hit, np.uint8)))
    jkd = JKdTree(*(jnp.asarray(getattr(tab, f)) for f in TABLES),
                  jnp.asarray(tab.world_lo), jnp.asarray(tab.world_hi))
    jh = j_intersect_kdtree(jkd, *(jnp.asarray(tp[:, i]) for i in range(3)), jnp.asarray(o),
                            jnp.asarray(d), jnp.asarray(tm), any_hit=any_hit)
    tri = tri.numpy()
    assert np.array_equal(tri, np.asarray(jh.tri))
    assert (tri[: n // 2] == 1).mean() > 0.5    # the diagonal rays' hit past the dropped pushes
    hit = tri >= 0
    jt = np.asarray(jh.t)[hit]
    assert np.all(np.abs(t.numpy()[hit] - jt) <= 1e-6 * np.maximum(1.0, np.abs(jt)))
    for a, b in ((b1, jh.b1), (b2, jh.b2)):
        assert np.all(np.abs(a.numpy()[hit] - np.asarray(b)[hit]) <= 1e-5)


def test_scene_takes_the_kd_route_from_64_world_triangles():
    """Accelerator "kdtree" builds the kd-tree over 64 or more world
    triangles (MIN_BVH_TRIS) and every world walk takes it; below that the
    BVH walks, as the reference's brute-force test stands in there."""
    line = 'Integrator "path" "integer maxdepth" 2'
    cs = load_scene_string(kdtree_calibration_scene(line), device="cpu")
    assert cs.flags.accel == "kdtree" and cs.flags.n_tris == 110 and cs.data.kd is not None
    small = load_scene_string(calibration_scene("knot", line).replace(
        "WorldBegin", 'Accelerator "kdtree"\nWorldBegin'), device="cpu")
    assert small.flags.n_tris == 40 and small.flags.accel == "bvh" and small.data.kd is None


def test_li_path_matches_reference():
    """li_path on the kd-tree calibration scene, 1,024 lanes at depth 3:
    hold_li's rule."""
    ref = C.load("path_kdtree")
    text = C.path_case_scene("path_kdtree")
    assert text == ref["scene"]
    cs = load_scene_string(text, device="cpu")
    L, p_film, _, cnt = li_path(cs, *(torch.as_tensor(ref[k]) for k in ("px", "py", "s")),
                                max_depth=C.DEPTH)
    assert hold_ref(L, p_film, cnt, ref) > 0.05


def test_cli_renders_the_kd_scene(tmp_path):
    """python -m pbrt_tpu_torch --device cpu renders the kd-tree scene, and
    its image is the BVH's but for edge ties (each walk its own triangle
    test): 99% of pixels within 1e-3 / 1e-4."""
    from pbrt_tpu_torch.__main__ import main
    line = 'Integrator "path" "integer maxdepth" 2'
    kd_text = kdtree_calibration_scene(line, res=16, spp=2)
    for name, text in (("kd", kd_text), ("bvh", kd_text.replace('Accelerator "kdtree"\n', ""))):
        (tmp_path / f"{name}.pbrt").write_text(text)
        assert main(["--device", "cpu", "--quiet", "--outfile", str(tmp_path / f"{name}.pfm"),
                     str(tmp_path / f"{name}.pbrt")]) == 0
    from pbrt_tpu_torch.io.image_io import read_pfm
    a, b = read_pfm(str(tmp_path / "kd.pfm")), read_pfm(str(tmp_path / "bvh.pfm"))
    assert a.shape == (16, 16, 3) and a.max() > 0
    assert np.mean(np.all(np.abs(a - b) <= 1e-4 + 1e-3 * np.abs(b), -1)) >= 0.99
