"""The port's BVH tables and traversal against pbrt_tpu.

- the packers' arrays are bit-equal to pack_pallas_bvh and _pack_bvh4;
- each plain walk against its Pallas kernel in interpret mode (B1-B5, one
  128-ray block at one pop per step);
- the plain walk against the XLA walk on the 4,612-triangle bench tables:
  equal hit and any-hit masks, |dt| <= 1e-6*max(1, t), and order[slot]
  equal to the reference's triangle on >= 99.9% of hits, every mismatch
  a tie (the reference triangle's t within 1e-6 of the port's t);
- the CUDA kernel against the plain walk, bit for bit (needs a card).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import jax_bench_scene, jax_scene_arrays, needs_cuda, rays_at_knot

from pbrt_tpu.accel import pallas_traverse
from pbrt_tpu.accel.bvh import build_bvh as jbuild
from pbrt_tpu.accel.pallas_traverse import _traverse, _traverse_cols, pack_pallas_bvh
from pbrt_tpu.accel.traverse import intersect_bvh
from pbrt_tpu.shapes.triangle import intersect_tri
from pbrt_tpu_torch.accel import traverse as T
from pbrt_tpu_torch.accel.bvh import build_bvh
from pbrt_tpu_torch.scene.bridge import tables_from_jax_arrays
from pbrt_tpu_torch.shapes.triangle import make_knot_mesh


def _knot(n_u, n_v):
    m = make_knot_mesh(n_u, n_v, 0.45)
    tp = m.p[m.indices]
    lo, hi = tp.min(1), tp.max(1)
    eps = 1e-5 * np.maximum(np.abs(lo) + np.abs(hi), 1.0)
    return tp, lo - eps, hi + eps


def _rays(n, seed):
    o, d = rays_at_knot(n, seed)
    ah = np.zeros(n, np.uint8)
    ah[1::2] = 1
    return o, d, np.full(n, np.inf, np.float32), ah


def _plain(kb, o, d, tm, ah):
    t, s, it = T.traverse(kb, *(torch.as_tensor(a) for a in (o, d, tm, ah)))
    return t.numpy(), s.numpy(), it.numpy()


@pytest.fixture(scope="module", params=[(8, 8), (96, 24)], ids=["8-8", "96-24"])
def knot_tables(request):
    """(the port's tables, the reference's tables and leaf order) of a knot
    of n_u x n_v quads."""
    tp, lo, hi = _knot(*request.param)
    kb = T.pack_kernel_bvh(build_bvh(lo, hi), tp[:, 0], tp[:, 1], tp[:, 2])
    _, host = jbuild(lo, hi, with_host=True)
    pb, order = pack_pallas_bvh(host, tp[:, 0], tp[:, 1], tp[:, 2])
    return kb, pb, order


def test_pack_matches_reference(knot_tables):
    kb, pb, order = knot_tables
    M = kb.metas.shape[0]
    assert np.array_equal(kb.metas.numpy(), np.asarray(pb.metas))
    assert np.array_equal(kb.nodes.numpy(), np.asarray(pb.nodes).reshape(-1, 16)[:M])
    assert np.array_equal(kb.tris.numpy(), np.asarray(pb.tris).reshape(-1, 16))
    assert np.array_equal(kb.order.numpy(), order)
    assert np.array_equal(kb.seed.numpy(), np.asarray(pb.seed).reshape(8, 16))
    assert np.array_equal(kb.seed_slots.numpy(), np.asarray(pb.seed_slots))
    assert np.array_equal(kb.wlo, np.asarray(pb.wlo)) and np.array_equal(kb.whi, np.asarray(pb.whi))
    assert 0 < kb.max_depth < T.STACK


def decode_walk_tables(recs, roots, metas, nodes):
    """Decode the walk records back to the tables they came from: record r
    is the r-th interior node i, its boxes are nodes[i, :12], and the words
    of its children i + 1 and right[i], like those of the roots ({node:
    word}), are their meta words (a leaf) or carry their axis and name
    their records (interior). -> {node: its walk word}, every node a record
    or roots names."""
    metas, nodes = metas.numpy().astype(np.int64), nodes.numpy()
    cnt = (metas >> 2) & 15
    ids = np.nonzero(cnt == 0)[0]
    r = recs.numpy()
    assert r.shape == (len(ids), 16) and np.array_equal(r[:, :12], nodes[ids, :12])
    words = r[:, 12:14].view(np.int32).astype(np.int64)
    named = dict(roots)
    for k, i in enumerate(ids):
        named[i + 1], named[int(metas[i] >> 6) & T.PAYLOAD] = words[k]
    for node, w in named.items():
        if cnt[node] > 0:
            assert w == metas[node]
        else:
            assert (w & 63) == (metas[node] & 3) and ids[w >> 6] == node
    return named


def test_walk_records_decode_to_tables(knot_tables):
    """The packet kernel's walk records name every node once, and decode to
    metas and nodes."""
    kb = knot_tables[0]
    named = decode_walk_tables(kb.recs, {0: kb.root_word}, kb.metas, kb.nodes)
    assert sorted(named) == list(range(kb.metas.shape[0]))


def test_walk_records_of_a_leaf_root():
    """A tree of at most 8 triangles is one leaf: no walk records, and the
    walk starts on the leaf's meta word."""
    tp, lo, hi = _knot(2, 2)
    kb = T.pack_kernel_bvh(build_bvh(lo, hi), tp[:, 0], tp[:, 1], tp[:, 2])
    assert kb.metas.shape[0] == 1 and int(kb.metas[0] >> 2) & 15 == tp.shape[0] == 8
    assert kb.recs.shape == (0, T.REC_FLOATS) and kb.recs.dtype == torch.float32
    assert kb.root_word == int(kb.metas[0])
    assert decode_walk_tables(kb.recs, {0: kb.root_word}, kb.metas, kb.nodes) == {
        0: kb.root_word}


def test_pack4_matches_reference(knot_tables):
    """The 4-wide collapse: boxes (NaN on empty slots), slot words and axis
    words bit-equal to _pack_bvh4's; the walk's stack need is counted."""
    kb, pb, _ = knot_tables
    kb4 = T.pack_kernel_bvh4(kb)
    M4 = kb4.axs4.shape[0]
    assert pb.nodes4 is not None and M4 > 1
    want = np.asarray(pb.nodes4).reshape(-1, 32)
    assert np.array_equal(kb4.nodes4.numpy(), want[:M4, :24], equal_nan=True)
    assert np.all(np.isnan(want[M4:, :24]))
    assert np.array_equal(kb4.meta4.numpy(), np.asarray(pb.meta4))
    assert np.array_equal(kb4.axs4.numpy(), np.asarray(pb.axs4))
    assert 3 < kb4.stack_need <= 3 * kb.max_depth + 4


ONE_BLOCK = dict(rows=1, pops=1, interpret=True)
# kernel -> (the reference's call at one 128-ray block and one pop a step,
# the port's plain walk; None: the 4-wide walk). B5 is the reference's
# default route on trees over SMEM_META_MAX nodes; the test patches that cap
# below the tree, and mode="packet" is traced by no other test, so jit's
# cache cannot hold a trace made with the unpatched cap.
KERNELS = {
    "B1": (lambda pb, o, d, tm: _traverse_cols(pb, *o.T, *d.T, tm, queue=1, **ONE_BLOCK),
           "queue"),
    "B2": (lambda pb, o, d, tm: _traverse_cols(pb, *o.T, *d.T, tm, queue=0, **ONE_BLOCK),
           "all"),
    "B3": (lambda pb, o, d, tm: _traverse_cols(pb, *o.T, *d.T, tm, use4=True, **ONE_BLOCK),
           None),
    "B4": (lambda pb, o, d, tm: _traverse(pb, o, d, tm, mode="block", **ONE_BLOCK), "block"),
    "B5": (lambda pb, o, d, tm: _traverse(pb, o, d, tm, mode="packet", **ONE_BLOCK), "packet"),
}


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_plain_walk_matches_pallas_interpret(kernel, monkeypatch):
    """Each plain walk against its TPU kernel in interpret mode on the
    128-triangle knot, 128 closest-hit rays: equal hit masks,
    |dt| <= 1e-6 max(1, t), the same slot on >= 99.9% of hits or a tie,
    and b1/b2 within 1e-6 where the slots agree."""
    tp, lo, hi = _knot(8, 8)
    kb = T.pack_kernel_bvh(build_bvh(lo, hi), tp[:, 0], tp[:, 1], tp[:, 2])
    _, host = jbuild(lo, hi, with_host=True)
    pb, _ = pack_pallas_bvh(host, tp[:, 0], tp[:, 1], tp[:, 2])
    n = 128
    o, d, tm, _ = _rays(n, seed=5)
    call, variant = KERNELS[kernel]
    if kernel == "B5":
        monkeypatch.setattr(pallas_traverse, "SMEM_META_MAX", 4)
    ref = call(pb, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
    args = [torch.as_tensor(a) for a in (o, d, tm, np.zeros(n, np.uint8))]
    if variant is None:
        got = T.traverse4(T.pack_kernel_bvh4(kb), *args)
    else:
        got = T.traverse(kb, *args, variant=variant)
    t, s = got[0].numpy(), got[1].numpy()
    rt, rs = np.asarray(ref.t), np.asarray(ref.slot)
    hit = s >= 0
    assert hit.sum() > 40
    assert np.array_equal(hit, rs >= 0)
    assert np.all(np.abs(t[hit] - rt[hit]) <= 1e-6 * np.maximum(1.0, rt[hit]))
    same = s[hit] == rs[hit]
    assert same.mean() >= 0.999 or np.all(np.abs(t[hit] - rt[hit])[~same] <= 1e-6)
    if len(got) == 5:
        both = hit & (s == rs)
        for mine, theirs in ((got[2], ref.b1), (got[3], ref.b2)):
            assert np.all(np.abs(mine.numpy()[both] - np.asarray(theirs)[both]) <= 1e-6)


@pytest.fixture(scope="module")
def bench_tables():
    _, jcs = jax_bench_scene(large=False)
    kb = tables_from_jax_arrays(jax_scene_arrays(jcs)[0])["bvh"]
    return jcs, kb


def test_plain_walk_matches_xla_walk(bench_tables):
    jcs, kb = bench_tables
    data = jcs.data
    o, d, tm, ah = _rays(3000, seed=7)
    t, s, iters = _plain(kb, o, d, tm, ah)
    args = (data.bvh, data.tri_p0, data.tri_p1, data.tri_p2,
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
    ref = intersect_bvh(*args)
    ref_any = intersect_bvh(*args, any_hit=True)
    rt, rtri = np.asarray(ref.t), np.asarray(ref.tri)
    cl = ah == 0
    hit = cl & (s >= 0)
    assert hit.sum() > 500 and (~cl & (s >= 0)).sum() > 500
    assert np.array_equal(s[cl] >= 0, rtri[cl] >= 0)
    assert np.array_equal(s[~cl] >= 0, np.asarray(ref_any.tri)[~cl] >= 0)
    tri = kb.order.numpy()[s[hit]]
    # The XLA walk forms its edge functions with difference-of-products;
    # the kernel (and so the port) with plain products. On the knot's
    # triangles t agrees to 1e-6 relative; on the 20-unit floor and the
    # light (triangles 0-3) the plain products lose more: measured up to
    # 2.1e-6 relative here, so those hits are held to 4e-6.
    tol = np.where(tri >= 4, 1e-6, 4e-6)
    assert np.all(np.abs(t[hit] - rt[hit]) <= tol * np.maximum(1.0, rt[hit]))
    same = tri == rtri[hit]
    assert same.mean() >= 0.999
    if not same.all():     # every mismatch is a tie: the reference's triangle
        lanes = np.nonzero(hit)[0][~same]      # sits at the port's t
        p0, p1, p2 = (np.asarray(x)[rtri[lanes]] for x in (data.tri_p0, data.tri_p1, data.tri_p2))
        _, t_ref_tri, *_ = intersect_tri(p0, p1, p2, o[lanes], d[lanes], np.full(len(lanes), np.inf))
        assert np.all(np.abs(np.asarray(t_ref_tri) - t[lanes]) <= 1e-6 * np.maximum(1.0, t[lanes]))
    assert not np.any(iters & T.OVF_BIT)
    assert iters.shape == (3,) and np.all(iters > 0)


@pytest.mark.parametrize("variant", ["packet", "queue", "all"])
def test_kernel_stack_holds_the_plain_walk(bench_tables, variant):
    """The packer's bound on the walk's stack, depth + 1, holds the most
    entries the plain walk held on 2,000 random rays of the small bench knot
    (half of them any-hit), seedless ("packet") or seeded ("queue", "all"),
    and fits the kernels' stack of STACK entries."""
    _, kb = bench_tables
    o, d, tm, ah = (torch.as_tensor(a) for a in _rays(2000, seed=8))
    counts = T.WalkCounts(kb.metas)
    T.traverse_plain(kb, o, d, tm, ah, counts, variant)
    assert 2 <= counts.max_stack <= kb.max_depth + 1 <= T.STACK


def test_kernel_resources_reads_the_ptxas_report(tmp_path, monkeypatch):
    """The registers, spills and shared memory chip_smoke.py prints come
    from ptxas -v's report kept beside a library; kernels are named by
    their demangled name and bool template arguments."""
    from pbrt_tpu_torch.accel import native
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    ns = "_ZN53_GLOBAL__N__0fe0dbb0_20_instance_traverse_cu_18ee9087"
    (tmp_path / "libinstance_traverse.log").write_text(
        f"ptxas info    : Compiling entry function '{ns}15instance_kernelILb1EEEvPK6float4' "
        "for 'sm_90a'\n"
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 80 registers, 1024 bytes smem, 480 bytes cmem[0]\n"
        f"ptxas info    : Compiling entry function '{ns}13packet_kernelEPK6float4' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 47 registers, 480 bytes cmem[0]\n")
    assert native.kernel_resources("instance_traverse") == {
        "instance_kernel<1>": dict(stack_frame=8, spill_stores=4, spill_loads=8, registers=80,
                                   static_smem=1024),
        "packet_kernel": dict(stack_frame=0, spill_stores=0, spill_loads=0, registers=47,
                              static_smem=0)}
    assert native.kernel_resources("bvh4_traverse") == {}


def test_far_miss_rays_retire_at_root(bench_tables):
    _, kb = bench_tables
    o, d = T.far_miss_rays(kb, 64, "cpu")
    t, s, it = T.traverse(kb, o.contiguous(), d.contiguous(),
                          torch.full((64,), float("inf")), torch.zeros(64, dtype=torch.uint8))
    assert torch.all(s == -1) and int(it[0]) == 1


def test_pack_rejects_what_the_kernel_cannot_take():
    tp, lo, hi = _knot(8, 8)
    bvh = build_bvh(lo, hi, leaf_size=16)
    with pytest.raises(ValueError, match="leaf"):
        T.pack_kernel_bvh(bvh, tp[:, 0], tp[:, 1], tp[:, 2])
    with pytest.raises(NotImplementedError):
        T.traverse(None, torch.zeros((1, 3), device="meta"), None, None, None)


@pytest.mark.parametrize("bad,err", [
    ("d_float64", TypeError), ("anyhit_bool", TypeError), ("o_shape", ValueError),
    ("tmax_strided", ValueError), ("tmax_device", ValueError), ("o_misaligned", ValueError)])
def test_launch_rejects_what_the_kernel_cannot_take(bench_tables, bad, err):
    """The CUDA wrapper's checks run before the kernel is built or called,
    so they are exercised here on CPU tensors."""
    _, kb = bench_tables
    n = 16
    o, d = (torch.as_tensor(a) for a in rays_at_knot(n, seed=3))
    tm = torch.full((n,), float("inf"))
    ah = torch.zeros(n, dtype=torch.uint8)
    if bad == "d_float64":
        d = d.double()
    elif bad == "anyhit_bool":
        ah = ah.bool()
    elif bad == "o_shape":
        o = torch.cat([o, o[:, :1]], 1)
    elif bad == "tmax_strided":
        tm = torch.full((2 * n,), float("inf"))[::2]
    elif bad == "tmax_device":
        tm = tm.to("meta")
    elif bad == "o_misaligned":
        o = torch.cat([o[:1], o])[1:]
    with pytest.raises(err):
        T._launch(kb, o, d, tm, ah)


@pytest.mark.parametrize("bad,err", [
    ("unknown_variant", ValueError), ("packet_d_float64", TypeError),
    ("bvh4_nodes_shape", ValueError), ("bvh4_meta_dtype", TypeError),
    ("bvh4_stack", ValueError), ("bvh4_leaf_root", ValueError),
    ("queue_recs_shape", ValueError), ("queue_recs_dtype", TypeError),
    ("all_recs_shape", ValueError), ("all_recs_dtype", TypeError)])
def test_new_walks_reject_what_their_kernels_cannot_take(bench_tables, bad, err):
    """The with-barycentrics and 4-wide wrappers, and every 2-wide walk's
    check of its walk records, run before they build or launch, so their
    refusals are exercised here on CPU tensors, as is the 4-wide packer's."""
    _, kb = bench_tables
    n = 16
    o, d = (torch.as_tensor(a) for a in rays_at_knot(n, seed=4))
    tm = torch.full((n,), float("inf"))
    ah = torch.zeros(n, dtype=torch.uint8)
    kb4 = T.pack_kernel_bvh4(kb)
    with pytest.raises(err):
        if bad == "unknown_variant":
            T.traverse(kb, o, d, tm, ah, variant="queue4")
        elif bad == "packet_d_float64":
            T._launch(kb, o, d.double(), tm, ah, "packet")
        elif bad == "bvh4_nodes_shape":
            T._launch4(dataclasses.replace(kb4, nodes4=kb4.nodes4[:-1]), o, d, tm, ah)
        elif bad == "bvh4_meta_dtype":
            T._launch4(dataclasses.replace(kb4, meta4=kb4.meta4.long()), o, d, tm, ah)
        elif bad == "bvh4_stack":
            T._launch4(dataclasses.replace(kb4, stack_need=T.STACK4 + 1), o, d, tm, ah)
        elif bad.endswith("_recs_shape"):
            T._launch(dataclasses.replace(kb, recs=kb.recs[:, :12]), o, d, tm, ah, bad[:-11])
        elif bad.endswith("_recs_dtype"):
            T._launch(dataclasses.replace(kb, recs=kb.recs.view(torch.int32)), o, d, tm, ah,
                      bad[:-11])
        else:
            tp, lo, hi = _knot(2, 2)
            T.pack_kernel_bvh4(T.pack_kernel_bvh(build_bvh(lo, hi), tp[:, 0], tp[:, 1], tp[:, 2]))


@pytest.mark.parametrize("large", [False, True])
def test_kernel_matches_plain_on_card(large):
    needs_cuda()
    tp, lo, hi = _knot(*((384, 96) if large else (96, 24)))
    kb = T.pack_kernel_bvh(build_bvh(lo, hi), tp[:, 0], tp[:, 1], tp[:, 2], device="cuda")
    o, d, tm, ah = _rays(100_003, seed=11)
    args = [torch.as_tensor(a, device="cuda") for a in (o, d, tm, ah)]
    before = T.traverse.launches
    t, s, it = T.traverse(kb, *args)
    torch.cuda.synchronize()
    assert T.traverse.launches == before + 1
    tp_, sp_, itp = T.traverse_plain(kb, *args)
    cl = args[3] == 0
    assert torch.equal(t[cl], tp_[cl]) and torch.equal(s[cl], sp_[cl])
    assert torch.equal(s[~cl] >= 0, sp_[~cl] >= 0)
    assert torch.equal(it, itp) and not bool(torch.any(it & T.OVF_BIT))
