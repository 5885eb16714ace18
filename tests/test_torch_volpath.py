"""Participating media and the volumetric path integrator against
pbrt_tpu: the medium tables, the Henyey-Greenstein phase function, medium
sampling and transmittance (homogeneous and grid), the shadow rays'
transmittance walk across a null shell, and li_volpath on a homogeneous
and a grid scene (the last two against the reference's outputs committed
in tests/torch_refs)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import front_end_tables, hold_ref, jax_scene_file
from torch_refs.cases import VOLPATH_KNOT, load as load_ref, tr_inputs

from pbrt_tpu import media as JMD
from pbrt_tpu.samplers.hashing import hash3 as j_hash3
from pbrt_tpu_torch import media as MD
from pbrt_tpu_torch.integrators.volpath import intersect_tr, li_volpath
from pbrt_tpu_torch.samplers.hashing import hash3
from pbrt_tpu_torch.scene import load_scene
from pbrt_tpu_torch.scene.bench import SMOKE_BOX, write_volpath_scene
from pbrt_tpu_torch.scene.bridge import from_jax_arrays, tables_from_jax_arrays

N = 1024   # the lanes of every test here, so that the reference compiles each op once
# a knot of 36 triangles: the scenes' 52 triangles stay under the
# reference's brute-force bound (MIN_BVH_TRIS, 64), so its intersect
# compiles no BVH loop per call (the port walks its BVH as ever)
TINY_KNOT = VOLPATH_KNOT


@pytest.fixture(scope="module", params=["homogeneous", "grid"])
def scene(request, tmp_path_factory):
    """The volpath scene at 64x64 (the fog alone, or the fog and the knot's
    box of grid medium) with a 36-triangle knot in the reference ->
    (its scene, the scene file)."""
    from pbrt_tpu.scene import load_scene as j_load_scene
    path = write_volpath_scene(str(tmp_path_factory.mktemp(request.param)), large=False,
                               grid=request.param == "grid", knot=TINY_KNOT)
    return j_load_scene(path), path


@pytest.mark.parametrize("grid", [False, True], ids=["homogeneous", "grid"])
def test_front_end_media_tables_equal_bridge(grid, tmp_path):
    """With the small bench knot: compile_media's tables, each primitive's,
    light's and the camera's medium, and the flags are the reference's,
    bit for bit."""
    jcs, arrays, specs = jax_scene_file(write_volpath_scene(str(tmp_path), large=False,
                                                            grid=grid))
    path = str(tmp_path / "scene.pbrt")
    want = tables_from_jax_arrays(arrays)
    got = front_end_tables(path)
    assert set(got) == set(want)
    for k in want:
        if k != "bvh":
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    ours = load_scene(path, device="cpu")
    assert ours.flags == from_jax_arrays(arrays, specs, device="cpu").flags
    grid = jcs.flags.any_grid_media
    assert ours.flags.n_media == 1 + grid and ours.data.camera_medium == 0
    assert got["med_kind"].tolist() == [0, 1][:1 + grid]
    assert (got["prim_medium"] == [[1, 0]]).all(1).sum() == grid


def _lanes(seed):
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(SMOKE_BOX[0]), np.asarray(SMOKE_BOX[1])
    o = rng.uniform(lo - 1.0, hi + 1.0, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0.05, 6.0, N).astype(np.float32)
    mid = rng.integers(-1, 2, N).astype(np.int32)
    keys = [rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32) for _ in range(2)]
    u = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    g = rng.uniform(-0.9, 0.9, N).astype(np.float32)
    g[::5] = 0.0
    return o, d, t, mid, keys, u, g


def _both(*a):
    return ([torch.as_tensor(x.astype(np.int64) if x.dtype == np.uint32 else x) for x in a],
            [jnp.asarray(x) for x in a])


def test_hg_p_and_sample_match_reference():
    """The phase function and its sample (g = 0 takes the uniform branch)
    within 2e-6 (absolute, on unit vectors and pdfs up to about 10)."""
    o, d, t, mid, keys, u, g = _lanes(1)
    (td, tu, tg), (jd, ju, jg) = _both(d, u, g)
    cos = np.clip((d * np.roll(d, 1, 0)).sum(1), -1, 1).astype(np.float32)
    np.testing.assert_allclose(MD.hg_p(torch.as_tensor(cos), tg).numpy(),
                               np.asarray(JMD.hg_p(jnp.asarray(cos), jg)), rtol=2e-6, atol=1e-7)
    wi, pdf = MD.hg_sample(td, tg, tu)
    jwi, jpdf = JMD.hg_sample(jd, jg, ju)
    np.testing.assert_allclose(wi.numpy(), np.asarray(jwi), rtol=0, atol=2e-6)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=2e-6, atol=1e-7)


def test_sample_medium_and_transmittance_match_reference(scene):
    """Medium sampling and transmittance of every lane kind (vacuum, the
    fog, and the grid, with rays from around its box) on the same keys:
    the scatter decisions equal on >= 99.9% of lanes, weights, distances
    of the lanes that agree and transmittances within 1e-5 relative
    (float32 logs and trilinear products round otherwise in XLA)."""
    jcs, path = scene
    cs = load_scene(path, device="cpu")
    med, jmed, grid = cs.data.media, jcs.data.media, cs.flags.any_grid_media
    o, d, t, mid, keys, u, _ = _lanes(2)
    mid = np.minimum(mid, 0 if not grid else 1)
    (to, td, tt, tm, ka, kb, tu), (jo, jd, jt, jm, jka, jkb, ju) = _both(o, d, t, mid, *keys, u)
    ms = MD.sample_medium(med, tm, to, td, tt, ka, kb, tu, grid)
    jms = JMD.sample_medium(jmed, jm, jo, jd, jt, jka, jkb, ju, any_grid=grid)
    same = ms.sampled_medium.numpy() == np.asarray(jms.sampled_medium)
    assert same.mean() >= 0.999, same.mean()
    assert ms.sampled_medium.numpy()[same].sum() > (40 if grid else 4)
    for got, want in ((ms.weight, jms.weight), (ms.t, jms.t), (ms.p, jms.p)):
        np.testing.assert_allclose(got.numpy()[same], np.asarray(want)[same], rtol=1e-5,
                                   atol=1e-6)
    tr = MD.transmittance(med, tm, to, td, tt, ka, kb, grid).numpy()
    jtr = np.asarray(JMD.transmittance(jmed, jm, jo, jd, jt, jka, jkb, any_grid=grid))
    close = np.all(np.abs(tr - jtr) <= 1e-5 * np.abs(jtr) + 1e-7, axis=1)
    assert close.mean() >= 0.999, close.mean()
    assert (tr < 0.99).mean() > 0.3


def test_intersect_tr_across_null_shell(scene, request):
    """Shadow rays from inside the knot's box (or the fog) toward the area
    light cross the box's null faces (a swap to the fog) and hit the knot
    or the floor: occlusion equal, transmittance within 1e-5 relative of
    the reference's outputs committed in tests/torch_refs (made by its
    make_refs.py from the same scene file and rays)."""
    _, path = scene
    ref = load_ref(f"intersect_tr_{request.node.callspec.params['scene']}")
    assert open(path).read() == ref["scene"]
    cs = load_scene(path, device="cpu")
    o, d, dist, mid, pix = tr_inputs(cs.flags.any_grid_media)
    for k, v in (("o", o), ("d", d), ("dist", dist), ("mid", mid), ("pix", np.stack(pix))):
        np.testing.assert_array_equal(v, ref[k])
    tpix = [torch.as_tensor(p.astype(np.int64)) for p in pix]
    tr, occ = intersect_tr(cs.data, cs.flags, *(torch.as_tensor(a) for a in (mid, o, d, dist)),
                           0xA100, hash3(*tpix))
    assert np.array_equal(occ.numpy(), ref["occ"])
    assert 0.05 < occ.numpy().mean() < 0.95
    np.testing.assert_allclose(tr.numpy(), ref["tr"], rtol=1e-5, atol=1e-7)
    assert (tr.numpy()[~occ.numpy()] < 0.999).all()


def test_li_volpath_matches_reference(scene, request):
    """li_volpath, 1,024 lanes at depth 3, with the criterion of
    tests/test_torch_path.py, against the reference's outputs committed in
    tests/torch_refs (made by its make_refs.py from the same scene file,
    lanes and seed)."""
    _, path = scene
    ref = load_ref(f"volpath_{request.node.callspec.params['scene']}")
    assert open(path).read() == ref["scene"]
    L, p_film, _, cnt = li_volpath(load_scene(path, device="cpu"),
                                   *(torch.as_tensor(ref[k]) for k in ("px", "py", "s")),
                                   max_depth=3)
    assert hold_ref(L, p_film, cnt, ref) > 0.05
