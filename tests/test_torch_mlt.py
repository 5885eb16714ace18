"""Metropolis light transport and li_path's primary-sample hooks against
pbrt_tpu.

Every comparison reads the reference's outputs committed in
tests/torch_refs (make_refs.py ran pbrt_tpu jitted on the CPU on the same
scene text and seeded inputs, and recorded one render_mlt's bootstrap,
chain starts and first step), so no test here compiles a JAX integrator.
"""
import numpy as np
import pytest
import torch

from torch_port_helpers import hold_ref
from torch_refs import cases as C

from pbrt_tpu_torch.core.spectrum import luminance
from pbrt_tpu_torch.film import FilmState
from pbrt_tpu_torch.integrators import mlt as M
from pbrt_tpu_torch.integrators.path import li_path
from pbrt_tpu_torch.scene import load_scene_string


def _hold_lanes(L, want, share=0.99):
    """>= share of lanes within rtol 1e-3 / atol 1e-4, the means within 1%."""
    L = np.asarray(L)
    ok = np.all(np.abs(L - want) <= 1e-4 + 1e-3 * np.abs(want), axis=-1)
    assert ok.mean() >= share, ok.mean()
    assert abs(L.mean() - want.mean()) <= 0.01 * abs(want.mean())


@pytest.fixture(scope="module")
def render_ref():
    name, _, _ = C.MLT_RENDER
    ref = C.load(name)
    return ref, load_scene_string(ref["scene"], device="cpu")


@pytest.mark.parametrize("scene", C.MLT_SCENES)
def test_bdpt_target_matches_reference(scene):
    """_eval_bdpt_target on 1,024 seeded vectors at depth 3, each lane's
    strategy from its last column: L by hold_li's rule (>= 99% of lanes
    within rtol 1e-3 / atol 1e-4, the means within 1%); the raster
    positions bit-equal where the strategy traces the lane's film position
    (t >= 2), and within 1e-4 pixels where a light vertex is projected onto
    the film (t = 1)."""
    ref = C.load(f"mlt_bdpt_{scene}")
    assert C.small_scene(scene, C.mlt_line("bdpt")) == ref["scene"]
    cs = load_scene_string(ref["scene"], device="cpu")
    u, depth = C.mlt_inputs(int(ref["seed"]), M._n_dims_bdpt(C.DEPTH))
    assert u.shape[1] == 91
    L, raster = M._eval_bdpt_target(cs, torch.as_tensor(u), C.DEPTH, torch.as_tensor(depth))
    _hold_lanes(L, ref["L"])
    assert float(L.sum()) > 0
    raster = raster.numpy()
    p_film = np.stack([u[:, 0], u[:, 1]], -1) * C.SMALL_RES
    moved = np.any(raster != p_film, axis=1)
    np.testing.assert_array_equal(raster[~moved], ref["p_film"][~moved])
    assert np.abs(raster - ref["p_film"]).max() <= 1e-4


@pytest.mark.parametrize("scene", C.MLT_SCENES)
def test_path_target_and_li_path_hooks_match_reference(scene):
    """_eval_target on 1,024 seeded vectors, and li_path under both hooks
    (sampler_fn from the vectors, p_film_override at seeded film
    positions, the lens from dimensions 2 - 3): L by hold_li's rule,
    p_film bit-equal, and li_path's live-ray counts within 1% of the
    reference's (on the knot one lane's path ends a vertex before the
    reference's, as test_bdpt_sample_matches_reference finds on the same
    scene)."""
    ref = C.load(f"mlt_path_{scene}")
    assert C.small_scene(scene, C.mlt_line("path")) == ref["scene"]
    cs = load_scene_string(ref["scene"], device="cpu")
    u, _ = C.mlt_inputs(int(ref["seed"]), M._n_dims(C.DEPTH))
    L, p_film = M._eval_target(cs, torch.as_tensor(u), C.DEPTH)
    hold_ref(L, p_film, None, {"L": np.nan_to_num(ref["L_eval"], posinf=0.0, neginf=0.0),
                               "p_film": ref["p_eval"]})
    cols = torch.as_tensor(u).t().contiguous()
    px, py = torch.as_tensor(ref["px"]), torch.as_tensor(ref["py"])
    L, p_film, ray_w, cnt = li_path(cs, px, py, torch.zeros_like(px), max_depth=C.DEPTH,
                                    sampler_fn=lambda d: cols[min(d, u.shape[1] - 1)],
                                    p_film_override=torch.as_tensor(ref["p_over"]))
    assert hold_ref(L, p_film, None, ref) > 0.01
    np.testing.assert_array_equal(ray_w.numpy(), ref["ray_w"])
    for k in ("camera_rays", "shadow_rays", "bounce_rays", "valid_hits"):
        assert abs(int(cnt[k]) - int(ref[f"cnt_{k}"])) <= 0.01 * int(ref[f"cnt_{k}"]), k


def test_li_path_without_hooks_is_unchanged():
    """With neither hook, li_path draws from the sampler and the camera as
    before: the same L as sampler_fn reading the sampler's own draws."""
    from pbrt_tpu_torch.samplers import sample_dim
    cs = load_scene_string(C.small_scene("knot", 'Integrator "path" "integer maxdepth" 3'),
                           device="cpu")
    rng = np.random.default_rng(3)
    px, py, s = (torch.as_tensor(rng.integers(0, 16, 256).astype(np.int32)) for _ in range(3))
    L, p_film, _, cnt = li_path(cs, px, py, s, max_depth=C.DEPTH)
    L2, _, _, cnt2 = li_path(cs, px, py, s, max_depth=C.DEPTH,
                             sampler_fn=lambda d: sample_dim(cs.sampler, px, py, s, d))
    assert torch.equal(L, L2) and float(L.sum()) > 0
    assert {k: int(v) for k, v in cnt.items()} == {k: int(v) for k, v in cnt2.items()}


def test_bootstrap_and_chain_starts_match_reference(render_ref):
    """The bootstrap's 1,024 luminances on the reference's 16x16 render
    scene: b within 1e-4 relative; from the reference's weights, the chain
    starts' vectors and depths bit-equal (the host numpy draw)."""
    ref, cs = render_ref
    n_boot, n_chains, _ = C.MLT_RENDER[2]
    n_u, n_depths = M._n_dims_bdpt(C.DEPTH), C.DEPTH + 1
    w = M.bootstrap(lambda u, d: M._eval_bdpt_target(cs, u, C.DEPTH, d), n_boot, n_u, n_depths,
                    "cpu")
    assert w.shape == ref["w_boot"].shape == (n_boot,) and w.dtype == np.float32
    b = float(w.mean()) * n_depths
    assert abs(b - float(ref["b"])) <= 1e-4 * float(ref["b"])
    assert float(ref["w_boot"].mean()) * n_depths == float(ref["b"])
    starts, depth = M.chain_starts(ref["w_boot"], n_chains, n_depths)
    np.testing.assert_array_equal(depth, ref["depth_lane"])
    u0 = M.pss_vectors(torch.as_tensor(starts.astype(np.int64)), n_u).numpy()
    np.testing.assert_array_equal(u0, ref["u0"])


def test_mlt_step_matches_reference(render_ref):
    """The first Metropolis step of 256 chains from the reference's chain
    starts (u, L, y, p_film): large steps equal and their u_prop
    bit-equal, perturbed lanes within 1e-6 (the card's and the CPU's log
    and cos round apart); the proposals' L by hold_li's rule; the
    acceptance equal on >= 99% of chains; the splat film within rtol 1e-3
    / atol 1e-4 on >= 99% of pixels."""
    ref, cs = render_ref
    depth = torch.as_tensor(ref["depth_lane"])
    u_in, L_in = torch.as_tensor(ref["u0"]), torch.as_tensor(ref["L0"])
    np.testing.assert_array_equal(luminance(L_in).numpy(), ref["y_in"])
    step = int(ref["step"])
    assert step == 1
    u_prop, large = M.propose(u_in, step)
    np.testing.assert_array_equal(large.numpy(), ref["large"])
    big = ref["large"]
    assert 0 < big.sum() < big.shape[0]
    np.testing.assert_array_equal(u_prop.numpy()[big], ref["u_prop"][big])
    assert np.abs(u_prop.numpy()[~big] - ref["u_prop"][~big]).max() <= 1e-6
    film = FilmState.zeros(cs.film, "cpu", splats=True)
    b = torch.tensor(float(ref["b"]), dtype=torch.float32)
    eval_t = lambda u: M._eval_bdpt_target(cs, u, C.DEPTH, depth)
    film, chains, acc = M.mlt_step(cs, film, (u_in, L_in, torch.as_tensor(ref["y_in"]),
                                              torch.as_tensor(ref["pf0"])), step, b, eval_t)
    L_prop, _ = eval_t(torch.as_tensor(ref["u_prop"]))
    _hold_lanes(L_prop, ref["L_prop"])
    assert (acc.numpy() == ref["acc"]).mean() >= 0.99
    assert 0 < int(acc.sum()) < acc.shape[0]
    np.testing.assert_array_equal(chains[0].numpy()[acc.numpy()], u_prop.numpy()[acc.numpy()])
    _hold_lanes(film.splat.reshape(-1, 3), ref["splat"].reshape(-1, 3))
    assert float(film.splat.sum()) > 0


def test_render_mlt_matches_reference(render_ref):
    """render_mlt end to end at 16x16 (1,024 bootstrap samples, 256 chains,
    4 steps): hold_li's rule on its pixels (>= 99% within rtol 1e-3 /
    atol 1e-4, the means within 1%; a chain whose acceptance flipped on a
    last-bit difference of y would walk elsewhere from there); the
    counters and passes."""
    ref, cs = render_ref
    img, cnt, passes = M.render_mlt(cs)
    want = ref["image"]
    assert img.shape == want.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
    _hold_lanes(img.reshape(-1, 3), want.reshape(-1, 3))
    assert cnt["mutations"] == 1024 and cnt["bootstrap_samples"] == 1024
    assert int(ref["n_acc"]) <= cnt["mutations_accepted"] < 1024
    assert passes == 1 + 1 + 4


def test_render_mlt_path_target_and_empty_image():
    """The path target renders through render (a finite, lit image at the
    path integrator's brightness within 25% on this tiny budget), and a
    scene whose bootstrap finds no light gives the all-zero image."""
    from pbrt_tpu_torch.render import render
    cs = load_scene_string(C.small_scene("point", C.mlt_line("path", 1024, 256, 16)),
                           device="cpu")
    img, cnt, passes = render(cs)
    path, _, _ = render(load_scene_string(
        C.small_scene("point", 'Integrator "path" "integer maxdepth" 3'), device="cpu"))
    assert bool(torch.isfinite(img).all()) and float(img.sum()) > 0
    assert abs(float(img.mean()) - float(path.mean())) <= 0.25 * float(path.mean())
    assert passes == 1 + 1 + 16 and cnt["mutations"] == 16 * 256
    dark = C.small_scene("point", C.mlt_line("bdpt", 256, 64, 4)).replace(
        '"rgb I" [40 40 40]', '"rgb I" [0 0 0]')
    img, cnt, passes = render(load_scene_string(dark, device="cpu"))
    assert float(img.abs().sum()) == 0.0 and passes == 1 and cnt["mutations"] == 0
