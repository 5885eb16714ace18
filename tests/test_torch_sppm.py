"""Stochastic progressive photon mapping against pbrt_tpu.

Every comparison reads the reference's outputs committed in
tests/torch_refs (make_refs.py ran pbrt_tpu's _sppm_iteration jitted on
the CPU, and once more eagerly with its locals and its first _deposit
call recorded, on the same scene text), so no test here compiles a JAX
integrator.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (caps torch at one thread)
from torch_refs import cases as C

from pbrt_tpu_torch.integrators import sppm as S
from pbrt_tpu_torch.materials import bsdf as B
from pbrt_tpu_torch.render import Options, render, sample_pixels
from pbrt_tpu_torch.scene import load_scene_string


def _close(a, want, share=0.99, rtol=1e-3, atol=1e-4):
    """>= share of rows within rtol / atol, the means within 1%."""
    a = np.asarray(a)
    ok = np.all((np.abs(a - want) <= atol + rtol * np.abs(want)).reshape(a.shape[0], -1), axis=1)
    assert ok.mean() >= share, ok.mean()
    assert abs(a.mean() - want.mean()) <= 0.01 * abs(want.mean()) + 1e-12


@pytest.fixture(scope="module", params=list(C.SPPM_SCENES))
def iteration(request):
    """(reference arrays, the port's scene, its lanes, its camera pass)."""
    scene = request.param
    ref = C.load(f"sppm_iteration_{scene}")
    assert C.small_scene(scene, C.sppm_line(C.SPPM_SCENES[scene])) == ref["scene"]
    cs = load_scene_string(ref["scene"], device="cpu")
    px, py = (torch.as_tensor(a) for a in sample_pixels(cs.film))
    np.testing.assert_array_equal(px.numpy(), ref["px"])
    np.testing.assert_array_equal(py.numpy(), ref["py"])
    vp, ld = S.camera_pass(cs, C.DEPTH, px, py, int(ref["it"]))
    return ref, cs, (px, py), (vp, ld)


def _ref_vp(ref, lobes_like):
    """The reference's visible points as VisiblePoints, its lobes in the
    port's layout (the fields the port's scene leaves None stay None)."""
    t = lambda k: torch.as_tensor(ref[k])
    lobes = B.Lobes(**{f.name: None if getattr(lobes_like, f.name) is None else
                       t(f"lobe_{f.name}").to(getattr(lobes_like, f.name).dtype)
                       for f in dataclasses.fields(B.Lobes)})
    return S.VisiblePoints(t("vp_valid"), t("vp_p"), t("vp_wo"), t("vp_beta"), lobes, t("vp_ns"),
                           t("vp_ss"), t("vp_ts"))


def test_camera_pass_matches_reference(iteration):
    """The visible points of 256 pixels at depth 3: vp_valid equal; p, wo,
    the throughput, the frame and ld (emission through specular bounces
    and NEE) by hold_li's rule (>= 99% of pixels within rtol 1e-3 / atol
    1e-4, the means within 1%)."""
    ref, cs, _, (vp, ld) = iteration
    np.testing.assert_array_equal(vp.valid.numpy(), ref["vp_valid"])
    assert 0 < int(vp.valid.sum()) < vp.valid.shape[0]
    for got, k in ((vp.p, "vp_p"), (vp.wo, "vp_wo"), (vp.beta, "vp_beta"), (ld, "ld"),
                   (vp.ns, "vp_ns"), (vp.ss, "vp_ss"), (vp.ts, "vp_ts")):
        _close(got.numpy(), ref[k])
    assert float(ld.sum()) > 0
    np.testing.assert_array_equal(vp.lobes.kd.numpy()[ref["vp_valid"]],
                                  ref["lobe_kd"][ref["vp_valid"]])


def test_grid_matches_reference(iteration):
    """The grid from the reference's visible points: the cell size, every
    cell id (0x7FFFFFFF where none) and the stable sort's order equal; and
    from the port's own visible points the same cells on >= 99% of
    pixels."""
    ref, cs, _, (vp, _) = iteration
    radius = torch.full((vp.p.shape[0],), float(ref["radius"]))
    grid = S.build_grid(cs, _ref_vp(ref, vp.lobes), radius)
    assert float(grid.cell_size) == float(ref["cell_size"])
    np.testing.assert_array_equal(grid.cell.numpy(), ref["vp_cell"])
    np.testing.assert_array_equal(grid.order.numpy(), ref["order"])
    np.testing.assert_array_equal(grid.sorted_cell.numpy(), ref["sorted_cell"])
    own = S.build_grid(cs, vp, radius)
    assert (own.cell.numpy() == ref["vp_cell"]).mean() >= 0.99


def test_deposit_matches_reference(iteration):
    """One _deposit call (the photons' second bounce) on the reference's
    inputs (its live photons, in photon order; the others deposit
    nothing): the deposit counts and the overflow count equal, phi within
    1e-5 relative (the port sums a point's deposits in the reference's
    (cell, slot, photon) order, by a fixed-order tree)."""
    ref, cs, _, (vp, _) = iteration
    rvp = _ref_vp(ref, vp.lobes)
    radius = torch.full((vp.p.shape[0],), float(ref["radius"]))
    grid = S.build_grid(cs, rvp, radius)
    t = lambda k: torch.as_tensor(ref[k])
    live = torch.ones(ref["ph_index"].shape[0], dtype=torch.bool)
    phi, m, ovf = S._deposit(rvp, grid, radius, t("ph_p"), t("ph_beta"), live, t("ph_dir"),
                             cs.flags.bsdf_fams)
    np.testing.assert_array_equal(m.numpy(), ref["m_count"])
    assert int(ovf) == int(ref["overflow"])
    np.testing.assert_allclose(phi.numpy(), ref["phi"], rtol=1e-5, atol=1e-30)
    assert float(m.sum()) >= 50


def test_sppm_iteration_matches_reference(iteration):
    """A whole iteration from the initial state against the reference's
    jitted one: the radii, photon counts, ld and tau by hold_li's rule;
    the overflow count equal."""
    ref, cs, (px, py), _ = iteration
    n = px.shape[0]
    state = (torch.full((n,), float(ref["radius"])), torch.zeros((n, 3)), torch.zeros((n, 3)),
             torch.zeros(n))
    r, ld, tau, n_ph, ovf = S._sppm_iteration(cs, C.DEPTH, C.SPPM_PHOTONS, px, py,
                                              int(ref["it"]), *state)
    for got, k in ((r, "out_radius"), (n_ph, "out_n"), (ld, "out_ld"), (tau, "out_tau")):
        _close(got.numpy(), ref[k])
    assert int(ovf) == int(ref["out_overflow"])
    assert float(tau.sum()) > 0


def test_render_sppm_matches_reference():
    """render_sppm at 16x16, 4 iterations of 256 photons: >= 99% of pixels
    within rtol 1e-3 / atol 1e-4 of the reference's image, the means
    within 1%, and the overflow count equal; the counters and passes."""
    name, scene, iterations = C.SPPM_RENDER
    ref = C.load(name)
    text = C.small_scene(scene, C.sppm_line(C.SPPM_SCENES[scene], iterations, photons=-1))
    assert text == ref["scene"]
    img, cnt, passes = render(load_scene_string(text, device="cpu"))
    assert img.shape == (16, 16, 3) and passes == iterations
    _close(img.numpy().reshape(-1, 3), ref["image"].reshape(-1, 3))
    assert cnt["grid_overflows"] == int(ref["overflow"])


def test_sppm_radius_option_and_overflow_warning(capsys):
    """Options.sppm_radius replaces the scene's radius: a radius whose
    cells hold more than MAX_PER_CELL points counts overflows and warns;
    the scene's own small radius renders the same image as the option set
    to it."""
    text = C.small_scene("knot", C.sppm_line(0.05, 2, photons=2048))
    cs = load_scene_string(text, device="cpu")
    a, cnt_a, _ = render(cs)
    b, _, _ = render(load_scene_string(text.replace('"float radius" 0.05', '"float radius" 3'),
                                       device="cpu"), Options(sppm_radius=0.05))
    assert torch.equal(a, b) and cnt_a["grid_overflows"] == 0
    assert "grid overflow" not in capsys.readouterr().out
    _, cnt, _ = render(cs, Options(sppm_radius=3.0))
    assert cnt["grid_overflows"] > 0
    assert f"{cnt['grid_overflows']} deposits skipped" in capsys.readouterr().out
