"""Spectral mode (`Integrator ... "bool spectral" "true"`) against pbrt_tpu:
the sampled-spectrum tables and conversions, the lobes' lift, and li_path,
li_direct and MLT's path target under the flag.

The integrators are held against the reference's outputs committed in
tests/torch_refs (make_refs.py ran pbrt_tpu jitted on the CPU on the same
scene text, lanes and seed), so no test here compiles a JAX integrator; the
conversions run the reference's own functions eagerly on a few colours.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import hold_ref
from torch_refs import cases as C

from pbrt_tpu.core import spectrum as JS
from pbrt_tpu_torch.core import spectrum as S
from pbrt_tpu_torch.integrators import mlt as M
from pbrt_tpu_torch.integrators.direct import li_direct
from pbrt_tpu_torch.integrators.path import li_path
from pbrt_tpu_torch.materials import LIFT_FIELDS, lift_lobes
from pbrt_tpu_torch.materials import bsdf as B
from pbrt_tpu_torch.render import Options, render
from pbrt_tpu_torch.scene import load_scene_string

# the conversions are sums of three products: the port's and XLA's roundings
# may differ in the last bit of a product or a sum
ULP_RTOL, ULP_ATOL = 4e-7, 1e-7


def _colours():
    """Seeded colours in [0, 1.5) and colours with every tie between
    channels (two equal, all three equal, zeros), [N, 3] float32."""
    rng = np.random.default_rng(7)
    rand = rng.uniform(0, 1.5, (256, 3)).astype(np.float32)
    a, b = rng.uniform(0, 1, (2, 16)).astype(np.float32)
    ties = [np.stack(p, -1) for p in ((a, a, b), (a, b, a), (b, a, a), (a, a, a), (b, b, a),
                                      (a, b, b), (b, a, b))]
    ties.append(np.array([[0, 0, 0], [1, 1, 1], [0, 1, 0], [1, 0, 1], [0.5, 0.5, 0]],
                         np.float32))
    return np.concatenate([rand] + ties)


def test_spectral_tables_are_the_references():
    """The wavelengths, the film's [60, 3] operator and both [7, 60] basis
    sets (the active-set solve in float64) bit-equal to the reference's."""
    assert S.N_SPECTRAL_SAMPLES == JS.N_SPECTRAL_SAMPLES == 60
    np.testing.assert_array_equal(S.spectral_lambdas(), JS.spectral_lambdas())
    for mine, ref in zip(S._spectral_tables(), JS._spectral_tables()):
        assert mine.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("reflectance", [False, True])
@pytest.mark.parametrize("clamp", [True, False])
def test_rgb_to_spectrum_matches_reference(reflectance, clamp):
    """rgb_to_spectrum on seeded colours and on every tie between channels
    (the branch on the smallest channel): within ULP_RTOL / ULP_ATOL of
    the reference's, and the same sign pattern where unclamped."""
    rgb = _colours()
    got = S.rgb_to_spectrum(torch.as_tensor(rgb), clamp=clamp, reflectance=reflectance).numpy()
    want = np.asarray(JS.rgb_to_spectrum(jnp.asarray(rgb), clamp=clamp, reflectance=reflectance))
    assert got.shape == want.shape == (rgb.shape[0], 60)
    np.testing.assert_allclose(got, want, rtol=ULP_RTOL, atol=ULP_ATOL)
    if clamp:
        assert (got >= 0).all()


def test_spectrum_to_rgb_matches_reference():
    """The film's conversion of lifted colours and of seeded spectra (a
    [N, 60] @ [60, 3] product): within 1e-6 of the reference's, and a
    lifted colour converts back to within 2e-3 of itself, as in the
    reference's round trip."""
    rgb = _colours()
    spec = np.concatenate([np.asarray(JS.rgb_to_spectrum(jnp.asarray(rgb))),
                           np.random.default_rng(8).uniform(0, 1, (64, 60)).astype(np.float32)])
    got = S.spectrum_to_rgb(torch.as_tensor(spec)).numpy()
    np.testing.assert_allclose(got, np.asarray(JS.spectrum_to_rgb(jnp.asarray(spec))),
                               rtol=1e-6, atol=1e-6)
    assert np.abs(got[:len(rgb)] - rgb).max() < 2e-3


def test_lift_lobes_matches_reference():
    """lift_lobes widens the nine colour fields to 60 channels with the
    reflectance bases, as the reference's does (ULP_RTOL / ULP_ATOL), and
    leaves every other field as it was."""
    from pbrt_tpu.materials import LIFT_FIELDS as J_LIFT, lift_lobes as j_lift
    from pbrt_tpu.materials.bsdf import Lobes as JLobes
    assert LIFT_FIELDS == J_LIFT
    rng = np.random.default_rng(9)
    n = 64
    cols = {f: rng.uniform(0, 1, (n, 3)).astype(np.float32) for f in LIFT_FIELDS}
    eta = rng.uniform(1, 2, n).astype(np.float32)
    lb = B.Lobes(**{f: torch.as_tensor(v) for f, v in cols.items()}, eta=torch.as_tensor(eta))
    got = lift_lobes(lb)
    want = j_lift(JLobes.zeros(n)._replace(**{f: jnp.asarray(v) for f, v in cols.items()}))
    for f in LIFT_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=ULP_RTOL, atol=ULP_ATOL, err_msg=f)
    assert torch.equal(got.eta, torch.as_tensor(eta)) and got.sigma is None


def test_gamma_correct_matches_reference():
    v = np.linspace(-0.1, 1.2, 301).astype(np.float32)
    np.testing.assert_allclose(S.gamma_correct(torch.as_tensor(v)).numpy(),
                               np.asarray(JS.gamma_correct(jnp.asarray(v))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(S.inverse_gamma_correct(torch.as_tensor(v)).numpy(),
                               np.asarray(JS.inverse_gamma_correct(jnp.asarray(v))),
                               rtol=1e-6, atol=1e-7)


LI_NAMES = [n for n, (_, kind, _) in C.SPECTRAL_CASES.items() if kind != "mlt"]


@pytest.mark.parametrize("name", LI_NAMES)
def test_li_under_the_flag_matches_reference(name):
    """li_path and li_direct (both strategies) on 1,024 lanes at depth 3
    under "bool spectral" "true": by hold_li's rule (>= 99% of lanes
    within rtol 1e-3 / atol 1e-4, the means within 1%, p_film bit-equal);
    directlighting's live-ray counts equal, path's within 2 (on the knot
    one lane's path takes another branch, as in the RGB knot cases); and
    the spectral radiance is not the RGB render's."""
    _, kind, strategy = C.SPECTRAL_CASES[name]
    ref = C.load(name)
    text = C.spectral_case_scene(name)
    assert text == ref["scene"]
    cs = load_scene_string(text, device="cpu")
    assert cs.flags.spectral
    lanes = [torch.as_tensor(ref[k]) for k in ("px", "py", "s")]
    li = li_path if kind == "path" else (
        lambda *a, **kw: li_direct(*a, strategy=strategy, **kw))
    L, p_film, w, cnt = li(cs, *lanes, max_depth=C.DEPTH)
    assert hold_ref(L, p_film, cnt if kind != "path" else None, ref) > 0.01
    assert np.array_equal(w.numpy(), ref["w"])
    for k in ("camera_rays", "shadow_rays", "bounce_rays", "valid_hits"):
        assert abs(int(cnt[k]) - int(ref[f"cnt_{k}"])) <= 2, k
    rgb = load_scene_string(text.replace(C.SPECTRAL, ""), device="cpu")
    assert not rgb.flags.spectral
    L_rgb = li(rgb, *lanes, max_depth=C.DEPTH)[0]
    assert not torch.equal(L, L_rgb)


def test_mlt_path_target_under_the_flag_matches_reference():
    """MLT's path target (li_path driven by the primary samples) under the
    flag on 1,024 seeded vectors: hold_li's rule, p_film bit-equal."""
    name = "spectral_mlt_path_knot"
    ref = C.load(name)
    assert C.spectral_case_scene(name) == ref["scene"]
    cs = load_scene_string(ref["scene"], device="cpu")
    assert cs.flags.spectral
    u, _ = C.mlt_inputs(int(ref["seed"]), M._n_dims(C.DEPTH))
    L, p_film = M._eval_target(cs, torch.as_tensor(u), C.DEPTH)
    hold_ref(L, p_film, None, {"L": np.nan_to_num(ref["L"], posinf=0.0, neginf=0.0),
                               "p_film": ref["p_film"]})


FURNACE = """LookAt 0 0 5  0 0 0  0 1 0
Camera "orthographic" "float screenwindow" [-1.3 1.3 -1.3 1.3]
Film "image" "integer xresolution" [12] "integer yresolution" [12]
Sampler "02sequence" "integer pixelsamples" 8
Integrator "path" "integer maxdepth" 4{SPECTRAL}
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
AttributeBegin
  Material "matte" "rgb Kd" [.4 .6 .8]
  Shape "sphere" "float radius" 1
AttributeEnd
WorldEnd
"""


def test_spectral_furnace_matches_rgb():
    """tests/test_spectral.py's white furnace in the port: the coloured
    ball's centre under the flag within 0.04 of the RGB render's per
    channel (the metamer tolerance), and not equal to it."""
    opts = Options(wavefront_size=1 << 12)
    imgs = [render(load_scene_string(FURNACE.replace("{SPECTRAL}", tok), device="cpu"),
                   opts)[0].numpy() for tok in ("", C.SPECTRAL)]
    c_rgb, c_spec = (im[4:8, 4:8].mean(axis=(0, 1)) for im in imgs)
    assert np.isfinite(imgs[1]).all() and not np.array_equal(*imgs)
    assert np.abs(c_spec - c_rgb).max() < 0.04, (c_rgb, c_spec)
