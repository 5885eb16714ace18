"""The moving, environment and realistic cameras against pbrt_tpu: the
animated transform, the camera rays and weights, the realistic camera's
focus and exit pupil, li_path through each (against the reference outputs
committed in tests/torch_refs), BDPT's camera at the shutter's start, and
the CLI on each form.

Tolerances: XLA and torch round acos, sin and cos otherwise on the CPU
(ROADMAP.md C), so the interpolated matrices, the environment camera's
directions and the moving camera's rays are held to 2e-6 absolute; the
realistic camera's focused lens and exit-pupil bounds are host numpy
float64 (its trace float32) and are held bit-equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import REPO, hold_ref
from torch_refs import cases as C

from pbrt_tpu.cameras import CameraSamples, generate_rays as j_generate_rays, \
    make_camera as j_make_camera
from pbrt_tpu.cameras import realistic as JR
from pbrt_tpu.core.transform import AnimatedTransform as JAnimated, Transform as JTransform
from pbrt_tpu_torch.cameras import generate_rays, make_camera
from pbrt_tpu_torch.cameras import realistic as R
from pbrt_tpu_torch.core.transform import AnimatedTransform, Transform, look_at, rotate, \
    scale, translate
from pbrt_tpu_torch.integrators.bdpt import _camera_importance, camera_pdf_we_dir
from pbrt_tpu_torch.integrators.common import camera_rays
from pbrt_tpu_torch.integrators.path import li_path
from pbrt_tpu_torch.io.image_io import read_png
from pbrt_tpu_torch.scene import load_scene_string
from pbrt_tpu_torch.scene.bench import CAMERA_MOTION, calibration_scene, scene_variant

START = look_at([3, 3, 3], [0, 0, 0], [0, 1, 0])
ENDS = {
    "static": START,
    "moving": translate([0.25, 0.1, 0.0]) * rotate(4.0, [0, 1, 0]) * START,
    "turn_scale": scale([1.0, 1.2, 0.9]) * rotate(70.0, [1, 1, 0]) * START,
    "tiny_turn": rotate(1e-4, [0, 0, 1]) * START,     # sin(theta) < 1e-5: the lerp guard
}
RES = (64, 48)
PARAMS = {"fov": [40.0], "aperturediameter": [8.0], "focusdistance": [5.196]}


def _pair(end):
    return JAnimated(JTransform(START.m), 0.0, JTransform(end.m), 1.0)


def _samples(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.uniform(0, 1, (n, 2)) * RES).astype(np.float32),
            rng.uniform(0, 1, (n, 2)).astype(np.float32),
            rng.uniform(-0.2, 1.2, n).astype(np.float32))


@pytest.mark.parametrize("end", list(ENDS))
def test_animated_transform_matches_reference(end):
    """interpolate at 4,096 batched times (clipped to [0, 1]): within 2e-6
    of the reference's matrices; the static transform returns its start."""
    t = np.random.default_rng(1).uniform(-0.25, 1.25, 4096).astype(np.float32)
    j = np.asarray(_pair(ENDS[end]).interpolate(jnp.asarray(t)))
    got = AnimatedTransform(Transform(START.m), 0.0, Transform(ENDS[end].m), 1.0) \
        .interpolate(torch.as_tensor(t)).numpy()
    j = np.broadcast_to(j, got.shape)
    assert np.abs(got - j).max() <= 2e-6
    if end == "static":
        assert np.array_equal(got, j)


@pytest.mark.parametrize("kind,end", [("perspective", "moving"), ("orthographic", "moving"),
                                      ("perspective", "turn_scale"), ("environment", "static"),
                                      ("environment", "moving"), ("realistic", "moving")])
def test_camera_rays_match_reference(kind, end):
    """Rays (with differentials where the camera has them) and weights of
    4,096 film samples, lens samples and times: within 2e-6, the weights
    equal; the environment and realistic cameras carry no differentials."""
    pf, ul, ut = _samples()
    jc = j_make_camera(kind, PARAMS, _pair(ENDS[end]), RES)
    c = make_camera(kind, PARAMS, (Transform(START.m), Transform(ENDS[end].m)), RES)
    assert (c.motion is None) == (end == "static")
    diff = kind in ("perspective", "orthographic")
    jr, jw = j_generate_rays(jc, CameraSamples(*(jnp.asarray(a) for a in (pf, ul, ut))), diff)
    r, w = generate_rays(c, torch.as_tensor(pf), diff, torch.as_tensor(ul), torch.as_tensor(ut))
    assert np.array_equal(w.numpy(), np.asarray(jw))
    live = w.numpy() > 0 if kind == "realistic" else slice(None)
    for name in ("o", "d", "rx_o", "rx_d", "ry_o", "ry_d"):
        a, b = getattr(r, name), getattr(jr, name)
        assert (a is None) == (b is None) == (not diff and name != "o" and name != "d")
        if a is not None:
            np.testing.assert_allclose(a.numpy()[live], np.asarray(b)[live], rtol=0, atol=2e-6)


def test_realistic_focus_and_exit_pupil_equal_reference():
    """The focused lens and the 32 exit-pupil bounds are the reference's
    bit for bit. As there, the focus bisection runs to its 1e-4 m floor with
    the built-in lens, no seeded ray passes, and every bin holds the whole
    rear aperture (ROADMAP.md C): every ray of the lens weighs 0."""
    jc = j_make_camera("realistic", PARAMS, _pair(START), RES)
    c = make_camera("realistic", PARAMS, (Transform(START.m),) * 2, RES)
    assert np.array_equal(c.lens_elements, jc.lens_elements)
    assert np.array_equal(c.exit_pupil, jc._exit_pupil)
    assert c.lens_elements[-1, 1] == pytest.approx(1e-4)
    rear = c.lens_elements[-1, 3]
    assert np.all(c.exit_pupil == np.float32([-rear, rear, -rear, rear]))
    pf, ul, _ = _samples()
    _, w = generate_rays(c, torch.as_tensor(pf), False, torch.as_tensor(ul))
    assert float(w.abs().sum()) == 0.0


@pytest.mark.parametrize("simple", [True, False])
def test_realistic_rays_through_an_open_lens_match_reference(simple):
    """The lens trace and realistic_rays on the built-in lens at its table's
    own rear gap (72.228 mm), with exit-pupil bounds the seeded rays pass:
    the weights (both simpleweighting settings) within 2e-6 relative, the
    rays within 2e-6, and most lanes pass."""
    lens = R.load_lens_system({"aperturediameter": [8.0]})
    bounds = R.focus_lens_system(lens, 5.196)[1]
    jc = j_make_camera("realistic", PARAMS, _pair(START), RES)
    c = make_camera("realistic", PARAMS, (Transform(START.m),) * 2, RES)
    # the pupil of the unfocused lens, the same routine on both sides
    rng = np.random.default_rng(2)
    for b in range(R.PUPIL_BINS):
        lx = rng.uniform(-0.02, 0.02, (512, 2))
        fx = np.full(512, (b + 0.5) / R.PUPIL_BINS * R.FILM_DIAG / 2)
        o = np.stack([fx, np.zeros(512), np.zeros(512)], -1)
        d = np.stack([lx[:, 0] - fx, lx[:, 1], np.full(512, -lens[-1, 1])], -1)
        ok = R._trace_np(lens, o, R._normalize_np(d))[0]
        jok = JR._trace_from_film_np(lens, o, JR.normalize_np(d))[0]
        assert np.array_equal(ok, jok)
        sel = lx[ok]
        bounds[b] = [sel[:, 0].min(), sel[:, 0].max(), sel[:, 1].min(), sel[:, 1].max()]
    object.__setattr__(jc, "lens_elements", lens)
    object.__setattr__(jc, "_exit_pupil", bounds)
    object.__setattr__(jc, "simple_weighting", simple)
    object.__setattr__(c, "lens_elements", lens)
    object.__setattr__(c, "exit_pupil", bounds)
    object.__setattr__(c, "simple_weighting", simple)
    pf, ul, ut = _samples(seed=3)
    jr, jw = j_generate_rays(jc, CameraSamples(*(jnp.asarray(a) for a in (pf, ul, ut))))
    r, w = generate_rays(c, torch.as_tensor(pf), True, torch.as_tensor(ul))
    w, jw = w.numpy(), np.asarray(jw)
    live = (w > 0) & (jw > 0)
    assert live.mean() > 0.3 and np.mean((w > 0) == (jw > 0)) >= 0.999
    np.testing.assert_allclose(w[live], jw[live], rtol=2e-6)
    for name in ("o", "d"):
        np.testing.assert_allclose(getattr(r, name).numpy()[live],
                                   np.asarray(getattr(jr, name))[live], rtol=0, atol=2e-6)


def test_lensfile_opens_relative_to_the_working_directory(tmp_path, monkeypatch):
    """A lensfile is read relative to the process's working directory, as
    the reference reads it (a known reference fault, mirrored); one that
    cannot be read gives the built-in lens."""
    table = "# a two-element lens\n40.0 5.0 1.6 30.0\n-40.0 40.0 1.0 30.0\n"
    (tmp_path / "lens.dat").write_text(table)
    monkeypatch.chdir(tmp_path)
    got = R.load_lens_system({"lensfile": ["lens.dat"]})
    assert np.array_equal(got, JR.load_lens_system({"lensfile": ["lens.dat"]}))
    assert got.shape == (2, 4) and got[0, 0] == pytest.approx(0.04)
    monkeypatch.chdir(REPO)
    assert np.array_equal(R.load_lens_system({"lensfile": ["lens.dat"]}),
                          R.load_lens_system({}))


@pytest.mark.parametrize("name", ["path_moving", "path_environment", "path_realistic"])
def test_li_path_matches_reference(name):
    """li_path on 1,024 lanes at depth 3 through each camera: hold_li's
    rule; the ray weights equal. A moving camera's rays differ from the
    reference's by the rounding of sin and acos (above), which moves a
    grazing lane: there the live-ray counts are held within 2 lanes. The
    realistic camera's focused lens passes no ray (above), so both sides
    open it (cases.open_lens, its exit pupil bit-equal) and its L is held
    by hold_li's rule on the lanes the lens passes; the counters count
    the stopped lanes too and are not held."""
    ref = C.load(name)
    text = C.path_case_scene(name)
    assert text == ref["scene"]
    cs = load_scene_string(text, device="cpu")
    if name == "path_realistic":
        lens, bounds = C.open_lens(R.load_lens_system, R._trace_np, R._normalize_np)
        jlens, jbounds = C.open_lens(JR.load_lens_system, JR._trace_from_film_np,
                                     JR.normalize_np)
        assert np.array_equal(lens, jlens) and np.array_equal(bounds, jbounds)
        object.__setattr__(cs.camera, "lens_elements", lens)
        object.__setattr__(cs.camera, "exit_pupil", bounds)
    lanes = [torch.as_tensor(ref[k]) for k in ("px", "py", "s")]
    L, p_film, w, cnt = li_path(cs, *lanes, max_depth=C.DEPTH)
    assert np.array_equal(w.numpy(), ref["w"])
    if name == "path_moving":
        assert hold_ref(L, p_film, None, ref) > 0.05
        for k in ("camera_rays", "shadow_rays", "bounce_rays", "valid_hits"):
            assert abs(int(cnt[k]) - int(ref[f"cnt_{k}"])) <= 2, k
    elif name == "path_realistic":
        # only the lanes the lens passes are rays; past a stop the trace
        # runs on from its last point, and its rounding diverges
        live = w.numpy() > 0
        assert 0.2 < live.mean() < 1.0
        np.testing.assert_array_equal(p_film.numpy(), ref["p_film"])
        Ls, jL = L.numpy()[live], ref["L"][live]
        assert np.mean(np.all(np.abs(Ls - jL) <= 1e-4 + 1e-3 * np.abs(jL), axis=1)) >= 0.99
        assert abs(Ls.mean() - jL.mean()) <= 0.01 * abs(jL.mean())
    else:
        assert hold_ref(L, p_film, cnt, ref) > 0.05


def test_moving_camera_draws_time_and_moves_the_rays():
    """The moving camera's rays are the static camera's at time 0 and
    differ elsewhere; camera_rays draws the time dimension for it."""
    line = 'Integrator "path" "integer maxdepth" 2'
    still = load_scene_string(calibration_scene("knot", line), device="cpu")
    moving = load_scene_string(scene_variant(calibration_scene("knot", line),
                                             motion=CAMERA_MOTION), device="cpu")
    px, py = torch.arange(16).repeat(16), torch.arange(16).repeat_interleave(16)
    s = torch.zeros_like(px)
    a = camera_rays(still, px, py, s)[0]
    b = camera_rays(moving, px, py, s)[0]
    assert not torch.allclose(a.d, b.d)
    p_film = torch.rand(256, 2) * 16
    z = torch.zeros(256)
    a0, _ = generate_rays(still.camera, p_film)
    b0, _ = generate_rays(moving.camera, p_film, u_time=z)
    assert torch.allclose(a0.d, b0.d, atol=1e-6) and torch.allclose(a0.o, b0.o, atol=1e-6)


def test_bdpt_camera_stays_at_the_start_transform():
    """BDPT's t = 1 importance, its raster projection and the camera's
    direction density read the start transform (world_to_camera), as the
    reference's do (ROADMAP.md C, mirrored on purpose): a moving camera's
    equal the static camera's."""
    line = 'Integrator "bdpt" "integer maxdepth" 2'
    still = load_scene_string(calibration_scene("knot", line), device="cpu")
    moving = load_scene_string(scene_variant(calibration_scene("knot", line),
                                             motion=CAMERA_MOTION), device="cpu")
    assert np.array_equal(moving.camera.world_to_camera, still.camera.world_to_camera)
    rng = np.random.default_rng(4)
    p = torch.as_tensor(rng.uniform(-1, 1, (512, 3)).astype(np.float32))
    cam_o = torch.as_tensor(START.m[:3, 3]).expand(512, 3)
    for got, want in zip(_camera_importance(moving, cam_o, p), _camera_importance(still, cam_o, p)):
        assert torch.equal(got, want)
    assert torch.equal(camera_pdf_we_dir(moving, cam_o, p), camera_pdf_we_dir(still, cam_o, p))


def test_environment_camera_carries_no_differentials():
    cs = load_scene_string(scene_variant(calibration_scene("knot", 'Integrator "path"'),
                                         camera='Camera "environment"'), device="cpu")
    px = torch.arange(8)
    rays, w, _ = camera_rays(cs, px, px, torch.zeros_like(px), spp_for_diff=16)
    assert rays.rx_o is None and rays.ry_d is None and torch.equal(w, torch.ones(8))


@pytest.mark.parametrize("form", ["moving", "environment", "realistic", "lensfile"])
def test_cli_renders_each_camera(form, tmp_path, monkeypatch):
    """python -m pbrt_tpu_torch --device cpu renders each form to a finite
    image; the built-in lens's is black, as the reference's is (above)."""
    from pbrt_tpu_torch.__main__ import main
    (tmp_path / "lens.dat").write_text("40.0 5.0 1.6 30.0\n-40.0 40.0 1.0 30.0\n")
    monkeypatch.chdir(tmp_path)
    cam = {"moving": {"motion": CAMERA_MOTION}, "environment": {"camera": 'Camera "environment"'},
           "realistic": {"camera": 'Camera "realistic" "float aperturediameter" 8'},
           "lensfile": {"camera": 'Camera "realistic" "string lensfile" "lens.dat"'}}[form]
    text = scene_variant(calibration_scene("knot", 'Integrator "path" "integer maxdepth" 2',
                                           res=8, spp=1), **cam)
    (tmp_path / "s.pbrt").write_text(text)
    assert main(["--device", "cpu", "--quiet", "--outfile", str(tmp_path / "s.png"),
                 str(tmp_path / "s.pbrt")]) == 0
    img = read_png(str(tmp_path / "s.png"))
    assert img.shape == (8, 8, 3)
    if form == "realistic":
        assert img.max() == 0
    elif form != "lensfile":
        assert img.max() > 0
