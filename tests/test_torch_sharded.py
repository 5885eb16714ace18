"""The sharded render and the sharded gradient step over several ranks,
against the single-process render and gradient (tests/test_sharded.py's
checks of the reference, on two gloo ranks on the CPU).

Each sharded call starts one more process and gives its process group a
timeout of its own (TIMEOUT), so a rank that hangs fails its test rather
than the suite's clock.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu_torch.parallel import mesh as MS
from pbrt_tpu_torch.render import render, render_sampler_integrator
from pbrt_tpu_torch.scene import load_scene_string
from pbrt_tpu_torch.scene.build import build_scene
from pbrt_tpu_torch.utils.checkpoint import load_checkpoint
from pbrt_tpu_torch.utils.options import Options

TIMEOUT = 120.0
# tests/test_sharded.py's scene
SCENE = """
LookAt 0 5 0  0 0 0  0 0 -1
Camera "perspective" "float fov" 30
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "02sequence" "integer pixelsamples" 8
Integrator "path" "integer maxdepth" 2
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
LightSource "point" "point from" [0 3 0] "rgb I" [20 20 20]
AttributeBegin
  Material "matte" "rgb Kd" [0.6 0.5 0.4]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-100 0 -100  100 0 -100  100 0 100  -100 0 100]
AttributeEnd
WorldEnd
"""
LANES = 16 * 16


def test_sharded_render_equals_single(tmp_path):
    """Two gloo ranks against render_sampler_integrator: the image within
    the reference's rtol 2e-5 / atol 2e-6, the counters equal, each pass
    twice the single render's lanes; with a checkpoint every pass, a
    resumed sharded render equals the straight one bit for bit."""
    opts = Options(wavefront_size=LANES)
    cs = load_scene_string(SCENE, opts, device="cpu")
    want, cnt, passes = render_sampler_integrator(cs, opts)
    ck = str(tmp_path / "ck.npz")
    got, cnt2, passes2 = MS.render_sharded(
        cs, 2, Options(wavefront_size=LANES, checkpoint_path=ck, checkpoint_every=1),
        timeout=TIMEOUT)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-6)
    assert float(want.sum()) > 0 and cnt2 == cnt
    assert (passes, passes2) == (8, 4)
    assert load_checkpoint(ck)[1] == 6
    again, cnt3, passes3 = MS.render_sharded(
        cs, 2, Options(wavefront_size=LANES, checkpoint_path=ck, resume=True), timeout=TIMEOUT)
    assert passes3 == 1 and cnt3["camera_rays"] == 2 * LANES
    assert torch.equal(again, got)


def test_sharded_gradient_equals_single():
    """One differentiable step over two gloo ranks (every pixel of 64 at
    samples 0 - 3, the lanes split over the ranks, the loss
    sum(luminance(film.rgb_sum)) and the gradients summed) against
    film_loss_grad of all the lanes in one process: the loss within rtol
    1e-6, each gradient leaf within 1e-5 of its largest magnitude; the
    material and light gradients nonzero."""
    cs = load_scene_string(SCENE, device="cpu")
    rng = np.random.default_rng(0)
    px, py = rng.integers(0, 16, 64), rng.integers(0, 16, 64)
    sidx = np.arange(4)
    loss2, g2 = MS.sharded_grad(cs, px, py, sidx, 2, max_depth=2, timeout=TIMEOUT)
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32)
    loss1, g1 = MS.film_loss_grad(cs, i32(np.tile(px, 4)), i32(np.tile(py, 4)),
                                  i32(np.repeat(sidx, 64)), max_depth=2)
    assert float(loss1) > 0
    np.testing.assert_allclose(float(loss2), float(loss1), rtol=1e-6)
    for f, a, b in zip(g1._fields, g1, g2):
        scale = float(a.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1e-30), f
    assert float(g1.mat_const.abs().max()) > 0 and float(g1.light_L.abs().max()) > 0


def test_cli_devices_shards_the_render(tmp_path, capsys):
    """--devices 2 --device cpu renders over two ranks through render():
    the image within 1 of the single render's sRGB value per pixel."""
    from pbrt_tpu_torch.__main__ import main
    from pbrt_tpu_torch.io.image_io import read_png
    scene = tmp_path / "s.pbrt"
    scene.write_text(SCENE)
    one, two = str(tmp_path / "one.png"), str(tmp_path / "two.png")
    assert main(["--device", "cpu", "--quiet", "--outfile", one, str(scene)]) == 0
    assert main(["--device", "cpu", "--quiet", "--devices", "2", "--outfile", two,
                 str(scene)]) == 0
    assert "error" not in capsys.readouterr().err
    a, b = read_png(one).astype(int), read_png(two).astype(int)
    assert a.max() > 0 and np.abs(a - b).max() <= 1


def test_backend_and_ranks_rule(monkeypatch):
    """NCCL only where every rank has a card of its own; --devices on CUDA
    takes the cards there are; a scene with no source cannot be sharded
    (and nothing is started)."""
    assert MS.backend_for("cpu", 2) == "gloo" and MS.n_ranks_for(3, "cpu") == 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert MS.backend_for("cuda", 1) == "nccl" and MS.backend_for("cuda", 2) == "gloo"
    assert MS.n_ranks_for(4, "cuda") == 1
    assert MS.rank_device("cuda:0", 1, "gloo") == torch.device("cuda:0")
    assert MS.rank_device("cuda:0", 1, "nccl") == torch.device("cuda", 1)
    cs = load_scene_string(SCENE, device="cpu")
    assert cs.source is not None
    from pbrt_tpu_torch.scene.api import Api
    from pbrt_tpu_torch.scene.parser import parse_string
    api = Api()
    parse_string(SCENE, api, ".")
    with pytest.raises(ValueError, match="load_scene"):
        render(build_scene(api.scene, device="cpu"), Options(devices=2))
