"""The slice as a whole: the port's front end, li_path and the render driver
against pbrt_tpu, and the port running with JAX absent."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import REPO, jax_bench_scene, jax_scene_arrays, lanes, pallas_tables

from pbrt_tpu.integrators.path import li_path as j_li_path
from pbrt_tpu.scene import load_scene as j_load_scene, load_scene_string as j_load_scene_string
from pbrt_tpu_torch.integrators.path import li_path
from pbrt_tpu_torch.io.image_io import read_png, write_png
from pbrt_tpu_torch.render import Options, render_sampler_integrator
from pbrt_tpu_torch.scene import load_scene, load_scene_string
from pbrt_tpu_torch.scene.api import Api
from pbrt_tpu_torch.scene.bench import (KNOT, KNOT_MATERIAL, SCENE, SPHERE_SCENE,
                                        bench_description, build_bench_scene,
                                        quadric_scene_text, textured_description,
                                        textured_scene_text, write_all_kinds_scene,
                                        write_env_material_scene, write_floor_image)
from pbrt_tpu_torch.scene.parser import parse_file
from pbrt_tpu_torch.scene.bridge import from_jax_arrays, tables_from_jax_arrays
from pbrt_tpu_torch.scene.build import build_tables

SMOKE = """
Camera "perspective" "float fov" 45
Film "image" "integer xresolution" [8] "integer yresolution" [8] "string filename" "{OUT}"
Sampler "random" "integer pixelsamples" 1
Integrator "path" "integer maxdepth" 1
WorldBegin
LightSource "infinite" "rgb L" [0.5 0.5 0.5]
WorldEnd
"""
# the smoke scene seen from above, with two instances of a dark triangle and
# an animated one in front of the environment
INSTANCED_SMOKE = SMOKE.replace("Camera", "LookAt 0 0 5  0 0 0  0 1 0\nCamera").replace(
    "WorldEnd", """ObjectBegin "tri"
  Material "matte" "rgb Kd" [0.2 0.2 0.2]
  Shape "trianglemesh" "integer indices" [0 1 2] "point P" [-1 0 0  1 0 0  0 1 0]
ObjectEnd
AttributeBegin
  Translate -1 0 0
  ObjectInstance "tri"
AttributeEnd
AttributeBegin
  Translate 1 0 0
  ObjectInstance "tri"
AttributeEnd
AttributeBegin
  ActiveTransform EndTime
  Translate 0 -0.5 0
  ActiveTransform All
  Shape "trianglemesh" "integer indices" [0 1 2] "point P" [-1 -1 0  1 -1 0  0 0 0]
AttributeEnd
WorldEnd""")


@pytest.fixture(scope="module")
def scenes():
    jcpu, jcs = jax_bench_scene(large=False)
    arrays, specs = jax_scene_arrays(jcs)
    return jcpu, arrays, specs


def test_bench_scene_text_is_the_reference_scene():
    sys.path.insert(0, REPO)
    import __graft_entry__
    assert SCENE == __graft_entry__._SCENE
    assert 'Material "matte" "rgb Kd" [0.5 0.5 0.5]' == __graft_entry__._FLOOR_PLAIN


def test_front_end_tables_equal_bridge(scenes):
    _, arrays, specs = scenes
    want = tables_from_jax_arrays(arrays)
    got = build_tables(bench_description(large=False))
    assert set(got) == set(want)
    for k in want:
        if k == "bvh":
            for f in ("metas", "nodes", "tris", "order", "seed", "seed_slots"):
                assert torch.equal(getattr(got[k], f), getattr(want[k], f)), f
            assert got[k].max_depth == want[k].max_depth
            assert np.array_equal(got[k].wlo, want[k].wlo)
        else:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    ours = build_bench_scene(large=False, device="cpu")
    theirs = from_jax_arrays(arrays, specs, device="cpu")
    assert np.array_equal(ours.camera.raster_to_camera, theirs.camera.raster_to_camera)
    assert np.array_equal(ours.camera.cam_to_world, theirs.camera.cam_to_world)
    assert ours.film == theirs.film and ours.sampler == theirs.sampler
    assert ours.flags == theirs.flags


def test_li_path_matches_reference(scenes):
    """1024 lanes, depth 4: >= 99% of lanes within rtol 1e-3 / atol 1e-4,
    the mean within 1%, and the same live-ray counts."""
    jcpu, arrays, specs = scenes
    cs = from_jax_arrays(arrays, specs, device="cpu")
    px, py, s = lanes(1024, 64, 4, seed=4)
    L, p_film, w, cnt = li_path(cs, *(torch.as_tensor(a) for a in (px, py, s)), max_depth=4)
    jL, jp, jw, jcnt = j_li_path(jcpu, jnp.asarray(px), jnp.asarray(py), jnp.asarray(s),
                                 max_depth=4, with_stats=True)
    L, jL = L.numpy(), np.asarray(jL)
    ok = np.all(np.abs(L - jL) <= 1e-4 + 1e-3 * np.abs(jL), axis=1)
    assert ok.mean() >= 0.99
    assert abs(L.mean() - jL.mean()) <= 0.01 * abs(jL.mean())
    assert L.mean() > 0.05
    np.testing.assert_array_equal(p_film.numpy(), np.asarray(jp))
    for k in ("camera_rays", "shadow_rays", "bounce_rays", "valid_hits"):
        assert abs(int(cnt[k]) - float(jcnt[k])) <= 0.01 * float(jcnt[k]), k


def _hold_li_path(jcs, cs, n, res, spp, depth, seed):
    """li_path of n lanes of both packages: >= 99% of lanes within rtol
    1e-3 / atol 1e-4, the means within 1%, p_film bit-equal and the same
    live-ray counts -> the port's mean."""
    px, py, s = lanes(n, res, spp, seed=seed)
    L, p_film, _, cnt = li_path(cs, *(torch.as_tensor(a) for a in (px, py, s)), max_depth=depth)
    jL, jp, _, jcnt = j_li_path(jcs, jnp.asarray(px), jnp.asarray(py), jnp.asarray(s),
                                max_depth=depth, with_stats=True)
    L, jL = L.numpy(), np.asarray(jL)
    ok = np.all(np.abs(L - jL) <= 1e-4 + 1e-3 * np.abs(jL), axis=1)
    assert ok.mean() >= 0.99
    assert abs(L.mean() - jL.mean()) <= 0.01 * abs(jL.mean())
    np.testing.assert_array_equal(p_film.numpy(), np.asarray(jp))
    for k in ("camera_rays", "shadow_rays", "bounce_rays", "valid_hits"):
        assert int(cnt[k]) == int(jcnt[k]), k
    return L.mean()


@pytest.fixture(scope="module")
def config3(tmp_path_factory):
    """BASELINE config 3's small scene (the small knot, 64x64, 4 spp) in the
    reference with kernel tables -> (its CPU-path scene, arrays, specs,
    the scene file)."""
    import dataclasses
    path = write_env_material_scene(str(tmp_path_factory.mktemp("config3")), large=False, spp=4)
    with pallas_tables():
        jcs = j_load_scene(path)
    arrays, specs = jax_scene_arrays(jcs)
    jcpu = dataclasses.replace(jcs, flags=dataclasses.replace(jcs.flags, use_pallas=False))
    return jcpu, arrays, specs, path


def test_config3_front_end_tables_equal_bridge(config3):
    """Every table of the port's front end, the environment map's, the
    material children and the lobe families included, equals the
    reference's; the port's own scene and the bridged one hold the same
    flags."""
    _, arrays, specs, path = config3
    want = tables_from_jax_arrays(arrays)
    api = Api()
    api.cwd = os.path.dirname(path)
    parse_file(path, api)
    got = build_tables(api.scene, api.cwd)
    assert set(got) == set(want)
    for k in want:
        if k != "bvh":
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    ours = load_scene(path, device="cpu")
    assert ours.flags == from_jax_arrays(arrays, specs, device="cpu").flags
    assert ours.flags.bsdf_fams == (False, True, False, False, True)
    assert ours.flags.mat_kinds == (0, 1, 2, 3, 4, 9) and ours.data.lights.mapped == (0,)


def test_config3_li_path_matches_reference(config3):
    """BASELINE config 3 (metal knot, mix floor, glass and mirror, the
    environment map with MIS), 1,024 lanes at depth 3."""
    jcpu, _, _, path = config3
    assert _hold_li_path(jcpu, load_scene(path, device="cpu"), 1024, 64, 4, 3, seed=5) > 0.05


FURNACE = {"glass": 'Material "glass"'}


@pytest.mark.parametrize("kind", list(FURNACE))
def test_furnace_li_path_matches_reference(kind):
    """The reference's furnace scene (tests/test_material_furnace.py: an
    orthographic view of a unit sphere under a white dome) for smooth glass
    (specular reflection, transmission and total internal reflection),
    1,024 lanes at depth 3; the other kinds are held in the two tests
    below, metal in config 3 and every kind in the all-kinds scene."""
    from test_material_furnace import furnace_scene
    text = furnace_scene(FURNACE[kind])
    assert _hold_li_path(j_load_scene_string(text), load_scene_string(text, device="cpu"),
                         1024, 20, 8, 3, seed=6) > 0.3


@pytest.mark.parametrize("strategy", ["spatial", "uniform"])
def test_all_kinds_li_path_matches_reference(tmp_path, strategy):
    """One sphere of every ported kind (fourier and none included) under a
    goniometric and a projection light with maps, chosen by the spatial or
    the uniform strategy, 1,024 lanes at depth 3."""
    path = write_all_kinds_scene(str(tmp_path), voxels=4, strategy=strategy)
    assert _hold_li_path(j_load_scene(path), load_scene(path, device="cpu"), 1024, 64, 8, 3,
                         seed=7) > 0.01


@pytest.fixture(scope="module")
def textured(tmp_path_factory):
    """The small textured bench scene (checkerboard wall, image-mapped
    floor from a 48x40 PNG, marble knot, a quad with a checkerboard alpha
    mask) in the reference, with kernel tables -> (its CPU-path scene,
    arrays, specs, image path)."""
    import dataclasses
    from pbrt_tpu.scene.api import Api as JApi, ShapeRecord as JShapeRecord
    from pbrt_tpu.scene.build import build_scene as j_build_scene
    from pbrt_tpu.scene.parser import parse_string as j_parse_string
    from pbrt_tpu.shapes.triangle import make_knot_mesh as j_make_knot_mesh
    image = str(tmp_path_factory.mktemp("textured") / "floor.png")
    write_floor_image(image, size=(48, 40))
    api = JApi()
    j_parse_string(textured_scene_text(False, image), api)
    knot = JShapeRecord("trianglemesh", mesh=j_make_knot_mesh(*KNOT[False], scale=0.45))
    knot.material = KNOT_MATERIAL
    api.scene.shapes.append(knot)
    with pallas_tables():
        jcs = j_build_scene(api.scene)
    arrays, specs = jax_scene_arrays(jcs)
    jcpu = dataclasses.replace(jcs, flags=dataclasses.replace(jcs.flags, use_pallas=False))
    return jcpu, arrays, specs, image


def test_textured_front_end_tables_equal_bridge(textured):
    """compile_textures (the image atlas included), the material texture
    slots and the alpha-mask columns of the port's front end equal the
    reference's tables."""
    _, arrays, specs, image = textured
    want = tables_from_jax_arrays(arrays)
    got = build_tables(textured_description(False, image))
    assert set(got) == set(want)
    for k in want:
        if k != "bvh":
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    cs = from_jax_arrays(arrays, specs, device="cpu")
    assert cs.flags.tex_kinds == (5, 11, 12) and cs.flags.has_alpha
    assert cs.flags.alpha_kinds == (5,)


def test_textured_li_path_matches_reference(textured):
    """1,024 lanes at depth 1 (the reference runs its texture stage op by
    op; at the lane count of test_li_path_matches_reference, which runs
    before it in this process, it reuses that test's compiled ops): >= 99%
    of lanes within rtol 1e-3 / atol 1e-4, the mean within 1%, the same
    live-ray counts."""
    jcpu, arrays, specs, _ = textured
    cs = from_jax_arrays(arrays, specs, device="cpu")
    px, py, s = lanes(1024, 64, 4, seed=12)
    L, _, _, cnt = li_path(cs, *(torch.as_tensor(a) for a in (px, py, s)), max_depth=1)
    jL, _, _, jcnt = j_li_path(jcpu, jnp.asarray(px), jnp.asarray(py), jnp.asarray(s),
                               max_depth=1, with_stats=True)
    L, jL = L.numpy(), np.asarray(jL)
    ok = np.all(np.abs(L - jL) <= 1e-4 + 1e-3 * np.abs(jL), axis=1)
    assert ok.mean() >= 0.99
    assert abs(L.mean() - jL.mean()) <= 0.01 * abs(jL.mean())
    assert L.mean() > 0.05
    for k in ("camera_rays", "shadow_rays", "bounce_rays", "valid_hits"):
        assert int(cnt[k]) == int(jcnt[k]), k


def test_render_driver_is_deterministic_and_finite():
    opts = Options(crop_window=(0.375, 0.5, 0.375, 0.5), wavefront_size=128)
    cs = build_bench_scene(large=False, device="cpu", options=opts)
    img1, cnt, passes = render_sampler_integrator(cs, opts)
    img2, _, _ = render_sampler_integrator(cs, opts)
    assert img1.shape == (8, 8, 3) and passes == 2
    assert torch.isfinite(img1).all() and float(img1.sum()) > 0
    assert torch.equal(img1, img2)
    assert cnt["camera_rays"] == 8 * 8 * 4


def test_smoke_scene_renders_without_jax(tmp_path):
    """A process with jax blocked imports the port and renders the
    constant-environment scene, where every pixel is sRGB 188, and the same
    with instances and an animated triangle, which darken some pixels; the
    sphere scene of BASELINE.json's first configuration (at 16x16 and 2
    spp), lit in the middle and black in the corners; a scene with every
    quadric kind, curves and point, spot and distant lights; and BASELINE
    config 3 (its knot read from PLY, its environment map from EXR) at
    16x16 and 1 spp."""
    sphere = SPHERE_SCENE.replace("[256]", "[16]").replace("pixelsamples\" 16",
                                                            "pixelsamples\" 2")
    quadrics = quadric_scene_text(res=16, spp=1, n_grass=2)
    config3 = open(write_env_material_scene(str(tmp_path), large=False, res=16, spp=1)).read()
    scenes, outs = [], []
    for name, text in (("smoke", SMOKE), ("instanced", INSTANCED_SMOKE), ("sphere", sphere),
                       ("quadrics", quadrics), ("config3", config3)):
        scenes.append(tmp_path / f"{name}.pbrt")
        outs.append(tmp_path / f"{name}.png")
        scenes[-1].write_text(text.replace("{OUT}", str(outs[-1])).replace(
            "Film \"image\"", f"Film \"image\" \"string filename\" \"{outs[-1]}\""))
    code = ("import sys; sys.modules['jax'] = None; sys.modules['pbrt_tpu'] = None\n"
            "from pbrt_tpu_torch.__main__ import main\n"
            f"sys.exit(main(['--device', 'cpu', '--quiet', *{[str(p) for p in scenes]!r}]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "error" not in res.stderr, res.stderr
    img = read_png(str(outs[0]))
    assert img.shape == (8, 8, 3) and np.all(img == 188)
    img = read_png(str(outs[1]))
    assert img.shape == (8, 8, 3) and (img == 188).any() and (img < 120).sum() >= 3 * 6
    img = read_png(str(outs[2]))
    assert img.shape == (16, 16, 3) and np.all(img[0, 0] == 0) and np.all(img[15, 15] == 0)
    assert img[6:10, 6:10].min() > 20
    img = read_png(str(outs[3]))
    assert img.shape == (16, 16, 3) and len(np.unique(img.reshape(-1, 3), axis=0)) > 50
    img = read_png(str(outs[4]))
    assert img.shape == (16, 16, 3) and len(np.unique(img.reshape(-1, 3), axis=0)) > 50


def test_cli_logs_a_failed_scene_and_goes_on(tmp_path, capsys):
    """A missing file and an unported accelerator are each logged as
    `error rendering PATH: ...` on stderr; the next scene still renders and
    the CLI returns 0, as the reference's does."""
    from pbrt_tpu_torch.__main__ import main
    missing = tmp_path / "missing.pbrt"
    kdtree = tmp_path / "kdtree.pbrt"
    smoke = tmp_path / "smoke.pbrt"
    kdtree.write_text(SMOKE.replace("{OUT}", str(tmp_path / "kd.png")).replace(
        "WorldBegin", 'Accelerator "kdtree"\nWorldBegin'))
    smoke.write_text(SMOKE.replace("{OUT}", str(tmp_path / "smoke.png")))
    rc = main(["--device", "cpu", "--quiet", str(missing), str(kdtree), str(smoke)])
    assert rc == 0
    errs = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("error rendering")]
    assert len(errs) == 2
    assert errs[0].startswith(f"error rendering {missing}: ")
    assert errs[1].startswith(f"error rendering {kdtree}: ") and "kdtree" in errs[1][len(str(kdtree)):]
    img = read_png(str(tmp_path / "smoke.png"))
    assert img.shape == (8, 8, 3) and np.all(img == 188)
    assert not (tmp_path / "kd.png").exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CLI on a machine with no card")
def test_cli_with_no_card_raises_before_any_scene(tmp_path):
    """--device cuda with no card is not a scene's error: the CLI raises
    rather than logging it and returning 0."""
    from pbrt_tpu_torch.__main__ import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--quiet", str(tmp_path / "missing.pbrt")])


def test_png_round_trip(tmp_path):
    rgb = np.random.default_rng(0).uniform(0, 1, (5, 7, 3)).astype(np.float32)
    write_png(str(tmp_path / "a.png"), rgb)
    got = read_png(str(tmp_path / "a.png"))
    from pbrt_tpu_torch.io.image_io import to_srgb8
    assert np.array_equal(got, to_srgb8(rgb))


@pytest.mark.parametrize("directive,what", [
    ('Material "subsurface"\nShape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 0 1 0 0 0 1 0]',
     "material 'subsurface'"),
    ('Material "kdsubsurface"\nShape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 0 1 0 0 0 1 0]',
     "material 'kdsubsurface'"),
    ('Material "subsurface" "string name" "Skin1" "float scale" 2\nShape "trianglemesh" '
     '"integer indices" [0 1 2] "point P" [0 0 0 1 0 0 0 1 0]', "material 'subsurface'"),
    ('MakeNamedMaterial "skin" "string type" "subsurface" "float eta" 1.4\n'
     'NamedMaterial "skin"\nShape "trianglemesh" "integer indices" [0 1 2] '
     '"point P" [0 0 0 1 0 0 0 1 0]', "material 'subsurface'"),
    ('Material "kdsubsurface" "rgb Kd" [0.6 0.4 0.3] "float eta" 1.33\nShape "trianglemesh" '
     '"integer indices" [0 1 2] "point P" [0 0 0 1 0 0 0 1 0]', "material 'kdsubsurface'"),
])
def test_unported_directives_raise(directive, what):
    text = SMOKE.replace("{OUT}", "x.png").replace("WorldEnd", directive + "\nWorldEnd")
    with pytest.raises(NotImplementedError, match=what):
        load_scene_string(text, device="cpu")


@pytest.mark.parametrize("line,what", [
    ('Camera "environment"', "camera 'environment'"),
    ('Camera "realistic" "string lensfile" "wide.dat"', "camera 'realistic'"),
    ('Integrator "bdpt" "bool spectral" "true"', "spectral"),
    ('Camera "realistic"', "camera 'realistic'"),
    ('Accelerator "kdtree"', "accelerator 'kdtree'"),
])
def test_unported_options_raise(line, what):
    text = SMOKE.replace("{OUT}", "x.png").replace("WorldBegin", line + "\nWorldBegin")
    with pytest.raises(NotImplementedError, match=what):
        load_scene_string(text, device="cpu")
