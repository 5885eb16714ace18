"""CPU tests of the benchmark's harness: files found by name, a cell and a
configuration added as files alone, the scene reader, the trace
arithmetic, the frozen scene writer and the imports. Run with `python -m
pytest benchmark/ -q` from the repository's root; a run of `pytest tests/`
does not collect them."""
from __future__ import annotations

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import devtrace
import harness
import plugins
import refscene
import roofline
import scenes

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "benchmark"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _metric_names():
    return [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(cell):
    entry, config, traffic, e2e, layer = harness.resolve(ROOT, BENCH, cell)
    assert entry["name"] == cell and config["name"] == entry["config"]
    assert traffic["wavefront_size"] > 0 and traffic["trace_frames"] >= 1
    assert traffic["idle_frames"] >= 1
    assert {m["name"] for m in e2e} >= {"msamples_per_s", "setup_s"}
    assert layer, "every cell reports a per-layer metric"
    assert set(config["check"]["limits"]) == {"rel_l1", "bad_px_pct"}


@pytest.mark.parametrize("metric", _metric_names())
def test_every_metric_has_its_reader(metric):
    assert callable(harness.reader(metric))
    assert harness.reader(metric)({}) is None, "a reader with nothing to read returns None"


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_every_configuration_file_is_its_own(entry):
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert entry["file"].startswith(BENCH["paths"][0] + "/")


def _py_digests(d):
    return {p.relative_to(d): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in Path(d).rglob("*.py")}


def test_cell_added_as_files_alone(tmp_path):
    """A copy of the benchmark gains a traffic mix and a cell through a data
    file and an entry of BENCHMARK.json: it resolves, and no code changed."""
    shutil.copytree(HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "benchmark" / "traffic" / "wf2m.json").write_text(json.dumps(
        {"wavefront_size": 2097152, "trace_frames": 1}))
    bench["workloads"].append({"name": "config4_glass_dof.wf2m", "config": "config4_glass_dof",
                               "traffic": "wf2m", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "walk.device_ms_per_frame.copy", "unit": "ms",
                               "better": "lower", "source": "device_trace", "layer": "walk kernels",
                               "moves": "msamples_per_s",
                               "workloads": ["config4_glass_dof.wf2m"]})
    shutil.copy(tmp_path / "benchmark" / "metrics" / "walk.device_ms_per_frame.py",
                tmp_path / "benchmark" / "metrics" / "walk.device_ms_per_frame.copy.py")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell, config, traffic, _, layer = harness.resolve(tmp_path, bench, "config4_glass_dof.wf2m")
    assert traffic["wavefront_size"] == 2097152 and config["name"] == "config4_glass_dof"
    assert "walk.device_ms_per_frame.copy" in [m["name"] for m in layer]
    evs = [(WALK_B1, 0, 2_000_000)]
    got = harness.read_metrics(layer, {"dev_events": evs, "trace_frames": 1},
                               tmp_path / "benchmark")
    assert got["walk.device_ms_per_frame.copy"] == {"value": 2.0, "unit": "ms"}
    before = _py_digests(HERE)
    after = _py_digests(tmp_path / "benchmark")
    del after[Path("metrics/walk.device_ms_per_frame.copy.py")]
    assert before == after
    other = harness.resolve(tmp_path, bench, "config2_ply.wf1m")[4]
    assert "walk.device_ms_per_frame.copy" not in [m["name"] for m in other]


WALK_B1 = "void (anonymous namespace)::walk_kernel<true, true, false>(float const*, int)"
WALK_B5 = "void (anonymous namespace)::walk_kernel<false, false, true>(float const*, int)"
ELEM = ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
        "at::detail::Array<char*, 3> >(int, at::native::CUDAFunctor_add<float>, "
        "at::detail::Array<char*, 3>)")


def test_kernel_names():
    assert devtrace.kernel_of(WALK_B1) == "B1" and devtrace.kernel_of(WALK_B5) == "B5"
    assert devtrace.kernel_of(ELEM) is None
    assert devtrace.kernel_op(ELEM) == "add"


def test_trace_arithmetic_on_synthetic_events():
    """Two frames: in each, a 4 ms B5 launch at 0 and a 1 ms add at 3 ms
    (overlapping it by 1 ms), then a 2 ms add after a 5 ms gap."""
    evs = []
    for f in range(2):
        base = f * 20_000_000
        evs += [(WALK_B5, base, 4_000_000), (ELEM, base + 3_000_000, 1_000_000),
                (ELEM, base + 9_000_000, 2_000_000)]
    busy, gaps = devtrace.union_ns(evs)
    assert busy == 2 * 6_000_000
    assert gaps == [(4_000_000, 9_000_000), (11_000_000, 20_000_000),
                    (24_000_000, 29_000_000)]
    ctx = {"dev_events": evs, "trace_frames": 2, "busy_s": busy / 1e9, "trace_window_s": 0.04,
           "untraced_frame_s": 0.015,
           "counters": {"camera_rays": 1_000_000, "shadow_rays": 2_000_000,
                        "bounce_rays": 1_000_000, "valid_hits": 0, "paths_terminated_rr": 0},
           "n_tris": 100_000}
    read = lambda m: harness.reader(m)(ctx)
    assert read("walk.device_ms_per_frame") == pytest.approx(4.0)
    assert read("integrator.device_ms_per_frame") == pytest.approx(3.0)
    assert read("integrator.kernels_per_frame") == 2
    assert read("device.idle_pct") == pytest.approx(60.0)
    want_bytes = 4_000_000 * 37 + 1 * 100_000 * 36
    assert roofline.walk_bytes(4_000_000, 1, 100_000) == want_bytes
    assert read("walk.roofline_pct") == pytest.approx(100 * want_bytes / 3.35e12 * 1e3 / 4.0)
    assert devtrace.idle_before(evs) == [["add", 0.010], ["walk_kernel", 0.009]]
    assert devtrace.top_ops(evs) == [["walk_kernel", 0.008], ["add", 0.006]]


def test_end_to_end_readers():
    ctx = {"window_s": 10.0, "frames": 20, "samples_per_frame": 1_048_576, "setup_s": 12.5}
    assert harness.reader("msamples_per_s")(ctx) == pytest.approx(20 * 1_048_576 / 10 / 1e6)
    assert harness.reader("msamples_per_s.device_paced")(ctx) == pytest.approx(2.097152)
    assert harness.reader("setup_s")(ctx) == 12.5


@pytest.mark.parametrize("segments", [(24, 6), (448, 112)])
def test_frozen_ply_writer_gives_the_programs_bytes(tmp_path, segments):
    sys.path.insert(0, str(ROOT))
    from pbrt_tpu_torch.scene.bench import write_knot_ply
    plugins.load("generators", "knot").write(tmp_path / "a.ply", *segments)
    write_knot_ply(str(tmp_path / "b.ply"), *segments)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


@pytest.mark.parametrize("name,writer", [("config2_ply", "write_config2_scene"),
                                         ("config4_glass_dof", "write_config4_scene")])
def test_frozen_scene_texts_match_the_programs(tmp_path, name, writer):
    sys.path.insert(0, str(ROOT))
    from pbrt_tpu_torch.scene import bench
    config = json.loads((HERE / "configs" / f"{name}.json").read_text())
    path = getattr(bench, writer)(str(tmp_path))
    assert Path(path).read_text().strip() == scenes.scene_text(config).strip()


FORBIDDEN = {"jax", "jaxlib", "flax", "pbrt_tpu"}


@pytest.mark.parametrize("path", sorted(str(p.relative_to(HERE)) for p in HERE.rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    tree = ast.parse((HERE / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path} imports {n}"


def test_the_yardstick_imports_nothing_of_the_program():
    yardstick = [p for p in HERE.rglob("*.py") if not p.name.startswith("test_")
                 and p.name not in ("harness.py", "control.py", "faults.py", "run.py")]
    assert len(yardstick) > 20
    for path in yardstick:
        name = str(path.relative_to(HERE))
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(m.split(".")[0] == "pbrt_tpu_torch" for m in mods), name


def test_run_refuses_without_a_card():
    """On a machine without CUDA the run exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "config2_ply.wf1m",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_needs_the_program(tmp_path):
    """A directory with BENCHMARK.json and benchmark/ alone cannot run a cell."""
    shutil.copytree(HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys, time; sys.path.insert(0, 'benchmark'); import harness; "
            "harness.run_cell('.', 'config2_ply.wf1m', 1, 1.0, False, time.time(), device='cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and "pbrt_tpu_torch" in out.stderr


def test_pixel_sample_is_drawn_from_the_seed():
    a = harness.check_pixels(4294967311, (256, 256), 2048)
    b = harness.check_pixels(4294967311, (256, 256), 2048)
    c = harness.check_pixels(4294967312, (256, 256), 2048)
    assert (a[0] == b[0]).all() and (a[1] == b[1]).all() and not (a[0] == c[0]).all()
    assert len(set(zip(a[0].tolist(), a[1].tolist()))) == 2048
    assert np.all((a[0] < 256) & (a[1] < 256))


WAVE_GENERATOR = '''"""A test generator: a wavy n x n height field as a PLY file, no normals."""
import numpy as np

import plugins


def write(path, n, amp):
    g = np.linspace(-1.0, 1.0, n)
    x, z = np.meshgrid(g, g, indexing="ij")
    verts = np.stack([x, amp * np.sin(3 * x) * np.cos(2 * z), z], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (i * n + j).reshape(-1)
    faces = np.concatenate([np.stack([a, a + 1, a + n], -1), np.stack([a + 1, a + n + 1, a + n], -1)])
    plugins.load("generators", "knot").write_ply(path, verts.astype(np.float32), faces)


def scaled(params, factor):
    return dict(params, n=max(4, int(params["n"] * factor)))
'''

WAVE_SCENE = [
    "LookAt 0 2.5 3  0 0 0  0 1 0",
    'Camera "perspective" "float fov" 45',
    'Film "image" "integer xresolution" [256] "integer yresolution" [256]',
    'Sampler "stratified" "integer xsamples" 2 "integer ysamples" 2 "bool jitter" "true"',
    'Integrator "path" "integer maxdepth" 3',
    'Accelerator "kdtree"',
    "WorldBegin",
    'LightSource "infinite" "rgb L" [0.4 0.4 0.5]',
    "AttributeBegin",
    '  AreaLightSource "diffuse" "rgb L" [6 6 6]',
    "  Translate 0 3 0",
    '  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]',
    '    "point P" [-0.5 0 -0.5  0.5 0 -0.5  0.5 0 0.5  -0.5 0 0.5]',
    "AttributeEnd",
    "AttributeBegin",
    "  Rotate 20 0 1 0",
    "  Scale 1.2 1 1.2",
    '  Material "matte" "rgb Kd" [0.3 0.6 0.4]',
    '  Shape "plymesh" "string filename" "wave.ply"',
    "AttributeEnd",
    "WorldEnd",
]


def test_configuration_added_as_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, with a mesh generator
    of its own, a traffic mix and a cell through new files and entries of
    BENCHMARK.json alone: the scene (a kd-tree, rotated and scaled mesh)
    is read by the reference, and a small run of the new cell on the CPU
    is correct; no file that was there changed."""
    shutil.copytree(HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    new = tmp_path / "benchmark"
    (new / "generators" / "wave.py").write_text(WAVE_GENERATOR)
    config = {"name": "wave_kd", "source": "a test configuration", "scene": WAVE_SCENE,
              "meshes": {"wave.ply": {"generator": "wave", "n": 64, "amp": 0.2}},
              "resolution": [256, 256], "spp": 4, "precision": "float32",
              "check": {"pixels": 96, "limits": {"rel_l1": 0.0025, "bad_px_pct": 2.5}},
              "reduced": [], "assumed": []}
    (new / "configs" / "wave_kd.json").write_text(json.dumps(config))
    (new / "traffic" / "wf64k.json").write_text(json.dumps(
        {"wavefront_size": 65536, "trace_frames": 1, "idle_frames": 1}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "wave_kd", "source": "a test configuration",
                             "file": "benchmark/configs/wave_kd.json", "reduced": [],
                             "why": "a test configuration"})
    bench["workloads"].append({"name": "wave_kd.wf64k", "config": "wave_kd", "traffic": "wf64k",
                               "chips": 1, "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    small = {"resolution": (16, 16), "mesh_scale": 0.25, "wavefront_size": 4096, "pixels": 96}
    code = ("import sys, time, json; sys.path.insert(0, 'benchmark'); import harness; "
            "r = harness.run_cell('.', 'wave_kd.wf64k', 4294967311, 0.1, False, time.time(), "
            f"device='cpu', small={small!r}); "
            "print(json.dumps([r['correct'], r['check'], sorted(r['metrics'])]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=900, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    correct, check, metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct is True, check
    assert metrics == ["msamples_per_s", "setup_s"]
    before = _py_digests(HERE)
    after = _py_digests(new)
    del after[Path("generators/wave.py")]
    assert before == after


def _scene_kinds(config):
    """{folder: {names}} of the parts a configuration's scene asks for."""
    want = {"generators": {m["generator"] for m in config.get("meshes", {}).values()}}
    folder = {"Shape": "shapes", "Material": "materials", "LightSource": "lights",
              "AreaLightSource": "area_lights", "Camera": "cameras", "Sampler": "samplers",
              "Integrator": "integrators"}
    for name, args, _ in refscene._directives(scenes.scene_text(config)):
        if name in folder:
            want.setdefault(folder[name], set()).add(args[0])
    return want


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_every_part_of_a_scene_is_found_by_name(entry):
    config = json.loads((ROOT / entry["file"]).read_text())
    kinds = _scene_kinds(config)
    assert {"shapes", "materials", "lights", "cameras", "samplers", "integrators"} <= set(kinds)
    for folder, names in kinds.items():
        for name in names - {"plastic"}:       # config 2's overridden Material line
            assert (HERE / folder / f"{name}.py").is_file(), (folder, name)
            assert plugins.load(folder, name) is plugins.load(folder, name)


def _scene_file(tmp_path, lines):
    path = tmp_path / "s.pbrt"
    path.write_text("\n".join(['LookAt 0 0 5  0 0 0  0 1 0', 'Camera "perspective"',
                               'Film "image" "integer xresolution" [8] "integer yresolution" [8]',
                               'Sampler "sobol" "integer pixelsamples" 4', 'Integrator "path"',
                               *lines, "WorldBegin",
                               'Shape "trianglemesh" "integer indices" [0 1 2]',
                               '  "point P" [0 0 0  1 0 0  0 1 0]', "WorldEnd"]))
    return path


def test_scene_reader_skips_the_accelerator_and_refuses_the_unknown(tmp_path):
    sc = refscene.Scene(_scene_file(tmp_path, ['Accelerator "kdtree" "integer maxprims" 4']))
    assert sc.n_tris == 1 and sc.materials[1][0] == "matte"
    with pytest.raises(ValueError, match="PixelFilter"):
        refscene.Scene(_scene_file(tmp_path, ['PixelFilter "gaussian"']))
    with pytest.raises(ValueError, match="no sampler 'halton'"):
        plugins.load("samplers", "halton")


def test_scene_reader_transforms():
    """Rotate, Scale and ConcatTransform compose as pbrt-v3's do, and each
    inverse is the matrix's inverse."""
    m = np.eye(4)
    inv = np.eye(4)
    for name, args in (("Translate", [1, 2, 3]), ("Rotate", [30, 0, 1, 1]),
                       ("Scale", [2, 3, 4]), ("ConcatTransform", list(np.eye(4).ravel() * 2))):
        a, b = refscene._transform(name, args)
        m, inv = m @ a, b @ inv
    assert np.allclose(m @ inv, np.eye(4))
    r = refscene._transform("Rotate", [90, 0, 0, 1])[0]
    assert np.allclose(r[:3, :3] @ [1, 0, 0], [0, 1, 0])
