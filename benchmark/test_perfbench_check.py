"""CPU tests of the check that decides `correct`, at sizes a test run
holds (16 x 16 pixels, a knot of an eighth of the segments): the plain
reference agrees with the port; its bfloat16 control fails; each fault
planted under the timed path fails a whole run; and a run's CPU path loads
nothing of JAX or the JAX package. Run with `python -m pytest benchmark/
-q` from the repository's root. The chip's readings, at the cells' own
sizes, come from control.py."""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import control
import faults
import harness
import judge
import refsampler

ROOT = Path(__file__).resolve().parent.parent
CELLS = ("config2_ply.wf1m", "config4_glass_dof.wf4m")
SMALL = {"resolution": (16, 16), "spp": 16, "mesh_scale": 0.125, "wavefront_size": 4096,
         "pixels": 96}
SEEDS = (7, 2147483659, 4294967311)


def _limits(cell):
    return harness.resolve(ROOT, harness.load_benchmark(ROOT), cell)[1]["check"]["limits"]


@pytest.fixture(scope="module")
def readings():
    """{(cell, seed): control.readings_for_seed(...)}: the program, the
    control and the faults, on the CPU at the small size."""
    return {(c, s): control.readings_for_seed(ROOT, c, s, "cpu", SMALL, True)
            for c in CELLS for s in SEEDS}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_reference_agrees_with_the_port(readings, cell, seed):
    got = readings[(cell, seed)]["program"]
    for k, lim in _limits(cell).items():
        assert got[k] <= lim, (k, got[k], lim)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_bfloat16_control_fails(readings, cell, seed):
    got = readings[(cell, seed)]["control"]
    assert any(got[k] > lim for k, lim in _limits(cell).items()), got


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_each_fault_is_caught(readings, cell, fault):
    for seed in SEEDS:
        got = readings[(cell, seed)][fault]
        assert any(got[k] > lim for k, lim in _limits(cell).items()), (seed, got)


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_run_with_a_fault_is_not_correct(fault):
    """The whole run, the look for a card skipped, with the timed path
    broken underneath: `correct` comes out false."""
    with faults.planted(fault):
        r = harness.run_cell(ROOT, "config2_ply.wf1m", 2147483659, 0.1, False, time.time(),
                             device="cpu", small=SMALL)
    assert r["correct"] is False
    assert list(r)[-1] == "check"


def test_a_sound_run_is_correct_and_loads_no_jax():
    code = ("import sys, time, json; sys.path.insert(0, 'benchmark'); import harness; "
            f"r = harness.run_cell('.', 'config4_glass_dof.wf4m', 99, 0.1, True, time.time(), "
            f"device='cpu', small={SMALL!r}); "
            "print(json.dumps([r['correct'], harness.forbidden_modules(), sorted(r['metrics'])]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, found, metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct is True and found == []
    assert "setup.scene_build_s" in metrics and "device.idle_pct" in metrics


def test_judge_fails_a_non_finite_frame():
    ok, got = judge.judge([[float("nan"), 0, 0]], [[1.0, 1.0, 1.0]],
                          {"rel_l1": 1.0, "bad_px_pct": 100.0})
    assert not ok


@pytest.mark.parametrize("kind", ["stratified", "sobol"])
def test_reference_draws_equal_the_ports(kind):
    """The reference's own sampler (NumPy u32) draws the port's numbers bit
    for bit, seeds past 32 bits included."""
    sys.path.insert(0, str(ROOT))
    from pbrt_tpu_torch.samplers import SamplerSpec, sample_2d, sample_dim
    rng = np.random.default_rng(3)
    n = 2000
    px, py = rng.integers(0, 256, n), rng.integers(0, 256, n)
    for seed in (0, 2147483659, 4294967311):
        if kind == "stratified":
            spec = SamplerSpec(kind, 16, seed, (256, 256), 4, 4, True)
            mine = refsampler.Stratified(4, 4, True, seed)
        else:
            spec = SamplerSpec(kind, 256, seed, (256, 256))
            mine = refsampler.Sobol(256, (256, 256))
        s = rng.integers(0, mine.spp, n)
        st = refsampler.Stream(mine, px, py, s)
        t = [torch.as_tensor(a) for a in (px, py, s)]
        for dim in (0, 2, 5, 6, 7, 9, 12, 85):
            assert (sample_dim(spec, *t, dim).numpy() == st.d1(dim)).all(), (seed, dim)
            assert (sample_2d(spec, *t, dim).numpy() == st.d2(dim)).all(), (seed, dim)
