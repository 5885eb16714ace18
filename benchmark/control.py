"""Readings that set a configuration's check limits, at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ... [--faults]

For each seed, in one process: builds the cell's scene, renders one frame
through the timed path (`render` at the cell's lanes a pass), and prints
the check's readings (judge.py) of three things against the float32
reference at the seed's sample of pixels:

  program   the frame as the port renders it (a sound run: the lower
            readings);
  control   the plain reference computed in bfloat16 in the program's
            place (the upper readings);
  faults    with --faults, the frame with the timed path broken
            underneath (faults.py): the film left unchanged, half of the
            samples left out, one sample in 61 altered.

One JSON line a seed and reading, then the largest program reading and the
smallest control reading of each number. The benchmark's own runs never
run this; it needs a CUDA device. The tests call readings_for_seed on the
CPU at their small size.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
from pathlib import Path

os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

import torch  # noqa: E402

import faults  # noqa: E402
import harness  # noqa: E402
import judge  # noqa: E402
import reference  # noqa: E402
import scenes  # noqa: E402


def readings_for_seed(root, name, seed, device, small, with_faults):
    """-> {kind: {number: reading}} for the program, the control and each
    fault, on one seed."""
    sys.path.insert(0, str(root))
    from pbrt_tpu_torch.render import render
    from pbrt_tpu_torch.scene.build import load_scene
    from pbrt_tpu_torch.utils.options import Options
    _, config, traffic, _, _ = harness.resolve(root, harness.load_benchmark(root), name)
    small = small or {}
    res = tuple(small.get("resolution", config["resolution"]))
    opts = Options(wavefront_size=small.get("wavefront_size", traffic["wavefront_size"]),
                   seed=seed)
    px, py = harness.check_pixels(seed, res, small.get("pixels", config["check"]["pixels"]))
    out = {}
    with tempfile.TemporaryDirectory(prefix="pbrt_control_") as tmp:
        path = scenes.write_scene(config, tmp, resolution=small.get("resolution"),
                                  spp=small.get("spp"), mesh_scale=small.get("mesh_scale"))
        cs = load_scene(path, opts, device=device, seed=seed)
        frames = {"program": render(cs, opts)[0]}
        if with_faults:
            for fault in faults.FAULTS:
                with faults.planted(fault):
                    frames[fault] = render(cs, opts)[0]
        picked = {k: v[torch.as_tensor(py), torch.as_tensor(px)].double().cpu().numpy()
                  for k, v in frames.items()}
        del cs, frames
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        ref = reference.Reference(path, seed, torch.float32, device).render_pixels(px, py)
        low = reference.Reference(path, seed, torch.bfloat16, device).render_pixels(px, py)
    for k, v in picked.items():
        out[k] = judge.readings(v, ref)
    out["control"] = judge.readings(low, ref)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    worst, best = {}, {}
    for seed in args.seeds:
        got = readings_for_seed(root, args.workload, seed, "cuda", None, args.faults)
        for kind, r in got.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind, **r}),
                  flush=True)
        for k in judge.NAMES:
            worst[k] = max(worst.get(k, 0.0), got["program"][k])
            best[k] = min(best.get(k, float("inf")), got["control"][k])
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "program_max": worst, "control_min": best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
