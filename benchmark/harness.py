"""One run of one benchmark cell of the pbrt_tpu_torch port.

A cell (an entry of BENCHMARK.json's "workloads") names a configuration,
whose file under configs/ holds the scene, its meshes and the limits of the
check, and a traffic mix, traffic/<name>.json: the lanes a pass
(`wavefront_size`) and the frames the traced run profiles. Each metric is
read by metrics/<name>.py. A configuration, a traffic mix or a metric is
added by adding its file and its entry: nothing here names one.

The run: write the scene and its meshes under TMPDIR, build it with the
port's load_scene, render one warm frame, then render whole frames back to
back (`render`, each ending in a synchronisation) until the frame that
crosses --seconds ends; with --trace 1, time a few frames without the
profiler and then profile a few instead. Then
read the peak device memory, free the port's state, and compare a sample
of the last frame's pixels, drawn from the seed, with the plain reference
(reference.py) at the same pixels.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

import devtrace
import judge
import plugins
import reference
import scenes

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pbrt_tpu"}


def load_benchmark(root):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(root, bench, name):
    """A cell by name -> (cell entry, configuration file's dict, traffic
    dict, [metric entries that this cell reports, end-to-end then per
    layer])."""
    root = Path(root)
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(root / bench["paths"][0] / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    mine = lambda m: "workloads" not in m or name in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    layer = [m for m in bench["per_layer"] if mine(m)]
    return cell, config, traffic, e2e, layer


def reader(metric_name, folder=HERE):
    """metrics/<name>.py's read(ctx), from the benchmark's folder."""
    return plugins.load("metrics", metric_name, folder).read


def read_metrics(entries, ctx, folder=HERE):
    """{name: {"value", "unit"}} of the entries whose reader finds something."""
    out = {}
    for m in entries:
        v = reader(m["name"], folder)(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules():
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def check_pixels(seed, res, n):
    """n distinct pixels of a res image, drawn from the seed -> (px, py)."""
    rng = np.random.default_rng(seed)
    flat = rng.choice(res[0] * res[1], size=min(n, res[0] * res[1]), replace=False)
    return flat % res[0], flat // res[0]


def power_limit():
    """The card's power limit as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def run_cell(root, name, seed, seconds, trace, t_start, device="cuda", small=None):
    """One run of cell `name` -> the result's dict. small: the CPU tests'
    overrides ({"resolution", "spp", "mesh_scale", "wavefront_size",
    "pixels"}); a run of the benchmark passes none."""
    import torch
    root = Path(root)
    sys.path.insert(0, str(root))
    from pbrt_tpu_torch.render import render
    from pbrt_tpu_torch.scene.build import load_scene
    from pbrt_tpu_torch.utils.options import Options

    small = small or {}
    _, config, traffic, e2e, layer = resolve(root, load_benchmark(root), name)
    res = tuple(small.get("resolution", config["resolution"]))
    spp = small.get("spp", config["spp"])
    opts = Options(wavefront_size=small.get("wavefront_size", traffic["wavefront_size"]),
                   seed=seed)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    ctx = {"spans": {}, "samples_per_frame": res[0] * res[1] * spp}
    with tempfile.TemporaryDirectory(prefix="pbrt_bench_") as tmp:
        scene_path = scenes.write_scene(
            config, tmp, resolution=small.get("resolution"), spp=small.get("spp"),
            mesh_scale=small.get("mesh_scale"))
        t = time.time()
        cs = load_scene(scene_path, opts, device=device, seed=seed)
        sync()
        ctx["spans"]["scene_build"] = time.time() - t
        t = time.time()
        render(cs, opts)
        sync()
        ctx["spans"]["warmup"] = time.time() - t
        ctx["setup_s"] = time.time() - t_start
        frames, bad = 0, 0
        if not trace:
            t0 = time.perf_counter()
            while True:
                img, _, _ = render(cs, opts)
                frames += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            sync()
            ctx["window_s"] = time.perf_counter() - t0
            ctx["frames"] = frames
        else:
            frames = _traced(cs, opts, render, traffic, ctx, device, sync)
            img = ctx.pop("last_img")
        if tuple(img.shape) != (res[1], res[0], 3) or not bool(torch.isfinite(img).all()):
            bad = 1
        px, py = check_pixels(seed, res, small.get("pixels", config["check"]["pixels"]))
        port_px = img[torch.as_tensor(py), torch.as_tensor(px)].double().cpu().numpy()
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        del cs, img
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        ref = reference.Reference(scene_path, seed, torch.float32, device)
        ctx["n_tris"] = ref.sc.n_tris
        t = time.time()
        ref_px = ref.render_pixels(px, py)
        check_s = time.time() - t
    correct, check = judge.judge(port_px, ref_px, config["check"]["limits"])
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": 1, "memory_peak_bytes": int(peak)}
    if device == "cuda":
        pl = power_limit()
        if pl:
            dev["power_limit"] = pl
    # attempted: the frames rendered; failed: the compared frame, where it is not a finite
    # image of the film's size
    result = {"correct": bool(correct and not bad), "attempted": frames, "failed": bad,
              "metrics": read_metrics(layer if trace else e2e, ctx), "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = ctx["busy_s"], ctx["trace_window_s"]
        result["breakdown"] = ctx["breakdown"]
    result["check_seconds"] = check_s
    result["check"] = check
    return result


def _traced(cs, opts, render, traffic, ctx, device, sync):
    """Time traffic["idle_frames"] frames without the profiler, whose host
    overhead would slow a host-paced frame, then profile
    traffic["trace_frames"] frames (device activity only) -> the frames
    rendered; fills ctx."""
    from torch.profiler import ProfilerActivity, profile
    m = int(traffic["idle_frames"])
    sync()
    t0 = time.perf_counter()
    for _ in range(m):
        render(cs, opts)
    sync()
    ctx["untraced_frame_s"] = (time.perf_counter() - t0) / m
    k = int(traffic["trace_frames"])
    acts = [ProfilerActivity.CUDA] if device == "cuda" else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        # the window starts once the profiler runs: its start-up is not the frames'
        sync()
        t0 = time.perf_counter()
        for _ in range(k):
            img, counters, _ = render(cs, opts)
        sync()
        ctx["trace_window_s"] = time.perf_counter() - t0
    evs = devtrace.events(prof, device=device == "cuda")
    busy_ns, _ = devtrace.union_ns(evs)
    ctx.update(dev_events=evs, busy_s=busy_ns / 1e9, trace_frames=k, counters=counters,
               last_img=img)
    ctx["breakdown"] = {"device_ops": devtrace.top_ops(evs),
                        "idle_gaps": devtrace.idle_before(evs)}
    return m + k


def main(argv, t_start):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = HERE.parent
    import torch
    cell = resolve(root, load_benchmark(root), args.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload}: needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
