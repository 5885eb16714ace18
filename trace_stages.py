"""Where a cell's frames go, stage by stage, from the port's own spans.

    python3 trace_stages.py --workload <cell> --seed <n> [--out FILE]

Builds the cell's scene and renders a warm frame as a run of the benchmark
does, then renders the traffic's `trace_frames` frames under torch.profiler
(device activity only) with the port's spans recorded
(pbrt_tpu_torch/utils/trace.py), and prints one JSON object, written to
FILE where given:

  metrics    the span metrics (benchmark/metrics/<name>.py, NEW_METRICS) and
             the existing device-trace ones, read from these frames;
  breakdown  `stages` (spans.stages), `idle_gaps_by_span`, and the existing
             `device_ops` and `idle_gaps` for comparison;
  join       spans.join_summary, the device ms a frame put down to a named
             span against all of it, and the operations that lead their
             launch the most;
  api        the host's CUDA API calls a frame: by name, and by the
             innermost span open at each call.

Needs a CUDA device; runs from the root of a checkout.
It lives outside benchmark/, whose measuring code imports nothing of the
program, and the benchmark's runs never call it. It goes once the
harness's traced run records spans (PERF.md, section 7).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
from pathlib import Path

os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "benchmark"))

import torch  # noqa: E402

import devtrace  # noqa: E402
import harness  # noqa: E402
import scenes  # noqa: E402
import spans as S  # noqa: E402

NEW_METRICS = [
    {"name": "entry.host_issue_ms_per_frame", "unit": "ms"},
    {"name": "entry.wait_ms_per_frame", "unit": "ms"},
    {"name": "entry.host_us_per_kernel", "unit": "us"},
    {"name": "integrator.sampler_device_ms_per_frame", "unit": "ms"},
    {"name": "integrator.bsdf_device_ms_per_frame", "unit": "ms"},
]
TRACE_METRICS = [
    {"name": "integrator.kernels_per_frame", "unit": "kernels"},
    {"name": "integrator.device_ms_per_frame", "unit": "ms"},
    {"name": "walk.device_ms_per_frame", "unit": "ms"},
]


def leads(spans, recs, n=10):
    """The n operations that start earliest against their launch's host
    time -> [[name, lead in us, span at launch]]."""
    own = S.owners(spans, recs)
    out = sorted(((r[3] - r[1]) / 1e3, r[0][:60], S.owner_name(spans, o))
                 for r, o in zip(recs, own) if r[3] is not None)[::-1][:n]
    return [[name, lead, at] for lead, name, at in out]


def api_table(spans, apis, frames):
    """{"by_name": {call: {calls, ms, p50_us, p99_us, max_us}},
    "by_span": {span: {call: [calls, ms]}}}, a frame."""
    by_name, by_span = {}, {}
    for (name, _, d), o in zip(apis, S.innermost(spans, [a[1] for a in apis])):
        by_name.setdefault(name, []).append(d)
        row = by_span.setdefault(S.owner_name(spans, o), {}).setdefault(name, [0, 0.0])
        row[0] += 1 / frames
        row[1] += d / 1e6 / frames
    names = {}
    for name, ds in sorted(by_name.items(), key=lambda kv: -sum(kv[1])):
        q = statistics.quantiles(ds, n=100) if len(ds) > 1 else ds * 99
        names[name] = {"calls": len(ds) / frames, "ms": sum(ds) / 1e6 / frames,
                       "p50_us": q[49] / 1e3, "p99_us": q[98] / 1e3, "max_us": max(ds) / 1e3}
    return {"by_name": names, "by_span": by_span}


def run(name, seed):
    from torch.profiler import ProfilerActivity, profile
    from pbrt_tpu_torch.render import render
    from pbrt_tpu_torch.scene.build import load_scene
    from pbrt_tpu_torch.utils import trace
    from pbrt_tpu_torch.utils.options import Options
    _, config, traffic, _, _ = harness.resolve(ROOT, harness.load_benchmark(ROOT), name)
    opts = Options(wavefront_size=traffic["wavefront_size"], seed=seed)
    k = int(traffic["trace_frames"])
    with tempfile.TemporaryDirectory(prefix="pbrt_stages_") as tmp:
        cs = load_scene(scenes.write_scene(config, tmp), opts, device="cuda", seed=seed)
        render(cs, opts)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            with trace.recording():
                for _ in range(k):
                    render(cs, opts)
            torch.cuda.synchronize()
    evs = devtrace.events(prof)
    sp, recs, apis = trace.take(), S.launch_records(prof), S.api_calls(prof)
    ctx = {"dev_events": evs, "trace_frames": k, "program_spans": sp, "launches": recs,
           "api_calls": apis}
    table = S.stages(sp, recs, k, apis)
    total = sum(d for _, _, d in evs) / 1e6 / k
    named = sum(v["device_ms"] for n, v in table.items() if n not in (S.OUTSIDE, S.UNJOINED))
    return {"workload": name, "seed": seed,
            "metrics": harness.read_metrics(NEW_METRICS + TRACE_METRICS, ctx),
            "breakdown": {"stages": table, "idle_gaps_by_span": S.idle_gaps_by_span(sp, recs),
                          "device_ops": devtrace.top_ops(evs),
                          "idle_gaps": devtrace.idle_before(evs)},
            "join": dict(S.join_summary(sp, recs), device_ms_per_frame=total,
                         named_device_ms_per_frame=named, spans=len(sp), leads=leads(sp, recs)),
            "api": api_table(sp, apis, k)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    out = run(args.workload, args.seed)
    out["device"] = torch.cuda.get_device_name(0)
    out["power_limit"] = harness.power_limit()
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
