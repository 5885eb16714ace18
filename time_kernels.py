"""Time the redesigned BVH kernels beside B1 on one CUDA card, for one or
more checkouts of this repository:

    python3 time_kernels.py [--check] [DIR ...]
    python3 time_kernels.py --sass DIR DIR ...

With no DIR it times the checkout it lies in, in this process. With DIRs
(checkouts of this repository, e.g. a parent commit unpacked with
`git archive` into a directory .gitignore lists), it runs one process per
DIR in turns, DIR1 ... DIRk and then DIRk ... DIR1 (for two: parent,
change, change, parent), so that a card that runs slower or faster over
the call shows in every DIR; each process imports the pbrt_tpu_torch of
its DIR and builds that checkout's kernels from its csrc/.

The rays, launches, timers and comparisons are those of this checkout's
chip_smoke.py, whichever DIR is timed. At the main path's shapes (the bench
scenes' 256x256 films at 2 samples a pixel), with CUDA events, each launch
20 times, the least of two rounds:
  packet  B4/B5 ("packet") on the PLY bench tree: 131,072 camera rays and
          a 262,144-ray pair launch whose second half is any-hit;
  b1      B1 ("queue") on the same tables and rays, the yardstick this
          comparison leaves unchanged;
  inst    B6 on the static and the animated instanced bench scenes:
          131,072 camera rays with their ray times and 262,144 shell rays,
          each bounded by B1's closest world hit, as the main path bounds it.
Then, on the render path itself, the device ms a render spends in the
kernels (torch.profiler, two renders after a warm-up, 2 passes of 5
launches each): the packet kernel in the PLY bench render, B6 in the
static instanced one.
--check first holds each kernel against its plain walk on the pair and
shell launches (in the first turn of each DIR). Every process prints one
JSON line {"tree", "card", "ms": {launch: ms}, "render_ms": {kernel:
[ms, ms]}}; then come the table of all turns and whether each kernel
compiled to the same machine code in every DIR as in the first (cuobjdump
-sass, the anonymous namespace's per-build hash masked; where a kernel
differs, its first differing lines). --sass builds the DIRs' libraries
and makes only that comparison.
"""
import difflib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile

REPS = 20
HERE = os.path.dirname(os.path.abspath(__file__))
LIBS = ("bvh_traverse", "bvh4_traverse", "instance_traverse")


def _smoke():
    """This checkout's chip_smoke.py as a module; its pbrt_tpu_torch is the
    one first on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def render_ms(S, cs, launches, kernels, reps=2):
    """Device ms of kernels (function names summed) in each of reps renders
    of cs after a warm-up; each render must make exactly launches
    ({counter: count}) -> [ms, ...]."""
    from pbrt_tpu_torch.render import Options, render_sampler_integrator
    opts = Options()
    render_sampler_integrator(cs, opts)
    out = []
    for _ in range(reps):
        S.zero_counts()
        mine = S.profile_render(cs, opts)[3]
        counts = S.read_counts()
        if counts != {**dict.fromkeys(counts, 0), **launches}:
            raise AssertionError(f"render launches {counts}, expected {launches}")
        out.append(sum(mine[k] for k in kernels))
    return out


def measure(check=False):
    """Time the launches and renders of the module docstring in this
    process -> the JSON record."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device (torch.cuda.is_available() is false)")
    S = _smoke()
    from pbrt_tpu_torch.accel import instance as I
    from pbrt_tpu_torch.accel import native
    from pbrt_tpu_torch.accel import traverse as T
    from pbrt_tpu_torch.scene.bench import build_instanced_bench_scene, build_ply_bench_scene
    dev = torch.device("cuda")
    native.load_all(["bvh_traverse", "bvh4_traverse", "instance_traverse"])
    with tempfile.TemporaryDirectory(prefix="ply_bench_") as ply_dir:
        cs_p = build_ply_bench_scene(ply_dir, dev)
    kbp = cs_p.data.bvh
    o, d, _ = S.camera_launch(cs_p, dev)
    n_cam = o.shape[0]
    rays = {"camera": [o, d, torch.full((n_cam,), float("inf"), device=dev),
                       torch.zeros(n_cam, dtype=torch.uint8, device=dev)],
            "pair": S.pair_launch(n_cam, dev)}
    calls = {}
    for name, r in rays.items():
        calls[f"packet {name}"] = (lambda r=r: T.traverse(kbp, *r, variant="packet"))
        calls[f"b1 {name}"] = (lambda r=r: T.traverse(kbp, *r))
    if check:
        S.compare(kbp, *rays["pair"], name="bvh_traverse_packet")
    for animated in (False, True):
        label = "animated" if animated else "static"
        cs_i = build_instanced_bench_scene(animated, dev)
        for name, (args, slot_w) in (
                ("camera", S.world_bounded(cs_i, *S.camera_launch(cs_i, dev))),
                ("shell", S.world_bounded(cs_i, *S.shell_rays(2 * n_cam, dev, 3)))):
            calls[f"inst {label} {name}"] = (lambda a=args: I.instance_traverse(*a))
            if check and name == "shell":
                S.compare_inst(args, slot_w)
        if not animated:
            cs_s = cs_i
    ms = {k: S.cuda_ms(f, REPS) for k, f in calls.items()}
    ms = {k: min(v, S.cuda_ms(calls[k], REPS)) for k, v in ms.items()}
    per_render = {
        "packet / PLY render": render_ms(S, cs_p, {"bvh_traverse_packet": 10},
                                         ("traverse_kernel", "packet_kernel")),
        "inst / static render": render_ms(S, cs_s, {"bvh_traverse": 10, "instance_traverse": 10},
                                          ("instance_kernel",)),
    }
    return {"tree": os.getcwd(), "card": S.card_line(), "checked": check, "ms": ms,
            "render_ms": per_render}


def sass(tree, lib, kernels):
    """{kernel: its SASS lines} of the kernels (function names) in a built
    library of the checkout at tree; a kernel is keyed by its mangled name
    from the function on (template arguments and parameter types)."""
    cuobjdump = "/usr/local/cuda/bin/cuobjdump"
    so = os.path.join(tree, "build", "pbrt_tpu_torch", f"lib{lib}.so")
    out = subprocess.run([cuobjdump if os.path.exists(cuobjdump) else "cuobjdump", "-sass", so],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    funcs = {}
    for part in out.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        k = next((f"{len(k)}{k}" for k in kernels if f"{len(k)}{k}" in name), None)
        if k:
            body = re.sub(r"_GLOBAL__N__[0-9a-f]+", "_GLOBAL__N__", body)
            funcs[name[name.index(k):].strip()] = [ln.strip() for ln in body.splitlines()
                                                   if ln.strip()]
    return funcs


def compare_sass(trees):
    """Print whether each kernel has the same SASS in every tree as in the
    first."""
    kernels = _smoke().PORT_KERNELS
    for lib in LIBS:
        base = sass(trees[0], lib, kernels)
        for tree in trees[1:]:
            other = sass(tree, lib, kernels)
            print(f"SASS of lib{lib}, {tree} vs {trees[0]}:")
            for key in sorted(base.keys() | other.keys()):
                label = re.match(r"\d+\w+?_kernel(I(?:Lb[01]E)+E)?", key).group()
                if key not in base or key not in other:
                    print(f"  {label}: only in {trees[0] if key in base else tree}")
                    continue
                diff = [ln for ln in difflib.unified_diff(base[key], other[key], n=0, lineterm="")
                        if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
                print(f"  {label}: {len(base[key])} lines, " + (
                    "identical" if not diff else f"{len(diff)} lines differ:\n    "
                    + "\n    ".join(d[:160] for d in diff[:12])))


def main(argv):
    check = "--check" in argv
    trees = [a for a in argv if a not in ("--check", "--sass")]
    if "--sass" in argv:
        for tree in trees:
            subprocess.run([sys.executable, "-c", "from pbrt_tpu_torch.accel import native; "
                            f"native.load_all({list(LIBS)})"],
                           cwd=tree, check=True, timeout=900)
        compare_sass(trees)
        return
    if "--one" in trees:
        sys.path.insert(0, os.getcwd())   # the DIR's pbrt_tpu_torch
        print(json.dumps(measure("--check" in argv)))
        return
    if not trees:
        print(json.dumps(measure(check)))
        return
    turns = [(t, check) for t in trees] + [(t, False) for t in reversed(trees)]
    rows = []
    for tree, chk in turns:
        cmd = [sys.executable, os.path.abspath(__file__), "--one"] + (["--check"] if chk else [])
        res = subprocess.run(cmd, cwd=tree, capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise SystemExit(f"time_kernels: {tree} failed:\n{res.stderr[-4000:]}")
        rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    print(f"{'launch (ms)':24s}" + "".join(f"{os.path.basename(r['tree'].rstrip('/')):>12s}"
                                           for r in rows) + f"  [{rows[0]['card']}]")
    for k in rows[0]["ms"]:
        print(f"{k:24s}" + "".join(f"{r['ms'][k]:12.4f}" for r in rows))
    for k in rows[0]["render_ms"]:
        print(f"{k:24s}" + "".join(f"{sum(r['render_ms'][k]) / len(r['render_ms'][k]):12.4f}"
                                   for r in rows))
    compare_sass(trees)


if __name__ == "__main__":
    main(sys.argv[1:])
