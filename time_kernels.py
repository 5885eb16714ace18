"""Time the seeded walks, B1 and B2 (csrc/bvh_traverse.cu) and B3
(csrc/bvh4_traverse.cu), and the kd-tree walk K1 (csrc/kdtree_traverse.cu)
on one CUDA card, for one or more checkouts of this repository:

    python3 time_kernels.py [--check] [--only b|k1] [DIR ...]
    python3 time_kernels.py --sass DIR DIR ...

With no DIR it times the checkout it lies in, in this process. With DIRs
(checkouts of this repository, e.g. a parent commit unpacked with
`git archive` into a directory .gitignore lists, or a copy of this one with
a design step changed), it runs one process per DIR in turns, DIR1 ... DIRk
and then DIRk ... DIR1 (for two: parent, change, change, parent), so that a
card that runs slower or faster over the call shows in every DIR; each
process imports the pbrt_tpu_torch of its DIR and builds that checkout's
kernels from its csrc/.

The rays, launches, timers and comparisons are those of this checkout's
chip_smoke.py, whichever DIR is timed. At the main path's shapes (the bench
scenes' 256x256 films at 2 samples a pixel), with CUDA events, each launch
20 times, the least of two rounds:
  b1, b2  B1 ("queue") and B2 ("all") on the large bench knot and on the
          PLY bench tree: 131,072 camera rays and a 262,144-ray pair launch
          whose second half is any-hit;
  b3      B3 (the 4-wide walk over each tree's 4-wide collapse) on the
          same trees and rays;
  b5      B4/B5 ("packet") on the PLY tree's pair launch, the yardstick
          this comparison leaves unchanged;
  k1      K1 on the large bench knot's kd-tree (4,499,247 nodes): the
          131,072 camera rays and the 262,144-ray pair launch, and what
          explains a launch's time: the camera rays in a shuffled order,
          only the camera (or pair) rays of under 100 node visits, only the
          1% of camera rays with the most, and the pair launch cut to
          131,072 rays (every other ray). The visits a ray are this
          checkout's plain walk's (`KdCounts.ray_visits`), counted once
          before the turns and read by every DIR's process.
Then, on the render path itself, the device ms a render spends in B1
(torch.profiler, two renders after a warm-up, 2 passes of 5 launches
each): the large bench render and the static instanced one; and in K1
on the large bench scene under the kd-tree. --only b or --only k1 times
one group alone.
--check first holds B1, B2, B3 and B5 against their plain walks on the
pair launches, B3 on the camera launches too, and K1 bit-equal to its
plain walk on both launches (in the first turn of each DIR). Every
process prints one JSON line {"tree", "card", "ms":
{launch: ms}, "render_ms": {render: [ms, ms]}}; then come the table of all turns and whether each kernel compiled
to the same machine code in every DIR as in the first (cuobjdump -sass,
the anonymous namespace's per-build hash masked; where a kernel differs,
its first differing lines). The kernels of UNCHANGED (B1, B2, B4/B5, B3
and both B6 paths) are expected unchanged. --sass builds
the DIRs' libraries and makes only that comparison.
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
LIBS = ("bvh_traverse", "bvh4_traverse", "instance_traverse", "kdtree_traverse")
GROUPS = ("b", "k1")
VISITS = os.path.join(HERE, "build", "k1_ray_visits.pt")   # the plain walk's visits a ray
# kernels whose machine code this change should leave as it was, by ptxas's
# name: B1, B2, B4/B5, B3 and B6's static and slerp paths
UNCHANGED = ("walk_kernel<1,1,0>", "walk_kernel<1,1,1>", "walk_kernel<0,0,1>",
             "traverse4_kernel", "instance_kernel<0>", "instance_kernel<1>")


def _smoke():
    """This checkout's chip_smoke.py as a module; its pbrt_tpu_torch is the
    one first on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def render_ms(S, cs, launches, kernel, reps=2):
    """Device ms of one port kernel (a name of chip_smoke's record) in each
    of reps renders of cs after a warm-up; each render must make exactly
    launches ({counter: count}) -> [ms, ...]."""
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
        out.append(mine[kernel])
    return out


def b_calls(S, dev, check):
    """The B kernels' launches ({name: fn}) and their renders ({name: fn ->
    [ms, ...]}); --check holds them against their plain walks first."""
    import torch
    from pbrt_tpu_torch.accel import traverse as T
    from pbrt_tpu_torch.scene.bench import (build_bench_scene, build_instanced_bench_scene,
                                            build_ply_bench_scene)
    cs_l = build_bench_scene(True, dev)
    with tempfile.TemporaryDirectory(prefix="ply_bench_") as ply_dir:
        cs_p = build_ply_bench_scene(ply_dir, dev)
    pair = S.pair_launch(131_072, dev)
    calls = {}
    for label, cs in (("large", cs_l), ("PLY", cs_p)):
        kb = cs.data.bvh
        kb4 = T.pack_kernel_bvh4(kb)
        o, d, _ = S.camera_launch(cs, dev)
        n_cam = o.shape[0]
        cam = [o, d, torch.full((n_cam,), float("inf"), device=dev),
               torch.zeros(n_cam, dtype=torch.uint8, device=dev)]
        for name, r in (("camera", cam), ("pair", pair)):
            calls[f"b1 {label} {name}"] = (lambda kb=kb, r=r: T.traverse(kb, *r))
            calls[f"b2 {label} {name}"] = (lambda kb=kb, r=r: T.traverse(kb, *r, variant="all"))
            calls[f"b3 {label} {name}"] = (lambda kb4=kb4, r=r: T.traverse4(kb4, *r))
        if check:
            for name in ("bvh_traverse", "bvh_traverse_all"):
                S.compare(kb, *pair, name=name)
            S.compare(kb4, *cam, name="bvh4_traverse")
            S.compare(kb4, *pair, name="bvh4_traverse")
    calls["b5 PLY pair"] = lambda: T.traverse(cs_p.data.bvh, *pair, variant="packet")
    if check:
        S.compare(cs_p.data.bvh, *pair, name="bvh_traverse_packet")
    cs_s = build_instanced_bench_scene(False, dev)
    renders = {
        "b1 / large render": lambda: render_ms(S, cs_l, {"bvh_traverse": 10}, "bvh_traverse"),
        "b1 / static inst render": lambda: render_ms(
            S, cs_s, {"bvh_traverse": 10, "instance_traverse": 10}, "bvh_traverse"),
    }
    return calls, renders


def kd_scene(S, dev):
    from pbrt_tpu_torch.scene.bench import bench_variant_description
    from pbrt_tpu_torch.scene.build import build_scene
    return build_scene(bench_variant_description(True, accelerator="kdtree"), None, dev)


def count_visits(path):
    """The plain walk's node visits a ray on K1's camera and pair launches
    (this checkout's `KdCounts.ray_visits`) -> saved to path."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device (torch.cuda.is_available() is false)")
    S = _smoke()
    from pbrt_tpu_torch.accel import kdtree as K
    dev = torch.device("cuda")
    cs = kd_scene(S, dev)
    launches, kd = S.kd_launches(cs, dev), cs.data.kd
    out = {}
    for name, rays in launches.items():
        counts = K.KdCounts()
        K.intersect_kdtree_plain(kd, *rays, counts)
        out[name] = counts.ray_visits.cpu()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(out, path)


def k1_calls(S, dev, check):
    """K1's launches ({name: fn}) and its render ({name: fn -> [ms, ...]});
    --check holds both launches bit-equal to the plain walk first."""
    import torch
    from pbrt_tpu_torch.accel import kdtree as K
    cs = kd_scene(S, dev)
    kd = cs.data.kd
    launches = S.kd_launches(cs, dev)
    if check:
        for name, rays in launches.items():
            got, want = K.intersect_kdtree(kd, *rays), K.intersect_kdtree_plain(kd, *rays)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"K1 differs from its plain walk on the {name} launch")
    calls = {f"k1 {name}": lambda r=rays: K.intersect_kdtree(kd, *r)
             for name, rays in launches.items()}
    subsets = {}   # name: (launch, its rays' indices)
    if os.path.exists(VISITS):
        visits = {k: v.to(dev) for k, v in torch.load(VISITS).items()}
        n_cam = visits["camera"].shape[0]
        gen = torch.Generator(device="cpu").manual_seed(5)
        subsets["camera shuffled"] = ("camera", torch.randperm(n_cam, generator=gen).to(dev))
        subsets["camera <100 visits"] = ("camera", torch.nonzero(visits["camera"] < 100)[:, 0])
        subsets["camera slowest 1%"] = ("camera", torch.argsort(visits["camera"],
                                                                descending=True)[:n_cam // 100])
        subsets["pair <100 visits"] = ("pair", torch.nonzero(visits["pair"] < 100)[:, 0])
    subsets["pair every other ray"] = ("pair", torch.arange(0, launches["pair"][0].shape[0], 2,
                                                            device=dev))
    for name, (launch, idx) in subsets.items():
        rays = [x[idx].contiguous() for x in launches[launch]]
        calls[f"k1 {name} ({rays[0].shape[0]} rays)"] = lambda r=rays: K.intersect_kdtree(kd, *r)
    renders = {"k1 / kd render": lambda: render_ms(S, cs, {"kdtree_traverse": 10},
                                                     "kdtree_traverse")}
    return calls, renders


def measure(check=False, only=None):
    """Time the launches and renders of the module docstring (one group
    with only) in this process -> the JSON record."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device (torch.cuda.is_available() is false)")
    S = _smoke()
    from pbrt_tpu_torch.accel import native
    dev = torch.device("cuda")
    native.load_all(LIBS)
    calls, renders = {}, {}
    for group, make in (("b", b_calls), ("k1", k1_calls)):
        if only in (None, group):
            c, r = make(S, dev, check)
            calls.update(c)
            renders.update(r)
    ms = {k: S.cuda_ms(f, REPS) for k, f in calls.items()}
    ms = {k: min(v, S.cuda_ms(calls[k], REPS)) for k, v in ms.items()}
    per_render = {k: f() for k, f in renders.items()}
    return {"tree": os.getcwd(), "card": S.card_line(), "checked": check, "ms": ms,
            "render_ms": per_render}


def sass(tree, lib):
    """{kernel: its SASS lines} of the kernels in a built library of the
    checkout at tree; a kernel is keyed by ptxas's name (its function and
    bool template arguments, `native._kernel_name`)."""
    from pbrt_tpu_torch.accel.native import _kernel_name
    cuobjdump = "/usr/local/cuda/bin/cuobjdump"
    so = os.path.join(tree, "build", "pbrt_tpu_torch", f"lib{lib}.so")
    out = subprocess.run([cuobjdump if os.path.exists(cuobjdump) else "cuobjdump", "-sass", so],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    funcs = {}
    for part in out.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        key = _kernel_name(name.strip())
        if key.split("<")[0].endswith("_kernel"):
            body = re.sub(r"_GLOBAL__N__[0-9a-f]+", "_GLOBAL__N__", body)
            funcs[key] = [ln.strip() for ln in body.splitlines() if ln.strip()]
    return funcs


def compare_sass(trees):
    """Print whether each kernel has the same SASS in every tree as in the
    first, and whether those of UNCHANGED are all identical."""
    held = True
    for lib in LIBS:
        base = sass(trees[0], lib)
        for tree in trees[1:]:
            other = sass(tree, lib)
            print(f"SASS of lib{lib}, {tree} vs {trees[0]}:")
            for key in sorted(base.keys() | other.keys()):
                tag = " (expected unchanged)" if key in UNCHANGED else ""
                if key not in base or key not in other:
                    print(f"  {key}{tag}: only in {trees[0] if key in base else tree}")
                    held = held and key not in UNCHANGED
                    continue
                diff = [ln for ln in difflib.unified_diff(base[key], other[key], n=0, lineterm="")
                        if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
                held = held and not (diff and key in UNCHANGED)
                print(f"  {key}{tag}: {len(base[key])} lines, " + (
                    "identical" if not diff else f"{len(diff)} lines differ:\n    "
                    + "\n    ".join(d[:160] for d in diff[:12])))
    print("SASS of " + ", ".join(UNCHANGED) + (
        ": identical in every tree" if held else ": NOT identical in every tree"))


def main(argv):
    check = "--check" in argv
    only = argv[argv.index("--only") + 1] if "--only" in argv else None
    if only not in (None, *GROUPS):
        raise SystemExit(f"time_kernels: --only takes one of {GROUPS}")
    trees = [a for a in argv if a not in ("--check", "--sass", "--only", only)]
    if "--sass" in argv:
        for tree in trees:
            subprocess.run([sys.executable, "-c", "from pbrt_tpu_torch.accel import native; "
                            f"native.load_all({list(LIBS)})"],
                           cwd=tree, check=True, timeout=900)
        compare_sass(trees)
        return
    if "--visits" in trees:
        count_visits(VISITS)
        return
    if only != "b" and "--one" not in trees:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--visits"], cwd=HERE,
                             timeout=900)
        if res.returncode != 0:
            raise SystemExit("time_kernels: counting K1's node visits a ray failed")
    if "--one" in trees:
        sys.path.insert(0, os.getcwd())   # the DIR's pbrt_tpu_torch
        print(json.dumps(measure(check, only)))
        return
    if not trees:
        print(json.dumps(measure(check, only)))
        return
    turns = [(t, check) for t in trees] + [(t, False) for t in reversed(trees)]
    rows = []
    for tree, chk in turns:
        cmd = ([sys.executable, os.path.abspath(__file__), "--one"] + (["--check"] if chk else [])
               + (["--only", only] if only else []))
        res = subprocess.run(cmd, cwd=tree, capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise SystemExit(f"time_kernels: {tree} failed:\n{res.stderr[-4000:]}")
        rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    print(f"{'launch (ms)':34s}" + "".join(f"{os.path.basename(r['tree'].rstrip('/')):>12s}"
                                           for r in rows) + f"  [{rows[0]['card']}]")
    for k in rows[0]["ms"]:
        print(f"{k:34s}" + "".join(f"{r['ms'][k]:12.4f}" for r in rows))
    for k in rows[0]["render_ms"]:
        print(f"{k:34s}" + "".join(f"{sum(r['render_ms'][k]) / len(r['render_ms'][k]):12.4f}"
                                   for r in rows))
    compare_sass(trees)


if __name__ == "__main__":
    main(sys.argv[1:])
