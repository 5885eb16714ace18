"""Smoke test of the PyTorch port on one CUDA card: python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing catches it):
  1. require a CUDA device; print the card's name and power limit;
  2. build both kernels, the BVH traversal (csrc/bvh_traverse.cu) and the
     two-level instance traversal (csrc/instance_traverse.cu), one nvcc
     each, started together;
  3. hold the kernel against its plain PyTorch walk on the large bench knot
     at the main path's shapes (131,072 camera rays; a 262,144-ray pair
     launch with an any-hit half), and on both bench knots with 100,003
     random rays: bit-equal t and slot on closest-hit rays, equal hit
     flags on any-hit rays, no stack overflow; time both with CUDA events;
  4. render the constant-environment smoke scene through the CLI entry on
     CUDA: every pixel must be sRGB 188;
  5. render the large bench scene (73,728-triangle knot, 256x256,
     02sequence at 4 spp, depth 4) through the port's front end and driver:
     finite and nonzero, one camera launch plus 4 pair launches per pass
     through the kernel (one more render under torch.profiler for the
     device's busy time), a 32x32 crop bitwise equal over two renders and
     close to the same crop rendered on the CPU with the plain walk;
  6. hold the instance kernel against its plain walk on the instanced bench
     scene (64 instances of the large knot) and on its animated variant, at
     the main path's shapes: 131,072 camera rays with their ray times, a
     262,144-ray launch from a shell around the grid with times past both
     ends of [0, 1], and 100,003 such rays; each launch is bounded by the
     BVH kernel's world hits, as the main path bounds it. Static scene: t,
     triangle, b1, b2, inst and iters bit-equal; animated (the slerp path):
     the same, or where the kernel's acosf/sinf/rsqrtf round otherwise than
     torch's ops, >= 99.9% equal triangle and inst with
     |dt| <= 1e-5 max(1, t); no stack overflow; hits in both the instances
     and the world. Time both with CUDA events;
  7. render both instanced scenes (256x256, 02sequence at 4 spp, depth 4)
     end to end, three times each after a warm-up: finite and nonzero, 5
     launches per pass of each kernel; one more render under
     torch.profiler for the device's busy time; a 32x32 crop bitwise equal
     over two renders and close to the same crop rendered on the CPU with
     the plain walks.
The line before the last is the kernels' JSON record, with each kernel's
bound: the larger of its fp32 operations over 67 TFLOP/s and its bytes over
3.35 TB/s (H100 SXM), counted from the plain walk's visits on the timed
launch. The last line is {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pbrt_tpu_torch.accel import instance as I
from pbrt_tpu_torch.accel import native
from pbrt_tpu_torch.accel import traverse as T
from pbrt_tpu_torch.integrators.common import camera_rays
from pbrt_tpu_torch.render import Options, render_sampler_integrator, sample_pixels
from pbrt_tpu_torch.samplers import sample_dim
from pbrt_tpu_torch.scene.bench import build_bench_scene, build_instanced_bench_scene

REPLACES = {"bvh_traverse": "pbrt_tpu/accel/pallas_traverse.py:1001",
            "instance_traverse": "pbrt_tpu/accel/pallas_instance.py:352"}
PEAK_FLOPS = 67e12     # H100 SXM, fp32 outside the tensor cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12   # H100 SXM, HBM3
# fp32 operations per step, counted from the kernels' sources (each add, sub,
# mul, div, min, max, abs or compare counts one, a transcendental one):
# ray setup; one child-box slab test; one triangle test; moving a ray into
# prototype space (3x4 matrix on o and d); a static instance's walk matrix
OPS = {"setup": 20, "box": 26, "tri": 51, "xform": 33, "lerp": 24}


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps, warm=True):
    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(kb, o, d, t_max, anyhit, counts=None):
    """Kernel vs plain on one launch -> max |dt| over closest hits."""
    before = T.traverse.launches
    t, s, it = T.traverse(kb, o, d, t_max, anyhit)
    torch.cuda.synchronize()
    if T.traverse.launches != before + 1:
        raise AssertionError("the kernel's launch counter did not advance")
    tp, sp, itp = T.traverse_plain(kb, o, d, t_max, anyhit, counts)
    cl = anyhit == 0
    if not (torch.equal(t[cl], tp[cl]) and torch.equal(s[cl], sp[cl])):
        raise AssertionError("kernel and plain walk differ on closest-hit rays")
    if not torch.equal(s[~cl] >= 0, sp[~cl] >= 0):
        raise AssertionError("kernel and plain walk differ in any-hit flags")
    if not torch.equal(it, itp) or bool(torch.any(it & T.OVF_BIT)):
        raise AssertionError(f"iters differ or a stack overflowed: {int(it.max())}")
    hit = cl & (s >= 0)
    if not bool(hit.any()):
        raise AssertionError("no closest-hit ray hit anything")
    # equal values count 0, so a hit at t = inf (a subnormal det) is no NaN
    a, b = t[hit], tp[hit]
    return float(torch.where(a == b, 0.0, (a - b).abs()).max())


def random_rays(n, dev, seed):
    """Rays from a shell around the knot toward it, zeroed direction
    components on every 7th / 11th ray, every other ray any-hit."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-1, 1, (n, 3)).astype(np.float32) - o
    d[::7, 0] = 0.0
    d[::11, 1] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ah = (np.arange(n) % 2).astype(np.uint8)
    return [torch.as_tensor(a, device=dev) for a in (o, d, np.full(n, np.inf, np.float32), ah)]


def shell_rays(n, dev, seed):
    """Rays from a shell of radius 12 around the instance grid toward
    points inside its bounds, with times in [-0.25, 1.25)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 12.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    o[:, 1] = np.abs(o[:, 1])
    d = rng.uniform([-6.0, -1.0, -6.0], [6.0, 1.2, 6.0], (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(-0.25, 1.25, n)
    return [torch.as_tensor(a.astype(np.float32), device=dev) for a in (o, d, tm)]


def world_bounded(cs, o, d, time):
    """The instance launch's inputs as the main path gives them: t_max is the
    BVH kernel's closest world hit -> ([ib, o, d, t_max, time, trs], world slot)."""
    n = o.shape[0]
    t_w, slot_w, _ = T.traverse(cs.data.bvh, o, d, torch.full((n,), float("inf"), device=o.device),
                                torch.zeros(n, dtype=torch.uint8, device=o.device))
    return [cs.data.ibvh, o, d, t_w, time, cs.flags.any_animated_inst], slot_w


def compare_inst(args, slot_w, counts=None):
    """Instance kernel vs plain walk on one launch -> max |dt| over hits."""
    before = I.instance_traverse.launches
    got = I.instance_traverse(*args)
    torch.cuda.synchronize()
    if I.instance_traverse.launches != before + 1:
        raise AssertionError("the instance kernel's launch counter did not advance")
    want = I.instance_traverse_plain(*args, counts)
    t, tri, b1, b2, inst, it = got
    tp, trip, b1p, b2p, instp, itp = want
    if bool(torch.any((it | itp) & T.OVF_BIT)):
        raise AssertionError("an instance walk's stack overflowed")
    n_inst = int((inst >= 0).sum())
    n_world = int(((inst < 0) & (slot_w >= 0)).sum())
    if n_inst == 0 or n_world == 0:
        raise AssertionError(f"{n_inst} instance hits and {n_world} world hits: need both")
    same = (tri == trip) & (inst == instp)
    both = same & (tri >= 0)
    dt = torch.where(t == tp, 0.0, (t - tp).abs())
    err = float(dt[both].max()) if bool(both.any()) else 0.0
    exact = all(torch.equal(a, b) for a, b in zip(got, want))
    frac = float(same.float().mean())
    db = float(torch.maximum((b1 - b1p).abs(), (b2 - b2p).abs())[both].max()) \
        if bool(both.any()) else 0.0
    print(f"  {tri.shape[0]} rays: {n_inst} instance hits, {n_world} world hits; "
          f"{'bit-equal' if exact else 'not bit-equal'}: {frac:.6f} equal triangle and inst, "
          f"max |dt| {err}, max |db| {db}, iters {int(it.max())}")
    if not args[5]:
        if not exact:
            raise AssertionError("instance kernel and plain walk differ on the static path")
    elif frac < 0.999 or bool(torch.any(dt[both] > 1e-5 * torch.clamp(tp[both], min=1.0))):
        raise AssertionError("instance kernel and plain walk differ beyond the slerp "
                             "path's tolerance")
    return err


def bound_ms(counts, n, ray_bytes, inst_bytes=0, enter_ops=0, fixed_bytes=0):
    """The least time of a launch on n rays: the larger of its fp32
    operations over the card's peak and the bytes it must move (rays in,
    results out, each table entry it touched read once) over its memory
    rate -> (ms, "operations" or "bytes")."""
    n_seen = int(counts.seen.sum())
    interior, leaf_tris, inst_leaves = counts.touched()
    ops = (n * OPS["setup"] + counts.interior * 2 * OPS["box"] + counts.tri_tests * OPS["tri"]
           + counts.enters * (enter_ops + OPS["xform"] + 2 * OPS["setup"]))
    byts = (n * ray_bytes + -(-n // T.GROUP) * 4 + n_seen * 4 + interior * 48
            + leaf_tris * 36 + inst_leaves * inst_bytes + fixed_bytes)
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, byts / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def profile_render(cs, opts):
    """One render under torch.profiler -> (device ms, device kernel count,
    the 5 ops with the most device time, the instance kernel's device ms)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render_sampler_integrator(cs, opts)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    avgs = prof.key_averages()
    ops = sorted((e for e in avgs if e.device_type != cuda),
                 key=lambda e: e.self_device_time_total, reverse=True)[:5]
    top = ", ".join(f"{e.key} {e.self_device_time_total / 1e3:.2f}" for e in ops)
    inst = sum(e.self_device_time_total for e in avgs
               if e.device_type == cuda and "instance_kernel" in e.key) / 1e3
    return busy, len(kernels), top, inst


def render_instanced(animated, dev, card):
    """Render one instanced bench scene end to end and check its crop ->
    instance kernel launches of the timed render."""
    label = "animated" if animated else "static"
    t0 = time.time()
    cs = build_instanced_bench_scene(animated, dev)
    print(f"instanced scene ({label}) built in {time.time() - t0:.2f} s")
    crop = Options(crop_window=(0.5, 0.625, 0.5, 0.625))
    a, _, _ = render_sampler_integrator(build_instanced_bench_scene(animated, dev, crop), crop)
    torch.cuda.synchronize()   # the crop render is the warm-up
    opts = Options()
    walls = []
    for _ in range(3):   # the host clock is noisy: three renders, the median
        T.traverse.launches = I.instance_traverse.launches = 0
        t0 = time.time()
        img, cnt, passes = render_sampler_integrator(cs, opts)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        launches = (T.traverse.launches, I.instance_traverse.launches)
        if tuple(img.shape) != (256, 256, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{label} instanced render is not a finite 256x256 image")
        if float(img.sum()) <= 0:
            raise AssertionError(f"{label} instanced render is black")
        if launches != (5 * passes, 5 * passes):
            raise AssertionError(f"{launches} (BVH, instance) kernel launches, expected 5 "
                                 f"per pass x {passes} each")
    wall = sorted(walls)[1]
    samples = 256 * 256 * cs.sampler.rounded_spp()
    live = cnt["camera_rays"] + cnt["shadow_rays"] + cnt["bounce_rays"]
    print(f"instanced render ({label}): {', '.join(f'{w:.3f}' for w in walls)} s, median "
          f"{wall:.3f} s; {passes} passes, {launches[0]} BVH and {launches[1]} instance kernel "
          f"launches each; {samples / wall:.0f} samples/s, {live / wall / 1e6:.3f} M live "
          f"rays/s ({live} live rays), mean {float(img.mean()):.5f}  [{card}]")

    busy, n_kern, top, inst_ms = profile_render(cs, opts)
    print(f"instanced render ({label}) under torch.profiler: {n_kern} device kernels, "
          f"{busy:.1f} ms device time, {100 * busy / 1e3 / wall:.1f}% of the unprofiled wall; "
          f"instance kernel {inst_ms:.2f} ms; top device ops (ms): {top}  [{card}]")

    b, _, _ = render_sampler_integrator(build_instanced_bench_scene(animated, dev, crop), crop)
    if tuple(a.shape) != (32, 32, 3) or not torch.equal(a, b):
        raise AssertionError(f"the {label} 32x32 crop differs between two renders")
    c, _, _ = render_sampler_integrator(build_instanced_bench_scene(animated, "cpu", crop), crop)
    a, c = a.cpu().numpy(), c.numpy()
    near = np.all(np.abs(a - c) <= 1e-4 + 1e-3 * np.abs(c), axis=-1).mean()
    if near < 0.99 or abs(a.mean() - c.mean()) > 0.01 * abs(c.mean()):
        raise AssertionError(f"{label} CUDA crop vs CPU crop: {near:.4f} of pixels close, "
                             f"means {a.mean()} / {c.mean()}")
    print(f"{label} 32x32 crop: bitwise equal over two CUDA renders; {near:.4f} of pixels "
          f"within rtol 1e-3 / atol 1e-4 of the CPU render, means {a.mean():.6f} / "
          f"{c.mean():.6f}")
    return launches[1]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))

    # ---- 2: build ----
    for name, sec in native.load_all(["bvh_traverse", "instance_traverse"]).items():
        print(f"build: {name}.cu in {sec:.2f} s")

    # ---- 3: kernel vs plain at the main path's shapes ----
    t0 = time.time()
    cs = build_bench_scene(large=True, device=dev)
    kb = cs.data.bvh
    print(f"large scene built in {time.time() - t0:.2f} s: {kb.metas.shape[0]} nodes, "
          f"{kb.tris.shape[0] // T.LEAF_TRIS} leaves, depth {kb.max_depth}")
    px_np, py_np = sample_pixels(cs.film)
    n_pix = px_np.shape[0]
    px = torch.as_tensor(px_np, device=dev).repeat(2)
    py = torch.as_tensor(py_np, device=dev).repeat(2)
    sidx = torch.arange(2, device=dev, dtype=torch.int32).repeat_interleave(n_pix)
    o, d, _, _ = camera_rays(cs, px, py, sidx)
    n_cam = o.shape[0]
    d = d / d.norm(dim=1, keepdim=True)
    cam = [o.contiguous(), d.contiguous(), torch.full((n_cam,), float("inf"), device=dev),
           torch.zeros(n_cam, dtype=torch.uint8, device=dev)]
    pair = random_rays(2 * n_cam, dev, seed=1)
    pair[3] = torch.cat([torch.zeros(n_cam, dtype=torch.uint8, device=dev),
                         torch.ones(n_cam, dtype=torch.uint8, device=dev)])
    odd = random_rays(100_003, dev, seed=2)
    small = build_bench_scene(large=False, device=dev)
    pair_counts = T.WalkCounts(kb.metas)
    err = max(compare(kb, *cam), compare(kb, *pair, pair_counts), compare(kb, *odd),
              compare(small.data.bvh, *odd))
    timings = {}
    for name, rays in (("camera", cam), ("pair", pair)):
        plain = cuda_ms(lambda: T.traverse_plain(kb, *rays), 2)
        kern = cuda_ms(lambda: T.traverse(kb, *rays), 20)
        kern2 = cuda_ms(lambda: T.traverse(kb, *rays), 20)
        plain2 = cuda_ms(lambda: T.traverse_plain(kb, *rays), 2)
        timings[name] = (min(kern, kern2), min(plain, plain2))
        print(f"traverse {name} launch, {rays[0].shape[0]} rays: kernel "
              f"{timings[name][0]:.3f} ms, plain {timings[name][1]:.3f} ms  [{card}]")
    print(f"kernel vs plain: bit-equal, max |dt| {err}")

    # ---- 4: the smoke scene through the CLI entry ----
    from pbrt_tpu_torch.__main__ import main as cli
    from pbrt_tpu_torch.io.image_io import read_png
    with tempfile.TemporaryDirectory() as tmp:
        scene = os.path.join(tmp, "smoke.pbrt")
        out = os.path.join(tmp, "smoke.png")
        with open(scene, "w") as f:
            f.write('Camera "perspective" "float fov" 45\n'
                    f'Film "image" "integer xresolution" [8] "integer yresolution" [8] '
                    f'"string filename" "{out}"\n'
                    'Sampler "random" "integer pixelsamples" 1\n'
                    'Integrator "path" "integer maxdepth" 1\n'
                    'WorldBegin\nLightSource "infinite" "rgb L" [0.5 0.5 0.5]\nWorldEnd\n')
        if cli(["--device", "cuda", "--quiet", scene]) != 0:
            raise AssertionError("CLI render failed")
        img = read_png(out)
        if img.shape != (8, 8, 3) or not np.all(img == 188):
            raise AssertionError(f"smoke scene is not sRGB 188 everywhere: {np.unique(img)}")
    print("smoke scene: every pixel sRGB 188")

    # ---- 5: the large bench scene, end to end ----
    opts = Options()
    render_sampler_integrator(small, opts)  # warm-up
    torch.cuda.synchronize()
    T.traverse.launches = 0
    t0 = time.time()
    img, cnt, passes = render_sampler_integrator(cs, opts)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = T.traverse.launches
    if tuple(img.shape) != (256, 256, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("large render is not a finite 256x256 image")
    if float(img.sum()) <= 0:
        raise AssertionError("large render is black")
    if launches != 5 * passes:
        raise AssertionError(f"{launches} kernel launches, expected 5 per pass x {passes}")
    samples = 256 * 256 * cs.sampler.rounded_spp()
    live = cnt["camera_rays"] + cnt["shadow_rays"] + cnt["bounce_rays"]
    print(f"large render: {wall:.3f} s, {passes} passes, {launches} kernel launches, "
          f"{samples / wall:.0f} samples/s, {live / wall / 1e6:.3f} M live rays/s "
          f"({live} live rays), mean {float(img.mean()):.5f}  [{card}]")
    busy, n_kern, top, _ = profile_render(cs, opts)
    print(f"large render under torch.profiler: {n_kern} device kernels, {busy:.1f} ms device "
          f"time, {100 * busy / 1e3 / wall:.1f}% of the unprofiled wall; top device ops (ms): "
          f"{top}  [{card}]")

    crop = Options(crop_window=(0.5, 0.625, 0.5, 0.625))
    a, _, _ = render_sampler_integrator(build_bench_scene(True, dev, crop), crop)
    b, _, _ = render_sampler_integrator(build_bench_scene(True, dev, crop), crop)
    if tuple(a.shape) != (32, 32, 3) or not torch.equal(a, b):
        raise AssertionError("the 32x32 crop differs between two renders")
    c, _, _ = render_sampler_integrator(build_bench_scene(True, "cpu", crop), crop)
    a, c = a.cpu().numpy(), c.numpy()
    near = np.all(np.abs(a - c) <= 1e-4 + 1e-3 * np.abs(c), axis=-1).mean()
    if near < 0.99 or abs(a.mean() - c.mean()) > 0.01 * abs(c.mean()):
        raise AssertionError(f"CUDA crop vs CPU crop: {near:.4f} of pixels close, "
                             f"means {a.mean()} / {c.mean()}")
    print(f"32x32 crop: bitwise equal over two CUDA renders; {near:.4f} of pixels within "
          f"rtol 1e-3 / atol 1e-4 of the CPU render, means {a.mean():.6f} / {c.mean():.6f}")

    # ---- 6: the instance kernel vs its plain walk on the instanced scenes ----
    inst_err, inst_timing, inst_counts = 0.0, {}, None
    for animated in (False, True):
        label = "animated" if animated else "static"
        cs_i = build_instanced_bench_scene(animated, dev)
        ib = cs_i.data.ibvh
        print(f"instanced scene ({label}): {ib.metas.shape[0]} nodes, "
              f"{ib.tris.shape[0] // T.LEAF_TRIS} leaf blocks, {ib.iroot.shape[0]} instances, "
              f"walk stack {ib.stack_need} of {I.STACK}")
        tcam = sample_dim(cs_i.sampler, px, py, sidx, 4)
        o_c, d_c, _, _ = camera_rays(cs_i, px, py, sidx)
        d_c = d_c / d_c.norm(dim=1, keepdim=True)
        launches_i = {"camera": world_bounded(cs_i, o_c.contiguous(), d_c.contiguous(), tcam),
                      "shell": world_bounded(cs_i, *shell_rays(2 * n_cam, dev, seed=3)),
                      "ragged": world_bounded(cs_i, *shell_rays(100_003, dev, seed=4))}
        for name, (args, slot_w) in launches_i.items():
            counts = T.WalkCounts(ib.metas) if (name, animated) == ("shell", False) else None
            inst_err = max(inst_err, compare_inst(args, slot_w, counts))
            inst_counts = inst_counts or counts
        for name in ("camera", "shell"):
            args = launches_i[name][0]
            plain = cuda_ms(lambda: I.instance_traverse_plain(*args), 1, warm=False)
            kern = cuda_ms(lambda: I.instance_traverse(*args), 20)
            kern2 = cuda_ms(lambda: I.instance_traverse(*args), 20)
            plain2 = cuda_ms(lambda: I.instance_traverse_plain(*args), 1, warm=False)
            inst_timing[label, name] = (min(kern, kern2), min(plain, plain2))
            print(f"instance_traverse {label} {name} launch, {args[1].shape[0]} rays: kernel "
                  f"{inst_timing[label, name][0]:.3f} ms, plain "
                  f"{inst_timing[label, name][1]:.3f} ms  [{card}]")
        del launches_i, cs_i

    # ---- 7: both instanced scenes, end to end ----
    inst_launches = sum(render_instanced(animated, dev, card) for animated in (False, True))

    # rays in (o, d, t_max, anyhit) and out (t, slot); the occluder seed
    b1_bound = bound_ms(pair_counts, pair[0].shape[0], 24 + 4 + 1 + 8,
                        fixed_bytes=T.LEAF_TRIS * 36 + 9 * 4)
    # rays in (o, d, t_max, time) and out (t, slot, b1, b2, inst); per
    # instance entered its 24 static matrix floats and its root
    b6_bound = bound_ms(inst_counts, 2 * n_cam, 24 + 4 + 4 + 20, 24 * 4 + 4, OPS["lerp"])
    print(f"bounds: bvh_traverse pair launch {b1_bound[0]:.5f} ms ({b1_bound[1]}), "
          f"instance_traverse static shell launch {b6_bound[0]:.5f} ms ({b6_bound[1]})")
    print(json.dumps({"kernels": [{
        "name": "bvh_traverse", "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/bvh_traverse.cu", "replaces": REPLACES["bvh_traverse"],
        "launches": launches, "max_abs_err": err,
        "ms": timings["pair"][0], "plain_ms": timings["pair"][1],
        "bound_ms": b1_bound[0], "bound_by": b1_bound[1], "library_ms": None}, {
        "name": "instance_traverse", "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/instance_traverse.cu",
        "replaces": REPLACES["instance_traverse"],
        "launches": inst_launches, "max_abs_err": inst_err,
        "ms": inst_timing["static", "shell"][0], "plain_ms": inst_timing["static", "shell"][1],
        "bound_ms": b6_bound[0], "bound_by": b6_bound[1], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
