"""Smoke test of the PyTorch port on one CUDA card: python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing catches it):
  1. require a CUDA device; print the card's name and power limit;
  2. build the three kernel sources, the BVH traversals (csrc/bvh_traverse.cu,
     csrc/bvh4_traverse.cu) and the two-level instance traversal
     (csrc/instance_traverse.cu), one nvcc each, started together; print
     each kernel's registers, spill bytes, stack frame and shared memory
     as ptxas reports them (walk_kernel<1,1,0> is B1, <1,1,1> B2 and
     <0,0,1> B4/B5; traverse4_kernel B3; instance_kernel<0>/<1> B6);
  3. hold B1 (walk_kernel over the walk records) against its plain PyTorch
     walk on the large bench knot
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
     device's busy time and B1's device ms), a 32x32 crop bitwise equal over two renders and
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
     and the world. Time both with CUDA events beside B1 on the large
     knot's pair launch; print the time the scene's build took to derive
     the kernel's walk and instance records, and the static shell launch's work per ray (interior
     pops, box tests, triangle tests, instance entries, deepest stack);
  7. render both instanced scenes (256x256, 02sequence at 4 spp, depth 4)
     end to end, three times each after a warm-up: finite and nonzero, 5
     launches per pass of each kernel; one more render under
     torch.profiler for the device's busy time and each kernel's device
     ms; a 32x32 crop bitwise equal
     over two renders and close to the same crop rendered on the CPU with
     the plain walks;
  8. build the PLY bench scene (the 100,352-triangle knot read from a PLY
     file; its tree has more than 32,768 nodes, where the reference runs
     its B5 kernel) and hold the "packet" kernel (B4/B5) against its plain
     walk at the main path's shapes (131,072 camera rays, a 262,144-ray
     pair launch with an any-hit half, 100,003 random rays): t, slot, b1,
     b2 and iters bit-equal on closest-hit rays, equal hit flags on any-hit
     rays, no overflow, and b1/b2 bit-equal to kernel_bary on the hits;
     time it beside B1 on the same tables and rays; print the time the
     scene's build took to derive its walk records;
  9. hold the "all" kernel (B2) on the PLY knot and the 4-wide kernel (B3)
     on both bench knots and the PLY knot (B3 on the small knot's random
     rays, the large knot's camera, pair and random launches and the PLY
     knot's camera and pair launches) against their plain walks the same
     way, and B3 against B1: equal hit masks, t bit-equal on >= 99.99%
     of hits, slot equal except on exact-t ties (rays that differ are
     printed); time both beside B1;
  10. render the PLY bench scene end to end three times after a warm-up and
     its loopsubdiv variant once: finite and nonzero, 5 "packet" launches
     per pass and no B1 launch; one render under torch.profiler for the
     device's busy time and the packet kernel's device ms; a 32x32 crop
     bitwise equal over two renders and close to the CPU crop;
  11. render the sphere scene of BASELINE.json's first configuration (one
     matte sphere, one point light, 256x256, 02sequence at 16 spp, depth 5;
     no triangle, so no BVH kernel) end to end three times after a warm-up:
     finite and nonzero, no kernel launch; one render under torch.profiler
     for the device's kernels, time and busy share; a 32x32 crop over the
     sphere bitwise equal over two renders and close to the CPU crop; time
     the quadric pass on the pair launch's 262,144 rays with CUDA events;
  12. the same for the quadric showcase (the large bench scene with one
     shape of each quadric kind, a cylinder instanced twice, an emitting
     sphere, point, spot and distant lights and 18 curves; 256x256, 4 spp,
     depth 4): 5 B1 launches per pass, B1 bit-equal to its plain walk on
     its tree's camera and pair launches, and the quadric pass's ms on the
     pair launch (bounded by B1's hits, as the main path bounds it) beside
     B1's pair launch on the same tree;
  13. the differentiable pass (BASELINE config 5's stand-in, the scene of
     tests/test_diff.py at 256x256, 02sequence at 8 spp, depth 3):
     grad_wrt_params over every pixel, one pass a sample index, through B1
     (4 launches a pass); the loss with the tape on bitwise equal to the
     same loss without it; every gradient entry finite; the albedo,
     checkerboard tex1 and light gradients of test_diff.py within 5% of
     central differences on the card with its epsilons (albedo and light
     positive); a 32x32 crop's gradients within 1e-3 of their largest
     entry of the CPU's; forward and forward+backward walls (medians of
     three), peak device memory (and its rise over what earlier phases
     hold) and B1 launches a pass;
  14. the textured bench scene (the large scene with an image-mapped floor
     read from a PNG written here, a marble knot, a checkerboard wall and a
     quad with a checkerboard alpha mask; 256x256, 4 spp, depth 4): three
     renders after a warm-up, finite and nonzero, B1 20 launches a pass
     (the walk and 3 alpha re-traces per intersection); one render under
     torch.profiler; a 32x32 crop bitwise equal over two renders and close
     to the CPU's.
The line before the last is the kernels' JSON record, with each kernel's
bound: the larger of its fp32 operations over 67 TFLOP/s and its bytes over
3.35 TB/s (H100 SXM), counted from the plain walk's visits on the timed
launch (the 4-wide walk counts 4 box tests per interior pop). The last line
is {"ok": true, "device": {...}}.
"""
import json
import os
import re
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
from pbrt_tpu_torch.scene.bench import (build_bench_scene, build_diff_scene,
                                        build_instanced_bench_scene, build_ply_bench_scene,
                                        build_quadric_showcase, build_sphere_scene,
                                        build_textured_bench_scene, write_floor_image)
from pbrt_tpu_torch.scene.intersect import _quadric_pass, kernel_bary

# each kernel of the JSON record: the TPU kernel it replaces and its source
REPLACES = {"bvh_traverse": "pbrt_tpu/accel/pallas_traverse.py:1001",
            "bvh_traverse_all": "pbrt_tpu/accel/pallas_traverse.py:698",
            "bvh4_traverse": "pbrt_tpu/accel/pallas_traverse.py:1330",
            "bvh_traverse_block": "pbrt_tpu/accel/pallas_traverse.py:512",
            "bvh_traverse_packet": "pbrt_tpu/accel/pallas_traverse.py:257",
            "instance_traverse": "pbrt_tpu/accel/pallas_instance.py:352"}
SOURCES = {"bvh4_traverse": "pbrt_tpu_torch/csrc/bvh4_traverse.cu",
           "instance_traverse": "pbrt_tpu_torch/csrc/instance_traverse.cu"}
PEAK_FLOPS = 67e12     # H100 SXM, fp32 outside the tensor cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12   # H100 SXM, HBM3
# fp32 operations per step, counted from the kernels' sources (each add, sub,
# mul, div, min, max, abs or compare counts one, a transcendental one):
# ray setup; one child-box slab test; one triangle test; moving a ray into
# prototype space (3x4 matrix on o and d); a static instance's walk matrix
OPS = {"setup": 20, "box": 26, "tri": 51, "xform": 33, "lerp": 24}
# the port's kernel functions, this tree's and those of earlier trees that
# time_kernels.py times beside it (traverse_kernel<1,1,b>: B1 and B2 before
# walk_kernel; packet_kernel: B4/B5 before walk_kernel<0,0,1>)
PORT_KERNELS = ("walk_kernel", "traverse_kernel", "packet_kernel", "traverse4_kernel",
                "instance_kernel")


def kernel_of(function):
    """A port kernel's name in the JSON record ("bvh_traverse", ...) from
    its demangled function name as torch.profiler reports it, or None."""
    m = re.search(r"::(\w+_kernel)(?:<([^>]*)>)?", function)
    if m is None or m.group(1) not in PORT_KERNELS:
        return None
    flags = tuple(a.strip() in ("true", "1", "(bool)1") for a in (m.group(2) or "").split(","))
    return {"traverse4_kernel": "bvh4_traverse", "instance_kernel": "instance_traverse",
            "packet_kernel": "bvh_traverse_packet"}.get(m.group(1)) or {
        (True, True, False): "bvh_traverse", (True, True, True): "bvh_traverse_all",
        (False, False, True): "bvh_traverse_packet"}.get(flags)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps, warm=True):
    """CUDA-event time of one call of fn, averaged over reps calls."""
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


def pair_launch(n_cam, dev):
    """The pair launch: 2 n_cam random rays, the second half any-hit."""
    pair = random_rays(2 * n_cam, dev, seed=1)
    pair[3] = torch.cat([torch.zeros(n_cam, dtype=torch.uint8, device=dev),
                         torch.ones(n_cam, dtype=torch.uint8, device=dev)])
    return pair


def camera_launch(cs, dev):
    """The camera launch of a bench scene: every pixel at samples 0 and 1,
    unit directions -> (o, d, time), 131,072 rays at 256x256."""
    px_np, py_np = sample_pixels(cs.film)
    n_pix = px_np.shape[0]
    px = torch.as_tensor(px_np, device=dev).repeat(2)
    py = torch.as_tensor(py_np, device=dev).repeat(2)
    sidx = torch.arange(2, device=dev, dtype=torch.int32).repeat_interleave(n_pix)
    rays, _, _ = camera_rays(cs, px, py, sidx)
    d = rays.d / rays.d.norm(dim=1, keepdim=True)
    return rays.o.contiguous(), d.contiguous(), sample_dim(cs.sampler, px, py, sidx, 4)


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


def zero_counts():
    """Set every kernel's launch count to 0."""
    T.traverse.launches = T.traverse4.launches = I.instance_traverse.launches = 0
    T.traverse.bary_launches = dict.fromkeys(T.traverse.bary_launches, 0)


def read_counts():
    """-> {kernel name: launches since zero_counts()}."""
    return {"bvh_traverse": T.traverse.launches, "bvh4_traverse": T.traverse4.launches,
            "instance_traverse": I.instance_traverse.launches,
            **{f"bvh_traverse_{v}": c for v, c in T.traverse.bary_launches.items()}}


def kernel_and_plain(name, kb):
    """(launch, plain walk, launch count) of a BVH kernel on tables kb: the
    2-wide ones by name, "bvh4_traverse" on a KernelBVH4."""
    if name == "bvh4_traverse":
        return (lambda *r: T.traverse4(kb, *r), lambda *r: T.traverse4_plain(kb, *r),
                lambda: T.traverse4.launches)
    variant = name[len("bvh_traverse_"):] or "queue"
    return (lambda *r: T.traverse(kb, *r, variant=variant),
            lambda *r: T.traverse_plain(kb, r[0], r[1], r[2], r[3], r[4], variant),
            lambda: read_counts()[name])


def compare(kb, o, d, t_max, anyhit, counts=None, name="bvh_traverse"):
    """Kernel vs plain on one launch -> max |dt| over closest hits. t and
    slot (and b1/b2, where the kernel returns them) bit-equal on closest-hit
    rays, equal any-hit flags, equal iters and no overflow; b1/b2 also
    bit-equal to kernel_bary on the closest hits."""
    launch, plain, launches = kernel_and_plain(name, kb)
    before = launches()
    got = launch(o, d, t_max, anyhit)
    torch.cuda.synchronize()
    if launches() != before + 1:
        raise AssertionError(f"the {name} launch counter did not advance")
    want = plain(o, d, t_max, anyhit, counts)
    cl = anyhit == 0
    for a, b in zip(got[:-1], want[:-1]):
        if not torch.equal(a[cl], b[cl]):
            raise AssertionError(f"{name} and its plain walk differ on closest-hit rays")
    t, s, it = got[0], got[1], got[-1]
    if not torch.equal(s[~cl] >= 0, want[1][~cl] >= 0):
        raise AssertionError(f"{name} and its plain walk differ in any-hit flags")
    if not torch.equal(it, want[-1]) or bool(torch.any(it & T.OVF_BIT)):
        raise AssertionError(f"{name}: iters differ or a stack overflowed: {int(it.max())}")
    hit = cl & (s >= 0)
    if not bool(hit.any()):
        raise AssertionError("no closest-hit ray hit anything")
    if len(got) == 5:
        tris = (kb.kb if name == "bvh4_traverse" else kb).tris
        rows = tris[s[hit].long()]
        b1, b2 = kernel_bary(o[hit], d[hit], rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])
        if not (torch.equal(b1, got[2][hit]) and torch.equal(b2, got[3][hit])):
            raise AssertionError(f"{name}: b1/b2 differ from kernel_bary")
    # equal values count 0, so a hit at t = inf (a subnormal det) is no NaN
    a, b = t[hit], want[0][hit]
    return float(torch.where(a == b, 0.0, (a - b).abs()).max())


def compare_with_b1(kb4, kb, rays, label):
    """B3 against B1 on one launch: equal hit masks, t bit-equal on >=
    99.99% of closest hits, slot equal except on exact-t ties; prints every
    ray that differs."""
    t4, s4 = T.traverse4(kb4, *rays)[:2]
    t1, s1, _ = T.traverse(kb, *rays)
    cl = rays[3] == 0
    if not torch.equal(s4 >= 0, s1 >= 0):
        raise AssertionError(f"B3 and B1 hit masks differ ({label})")
    hit = cl & (s1 >= 0)
    t_same = t4 == t1
    diff = torch.nonzero(hit & (~t_same | (s4 != s1))).squeeze(1)
    for i in diff.tolist()[:20]:
        print(f"  B3 vs B1 ({label}) ray {i}: t {float(t4[i])!r} / {float(t1[i])!r}, "
              f"slot {int(s4[i])} / {int(s1[i])}")
    frac = float(t_same[hit].float().mean())
    ties = int((hit & t_same & (s4 != s1)).sum())
    print(f"B3 vs B1 ({label}, {rays[0].shape[0]} rays): equal hit masks, t bit-equal on "
          f"{frac:.6f} of {int(hit.sum())} closest hits, {ties} exact-t ties with another slot, "
          f"{len(diff)} rays differ")
    if frac < 0.9999:
        raise AssertionError(f"B3 and B1 t differ on more than 0.01% of hits ({label})")


def time_kernels(names_tables, rays, label, card, plain_name=None):
    """CUDA-event times of kernels on one launch, in turns (each twice,
    the minimum), and of one plain walk -> {name: ms}."""
    out = {}
    for name, tables in names_tables:
        launch = kernel_and_plain(name, tables)[0]
        out[name] = cuda_ms(lambda: launch(*rays), 20)
    for name, tables in names_tables:
        launch = kernel_and_plain(name, tables)[0]
        out[name] = min(out[name], cuda_ms(lambda: launch(*rays), 20))
    if plain_name is not None:
        plain = kernel_and_plain(plain_name, dict(names_tables)[plain_name])[1]
        out["plain"] = cuda_ms(lambda: plain(*rays, None), 1, warm=False)
    print(f"{label}, {rays[0].shape[0]} rays: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in out.items()) + f"  [{card}]")
    return out


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
    rate -> (ms, "operations" or "bytes"). counts says how many boxes an
    interior pop tests and how many bytes an interior entry holds."""
    n_seen = int(counts.seen.sum())
    interior, leaf_tris, inst_leaves = counts.touched()
    ops = (n * OPS["setup"] + counts.interior * counts.boxes * OPS["box"]
           + counts.tri_tests * OPS["tri"]
           + counts.enters * (enter_ops + OPS["xform"] + 2 * OPS["setup"]))
    byts = (n * ray_bytes + -(-n // T.GROUP) * 4 + n_seen * 4 + interior * counts.node_bytes
            + leaf_tris * 36 + inst_leaves * inst_bytes + fixed_bytes)
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, byts / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def profile_render(cs, opts):
    """One render under torch.profiler -> (device ms, device kernel count,
    the 5 ops with the most device time, {port kernel (`kernel_of`): its
    device ms in the render})."""
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
    mine = dict.fromkeys(REPLACES, 0.0)
    for e in avgs:
        name = kernel_of(e.key)
        if e.device_type == cuda and name:
            mine[name] += e.self_device_time_total / 1e3
    return busy, len(kernels), top, mine


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
        zero_counts()
        t0 = time.time()
        img, cnt, passes = render_sampler_integrator(cs, opts)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        counts = read_counts()
        launches = (counts["bvh_traverse"], counts["instance_traverse"])
        check_render(img, counts, {"bvh_traverse": 5 * passes,
                                   "instance_traverse": 5 * passes}, f"{label} instanced")
    wall = sorted(walls)[1]
    samples = 256 * 256 * cs.sampler.rounded_spp()
    live = cnt["camera_rays"] + cnt["shadow_rays"] + cnt["bounce_rays"]
    print(f"instanced render ({label}): {', '.join(f'{w:.3f}' for w in walls)} s, median "
          f"{wall:.3f} s; {passes} passes, {launches[0]} BVH and {launches[1]} instance kernel "
          f"launches each; {samples / wall:.0f} samples/s, {live / wall / 1e6:.3f} M live "
          f"rays/s ({live} live rays), mean {float(img.mean()):.5f}  [{card}]")

    busy, n_kern, top, mine = profile_render(cs, opts)
    print(f"instanced render ({label}) under torch.profiler: {n_kern} device kernels, "
          f"{busy:.1f} ms device time, {100 * busy / 1e3 / wall:.1f}% of the unprofiled wall; "
          f"instance kernel {mine['instance_traverse']:.3f} ms, B1 "
          f"{mine['bvh_traverse']:.3f} ms; top device ops (ms): {top}  [{card}]")

    b, _, _ = render_sampler_integrator(build_instanced_bench_scene(animated, dev, crop), crop)
    c, _, _ = render_sampler_integrator(build_instanced_bench_scene(animated, "cpu", crop), crop)
    check_crop(a, b, c, label)
    return launches[1]


def check_render(img, launches, want, label, res=256):
    """A bench render: a finite, nonzero res x res image, and kernel
    launches as in want ({kernel: count}; every other kernel none)."""
    if tuple(img.shape) != (res, res, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label} render is not a finite {res}x{res} image")
    if float(img.sum()) <= 0:
        raise AssertionError(f"{label} render is black")
    want = {**dict.fromkeys(launches, 0), **want}
    if launches != want:
        raise AssertionError(f"{label} render launches {launches}, expected {want}")


def check_crop(a, b, c, label):
    """A 32x32 crop: bitwise equal over two card renders (a, b) and within
    rtol 1e-3 / atol 1e-4 of the CPU render (c) on >= 99% of pixels."""
    if tuple(a.shape) != (32, 32, 3) or not torch.equal(a, b):
        raise AssertionError(f"the {label} 32x32 crop differs between two renders")
    a, c = a.cpu().numpy(), c.numpy()
    near = np.all(np.abs(a - c) <= 1e-4 + 1e-3 * np.abs(c), axis=-1).mean()
    if near < 0.99 or abs(a.mean() - c.mean()) > 0.01 * abs(c.mean()):
        raise AssertionError(f"{label} CUDA crop vs CPU crop: {near:.4f} of pixels close, "
                             f"means {a.mean()} / {c.mean()}")
    print(f"{label} 32x32 crop: bitwise equal over two CUDA renders; {near:.4f} of pixels "
          f"within rtol 1e-3 / atol 1e-4 of the CPU render, means {a.mean():.6f} / "
          f"{c.mean():.6f}")


def render_quadric_scene(label, build, crop, want, dev, card):
    """Build and render one scene with quadrics end to end (phases 11 and
    12): three timed renders after a warm-up, each finite and nonzero with
    the launches want ({kernel: launches per pass}); one render under
    torch.profiler; the crop bitwise equal over two renders and close to
    the CPU crop -> the scene built on the card."""
    t0 = time.time()
    cs = build(dev)
    print(f"{label} scene built in {time.time() - t0:.2f} s: {cs.flags.n_tris} triangles, "
          f"{cs.flags.n_quadrics} quadrics of kinds {tuple(cs.data.quads.by_kind)}, "
          f"{cs.flags.n_lights} lights of kinds {cs.data.lights.kinds}")
    crop = Options(crop_window=crop)
    a, _, _ = render_sampler_integrator(build(dev, crop), crop)
    torch.cuda.synchronize()   # the crop render is the warm-up
    opts = Options()
    walls = []
    for _ in range(3):
        zero_counts()
        t0 = time.time()
        img, cnt, passes = render_sampler_integrator(cs, opts)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        launches = read_counts()
        check_render(img, launches, {k: v * passes for k, v in want.items()}, label)
    wall = sorted(walls)[1]
    samples = 256 * 256 * cs.sampler.rounded_spp()
    live = cnt["camera_rays"] + cnt["shadow_rays"] + cnt["bounce_rays"]
    print(f"{label} render: {', '.join(f'{w:.3f}' for w in walls)} s, median {wall:.3f} s; "
          f"{passes} passes, kernel launches {launches}; {samples / wall:.0f} samples/s, "
          f"{live / wall / 1e6:.3f} M live rays/s ({live} live rays), mean "
          f"{float(img.mean()):.5f}  [{card}]")
    busy, n_kern, top, mine = profile_render(cs, opts)
    print(f"{label} render under torch.profiler: {n_kern} device kernels, {busy:.1f} ms device "
          f"time, {100 * busy / 1e3 / wall:.1f}% of the unprofiled wall; B1 "
          f"{mine['bvh_traverse']:.3f} ms; top device ops (ms): {top}  [{card}]")
    b, _, _ = render_sampler_integrator(build(dev, crop), crop)
    c, _, _ = render_sampler_integrator(build("cpu", crop), crop)
    check_crop(a, b, c, label)
    return cs


def diff_pass(dev, card, res=256):
    """Phase 13: the differentiable pass on the card, at res x res."""
    from pbrt_tpu_torch.diff import DiffParams, get_params, grad_wrt_params, render_samples
    n_samples, depth = 8, 3
    t0 = time.time()
    cs = build_diff_scene(res, dev)
    print(f"differentiable scene built in {time.time() - t0:.2f} s: {cs.flags.n_tris} "
          f"triangles, {cs.flags.n_quadrics} quadric, texture kinds {cs.flags.tex_kinds}")
    xs, ys = np.meshgrid(np.arange(res), np.arange(res))
    px, py = (torch.as_tensor(a.ravel().astype(np.int32), device=dev) for a in (xs, ys))

    def loss_no_tape(c, params, px, py):
        total = torch.zeros((), device=px.device)
        with torch.no_grad():
            for s in range(n_samples):
                sidx = torch.full(px.shape, s, dtype=torch.int32, device=px.device)
                total = total + torch.mean(render_samples(c, params, px, py, sidx, depth))
        return total / n_samples

    grad_wrt_params(build_diff_scene(32, dev), px[:1024], py[:1024], 1, depth)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()   # earlier phases' tensors still alive
    zero_counts()
    loss, grad = grad_wrt_params(cs, px, py, n_samples, depth)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {**dict.fromkeys(launches, 0), "bvh_traverse": 4 * n_samples}
    if launches != want:
        raise AssertionError(f"differentiable pass launches {launches}, expected {want}")
    p0 = DiffParams(*(t.detach() for t in get_params(cs)))
    plain = loss_no_tape(cs, p0, px, py)
    if not torch.equal(loss, plain):
        raise AssertionError(f"loss with the tape {float(loss)!r} != without {float(plain)!r}")
    if not all(bool(torch.isfinite(g).all()) for g in grad):
        raise AssertionError("a gradient entry is not finite")
    for name, table, index, eps in (("albedo", "mat_const", (1, 0, 0), 1e-3),
                                    ("texture", "tex_params", (0, 1), 1e-3),
                                    ("light", "light_L", (0, 1), 1e-2)):
        bumped = []
        for e in (eps, -eps):
            t = getattr(p0, table).clone()
            t[index] += e
            bumped.append(float(loss_no_tape(cs, p0._replace(**{table: t}), px, py)))
        fd = (bumped[0] - bumped[1]) / (2 * eps)
        ad = float(getattr(grad, table)[index])
        print(f"d loss / d {name} ({table}{list(index)}): autograd {ad!r}, central difference "
              f"{fd!r} (eps {eps}), {abs(ad - fd) / max(abs(fd), 1e-4):.2e} relative")
        if abs(ad - fd) >= 0.05 * max(abs(fd), 1e-4) or (name != "texture" and ad <= 0):
            raise AssertionError(f"the {name} gradient disagrees with central differences")
    walls = {"forward": [], "forward+backward": []}
    for _ in range(3):
        t0 = time.time()
        loss_no_tape(cs, p0, px, py)
        torch.cuda.synchronize()
        walls["forward"].append(time.time() - t0)
        t0 = time.time()
        grad_wrt_params(cs, px, py, n_samples, depth)
        torch.cuda.synchronize()
        walls["forward+backward"].append(time.time() - t0)
    c0 = res // 2 - 16
    crop = ((ys >= c0) & (ys < c0 + 32) & (xs >= c0) & (xs < c0 + 32)).ravel()
    got = grad_wrt_params(cs, px[crop], py[crop], n_samples, depth)[1]
    cpu_px, cpu_py = (torch.as_tensor(a.ravel()[crop].astype(np.int32)) for a in (xs, ys))
    want_cpu = grad_wrt_params(build_diff_scene(res, "cpu"), cpu_px, cpu_py, n_samples, depth)[1]
    worst = max(float((a.cpu() - b).abs().max()) / float(b.abs().max())
                for a, b in zip(got, want_cpu))
    if worst > 1e-3:
        raise AssertionError(f"crop gradients on the card vs the CPU: {worst:.2e} of the "
                             "largest entry")
    print(f"differentiable pass, {res}x{res} at {n_samples} spp, depth {depth}: loss {float(loss)!r} "
          f"bitwise equal with and without the tape; gradients finite; walls (medians of "
          f"three) forward {sorted(walls['forward'])[1]:.3f} s, forward+backward "
          f"{sorted(walls['forward+backward'])[1]:.3f} s; peak device memory "
          f"{peak / 2 ** 20:.1f} MiB, {(peak - held) / 2 ** 20:.1f} MiB above the "
          f"{held / 2 ** 20:.1f} MiB held before; B1 {launches['bvh_traverse'] // n_samples} launches a pass; "
          f"32x32 crop gradients within {worst:.2e} of the CPU's largest entry  [{card}]")


def textured_render(dev, card, large=True):
    """Phase 14: the textured bench scene (large: 256x256, else 64x64),
    end to end."""
    with tempfile.TemporaryDirectory(prefix="textured_") as tmp:
        image = os.path.join(tmp, "floor.png")
        write_floor_image(image)
        t0 = time.time()
        cs = build_textured_bench_scene(image, large, dev)
        print(f"textured scene built in {time.time() - t0:.2f} s: {cs.flags.n_tris} triangles, "
              f"texture kinds {cs.flags.tex_kinds}, alpha mask kinds {cs.flags.alpha_kinds}, "
              f"atlas {tuple(cs.data.tex.atlas.shape)}")
        crop = Options(crop_window=(0.5, 0.625, 0.5, 0.625))
        a, _, _ = render_sampler_integrator(build_textured_bench_scene(image, large, dev, crop),
                                            crop)
        torch.cuda.synchronize()   # the crop render is the warm-up
        opts = Options()
        walls = []
        for _ in range(3):
            zero_counts()
            t0 = time.time()
            img, cnt, passes = render_sampler_integrator(cs, opts)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            launches = read_counts()
            check_render(img, launches, {"bvh_traverse": 20 * passes}, "textured",
                         res=256 if large else 64)
        wall = sorted(walls)[1]
        live = cnt["camera_rays"] + cnt["shadow_rays"] + cnt["bounce_rays"]
        print(f"textured render: {', '.join(f'{w:.3f}' for w in walls)} s, median {wall:.3f} s; "
              f"{passes} passes, B1 {launches['bvh_traverse'] // passes} launches a pass; "
              f"{img.shape[0] * img.shape[1] * cs.sampler.rounded_spp() / wall:.0f} samples/s, "
              f"{live / wall / 1e6:.3f} M live rays/s ({live} live rays), mean "
              f"{float(img.mean()):.5f}  [{card}]")
        busy, n_kern, top, mine = profile_render(cs, opts)
        print(f"textured render under torch.profiler: {n_kern} device kernels, {busy:.1f} ms "
              f"device time, {100 * busy / 1e3 / wall:.1f}% of the unprofiled wall; B1 "
              f"{mine['bvh_traverse']:.3f} ms; top device ops (ms): {top}  [{card}]")
        b, _, _ = render_sampler_integrator(build_textured_bench_scene(image, large, dev, crop),
                                            crop)
        c, _, _ = render_sampler_integrator(build_textured_bench_scene(image, large, "cpu", crop),
                                            crop)
        check_crop(a, b, c, "textured")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))

    # ---- 2: build ----
    for name, sec in native.load_all(["bvh_traverse", "bvh4_traverse",
                                      "instance_traverse"]).items():
        print(f"build: {name}.cu in {sec:.2f} s; " + "; ".join(
            f"{k}: {v.get('registers')} registers, {v.get('spill_stores')} / "
            f"{v.get('spill_loads')} bytes spill stores / loads, {v.get('stack_frame')} bytes "
            f"stack frame, {v.get('static_smem')} bytes static shared memory"
            for k, v in native.kernel_resources(name).items()))

    # ---- 3: kernel vs plain at the main path's shapes ----
    t0 = time.time()
    cs = build_bench_scene(large=True, device=dev)
    kb = cs.data.bvh
    print(f"large scene built in {time.time() - t0:.2f} s: {kb.metas.shape[0]} nodes, "
          f"{kb.tris.shape[0] // T.LEAF_TRIS} leaves, depth {kb.max_depth}")
    o, d, _ = camera_launch(cs, dev)
    n_cam = o.shape[0]
    cam = [o, d, torch.full((n_cam,), float("inf"), device=dev),
           torch.zeros(n_cam, dtype=torch.uint8, device=dev)]
    pair = pair_launch(n_cam, dev)
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
    zero_counts()
    t0 = time.time()
    img, cnt, passes = render_sampler_integrator(cs, opts)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()["bvh_traverse"]
    check_render(img, read_counts(), {"bvh_traverse": 5 * passes}, "large")
    samples = 256 * 256 * cs.sampler.rounded_spp()
    live = cnt["camera_rays"] + cnt["shadow_rays"] + cnt["bounce_rays"]
    print(f"large render: {wall:.3f} s, {passes} passes, {launches} kernel launches, "
          f"{samples / wall:.0f} samples/s, {live / wall / 1e6:.3f} M live rays/s "
          f"({live} live rays), mean {float(img.mean()):.5f}  [{card}]")
    busy, n_kern, top, mine = profile_render(cs, opts)
    print(f"large render under torch.profiler: {n_kern} device kernels, {busy:.1f} ms device "
          f"time, {100 * busy / 1e3 / wall:.1f}% of the unprofiled wall; B1 "
          f"{mine['bvh_traverse']:.3f} ms; top device ops (ms): {top}  [{card}]")

    crop = Options(crop_window=(0.5, 0.625, 0.5, 0.625))
    a, _, _ = render_sampler_integrator(build_bench_scene(True, dev, crop), crop)
    b, _, _ = render_sampler_integrator(build_bench_scene(True, dev, crop), crop)
    c, _, _ = render_sampler_integrator(build_bench_scene(True, "cpu", crop), crop)
    check_crop(a, b, c, "large")

    # ---- 6: the instance kernel vs its plain walk on the instanced scenes ----
    inst_err, inst_timing, inst_counts = 0.0, {}, None
    for animated in (False, True):
        label = "animated" if animated else "static"
        cs_i = build_instanced_bench_scene(animated, dev)
        ib = cs_i.data.ibvh
        print(f"instanced scene ({label}): {ib.metas.shape[0]} nodes, "
              f"{ib.tris.shape[0] // T.LEAF_TRIS} leaf blocks, {ib.iroot.shape[0]} instances, "
              f"walk stack {ib.stack_need} of {I.STACK}; {ib.recs.shape[0]} walk records and "
              f"{ib.irec.shape[0]} instance records derived in {ib.recs_ms:.1f} ms at its build")
        launches_i = {"camera": world_bounded(cs_i, *camera_launch(cs_i, dev)),
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
            b1 = cuda_ms(lambda: T.traverse(kb, *pair), 20)   # the yardstick, B1
            kern2 = cuda_ms(lambda: I.instance_traverse(*args), 20)
            b1 = min(b1, cuda_ms(lambda: T.traverse(kb, *pair), 20))
            plain2 = cuda_ms(lambda: I.instance_traverse_plain(*args), 1, warm=False)
            inst_timing[label, name] = (min(kern, kern2), min(plain, plain2))
            print(f"instance_traverse {label} {name} launch, {args[1].shape[0]} rays: kernel "
                  f"{inst_timing[label, name][0]:.3f} ms, plain "
                  f"{inst_timing[label, name][1]:.3f} ms; B1 on the large knot's pair launch "
                  f"{b1:.3f} ms  [{card}]")
        del launches_i, cs_i
    n_shell = 2 * n_cam
    print(f"work per ray of the static shell launch (plain walk): "
          f"{inst_counts.interior / n_shell:.2f} interior pops, "
          f"{inst_counts.interior * inst_counts.boxes / n_shell:.2f} box tests, "
          f"{inst_counts.tri_tests / n_shell:.2f} triangle tests, "
          f"{inst_counts.enters / n_shell:.2f} instance entries; stack at most "
          f"{inst_counts.max_stack} entries")

    # ---- 7: both instanced scenes, end to end ----
    inst_launches = sum(render_instanced(animated, dev, card) for animated in (False, True))

    # ---- 8: the PLY bench scene's tree through the "packet" kernel (B4/B5) ----
    ply_dir = tempfile.TemporaryDirectory(prefix="ply_bench_")
    t0 = time.time()
    cs_p = build_ply_bench_scene(ply_dir.name, dev)
    kbp = cs_p.data.bvh
    print(f"PLY bench scene built in {time.time() - t0:.2f} s: {cs_p.flags.n_tris} triangles, "
          f"{kbp.metas.shape[0]} nodes, {kbp.tris.shape[0] // T.LEAF_TRIS} leaves, depth "
          f"{kbp.max_depth}, {T.tpu_table_bytes(kbp) / 2 ** 20:.3f} MiB of reference kernel "
          f"tables")
    print(f"PLY tree: {kbp.recs.shape[0]} walk records derived in {kbp.recs_ms:.1f} ms at "
          f"its build")
    cam_p = [*camera_launch(cs_p, dev)[:2], cam[2], cam[3]]
    counts = {n: T.WalkCounts(kbp.metas) for n in ("bvh_traverse_packet", "bvh_traverse_all")}
    errs = {"bvh_traverse_packet": max(
        compare(kbp, *cam_p, name="bvh_traverse_packet"),
        compare(kbp, *pair, counts["bvh_traverse_packet"], name="bvh_traverse_packet"),
        compare(kbp, *odd, name="bvh_traverse_packet"))}
    errs["bvh_traverse_block"] = compare(kbp, *pair, name="bvh_traverse_block")
    ply_b1_counts = T.WalkCounts(kbp.metas)
    compare(kbp, *pair, ply_b1_counts)
    print(f"packet kernel vs plain on the PLY tree: bit-equal in t, slot, b1, b2 and iters, "
          f"b1/b2 equal to kernel_bary, max |dt| {errs['bvh_traverse_packet']}")
    p_time = {}
    for label, rays in (("camera", cam_p), ("pair", pair)):
        p_time[label] = time_kernels(
            [("bvh_traverse_packet", kbp), ("bvh_traverse_block", kbp), ("bvh_traverse", kbp)],
            rays, f"PLY tree {label} launch", card, plain_name="bvh_traverse_packet")

    # ---- 9: B2 on the PLY tree, B3 on both bench knots and the PLY tree ----
    errs["bvh_traverse_all"] = max(
        compare(kbp, *cam_p, name="bvh_traverse_all"),
        compare(kbp, *pair, counts["bvh_traverse_all"], name="bvh_traverse_all"),
        compare(kbp, *odd, name="bvh_traverse_all"))
    kb4s = {"small": T.pack_kernel_bvh4(small.data.bvh), "large": T.pack_kernel_bvh4(kb),
            "PLY": T.pack_kernel_bvh4(kbp)}
    for label, k4 in kb4s.items():
        print(f"BVH4 of the {label} tree: {k4.axs4.shape[0]} nodes, stack need "
              f"{k4.stack_need} of {T.STACK4}")
    counts["bvh4_traverse"] = T.WalkCounts.for_bvh4(kb4s["PLY"])
    errs["bvh4_traverse"] = max(
        compare(kb4s["small"], *odd, name="bvh4_traverse"),
        compare(kb4s["large"], *cam, name="bvh4_traverse"),
        compare(kb4s["large"], *pair, name="bvh4_traverse"),
        compare(kb4s["large"], *odd, name="bvh4_traverse"),
        compare(kb4s["PLY"], *cam_p, name="bvh4_traverse"),
        compare(kb4s["PLY"], *pair, counts["bvh4_traverse"], name="bvh4_traverse"))
    print(f"all and BVH4 kernels vs plain: bit-equal in t, slot, b1, b2 and iters, b1/b2 equal "
          f"to kernel_bary, max |dt| {max(errs['bvh_traverse_all'], errs['bvh4_traverse'])}")
    compare_with_b1(kb4s["small"], small.data.bvh, odd, "small knot, random rays")
    compare_with_b1(kb4s["large"], kb, cam, "large knot, camera rays")
    compare_with_b1(kb4s["large"], kb, pair, "large knot, pair launch")
    compare_with_b1(kb4s["PLY"], kbp, pair, "PLY knot, pair launch")
    for label, rays in (("camera", cam_p), ("pair", pair)):
        p_time[label].update(time_kernels(
            [("bvh_traverse_all", kbp), ("bvh4_traverse", kb4s["PLY"]), ("bvh_traverse", kbp)],
            rays, f"PLY tree {label} launch", card))
        p_time[label]["plain4"] = cuda_ms(lambda: T.traverse4_plain(kb4s["PLY"], *rays), 1,
                                          warm=False)
        p_time[label]["plain_all"] = cuda_ms(
            lambda: T.traverse_plain(kbp, *rays, variant="all"), 1, warm=False)
    for label, rays in (("camera", cam), ("pair", pair)):
        time_kernels([("bvh4_traverse", kb4s["large"]), ("bvh_traverse_all", kb),
                      ("bvh_traverse", kb)], rays, f"large knot {label} launch", card)

    # ---- 10: the PLY bench scene and its loopsubdiv variant, end to end ----
    crop = Options(crop_window=(0.5, 0.625, 0.5, 0.625))
    a, _, _ = render_sampler_integrator(build_ply_bench_scene(ply_dir.name, dev, options=crop),
                                        crop)
    torch.cuda.synchronize()   # the crop render is the warm-up
    walls = []
    for _ in range(3):
        zero_counts()
        t0 = time.time()
        img, cnt, passes = render_sampler_integrator(cs_p, opts)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        ply_launches = read_counts()
        check_render(img, ply_launches, {"bvh_traverse_packet": 5 * passes}, "PLY")
    wall = sorted(walls)[1]
    live = cnt["camera_rays"] + cnt["shadow_rays"] + cnt["bounce_rays"]
    print(f"PLY render: {', '.join(f'{w:.3f}' for w in walls)} s, median {wall:.3f} s; {passes} "
          f"passes, {ply_launches['bvh_traverse_packet']} packet and "
          f"{ply_launches['bvh_traverse']} B1 launches each; "
          f"{256 * 256 * cs_p.sampler.rounded_spp() / wall:.0f} samples/s, "
          f"{live / wall / 1e6:.3f} M live rays/s ({live} live rays), mean "
          f"{float(img.mean()):.5f}  [{card}]")
    busy, n_kern, top, mine = profile_render(cs_p, opts)
    print(f"PLY render under torch.profiler: {n_kern} device kernels, {busy:.1f} ms device time, "
          f"{100 * busy / 1e3 / wall:.1f}% of the unprofiled wall; packet kernel "
          f"{mine['bvh_traverse_packet']:.3f} ms; top device ops (ms): {top}  [{card}]")
    b, _, _ = render_sampler_integrator(build_ply_bench_scene(ply_dir.name, dev, options=crop),
                                        crop)
    c, _, _ = render_sampler_integrator(build_ply_bench_scene(ply_dir.name, "cpu", options=crop),
                                        crop)
    check_crop(a, b, c, "PLY")
    t0 = time.time()
    cs_l = build_ply_bench_scene(ply_dir.name, dev, loopsubdiv=True)
    print(f"loopsubdiv scene built in {time.time() - t0:.2f} s: {cs_l.flags.n_tris} triangles, "
          f"{cs_l.data.bvh.metas.shape[0]} nodes, "
          f"{T.tpu_table_bytes(cs_l.data.bvh) / 2 ** 20:.3f} MiB of reference kernel tables")
    zero_counts()
    t0 = time.time()
    img, cnt, passes = render_sampler_integrator(cs_l, opts)
    torch.cuda.synchronize()
    wall_l = time.time() - t0
    check_render(img, read_counts(), {"bvh_traverse_packet": 5 * passes}, "loopsubdiv")
    print(f"loopsubdiv render: {wall_l:.3f} s, {passes} passes, mean {float(img.mean()):.5f}  "
          f"[{card}]")
    ply_dir.cleanup()

    # ---- 11: the sphere scene of BASELINE.json's first configuration ----
    cs_s = render_quadric_scene("sphere", lambda dv, o=None: build_sphere_scene(dv, o),
                                (0.4375, 0.5625, 0.4375, 0.5625), {}, dev, card)
    n_pair = pair[0].shape[0]
    unbounded = torch.full((n_pair,), float("inf"), device=dev)
    q_ms = cuda_ms(lambda: _quadric_pass(cs_s.data.quads, pair[0], pair[1], unbounded), 20)
    print(f"quadric pass of the sphere scene (1 sphere), {n_pair} rays: {q_ms:.3f} ms  [{card}]")
    del cs_s

    # ---- 12: the quadric showcase ----
    cs_q = render_quadric_scene("showcase", lambda dv, o=None: build_quadric_showcase(dv, o),
                                (0.5, 0.625, 0.5, 0.625), {"bvh_traverse": 5}, dev, card)
    kbq = cs_q.data.bvh
    cam_q = [*camera_launch(cs_q, dev)[:2], cam[2], cam[3]]
    err_q = max(compare(kbq, *cam_q), compare(kbq, *pair))
    t_q = T.traverse(kbq, *pair)[0]
    q_ms, b1_ms = [], []
    for _ in range(2):   # in turns, each the least of two
        q_ms.append(cuda_ms(lambda: _quadric_pass(cs_q.data.quads, pair[0], pair[1], t_q),
                            20))
        b1_ms.append(cuda_ms(lambda: T.traverse(kbq, *pair), 20))
    q_t, q_id = _quadric_pass(cs_q.data.quads, pair[0], pair[1], t_q)
    print(f"showcase tree: {kbq.metas.shape[0]} nodes; B1 vs plain on its camera and pair "
          f"launches: bit-equal, max |dt| {err_q}; pair launch, {n_pair} rays: quadric pass "
          f"{min(q_ms):.3f} ms ({int((q_id >= 0).sum())} quadric hits below B1's t), B1 "
          f"{min(b1_ms):.3f} ms  [{card}]")
    del cs_q, kbq, cam_q, t_q

    # ---- 13: the differentiable pass; 14: the textured bench scene ----
    diff_pass(dev, card)
    textured_render(dev, card)

    print("work per ray of the PLY tree's pair launch (plain walks): " + ", ".join(
        f"{name} {c.interior / n_pair:.2f} interior pops, {c.interior * c.boxes / n_pair:.2f} "
        f"box tests, {c.tri_tests / n_pair:.2f} triangle tests, stack at most {c.max_stack}"
        for name, c in (("bvh_traverse", ply_b1_counts), *counts.items())))

    # rays in (o, d, t_max, anyhit) and out (t, slot); the occluder seed
    seed_bytes = T.LEAF_TRIS * 36 + 9 * 4
    bounds = {"bvh_traverse": bound_ms(pair_counts, pair[0].shape[0], 24 + 4 + 1 + 8,
                                       fixed_bytes=seed_bytes)}
    # the same plus b1/b2 out; the packet walk has no seed
    for name in ("bvh_traverse_packet", "bvh_traverse_all", "bvh4_traverse"):
        bounds[name] = bound_ms(counts[name], pair[0].shape[0], 24 + 4 + 1 + 16,
                                fixed_bytes=0 if name == "bvh_traverse_packet" else seed_bytes)
    bounds["bvh_traverse_block"] = bounds["bvh_traverse_packet"]
    # rays in (o, d, t_max, time) and out (t, slot, b1, b2, inst); per
    # instance entered its 24 static matrix floats and its root
    bounds["instance_traverse"] = bound_ms(inst_counts, 2 * n_cam, 24 + 4 + 4 + 20, 24 * 4 + 4,
                                           OPS["lerp"])
    print("bounds (pair launches): " + ", ".join(f"{k} {v[0]:.5f} ms ({v[1]})"
                                                  for k, v in bounds.items()))
    record = {
        "bvh_traverse": (launches, err, timings["pair"][0], timings["pair"][1]),
        "instance_traverse": (inst_launches, inst_err, inst_timing["static", "shell"][0],
                              inst_timing["static", "shell"][1]),
        "bvh_traverse_packet": (ply_launches["bvh_traverse_packet"], errs["bvh_traverse_packet"],
                                p_time["pair"]["bvh_traverse_packet"], p_time["pair"]["plain"]),
        "bvh_traverse_block": (ply_launches["bvh_traverse_block"], errs["bvh_traverse_block"],
                               p_time["pair"]["bvh_traverse_block"], p_time["pair"]["plain"]),
        "bvh_traverse_all": (ply_launches["bvh_traverse_all"], errs["bvh_traverse_all"],
                             p_time["pair"]["bvh_traverse_all"], p_time["pair"]["plain_all"]),
        "bvh4_traverse": (ply_launches["bvh4_traverse"], errs["bvh4_traverse"],
                          p_time["pair"]["bvh4_traverse"], p_time["pair"]["plain4"]),
    }
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": SOURCES.get(name, "pbrt_tpu_torch/csrc/bvh_traverse.cu"),
        "replaces": REPLACES[name], "launches": n_launch, "max_abs_err": e,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1], "library_ms": None}
        for name, (n_launch, e, ms, plain_ms) in record.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
