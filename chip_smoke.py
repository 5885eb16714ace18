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
     to the CPU's;
  15. BASELINE config 3 (scene/bench.py ENV_SCENE, written here: the large
     bench knot as copper metal, read from a PLY file, a mix floor of a
     checkerboard matte and a uv-textured plastic, a glass sphere and a
     mirror quad under a 512x256 environment map with a sun; 256x256, 16
     spp, depth 5): three renders after a warm-up, finite and nonzero, B1 6
     launches a pass; one render under torch.profiler; a 32x32 crop bitwise
     equal over two renders and close to the CPU's;
  16. the all-kinds scene (64x64, orthographic: one sphere of each ported
     material kind, a fourier table, a goniometric and a projection light
     with maps written here, the spatial light strategy): the same checks
     at 64x64 with a 32x32 crop;
  17. every sampler kind (random, stratified 4x4 jittered and 3x5 not,
     halton, sobol and its Owen-scrambled variant, 02sequence, maxmindist)
     drawn on the card at 131,072 lanes of a 256x256 film for dims 0-44
     and three 2D slots, bit-equal to the same draw on the CPU; the ms and
     the tensor ops a dimension of each kind;
  18. BASELINE config 2 (scene/bench.py write_config2_scene: the PLY bench
     scene, its 100,352-triangle knot over 32,768 nodes, with the
     stratified sampler 4x4 jittered, 256x256, depth 5): three renders
     after a warm-up, finite and nonzero, "packet" (B5) 6 launches a pass
     and no other kernel; one render under torch.profiler; a 32x32 crop
     bitwise equal over two renders and close to the CPU's;
  19. BASELINE config 4 (write_config4_scene: the large knot as glass
     before a mirror, a lens focused on the knot, the global Sobol'
     sampler, 256x256, depth 5): one timed render at the full 256 spp (128
     passes), finite and nonzero with B1 6 launches a pass; the profiled
     render and the crops at 16 spp, with the same checks (the crop held
     to 99%: the card takes its reciprocal square roots as 1 / sqrt,
     core/math.py rsqrt, since its rsqrt moved paths through the glass
     knot's specular chains); and the first
     bounce's stages on the crop's 16,384 lanes, each fed the CPU's
     inputs, print the share of lanes bit-equal to the CPU's
     (config4_stages);
  20. the volpath scene (write_volpath_scene: the large bench scene in a
     homogeneous fog with the knot in a box of grid medium, volpath at
     depth 5, 4 spp): the checks of phase 18 with B1 26 launches a pass (6
     bounce intersections and 4 transmittance rounds for each of 5 NEE
     shadow rays), and the tracking loops' host reads a render;
  21. BASELINE config 3 under Integrator "whitted" and "directlighting"
     (strategy "all" and "one"), depth 5, each through render_file once (the
     warm-up) and then the checks of phase 15 with one timed render at 16
     spp, the profiled render and the crops at 4 spp: B1 11 launches a pass
     (6 intersections and one shadow ray a bounce from its one light);
  22. the large bench scene (its knot read from a PLY file) under
     Integrator "bdpt" at depth 4, 256x256, 4 spp (4 passes of 65,536
     lanes, each a camera and a light subpath): render_file once, then the
     checks of phase 15 with one timed render, the profiled render and the
     crops at 1 spp (the CPU's BDPT crop walks the 73,728-triangle knot
     with the plain walk): B1 28 launches a pass (5 camera and 4 light
     subpath walks, 5 light-sample, 10 vertex and 4 camera connections),
     the profile's device kernels and ms; the splat film of a full render
     nonzero; the tensor ops of one pass on the card;
  23. BDPT against the port's own integrators on the card: the env-lit
     calibration scene (scene/bench.py calibration_scene, the reference's
     tests/test_integrators.py scene) at 256x256 and 4 spp, BDPT's mean
     within 5% of path's, and the fog scene, BDPT's mean within 8% of
     volpath's (depth 3; the reference tests' bounds);
  24. the large bench scene (its knot read from a PLY file) under
     Integrator "mlt" at depth 4, 256x256: 65,536 bootstrap samples in 4
     chunks, 65,536 chains, 8 mutations a pixel (8 steps), 13 target
     evaluations of B1 28 launches each: render_file once, then one timed
     render, bitwise equal to render_file's, and one profiled render;
     _eval_bdpt_target on 16,384 seeded lanes against the CPU's (>= 99%
     within rtol 1e-3 / atol 1e-4) with its tensor ops, and a step's;
     the timed render under "string target" "path" (B1 5 an evaluation);
  25. the same scene under Integrator "sppm", depth 5, 16 iterations of
     65,536 photons at SPPM_RADIUS (zero grid overflows): render_file,
     the timed render (B1 15 launches an iteration, bitwise equal to
     render_file's) and the profiled one, an iteration's tensor ops, and
     one iteration on a 32x32 crop's lanes (16,384 photons at radius 0.3)
     against the CPU's: visible points, ld, phi and the deposit counts
     on >= 99% of lanes, the overflow count equal;
  26. the reference tests' point scene at their own settings (20x20):
     MLT (depth 3, 400 mutations a pixel) within 5% of path's mean and
     SPPM (64 iterations, radius 0.25, depth 3) within 10%, with zero
     overflows.
Every profile records the device's activity only (kernels, copies and
sets), read from the profiler's raw records; its top ops are the kernels'
ops by name (`kernel_op`).
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
from torch.utils._python_dispatch import TorchDispatchMode

from pbrt_tpu_torch.accel import instance as I
from pbrt_tpu_torch.accel import native
from pbrt_tpu_torch.accel import traverse as T
from pbrt_tpu_torch import media as MD
from pbrt_tpu_torch.integrators.common import camera_rays
from pbrt_tpu_torch.integrators.path import li_path
from pbrt_tpu_torch.integrators.volpath import TR_SEGMENTS
from pbrt_tpu_torch.integrators import bdpt as BD
from pbrt_tpu_torch.integrators import mlt as ML
from pbrt_tpu_torch.integrators import sppm as SP
from pbrt_tpu_torch.core.spectrum import luminance
from pbrt_tpu_torch.film import FilmState
from pbrt_tpu_torch.render import Options, render, render_file, render_sampler_integrator, \
    sample_pixels
from pbrt_tpu_torch.samplers import SamplerSpec, sample_2d, sample_dim
from pbrt_tpu_torch.scene.bench import (build_bench_scene, build_diff_scene,
                                        build_instanced_bench_scene, build_ply_bench_scene,
                                        build_quadric_showcase, build_sphere_scene,
                                        build_textured_bench_scene, calibration_scene,
                                        write_all_kinds_scene, write_bdpt_scene,
                                        write_config2_scene, write_config4_scene,
                                        write_env_material_scene, write_floor_image,
                                        write_mlt_scene, write_sppm_scene, write_volpath_scene)
from pbrt_tpu_torch.scene.build import load_scene
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
# every sampler kind, with the spec fields it takes (phase 17)
SAMPLER_KINDS = [("random", {}), ("stratified", dict(xsamples=4, ysamples=4)),
                 ("stratified", dict(xsamples=3, ysamples=5, jitter=False)), ("halton", {}),
                 ("sobol", {}), ("sobol", dict(owen=True)), ("02sequence", {}),
                 ("maxmindist", {})]
# SPPM's initial radius in phase 25: the bench scene's 16 iterations at 256x256 report no
# grid overflow at it (found on the card, PERF.md section 4)
SPPM_RADIUS = 0.015
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


class OpCount(TorchDispatchMode):
    """Counts the non-view tensor ops issued under it (each a device kernel
    on the card)."""
    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        OpCount.n += not func.is_view
        return func(*args, **(kwargs or {}))


def ops_of(fn):
    """-> (fn's result, the tensor ops it issued)."""
    OpCount.n = 0
    with torch.no_grad(), OpCount():
        out = fn()
    return out, OpCount.n


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


def kernel_op(name):
    """A device kernel's name shortened to the op it computes: the functor
    or lambda of an elementwise kernel ("Mul", "add", "bitwise_and"), else
    the kernel function's name."""
    for pattern in (r"(\w+)_kernel_cuda", r"Functor_(\w+)", r"::(\w+)Functor<", r"(\w*kernel\w*)[<(]"):
        found = re.findall(pattern, name)
        if found:
            return found[-1]
    return name[:48]


def profile_render(cs, opts):
    """One render under torch.profiler, the device's activity only (the
    host's op events would cost 2.5x the post-processing time for the same
    kernels) -> (device ms, device kernel count, the 5 kernel ops
    (`kernel_op`) with the most device time, {port kernel (`kernel_of`):
    its device ms in the render}). The device events are read from the
    profiler's raw kineto records: building its FunctionEvent list costs
    about 0.3 ms an event on the card's host."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        render(cs, opts)
        torch.cuda.synchronize()
    return device_summary(prof)


def device_summary(prof):
    """A finished profile's device events -> profile_render's tuple."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.name(), e.duration_ns() / 1e6) for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
    by_op, mine = {}, dict.fromkeys(REPLACES, 0.0)
    for name, ms in kernels:
        op = kernel_op(name)
        by_op[op] = by_op.get(op, 0.0) + ms
        if kernel_of(name):
            mine[kernel_of(name)] += ms
    top = ", ".join(f"{k} {v:.2f}" for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:5])
    return sum(ms for _, ms in kernels), len(kernels), top, mine


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


def close_share(a, c):
    """Share of the pixels or lanes of a (the last axis holds a row) within
    rtol 1e-3 / atol 1e-4 of c."""
    a, c = a.cpu().numpy(), c.cpu().numpy()
    return float(np.all(np.abs(a - c) <= 1e-4 + 1e-3 * np.abs(c), axis=-1).mean())


def check_crop(a, b, c, label, bound=0.99):
    """A 32x32 crop: bitwise equal over two card renders (a, b) and within
    rtol 1e-3 / atol 1e-4 of the CPU render (c) on >= `bound` of its pixels,
    the means within 1%."""
    if tuple(a.shape) != (32, 32, 3) or not torch.equal(a, b):
        raise AssertionError(f"the {label} 32x32 crop differs between two renders")
    near = close_share(a, c)
    a, c = a.cpu().numpy(), c.numpy()
    if near < bound or abs(a.mean() - c.mean()) > 0.01 * abs(c.mean()):
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


def config4_stages(path, copt, dev):
    """Phase 19: config 4's crop lanes (each pixel at each sample index)
    through the first bounce of li_path's stages on the card and on the
    CPU, each stage fed the CPU's inputs -> prints, for each stage's
    outputs, the share of lanes bit-equal to the CPU's and the largest
    difference."""
    import dataclasses
    from pbrt_tpu_torch.core.math import normalize
    from pbrt_tpu_torch.integrators.common import prepare_one_light
    from pbrt_tpu_torch.materials import bsdf as MB
    from pbrt_tpu_torch.materials import compute_lobes
    from pbrt_tpu_torch.scene.intersect import intersect
    cg, cc = load_scene(path, copt, dev), load_scene(path, copt, "cpu")
    px, py = (torch.as_tensor(a) for a in sample_pixels(cc.film))
    spp = cc.sampler.rounded_spp()
    sidx = torch.arange(spp, dtype=torch.int32).repeat_interleave(px.shape[0])
    lanes = (px.repeat(spp), py.repeat(spp), sidx)
    lanes_g = [t.to(dev) for t in lanes]
    to = lambda x: x.to(dev) if torch.is_tensor(x) else x
    moved = lambda obj: dataclasses.replace(obj, **{f.name: to(getattr(obj, f.name))
                                                    for f in dataclasses.fields(obj)})
    rows = []

    def cmp(name, g, c):
        g = g.cpu().reshape(c.shape[0], -1).double()
        c = c.reshape(c.shape[0], -1).double()
        rows.append(f"{name} {float((g == c).all(1).float().mean()):.4f} "
                    f"({float((g - c).abs().nan_to_num(posinf=0.0, neginf=0.0).max()):.3g})")

    for dim in (0, 2, 5, 9, 10):   # film, lens, bounce 0's lobe and direction
        cmp(f"dim {dim}", sample_dim(cg.sampler, *lanes_g, dim), sample_dim(cc.sampler, *lanes, dim))
    rg, _, _ = camera_rays(cg, *lanes_g)
    rc, _, _ = camera_rays(cc, *lanes)
    cmp("ray o", rg.o, rc.o)
    cmp("ray d", rg.d, rc.d)
    dn = normalize(rc.d)
    inf = torch.full((dn.shape[0],), float("inf"))
    sg = intersect(cg.data, cg.flags, rc.o.to(dev), dn.to(dev), inf.to(dev))
    sc = intersect(cc.data, cc.flags, rc.o, dn, inf)
    for k in ("t", "p", "ng", "ns", "ss"):
        cmp(f"hit {k}", getattr(sg, k), getattr(sc, k))
    scg = moved(sc)
    fl = cc.flags
    lobes = lambda c, si: compute_lobes(c.data.mats, c.data.tex, si.material, si.uv, si.p, None,
                                        fl.has_tex_slot, fl.tex_kinds, None, fl.bsdf_fams,
                                        fl.mat_kinds)
    lg, lc = lobes(cg, scg), lobes(cc, sc)
    for k in ("kd", "eta", "spec_r", "spec_t"):
        if getattr(lc, k) is not None:
            cmp(f"lobes {k}", getattr(lg, k), getattr(lc, k))
    u_lobe, u_dir = sample_dim(cc.sampler, *lanes, 9), sample_2d(cc.sampler, *lanes, 10)
    bg = MB.bsdf_sample(moved(lc), scg.world_to_local(scg.wo), u_lobe.to(dev), u_dir.to(dev),
                        None, fl.bsdf_fams)
    bc = MB.bsdf_sample(lc, sc.world_to_local(sc.wo), u_lobe, u_dir, None, fl.bsdf_fams)
    for k in ("wi", "f", "pdf", "is_specular"):
        cmp(f"bsdf {k}", getattr(bg, k), getattr(bc, k))
    wi = sc.local_to_world(bc.wi)
    cmp("wi world", scg.local_to_world(bc.wi.to(dev)), wi)
    cmp("spawn", scg.spawn_origin(wi.to(dev)), sc.spawn_origin(wi))
    u_sel, u_light = sample_dim(cc.sampler, *lanes, 6), sample_2d(cc.sampler, *lanes, 7)
    ng = prepare_one_light(cg, scg, moved(lc), scg.valid, u_sel.to(dev), u_light.to(dev))
    nc = prepare_one_light(cc, sc, lc, sc.valid, u_sel, u_light)
    for k, a, b in zip(("nee ld", "nee o", "nee d", "nee dist"), ng, nc):
        cmp(k, a, b)
    idx = torch.arange(fl.n_lights).repeat(64)
    cmp("light pmf", cg.data.light_distr.discrete_pdf(idx.to(dev)),
        cc.data.light_distr.discrete_pdf(idx))
    print(f"config 4 stages on the crop's {lanes[0].shape[0]} lanes, the card on the CPU's "
          f"inputs (share of lanes bit-equal to the CPU's, largest |difference|): "
          + "; ".join(rows))


def scene_file_render(label, path, res, crop, want, dev, card, timed=3, small_path=None):
    """Phases 15, 16 and 18 - 22: one scene file end to end on the card,
    by its integrator (render): `timed` renders after a warm-up, each
    finite and nonzero with the kernel launches want ({kernel: launches a
    pass}; no other kernel); one render under torch.profiler; the crop
    bitwise equal over two renders and close to the CPU crop on >= 99% of
    its pixels. small_path, where given, is the scene at a lower sample
    count for the profiled render and the crops.
    In scenes with a grid medium, each render's tracking-loop host reads
    are printed. -> the timed scene."""
    t0 = time.time()
    cs = load_scene(path, None, dev)
    f = cs.flags
    print(f"{label} scene built in {time.time() - t0:.2f} s: {f.n_tris} triangles, "
          f"{cs.data.bvh.metas.shape[0]} nodes, {f.n_quadrics} quadrics, material kinds "
          f"{f.mat_kinds}, lobe families {f.bsdf_fams}, fourier {f.has_fourier}, light kinds "
          f"{cs.data.lights.kinds}, environment map "
          f"{None if cs.data.lights.env is None else tuple(cs.data.lights.env.image.shape)}, "
          f"light strategy {f.light_strategy}, sampler {cs.sampler.kind} at "
          f"{cs.sampler.rounded_spp()} spp, lens radius {cs.camera.lens_radius}, integrator "
          f"{cs.integrator_kind}, media {f.n_media} (grid {f.any_grid_media})")
    small = small_path or path
    copt = Options(crop_window=crop)
    a, _, _ = render(load_scene(small, copt, dev), copt)
    torch.cuda.synchronize()   # the crop render is the warm-up
    opts = Options()
    walls, reads = [], []
    for _ in range(timed):
        zero_counts()
        MD.HOST_READS["blocks"] = 0
        t0 = time.time()
        img, cnt, passes = render(cs, opts)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        reads.append(MD.HOST_READS["blocks"])
        launches = read_counts()
        check_render(img, launches, {k: v * passes for k, v in want.items()}, label, res=res)
    wall = sorted(walls)[len(walls) // 2]
    live = cnt["camera_rays"] + cnt["shadow_rays"] + cnt["bounce_rays"]
    per_pass = ", ".join(f"{k} {launches[k] // passes}" for k in want)
    print(f"{label} render: {', '.join(f'{w:.3f}' for w in walls)} s, median {wall:.3f} s; "
          f"{passes} passes, launches a pass: {per_pass}; "
          f"{res * res * cs.sampler.rounded_spp() / wall:.0f} samples/s, "
          f"{live / wall / 1e6:.3f} M live rays/s ({live} live rays), mean "
          f"{float(img.mean()):.5f}  [{card}]")
    if f.any_grid_media:
        print(f"{label}: tracking-loop host reads a render {reads} ({reads[0] / passes:.1f} a "
              f"pass)")
    cs_p = load_scene(small, None, dev) if small_path else cs
    busy, n_kern, top, mine = profile_render(cs_p, opts)
    wall_p = wall * cs_p.sampler.rounded_spp() / cs.sampler.rounded_spp()
    print(f"{label} render{' at ' + str(cs_p.sampler.rounded_spp()) + ' spp' if small_path else ''}"
          f" under torch.profiler: {n_kern} device kernels, {busy:.1f} ms device time, "
          f"{100 * busy / 1e3 / wall_p:.1f}% of the unprofiled wall"
          f"{' (scaled by spp)' if small_path else ''}; "
          + ", ".join(f"{k} {mine[k]:.3f} ms" for k in want)
          + f"; top device ops (ms): {top}  [{card}]")
    b, _, _ = render(load_scene(small, copt, dev), copt)
    c, _, _ = render(load_scene(small, copt, "cpu"), copt)
    check_crop(a, b, c, label)
    return cs


def sampler_draws(dev, card, n=131_072, dims=45):
    """Phase 17: every sampler kind drawn on the card at n lanes of a
    256x256 film (16 spp) for dims 0 - 44, bit-equal to the same draw on
    the CPU; ms a dimension by CUDA events and tensor ops a dimension."""
    rng = np.random.default_rng(17)
    lanes_np = [rng.integers(0, 256, n).astype(np.int32) for _ in range(2)]
    for kind, kw in SAMPLER_KINDS:
        spec = SamplerSpec(kind, 16, 0, (256, 256), **kw)
        lanes = lanes_np + [rng.integers(0, spec.rounded_spp(), n).astype(np.int32)]
        gpu = [torch.as_tensor(a, device=dev) for a in lanes]
        cpu = [torch.as_tensor(a) for a in lanes]
        for dim in range(dims):
            got = sample_dim(spec, *gpu, dim).cpu()
            if not torch.equal(got.view(torch.int32), sample_dim(spec, *cpu, dim).view(torch.int32)):
                raise AssertionError(f"sampler {kind} {kw}: dim {dim} on the card differs "
                                     "from the CPU")
        for dim in (0, 2, 21):
            got = sample_2d(spec, *gpu, dim).cpu()
            if not torch.equal(got.view(torch.int32), sample_2d(spec, *cpu, dim).view(torch.int32)):
                raise AssertionError(f"sampler {kind} {kw}: 2D slot {dim} differs")
        ms = cuda_ms(lambda: [sample_dim(spec, *gpu, d) for d in range(dims)], 3) / dims
        _, n_ops = ops_of(lambda: [sample_dim(spec, *gpu, d) for d in range(dims)])
        print(f"sampler {kind} {kw or ''}: dims 0-{dims - 1} at {n} lanes bit-equal to the CPU; "
              f"{ms:.3f} ms and {n_ops / dims:.1f} tensor ops a dimension  [{card}]")


INTEGRATOR_LINES = (("whitted", 'Integrator "whitted" "integer maxdepth" 5'),
                    ("directlighting all", 'Integrator "directlighting" "integer maxdepth" 5'),
                    ("directlighting one", 'Integrator "directlighting" "integer maxdepth" 5 '
                                           '"string strategy" "one"'))


def entry_render(label, path, dev):
    """Render a scene file through render_file (the CLI's entry) -> its
    wall, the warm-up of the phase."""
    t0 = time.time()
    out, img = render_file(path, Options(outfile=os.path.join(os.path.dirname(path),
                                                              "entry.png")), dev)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(img).all()) and float(img.sum()) > 0 and os.path.exists(out)):
        raise AssertionError(f"{label}: render_file gave no finite, lit image")
    print(f"{label}: render_file (parse, build, render, write) {time.time() - t0:.2f} s")


def integrator_renders(dev, card):
    """Phase 21: config 3 under whitted and directlighting."""
    for label, line in INTEGRATOR_LINES:
        with tempfile.TemporaryDirectory(prefix="integrator_") as tmp:
            full, low = os.path.join(tmp, "full"), os.path.join(tmp, "low")
            os.mkdir(full)
            os.mkdir(low)
            path = write_env_material_scene(full, large=True, integrator=line)
            entry_render(label, path, dev)
            scene_file_render(label, path, 256, (0.5, 0.625, 0.5, 0.625), {"bvh_traverse": 11},
                              dev, card, timed=1,
                              small_path=write_env_material_scene(low, spp=4, integrator=line))


def bdpt_render(dev, card):
    """Phase 22: the large bench scene under bdpt."""
    with tempfile.TemporaryDirectory(prefix="bdpt_") as tmp:
        full, low = os.path.join(tmp, "full"), os.path.join(tmp, "low")
        os.mkdir(full)
        os.mkdir(low)
        path = write_bdpt_scene(full, large=True)
        entry_render("bdpt", path, dev)
        cs = scene_file_render("bdpt", path, 256, (0.5, 0.625, 0.5, 0.625),
                               {"bvh_traverse": 28}, dev, card, timed=1,
                               small_path=write_bdpt_scene(low, spp=1))
        film, _, spp = BD.render_bdpt_film(cs, Options())
        splat = film.splat.sum(-1)
        if not bool(torch.isfinite(splat).all()) or float(splat.sum()) <= 0:
            raise AssertionError("bdpt: the splat film of a full render is empty or not finite")
        print(f"bdpt: splat film nonzero on {float((splat > 0).float().mean()):.4f} of its "
              f"pixels, mean splat {float(splat.mean()) / 3 / spp:.6f} a sample")
        px, py = (torch.as_tensor(a, device=dev) for a in sample_pixels(cs.film))
        D = int(cs.integrator_params["maxdepth"][0]) + 1
        _, n_ops = ops_of(lambda: BD._bdpt_sample(cs, px, py, torch.zeros_like(px), D))
        print(f"bdpt: {n_ops} tensor ops a pass of {px.shape[0]} lanes on the card  [{card}]")


def bdpt_calibration(dev, card):
    """Phase 23: BDPT's mean against path's (env-lit) and volpath's (fog)."""
    with tempfile.TemporaryDirectory(prefix="calibration_") as tmp:
        for name, other, bound in (("env", "path", 0.05), ("fog", "volpath", 0.08)):
            means = {}
            for kind in ("bdpt", other):
                path = os.path.join(tmp, f"{name}_{kind}.pbrt")
                with open(path, "w") as f:
                    f.write(calibration_scene(name, f'Integrator "{kind}" "integer maxdepth" 3',
                                              res=256, spp=4))
                t0 = time.time()
                img, _, passes = render(load_scene(path, None, dev))
                torch.cuda.synchronize()
                wall = time.time() - t0
                if not bool(torch.isfinite(img).all()):
                    raise AssertionError(f"{name} scene under {kind}: not finite")
                means[kind] = float(img.mean())
                print(f"{name} calibration scene under {kind}: 256x256, 4 spp, depth 3, "
                      f"{passes} passes in {wall:.3f} s, mean {means[kind]:.6f}  [{card}]")
            rel = abs(means["bdpt"] - means[other]) / means[other]
            print(f"{name}: bdpt's mean is {rel:.4f} off {other}'s (bound {bound})")
            if not rel < bound:
                raise AssertionError(f"{name}: bdpt's mean {means['bdpt']} is {rel:.4f} off "
                                     f"{other}'s {means[other]}")


def timed_render(label, cs, want, card, res=256):
    """One render by the scene's integrator with the launch counts zeroed
    before it: finite and nonzero, the launches want ({kernel: launches a
    pass}) times its passes -> (image, counters, passes, wall)."""
    zero_counts()
    t0 = time.time()
    img, cnt, passes = render(cs, Options())
    torch.cuda.synchronize()
    wall = time.time() - t0
    check_render(img, read_counts(), {k: v * passes for k, v in want.items()}, label, res=res)
    print(f"{label} render: {wall:.3f} s, {passes} passes, launches "
          + ", ".join(f"{k} {v * passes} ({v} a pass)" for k, v in want.items())
          + f", counters {cnt}, mean {float(img.mean()):.6f}  [{card}]")
    return img, cnt, passes, wall


def profiled(label, cs, wall, want, card):
    """A render of cs, a shorter run of the timed scene, under
    torch.profiler: its device kernels, device time and busy share of
    `wall`, the timed render's wall scaled to its passes."""
    render(cs, Options())   # warm-up
    t0 = time.time()
    busy, n_kern, top, mine = profile_render(cs, Options())
    print(f"{label} render under torch.profiler ({time.time() - t0:.1f} s): {n_kern} device "
          f"kernels, {busy:.1f} ms device time, {100 * busy / 1e3 / wall:.1f}% of the timed "
          f"render's wall for as many passes; " + ", ".join(f"{k} {mine[k]:.3f} ms" for k in want)
          + f"; top device ops (ms): {top}  [{card}]")


def mlt_render(dev, card):
    """Phase 24: the large bench scene under mlt, both targets."""
    with tempfile.TemporaryDirectory(prefix="mlt_") as tmp:
        path = write_mlt_scene(tmp)
        t0 = time.time()
        out, first = render_file(path, Options(outfile=os.path.join(tmp, "entry.png")), dev)
        torch.cuda.synchronize()
        print(f"mlt: render_file (parse, build, render, write) {time.time() - t0:.2f} s")
        cs = load_scene(path, None, dev)
        img, cnt, passes, wall = timed_render("mlt", cs, {"bvh_traverse": 28}, card)
        if passes != 4 + 1 + 8:
            raise AssertionError(f"mlt: {passes} target evaluations, expected 13")
        if not torch.equal(img, first):
            raise AssertionError("mlt: two renders of the scene differ")
        print(f"mlt: bitwise equal over two renders; {cnt['mutations_accepted']} of "
              f"{cnt['mutations']} mutations accepted")
        # the profile of one bootstrap chunk, the chain starts and one step
        # (its post-processing grows with the kernels it records)
        os.mkdir(os.path.join(tmp, "short"))
        profiled("mlt", load_scene(write_mlt_scene(os.path.join(tmp, "short"), bootstrap=16384,
                                                   mutations=1), None, dev),
                 wall * 3 / passes, ("bvh_traverse",), card)
        # one BDPT-target evaluation on 16,384 lanes, the card against the CPU
        n_u, depth = ML._n_dims_bdpt(4), 4
        rng = np.random.default_rng(24)
        u = rng.uniform(0, 1, (16384, n_u)).astype(np.float32)
        d = rng.integers(0, depth + 1, 16384).astype(np.int32)
        zero_counts()
        (L, raster), n_ops = ops_of(lambda: ML._eval_bdpt_target(
            cs, torch.as_tensor(u, device=dev), depth, torch.as_tensor(d, device=dev)))
        launches = read_counts()["bvh_traverse"]
        cs_cpu = load_scene(path, None, "cpu")
        t0 = time.time()
        Lc, rc = ML._eval_bdpt_target(cs_cpu, torch.as_tensor(u), depth, torch.as_tensor(d))
        share = close_share(L, Lc)
        print(f"mlt: _eval_bdpt_target on 16,384 lanes: {n_ops} tensor ops and {launches} B1 "
              f"launches on the card; {share:.4f} of lanes within rtol 1e-3 / atol 1e-4 of the "
              f"CPU's (CPU {time.time() - t0:.1f} s), raster max |d| "
              f"{float((raster.cpu() - rc).abs().max()):.3g}, means {float(L.mean()):.6f} / "
              f"{float(Lc.mean()):.6f}")
        if share < 0.99 or launches != 28:
            raise AssertionError(f"mlt: evaluation {share:.4f} close, {launches} launches")
        film = FilmState.zeros(cs.film, dev, splats=True)
        uc = torch.as_tensor(u[:4096], device=dev)
        Lq, pq = ML._eval_bdpt_target(cs, uc, depth, torch.as_tensor(d[:4096], device=dev))
        chains = (uc, Lq, luminance(Lq), pq)
        b = torch.tensor(0.1, device=dev)
        eval_t = lambda v: ML._eval_bdpt_target(cs, v, depth, torch.as_tensor(d[:4096],
                                                                             device=dev))
        _, step_ops = ops_of(lambda: ML.mlt_step(cs, film, chains, 1, b, eval_t))
        print(f"mlt: a step issues {step_ops} tensor ops, {step_ops - n_ops} more than an "
              f"evaluation  [{card}]")
        del cs_cpu, L, Lc
        os.mkdir(os.path.join(tmp, "path"))
        cs = load_scene(write_mlt_scene(os.path.join(tmp, "path"), target="path"), None, dev)
        img, cnt, passes, wall = timed_render("mlt (target path)", cs, {"bvh_traverse": 5}, card)


def sppm_render(dev, card):
    """Phase 25: the large bench scene under sppm at SPPM_RADIUS."""
    with tempfile.TemporaryDirectory(prefix="sppm_") as tmp:
        path = write_sppm_scene(tmp, SPPM_RADIUS)
        t0 = time.time()
        _, first = render_file(path, Options(outfile=os.path.join(tmp, "entry.png")), dev)
        torch.cuda.synchronize()
        print(f"sppm: render_file (parse, build, render, write) {time.time() - t0:.2f} s")
        cs = load_scene(path, None, dev)
        img, cnt, passes, wall = timed_render("sppm", cs, {"bvh_traverse": 15}, card)
        print(f"sppm: radius {SPPM_RADIUS}, {cnt['grid_overflows']} grid overflows")
        if cnt["grid_overflows"] != 0 or passes != 16:
            raise AssertionError(f"sppm: {cnt['grid_overflows']} overflows, {passes} iterations")
        if not torch.equal(img, first):
            raise AssertionError("sppm: two renders of the scene differ")
        print("sppm: bitwise equal over two renders")
        os.mkdir(os.path.join(tmp, "short"))   # the profile of 2 iterations
        profiled("sppm", load_scene(write_sppm_scene(os.path.join(tmp, "short"), SPPM_RADIUS,
                                                     iterations=2), None, dev),
                 wall * 2 / passes, ("bvh_traverse",), card)
        px, py = (torch.as_tensor(a, device=dev) for a in sample_pixels(cs.film))
        n = px.shape[0]
        state = (torch.full((n,), SPPM_RADIUS, device=dev), torch.zeros((n, 3), device=dev),
                 torch.zeros((n, 3), device=dev), torch.zeros(n, device=dev))
        _, n_ops = ops_of(lambda: SP._sppm_iteration(cs, 5, n, px, py, 0, *state))
        print(f"sppm: an iteration issues {n_ops} tensor ops on the card  [{card}]")
        # one iteration's visible points and photon flux on a 32x32 crop's
        # lanes, the card against the CPU: 16,384 photons at radius 0.3, so
        # that the crop's points receive deposits
        copt = Options(crop_window=(0.5, 0.625, 0.5, 0.625))
        out = []
        t0 = time.time()
        for dv in (dev, "cpu"):
            c = load_scene(path, copt, dv)
            qx, qy = (torch.as_tensor(a, device=dv) for a in sample_pixels(c.film))
            r = torch.full((qx.shape[0],), 0.3, device=dv)
            vp, ld = SP.camera_pass(c, 5, qx, qy, 3)
            grid = SP.build_grid(c, vp, r)
            phi, m, ovf = SP.photon_pass(c, 5, 16384, 3, vp, grid, r)
            out.append((vp, ld, phi, m, int(ovf)))
        (vg, lg, pg, mg, og), (vc, lc, pc, mc, oc) = out
        valid = float((vg.valid.cpu() == vc.valid).float().mean())
        shares = {k: close_share(a, b) for k, a, b in (("p", vg.p, vc.p), ("beta", vg.beta, vc.beta),
                                                       ("ld", lg, lc), ("phi", pg, pc),
                                                       ("m", mg[:, None], mc[:, None]))}
        print(f"sppm: one iteration on the 32x32 crop's {vc.valid.shape[0]} lanes: vp_valid equal "
              f"on {valid:.4f}; within rtol 1e-3 / atol 1e-4 of the CPU's: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in shares.items())
              + f"; {int(mc.sum())} deposits and {oc} overflows on the CPU, {int(mg.sum())} and "
              f"{og} on the card ({time.time() - t0:.1f} s)")
        if valid < 0.99 or min(shares.values()) < 0.99 or int(mc.sum()) < 50 or og != oc:
            raise AssertionError("sppm: the crop's iteration differs from the CPU's")


def sppm_radii(dev, card, radii=(0.04, 0.03, 0.025, 0.02, 0.015)):
    """Not a phase: the grid overflows of phase 25's render at each initial
    radius, the way SPPM_RADIUS was chosen (the largest with none)."""
    for r in radii:
        with tempfile.TemporaryDirectory(prefix="sppm_radius_") as tmp:
            cs = load_scene(write_sppm_scene(tmp, r), None, dev)
            t0 = time.time()
            img, cnt, passes = render(cs, Options())
            torch.cuda.synchronize()
            print(f"sppm at radius {r}: {cnt['grid_overflows']} grid overflows in {passes} "
                  f"iterations, {time.time() - t0:.3f} s, mean {float(img.mean()):.6f}  [{card}]")


def sppm_mlt_calibration(dev, card):
    """Phase 26: MLT and SPPM against path on the reference tests' point
    scene at their own settings (20x20)."""
    lines = {"path": 'Integrator "path" "integer maxdepth" 3',
             "mlt": 'Integrator "mlt" "integer maxdepth" 3 "integer mutationsperpixel" 400',
             "sppm": 'Integrator "sppm" "integer numiterations" 64 "float radius" 0.25 '
                     '"integer maxdepth" 3'}
    means = {}
    with tempfile.TemporaryDirectory(prefix="calibration26_") as tmp:
        for kind, line in lines.items():
            path = os.path.join(tmp, f"{kind}.pbrt")
            with open(path, "w") as f:
                f.write(calibration_scene("point", line))
            t0 = time.time()
            img, cnt, passes = render(load_scene(path, None, dev))
            torch.cuda.synchronize()
            if not bool(torch.isfinite(img).all()):
                raise AssertionError(f"point scene under {kind}: not finite")
            means[kind] = float(img.mean())
            print(f"point calibration scene under {kind}: 20x20, {passes} passes in "
                  f"{time.time() - t0:.3f} s, counters {cnt}, mean {means[kind]:.6f}  [{card}]")
            if kind == "sppm" and cnt["grid_overflows"] != 0:
                raise AssertionError(f"sppm: {cnt['grid_overflows']} grid overflows")
    for kind, bound in (("mlt", 0.05), ("sppm", 0.10)):
        rel = abs(means[kind] - means["path"]) / means["path"]
        print(f"point: {kind}'s mean is {rel:.4f} off path's (bound {bound})")
        if not rel < bound:
            raise AssertionError(f"point: {kind}'s mean {means[kind]} is {rel:.4f} off path's")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    dev = torch.device("cuda")
    card = card_line()
    marks = [time.time()]

    def lap(label):   # the wall of each group of phases, for the script's time limit
        marks.append(time.time())
        print(f"time: {label} {marks[-1] - marks[-2]:.1f} s (total {marks[-1] - marks[0]:.1f} s)",
              flush=True)

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

    lap("phase 2")
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
        plain = cuda_ms(lambda: T.traverse_plain(kb, *rays), 1, warm=False)
        kern = cuda_ms(lambda: T.traverse(kb, *rays), 20)
        kern2 = cuda_ms(lambda: T.traverse(kb, *rays), 20)
        timings[name] = (min(kern, kern2), plain)
        print(f"traverse {name} launch, {rays[0].shape[0]} rays: kernel "
              f"{timings[name][0]:.3f} ms, plain {timings[name][1]:.3f} ms  [{card}]")
    print(f"kernel vs plain: bit-equal, max |dt| {err}")

    lap("phase 3")
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

    lap("phase 4")
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

    lap("phase 5")
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
            inst_timing[label, name] = (min(kern, kern2), plain)
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

    lap("phase 6")
    # ---- 7: both instanced scenes, end to end ----
    inst_launches = sum(render_instanced(animated, dev, card) for animated in (False, True))

    lap("phase 7")
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

    lap("phase 8")
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

    lap("phase 9")
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

    lap("phase 10")
    # ---- 11: the sphere scene of BASELINE.json's first configuration ----
    cs_s = render_quadric_scene("sphere", lambda dv, o=None: build_sphere_scene(dv, o),
                                (0.4375, 0.5625, 0.4375, 0.5625), {}, dev, card)
    n_pair = pair[0].shape[0]
    unbounded = torch.full((n_pair,), float("inf"), device=dev)
    q_ms = cuda_ms(lambda: _quadric_pass(cs_s.data.quads, pair[0], pair[1], unbounded), 20)
    print(f"quadric pass of the sphere scene (1 sphere), {n_pair} rays: {q_ms:.3f} ms  [{card}]")
    del cs_s

    lap("phase 11")
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

    lap("phase 12")
    # ---- 13: the differentiable pass; 14: the textured bench scene ----
    diff_pass(dev, card)
    textured_render(dev, card)

    lap("phases 13, 14")
    # ---- 15: BASELINE config 3; 16: the all-kinds scene ----
    with tempfile.TemporaryDirectory(prefix="config3_") as tmp:
        scene_file_render("config 3", write_env_material_scene(tmp, large=True), 256,
                          (0.5, 0.625, 0.5, 0.625), {"bvh_traverse": 6}, dev, card)
    with tempfile.TemporaryDirectory(prefix="all_kinds_") as tmp:
        scene_file_render("all kinds", write_all_kinds_scene(tmp), 64,
                          (0.25, 0.75, 0.25, 0.75), {"bvh_traverse": 6}, dev, card)

    lap("phases 15, 16")
    # ---- 17: every sampler kind on the card ----
    sampler_draws(dev, card)

    lap("phase 17")
    # ---- 18: BASELINE config 2; 19: BASELINE config 4; 20: the volpath scene ----
    with tempfile.TemporaryDirectory(prefix="config2_") as tmp:
        scene_file_render("config 2", write_config2_scene(tmp), 256, (0.5, 0.625, 0.5, 0.625),
                          {"bvh_traverse_packet": 6}, dev, card)
    with tempfile.TemporaryDirectory(prefix="config4_") as tmp:
        full, low = os.path.join(tmp, "full"), os.path.join(tmp, "low")
        os.mkdir(full)
        os.mkdir(low)
        small = write_config4_scene(low, spp=16)
        scene_file_render("config 4", write_config4_scene(full), 256, (0.5, 0.625, 0.5, 0.625),
                          {"bvh_traverse": 6}, dev, card, timed=1, small_path=small)
        config4_stages(small, Options(crop_window=(0.5, 0.625, 0.5, 0.625)), dev)
    with tempfile.TemporaryDirectory(prefix="volpath_") as tmp:
        scene_file_render("volpath", write_volpath_scene(tmp), 256, (0.5, 0.625, 0.5, 0.625),
                          {"bvh_traverse": 6 + 5 * TR_SEGMENTS}, dev, card)

    lap("phases 18, 19, 20")
    # ---- 21: whitted and directlighting; 22: BDPT; 23: BDPT against path and volpath ----
    integrator_renders(dev, card)
    bdpt_render(dev, card)
    bdpt_calibration(dev, card)

    lap("phases 21, 22, 23")
    # ---- 24: MLT; 25: SPPM; 26: MLT and SPPM against path ----
    mlt_render(dev, card)
    sppm_render(dev, card)
    sppm_mlt_calibration(dev, card)

    lap("phases 24, 25, 26")
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
