"""Smoke test of the PyTorch port on one CUDA card: python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing catches it):
  1. require a CUDA device; print the card's name and power limit;
  2. build the BVH traversal kernel (csrc/bvh_traverse.cu) with nvcc;
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
     through the kernel, a 32x32 crop bitwise equal over two renders and
     close to the same crop rendered on the CPU with the plain walk.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pbrt_tpu_torch.accel import native
from pbrt_tpu_torch.accel import traverse as T
from pbrt_tpu_torch.integrators.common import camera_rays
from pbrt_tpu_torch.render import Options, render_sampler_integrator, sample_pixels
from pbrt_tpu_torch.scene.bench import build_bench_scene

REPLACES = "pbrt_tpu/accel/pallas_traverse.py:1001"


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(kb, o, d, t_max, anyhit):
    """Kernel vs plain on one launch -> max |dt| over closest hits."""
    before = T.traverse.launches
    t, s, it = T.traverse(kb, o, d, t_max, anyhit)
    torch.cuda.synchronize()
    if T.traverse.launches != before + 1:
        raise AssertionError("the kernel's launch counter did not advance")
    tp, sp, itp = T.traverse_plain(kb, o, d, t_max, anyhit)
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))

    # ---- 2: build ----
    t0 = time.time()
    native.load("bvh_traverse")
    print(f"build: bvh_traverse.cu in {time.time() - t0:.2f} s")

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
    err = max(compare(kb, *cam), compare(kb, *pair), compare(kb, *odd),
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

    print(json.dumps({"kernels": [{
        "name": "bvh_traverse", "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/bvh_traverse.cu", "replaces": REPLACES,
        "launches": launches, "max_abs_err": err,
        "ms": timings["pair"][0], "plain_ms": timings["pair"][1]}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
