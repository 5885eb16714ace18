"""The BVH (2- and 4-wide) and instance traversal kernels on the card, and
the differentiable, textured, sampler, depth-of-field and volumetric paths
that launch them, in a process without JAX.

Run on a machine with an NVIDIA GPU (`--noconftest` skips tests/conftest.py,
which configures JAX; nothing here imports it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Every test skips where torch sees no CUDA device: the kernel has no CPU mode.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_port_helpers import needs_cuda, rays_at_grid, rays_at_knot

from pbrt_tpu_torch.accel import instance as I
from pbrt_tpu_torch.accel import traverse as T
from pbrt_tpu_torch.accel.bvh import build_bvh
from pbrt_tpu_torch.integrators.common import camera_rays
from pbrt_tpu_torch.render import Options, render_sampler_integrator, sample_pixels
from pbrt_tpu_torch.scene.bench import (build_bench_scene, build_instanced_bench_scene,
                                        build_ply_bench_scene)
from pbrt_tpu_torch.scene.intersect import kernel_bary
from pbrt_tpu_torch.shapes.triangle import make_knot_mesh


def _launch_rays(cs, dev):
    """A camera launch (every pixel, sample 0) followed by a pair launch of
    20,001 random rays, closest-hit then any-hit: odd N, zero components."""
    px, py = (torch.as_tensor(a, device=dev) for a in sample_pixels(cs.film))
    rays, _, _ = camera_rays(cs, px, py, torch.zeros_like(px))
    o_c, d_c = rays.o, rays.d
    d_c = d_c / d_c.norm(dim=1, keepdim=True)
    o_r, d_r = (torch.as_tensor(a, device=dev) for a in rays_at_knot(20_001, seed=31))
    n_c, n_r = o_c.shape[0], o_r.shape[0]
    anyhit = torch.zeros(n_c + n_r, dtype=torch.uint8, device=dev)
    anyhit[n_c + n_r // 2:] = 1
    return (torch.cat([o_c, o_r]).contiguous(), torch.cat([d_c, d_r]).contiguous(),
            torch.full((n_c + n_r,), float("inf"), device=dev), anyhit)


@pytest.mark.parametrize("large", [False, True])
def test_kernel_matches_plain_on_bench_knot(large):
    """Bit-equal t and slot on closest-hit rays, equal any-hit flags, equal
    iters and no stack overflow, on the tables of the port's front end."""
    needs_cuda()
    dev = torch.device("cuda")
    cs = build_bench_scene(large, dev)
    kb = cs.data.bvh
    o, d, tm, ah = _launch_rays(cs, dev)
    before = T.traverse.launches
    t, s, it = T.traverse(kb, o, d, tm, ah)
    torch.cuda.synchronize()
    assert T.traverse.launches == before + 1
    tp, sp, itp = T.traverse_plain(kb, o, d, tm, ah)
    cl = ah == 0
    assert int((s[cl] >= 0).sum()) > 1000 and int((s[~cl] >= 0).sum()) > 1000
    assert torch.equal(t[cl], tp[cl]) and torch.equal(s[cl], sp[cl])
    assert torch.equal(s[~cl] >= 0, sp[~cl] >= 0)
    assert torch.equal(it, itp) and not bool(torch.any(it & T.OVF_BIT))


def test_wrapper_raises_instead_of_falling_back():
    needs_cuda()
    dev = torch.device("cuda")
    kb = build_bench_scene(False, dev).data.bvh
    o, d = (torch.as_tensor(a, device=dev) for a in rays_at_knot(64, seed=32))
    tm = torch.full((64,), float("inf"), device=dev)
    ah = torch.zeros(64, dtype=torch.uint8, device=dev)
    with pytest.raises(TypeError):
        T.traverse(kb, o, d.double(), tm, ah)
    with pytest.raises(ValueError):
        T.traverse(kb, o, d, tm.cpu(), ah)
    with pytest.raises(ValueError):
        T.traverse(kb, o, d.t().contiguous().t(), tm, ah)


def test_render_goes_through_the_kernel():
    """A crop of the small bench scene: one camera launch and 4 pair
    launches per pass, bitwise equal over two renders, and close to the
    same crop rendered on the CPU with the plain walk."""
    needs_cuda()
    opts = Options(crop_window=(0.375, 0.5, 0.375, 0.5))
    cs = build_bench_scene(False, "cuda", opts)
    T.traverse.launches = 0
    a, cnt, passes = render_sampler_integrator(cs, opts)
    torch.cuda.synchronize()
    assert T.traverse.launches == 5 * passes and cnt["camera_rays"] == 8 * 8 * 4
    b, _, _ = render_sampler_integrator(cs, opts)
    assert torch.equal(a, b)
    c, _, _ = render_sampler_integrator(build_bench_scene(False, "cpu", opts), opts)
    a, c = a.cpu().numpy(), c.numpy()
    assert np.all(np.isfinite(a)) and a.sum() > 0
    near = np.all(np.abs(a - c) <= 1e-4 + 1e-3 * np.abs(c), axis=-1).mean()
    assert near >= 0.99 and abs(a.mean() - c.mean()) <= 0.01 * abs(c.mean())


def _grid_rays(n, seed, dev):
    o, d, time = (torch.as_tensor(a, device=dev) for a in rays_at_grid(n, seed))
    return o, d, torch.full((n,), float("inf"), device=dev), time


@pytest.mark.parametrize("animated", [False, True])
def test_instance_kernel_matches_plain(animated):
    """t, triangle, b1, b2, inst and iters bit-equal to the plain walk on
    the instanced bench scene, static and animated (the slerp path), for
    20,001 rays with times past both ends of [0, 1]; no stack overflow."""
    needs_cuda()
    dev = torch.device("cuda")
    cs = build_instanced_bench_scene(animated, dev)
    assert cs.flags.any_animated_inst == animated
    args = (cs.data.ibvh, *_grid_rays(20_001, 33, dev), animated)
    before = I.instance_traverse.launches
    got = I.instance_traverse(*args)
    torch.cuda.synchronize()
    assert I.instance_traverse.launches == before + 1
    want = I.instance_traverse_plain(*args)
    assert int((got[4] >= 0).sum()) > 10_000
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not bool(torch.any(got[5] & T.OVF_BIT))


def test_instance_wrapper_raises_instead_of_falling_back():
    needs_cuda()
    dev = torch.device("cuda")
    ib = build_instanced_bench_scene(False, dev).data.ibvh
    o, d, tm, time = _grid_rays(64, 34, dev)
    with pytest.raises(TypeError):
        I.instance_traverse(ib, o, d.double(), tm, time, False)
    with pytest.raises(ValueError):
        I.instance_traverse(ib, o, d, tm, time.cpu(), False)
    with pytest.raises(ValueError):
        I.instance_traverse(ib, o, d, tm, time[:32], False)
    with pytest.raises(ValueError):
        I.instance_traverse(ib, o, d.t().contiguous().t(), tm, time, False)


@pytest.mark.parametrize("animated", [False, True])
def test_instanced_render_goes_through_both_kernels(animated):
    """A crop of an instanced bench scene: 5 launches per pass of each
    kernel, bitwise equal over two renders, and close to the same crop
    rendered on the CPU with the plain walks."""
    needs_cuda()
    opts = Options(crop_window=(0.5, 0.5625, 0.5, 0.5625))
    cs = build_instanced_bench_scene(animated, "cuda", opts)
    T.traverse.launches = I.instance_traverse.launches = 0
    a, cnt, passes = render_sampler_integrator(cs, opts)
    torch.cuda.synchronize()
    assert T.traverse.launches == I.instance_traverse.launches == 5 * passes
    assert cnt["camera_rays"] == 16 * 16 * 4
    b, _, _ = render_sampler_integrator(cs, opts)
    assert torch.equal(a, b)
    c, _, _ = render_sampler_integrator(build_instanced_bench_scene(animated, "cpu", opts), opts)
    a, c = a.cpu().numpy(), c.numpy()
    assert np.all(np.isfinite(a)) and a.sum() > 0
    near = np.all(np.abs(a - c) <= 1e-4 + 1e-3 * np.abs(c), axis=-1).mean()
    assert near >= 0.99 and abs(a.mean() - c.mean()) <= 0.01 * abs(c.mean())


def _bench_tables(which, dev, tmp_path):
    """A bench scene: "small", "large", or "ply", the PLY bench scene, whose
    tree has more than 32,768 nodes."""
    if which == "ply":
        return build_ply_bench_scene(str(tmp_path), dev)
    return build_bench_scene(which == "large", dev)


def _hold(got, want, ah, kb, o, d):
    """A with-barycentrics kernel against its plain walk: t, slot, b1, b2
    bit-equal on closest-hit rays, equal any-hit flags, equal iters, no
    overflow; b1/b2 bit-equal to kernel_bary on the closest hits."""
    t, s, b1, b2, it = got
    cl = ah == 0
    assert int((s[cl] >= 0).sum()) > 1000 and int((s[~cl] >= 0).sum()) > 1000
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a[cl], b[cl])
    assert torch.equal(s[~cl] >= 0, want[1][~cl] >= 0)
    assert torch.equal(it, want[4]) and not bool(torch.any(it & T.OVF_BIT))
    hit = cl & (s >= 0)
    rows = kb.tris[s[hit].long()]
    kb1, kb2 = kernel_bary(o[hit], d[hit], rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])
    assert torch.equal(kb1, b1[hit]) and torch.equal(kb2, b2[hit])


@pytest.mark.parametrize("which", ["small", "large", "ply"])
@pytest.mark.parametrize("variant", ["all", "block", "packet"])
def test_bary_kernel_matches_plain(variant, which, tmp_path):
    """B2 ("all") and B4/B5 ("block"/"packet") against their plain walk."""
    needs_cuda()
    dev = torch.device("cuda")
    cs = _bench_tables(which, dev, tmp_path)
    kb = cs.data.bvh
    assert (kb.metas.shape[0] > 32768) == (which == "ply")
    o, d, tm, ah = _launch_rays(cs, dev)
    before = dict(T.traverse.bary_launches)
    got = T.traverse(kb, o, d, tm, ah, variant=variant)
    torch.cuda.synchronize()
    assert T.traverse.bary_launches[variant] == before[variant] + 1
    _hold(got, T.traverse_plain(kb, o, d, tm, ah, variant=variant), ah, kb, o, d)


@pytest.mark.parametrize("which", ["small", "large", "ply"])
def test_bvh4_kernel_matches_plain(which, tmp_path):
    """B3 against its plain walk, and its hits against B1's: equal hit
    masks, t equal on >= 99.99% of closest hits."""
    needs_cuda()
    dev = torch.device("cuda")
    cs = _bench_tables(which, dev, tmp_path)
    kb = cs.data.bvh
    kb4 = T.pack_kernel_bvh4(kb)
    o, d, tm, ah = _launch_rays(cs, dev)
    before = T.traverse4.launches
    got = T.traverse4(kb4, o, d, tm, ah)
    torch.cuda.synchronize()
    assert T.traverse4.launches == before + 1
    _hold(got, T.traverse4_plain(kb4, o, d, tm, ah), ah, kb, o, d)
    t1, s1, _ = T.traverse(kb, o, d, tm, ah)
    cl = ah == 0
    assert torch.equal(got[1] >= 0, s1 >= 0)
    hit = cl & (s1 >= 0)
    assert float((got[0][hit] == t1[hit]).float().mean()) >= 0.9999


def test_new_wrappers_raise_instead_of_falling_back(tmp_path):
    needs_cuda()
    dev = torch.device("cuda")
    cs = build_bench_scene(False, dev)
    kb = cs.data.bvh
    o, d = (torch.as_tensor(a, device=dev) for a in rays_at_knot(64, seed=35))
    tm = torch.full((64,), float("inf"), device=dev)
    ah = torch.zeros(64, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="variant"):
        T.traverse(kb, o, d, tm, ah, variant="queue4")
    with pytest.raises(TypeError):
        T.traverse(kb, o, d.double(), tm, ah, variant="packet")
    with pytest.raises(ValueError):
        T.traverse(kb, o, d, tm.cpu(), ah, variant="all")
    kb4 = T.pack_kernel_bvh4(kb)
    with pytest.raises(ValueError):
        T.traverse4(kb4, o, d.t().contiguous().t(), tm, ah)
    with pytest.raises(ValueError):
        T.traverse4(dataclasses.replace(kb4, nodes4=kb4.nodes4[:-1]), o, d, tm, ah)
    with pytest.raises(ValueError):
        T.traverse4(dataclasses.replace(kb4, stack_need=T.STACK4 + 1), o, d, tm, ah)


def test_ply_render_goes_through_the_packet_kernel(tmp_path):
    """A crop of the PLY bench scene: its tree is over 32,768 nodes, so each
    pass launches the "packet" kernel once for the camera and 4 times for
    the bounces and no B1 kernel; bitwise equal over two renders, and close
    to the same crop rendered on the CPU with the plain walk."""
    needs_cuda()
    opts = Options(crop_window=(0.5, 0.5625, 0.5, 0.5625))
    cs = build_ply_bench_scene(str(tmp_path), "cuda", options=opts)
    T.traverse.launches = 0
    T.traverse.bary_launches["packet"] = 0
    a, cnt, passes = render_sampler_integrator(cs, opts)
    torch.cuda.synchronize()
    assert T.traverse.bary_launches["packet"] == 5 * passes and T.traverse.launches == 0
    assert cnt["camera_rays"] == 16 * 16 * 4
    b, _, _ = render_sampler_integrator(cs, opts)
    assert torch.equal(a, b)
    c, _, _ = render_sampler_integrator(build_ply_bench_scene(str(tmp_path), "cpu", options=opts),
                                        opts)
    a, c = a.cpu().numpy(), c.numpy()
    assert np.all(np.isfinite(a)) and a.sum() > 0
    near = np.all(np.abs(a - c) <= 1e-4 + 1e-3 * np.abs(c), axis=-1).mean()
    assert near >= 0.99 and abs(a.mean() - c.mean()) <= 0.01 * abs(c.mean())


def _resident_threads():
    p = torch.cuda.get_device_properties(0)
    return p.multi_processor_count * p.max_threads_per_multi_processor


def _walk_launch(kb, n, variant, dev):
    """One 2-wide kernel launch of n rays at the knot, every other one
    any-hit -> (its outputs, its launches, the plain walk's outputs)."""
    o, d = (torch.as_tensor(a, device=dev) for a in rays_at_knot(n, seed=36))
    ah = (torch.arange(n, device=dev) % 2).to(torch.uint8)
    args = (kb, o, d, torch.full((n,), float("inf"), device=dev), ah)
    count = lambda: T.traverse.launches if variant == "queue" else \
        T.traverse.bary_launches[variant]
    before = count()
    got = T.traverse(*args, variant=variant)
    launches = count() - before
    return got, launches, T.traverse_plain(*args, variant=variant)


def _walk4_launch(kb4, n, dev):
    """One 4-wide kernel launch of n rays at the knot, every other one
    any-hit -> (its outputs, its launches, the plain walk's outputs)."""
    o, d = (torch.as_tensor(a, device=dev) for a in rays_at_knot(n, seed=36))
    ah = (torch.arange(n, device=dev) % 2).to(torch.uint8)
    args = (kb4, o, d, torch.full((n,), float("inf"), device=dev), ah)
    before = T.traverse4.launches
    got = T.traverse4(*args)
    return got, T.traverse4.launches - before, T.traverse4_plain(*args)


@pytest.mark.parametrize("size", ["empty", "ragged", "refill"])
@pytest.mark.parametrize("kernel", ["queue", "all", "packet", "instance", "bvh4"])
def test_redesigned_kernel_launch_sizes(kernel, size):
    """The "queue" (B1), "all" (B2), "packet" (B4/B5), instance (B6) and
    4-wide (B3) kernels at 0 rays (no launch), at a ragged 4,099 rays (not a
    multiple of 32 or of the block), and at 8x the card's resident threads
    plus 13 (many waves of blocks): every output bit-equal to the plain
    walk, iters included."""
    needs_cuda()
    dev = torch.device("cuda")
    n = {"empty": 0, "ragged": 4099, "refill": 8 * _resident_threads() + 13}[size]
    if kernel == "bvh4":
        kb4 = T.pack_kernel_bvh4(build_bench_scene(False, dev).data.bvh)
        got, launches, want = _walk4_launch(kb4, n, dev)
    elif kernel != "instance":
        got, launches, want = _walk_launch(build_bench_scene(False, dev).data.bvh, n, kernel, dev)
    else:
        args = (build_instanced_bench_scene(False, dev).data.ibvh, *_grid_rays(n, 37, dev), False)
        before = I.instance_traverse.launches
        got = I.instance_traverse(*args)
        launches = I.instance_traverse.launches - before
        want = I.instance_traverse_plain(*args)
    torch.cuda.synchronize()
    assert launches == (n > 0)
    assert got[1].shape == (n,) and got[-1].shape == (-(-n // T.GROUP),)
    if n:
        assert int((got[1] >= 0).sum()) > n // 10
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not bool(torch.any(got[-1] & T.OVF_BIT))


@pytest.mark.parametrize("variant", ["queue", "all", "packet"])
def test_walk_from_a_leaf_root(variant):
    """A tree of 8 triangles is one leaf: no walk records, and the kernel's
    walk starts on the leaf's word. Every output of 4,099 rays, half of them
    any-hit, bit-equal to the plain walk, iters included."""
    needs_cuda()
    dev = torch.device("cuda")
    m = make_knot_mesh(2, 2, 0.45)
    tp = m.p[m.indices]
    kb = T.pack_kernel_bvh(build_bvh(tp.min(1), tp.max(1)), tp[:, 0], tp[:, 1], tp[:, 2],
                           device=dev)
    assert kb.recs.shape[0] == 0 and kb.root_word == int(kb.metas[0]) and kb.max_depth == 0
    got, launches, want = _walk_launch(kb, 4099, variant, dev)
    torch.cuda.synchronize()
    assert launches == 1 and int((got[1] >= 0).sum()) > 50
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_gradients_on_the_card_match_the_cpu():
    """grad_wrt_params on the differentiable scene at 16x16, 4 samples,
    depth 2: the card's loss within 1e-5 relative of the CPU's and each
    gradient table within 1e-4 of its largest entry (the same paths; the
    card sums in another order), every entry finite."""
    needs_cuda()
    from pbrt_tpu_torch.diff import grad_wrt_params
    from pbrt_tpu_torch.scene.bench import build_diff_scene
    out = {}
    for dev in ("cuda", "cpu"):
        xs, ys = np.meshgrid(np.arange(16), np.arange(16))
        px, py = (torch.as_tensor(a.ravel().astype(np.int32), device=dev) for a in (xs, ys))
        out[dev] = grad_wrt_params(build_diff_scene(16, dev), px, py, n_samples=4, max_depth=2)
    (lc, gc), (lp, gp) = out["cuda"], out["cpu"]
    assert abs(float(lc) - float(lp)) <= 1e-5 * float(lp)
    for a, b in zip(gc, gp):
        a = a.cpu()
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_textured_render_takes_the_alpha_rounds(tmp_path):
    """The small textured bench scene on the card: B1 launches 4 times an
    intersection (the walk and ALPHA_ROUNDS re-traces), 20 a pass at depth
    4; the image is finite and nonzero and its 8x8 crop close to the CPU's
    (>= 99% of pixels within rtol 1e-3 / atol 1e-4)."""
    needs_cuda()
    from pbrt_tpu_torch.scene.bench import build_textured_bench_scene, write_floor_image
    image = str(tmp_path / "floor.png")
    write_floor_image(image, size=(48, 40))
    opts = Options(crop_window=(0.375, 0.5, 0.375, 0.5))
    before = T.traverse.launches
    img, cnt, passes = render_sampler_integrator(
        build_textured_bench_scene(image, large=False, device="cuda", options=opts), opts)
    torch.cuda.synchronize()
    assert T.traverse.launches - before == 20 * passes
    assert torch.isfinite(img).all() and float(img.sum()) > 0
    cpu, _, _ = render_sampler_integrator(
        build_textured_bench_scene(image, large=False, device="cpu", options=opts), opts)
    a, c = img.cpu().numpy(), cpu.numpy()
    assert np.all(np.abs(a - c) <= 1e-4 + 1e-3 * np.abs(c), axis=-1).mean() >= 0.99


def _crop_close(a, c):
    a, c = a.cpu().numpy(), c.numpy()
    return np.all(np.abs(a - c) <= 1e-4 + 1e-3 * np.abs(c), axis=-1).mean()


def test_config3_crop_on_the_card_matches_the_cpu(tmp_path):
    """BASELINE config 3's small scene on the card: B1 6 launches a pass
    (the camera walk and 5 pair launches at depth 5); its centre 32x32
    crop finite, nonzero and close to the CPU's (>= 99% of pixels within
    rtol 1e-3 / atol 1e-4, as chip_smoke.py holds its crops: a pixel whose
    path meets a glass edge or an environment texel edge may take the
    other branch on the card's sin, cos and atan2)."""
    needs_cuda()
    from pbrt_tpu_torch.scene.bench import write_env_material_scene
    from pbrt_tpu_torch.scene.build import load_scene
    path = write_env_material_scene(str(tmp_path), large=False)
    opts = Options(crop_window=(0.25, 0.75, 0.25, 0.75))
    before = T.traverse.launches
    img, _, passes = render_sampler_integrator(load_scene(path, opts, "cuda"), opts)
    torch.cuda.synchronize()
    assert T.traverse.launches - before == 6 * passes
    assert torch.isfinite(img).all() and float(img.sum()) > 0
    cpu, _, _ = render_sampler_integrator(load_scene(path, opts, "cpu"), opts)
    assert _crop_close(img, cpu) >= 0.99


def test_all_kinds_scene_is_finite_on_the_card(tmp_path):
    """The all-kinds scene (every ported material kind, a fourier table,
    goniometric and projection maps, the spatial strategy) at 64x64 and 2
    spp on the card: finite and nonzero, each sphere lit, and its centre
    32x32 crop close to the CPU's."""
    needs_cuda()
    from pbrt_tpu_torch.scene.bench import write_all_kinds_scene
    from pbrt_tpu_torch.scene.build import load_scene
    path = write_all_kinds_scene(str(tmp_path), spp=2)
    img, _, _ = render_sampler_integrator(load_scene(path, None, "cuda"), Options())
    assert tuple(img.shape) == (64, 64, 3) and torch.isfinite(img).all()
    assert float(img.sum()) > 0
    opts = Options(crop_window=(0.25, 0.75, 0.25, 0.75))
    a, _, _ = render_sampler_integrator(load_scene(path, opts, "cuda"), opts)
    c, _, _ = render_sampler_integrator(load_scene(path, opts, "cpu"), opts)
    assert _crop_close(a, c) >= 0.99


@pytest.mark.parametrize("kind,kw", [("stratified", dict(xsamples=4, ysamples=4)),
                                     ("halton", {}), ("sobol", {}), ("sobol", dict(owen=True)),
                                     ("maxmindist", {})])
def test_sampler_draw_on_the_card_matches_the_cpu(kind, kw):
    """The samplers' u32 hashes, digit permutations and Sobol' byte tables
    on the card: dims 0-44 of 65,536 lanes bit-equal to the CPU's draw."""
    needs_cuda()
    from pbrt_tpu_torch.samplers import SamplerSpec, sample_2d, sample_dim
    spec = SamplerSpec(kind, 16, 0, (256, 256), **kw)
    rng = np.random.default_rng(9)
    lanes = [rng.integers(0, 256, 65_536).astype(np.int32) for _ in range(2)]
    lanes.append(rng.integers(0, spec.rounded_spp(), 65_536).astype(np.int32))
    gpu, cpu = [torch.as_tensor(a, device="cuda") for a in lanes], [torch.as_tensor(a) for a in lanes]
    for dim in range(45):
        assert torch.equal(sample_dim(spec, *gpu, dim).cpu(), sample_dim(spec, *cpu, dim)), dim
    assert torch.equal(sample_2d(spec, *gpu, 0).cpu(), sample_2d(spec, *cpu, 0))


@pytest.mark.parametrize("scene", ["config4", "volpath"])
def test_new_scene_crops_on_the_card_match_the_cpu(scene, tmp_path):
    """The small BASELINE config 4 (a glass knot before a mirror through a
    lens, Sobol' at 16 spp) and the small volpath scene (a fog and a grid
    medium around the knot, 4 spp): B1 6 and 26 launches a pass (volpath:
    6 bounce walks and 4 transmittance rounds for each of 5 shadow rays),
    and the centre 32x32 crop finite, nonzero and close to the CPU's: on
    >= 99% of its pixels, and for config 4 on 99% of its lanes too
    (li_path of each pixel at each sample index): the card takes its
    reciprocal square roots as 1 / sqrt, whose rounding keeps the glass
    knot's specular chains on the CPU's paths."""
    needs_cuda()
    from pbrt_tpu_torch.scene.bench import write_config4_scene, write_volpath_scene
    from pbrt_tpu_torch.scene.build import load_scene
    path = (write_config4_scene(str(tmp_path), large=False, spp=16) if scene == "config4"
            else write_volpath_scene(str(tmp_path), large=False))
    opts = Options(crop_window=(0.25, 0.75, 0.25, 0.75))
    before = T.traverse.launches
    img, _, passes = render_sampler_integrator(load_scene(path, opts, "cuda"), opts)
    torch.cuda.synchronize()
    assert T.traverse.launches - before == (6 if scene == "config4" else 26) * passes
    assert torch.isfinite(img).all() and float(img.sum()) > 0
    cpu, _, _ = render_sampler_integrator(load_scene(path, opts, "cpu"), opts)
    assert _crop_close(img, cpu) >= 0.99
    assert abs(float(img.mean()) - float(cpu.mean())) <= 0.01 * float(cpu.mean())
    if scene == "config4":
        from pbrt_tpu_torch.integrators.path import li_path
        out = []
        for dev in ("cuda", "cpu"):
            cs = load_scene(path, opts, dev)
            px, py = (torch.as_tensor(a, device=dev) for a in sample_pixels(cs.film))
            sidx = torch.arange(16, device=dev, dtype=torch.int32).repeat_interleave(px.shape[0])
            out.append(li_path(cs, px.repeat(16), py.repeat(16), sidx, max_depth=5)[0])
        assert _crop_close(*out) >= 0.99


@pytest.mark.parametrize("integrator", ["whitted", "direct_all", "direct_one", "bdpt"])
def test_new_integrator_crops_on_the_card_match_the_cpu(integrator, tmp_path):
    """The small config 3 (64x64, 4 spp, depth 5) under whitted and
    directlighting (B1 11 launches a pass: 6 intersections and one shadow
    ray a bounce) and the small bench scene under bdpt (64x64, 4 spp,
    depth 4; B1 28 a pass), through the render dispatcher: the centre 32x32
    crop finite, nonzero and within rtol 1e-3 / atol 1e-4 of the CPU's on
    >= 99% of its pixels, the means within 1%."""
    needs_cuda()
    from pbrt_tpu_torch.render import render
    from pbrt_tpu_torch.scene.bench import write_bdpt_scene, write_env_material_scene
    from pbrt_tpu_torch.scene.build import load_scene
    lines = {"whitted": 'Integrator "whitted" "integer maxdepth" 5',
             "direct_all": 'Integrator "directlighting" "integer maxdepth" 5',
             "direct_one": 'Integrator "directlighting" "integer maxdepth" 5 '
                           '"string strategy" "one"'}
    path = (write_bdpt_scene(str(tmp_path), large=False) if integrator == "bdpt" else
            write_env_material_scene(str(tmp_path), large=False, spp=4,
                                     integrator=lines[integrator]))
    opts = Options(crop_window=(0.25, 0.75, 0.25, 0.75))
    before = T.traverse.launches
    img, _, passes = render(load_scene(path, opts, "cuda"), opts)
    torch.cuda.synchronize()
    assert T.traverse.launches - before == (28 if integrator == "bdpt" else 11) * passes
    assert torch.isfinite(img).all() and float(img.sum()) > 0
    cpu, _, _ = render(load_scene(path, opts, "cpu"), opts)
    assert _crop_close(img, cpu) >= 0.99
    assert abs(float(img.mean()) - float(cpu.mean())) <= 0.01 * float(cpu.mean())


@pytest.mark.parametrize("integrator", ["mlt", "mlt_path", "sppm"])
def test_mlt_and_sppm_on_the_card_match_the_cpu(integrator, tmp_path):
    """The small bench scene (64x64, its knot from a PLY file) under mlt
    (depth 4, 4,096 bootstrap samples, 1,024 chains, 8 steps; B1 28
    launches a BDPT-target evaluation, 5 a path-target one) and sppm
    (depth 5, 4 iterations of 4,096 photons; B1 15 launches an
    iteration), through the render dispatcher: finite and nonzero,
    bitwise equal over two renders, and within rtol 1e-3 / atol 1e-4 of
    the CPU's render on >= 99% of its pixels, the means within 1%; SPPM's
    overflow count the CPU's."""
    needs_cuda()
    from pbrt_tpu_torch.render import render
    from pbrt_tpu_torch.scene.bench import write_mlt_scene, write_sppm_scene
    from pbrt_tpu_torch.scene.build import load_scene
    if integrator == "sppm":
        path = write_sppm_scene(str(tmp_path), 0.08, large=False, iterations=4)
    else:
        path = write_mlt_scene(str(tmp_path), large=False, bootstrap=4096, chains=1024,
                               mutations=2, target="path" if integrator == "mlt_path" else "bdpt")
    per_pass = {"mlt": 28, "mlt_path": 5, "sppm": 15}[integrator]
    before = T.traverse.launches
    img, cnt, passes = render(load_scene(path, None, "cuda"))
    torch.cuda.synchronize()
    assert T.traverse.launches - before == per_pass * passes
    assert torch.isfinite(img).all() and float(img.sum()) > 0
    again, _, _ = render(load_scene(path, None, "cuda"))
    assert torch.equal(img, again)
    cpu, cnt_cpu, _ = render(load_scene(path, None, "cpu"))
    assert _crop_close(img, cpu) >= 0.99
    assert abs(float(img.mean()) - float(cpu.mean())) <= 0.01 * float(cpu.mean())
    if integrator == "sppm":
        assert cnt["grid_overflows"] == cnt_cpu["grid_overflows"]


# device kernels of one full render under torch.profiler before the new
# material, light and strategy stages (PERF.md section 5's ranges over
# earlier chip runs); the sphere scene, matte only, now skips the glossy
# family and issues about 28,000 fewer
UNTOUCHED_KERNELS = {"large": (30136, 30208), "static": (31596, 31674),
                     "animated": (33483, 33562), "ply": (28932, 29016),
                     "sphere": (162857, 162949), "showcase": (49932, 50047),
                     "textured": (99631, 99666)}


@pytest.mark.parametrize("name", list(UNTOUCHED_KERNELS))
def test_untouched_scenes_keep_their_device_kernels(name, tmp_path):
    """One full render of each scene that holds none of the new stages
    under torch.profiler: its device kernels within the range it had
    before them, widened by 0.5% for the run-to-run spread of the
    profiler's count (its memsets and copies move with the allocator's
    state: one process counted the showcase at 50,060, another at 50,044,
    on the same tensor ops); the sphere scene below that range."""
    needs_cuda()
    from torch.profiler import ProfilerActivity, profile
    from pbrt_tpu_torch.scene import bench as Bn
    image = str(tmp_path / "floor.png")
    Bn.write_floor_image(image)
    cs = {"large": lambda: Bn.build_bench_scene(True, "cuda"),
          "static": lambda: Bn.build_instanced_bench_scene(False, "cuda"),
          "animated": lambda: Bn.build_instanced_bench_scene(True, "cuda"),
          "ply": lambda: Bn.build_ply_bench_scene(str(tmp_path), "cuda"),
          "sphere": lambda: Bn.build_sphere_scene("cuda"),
          "showcase": lambda: Bn.build_quadric_showcase("cuda"),
          "textured": lambda: Bn.build_textured_bench_scene(image, True, "cuda")}[name]()
    render_sampler_integrator(cs, Options())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render_sampler_integrator(cs, Options())
        torch.cuda.synchronize()
    n = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
    lo, hi = UNTOUCHED_KERNELS[name]
    lo, hi = int(lo * 0.995), int(hi * 1.005)
    assert n < lo if name == "sphere" else lo <= n <= hi, n


def _kd_scene(dev, options=None, **variant):
    from pbrt_tpu_torch.scene import bench as Bn
    from pbrt_tpu_torch.scene.build import build_scene
    return build_scene(Bn.bench_variant_description(False, **variant), options, dev)


def test_kd_kernel_matches_plain():
    """K1 against intersect_kdtree_plain (on the card's tensors) on the
    small bench knot's kd-tree (a camera launch and 20,001 random rays, the
    second half any-hit) and on bench.deep_kd_case's 72-level tree, whose
    diagonal rays push past the stack's 64 entries (the drop and clamp
    rules decide their hits): t, triangle, b1 and b2 bit-equal on every
    ray; one launch counted each."""
    needs_cuda()
    from pbrt_tpu_torch.accel import kdtree as K
    from pbrt_tpu_torch.scene.bench import deep_kd_case
    dev = torch.device("cuda")
    cs = _kd_scene(dev, accelerator="kdtree")
    assert cs.flags.accel == "kdtree"
    tab, tp, *deep = deep_kd_case()
    T = lambda a: torch.as_tensor(a, device=dev)
    deep_kd = K.KdTree.from_tables(tab, T(tp[:, 0]), T(tp[:, 1]), T(tp[:, 2]))
    for kd, rays in ((cs.data.kd, _launch_rays(cs, dev)), (deep_kd, [T(a) for a in deep])):
        before = K.intersect_kdtree.launches
        got = K.intersect_kdtree(kd, *rays)
        torch.cuda.synchronize()
        assert K.intersect_kdtree.launches == before + 1
        want = K.intersect_kdtree_plain(kd, *rays)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert bool((got[1] >= 0).any()) and bool((got[1] < 0).any())


def test_kd_wrapper_raises_instead_of_falling_back():
    needs_cuda()
    from pbrt_tpu_torch.accel import kdtree as K
    dev = torch.device("cuda")
    cs = _kd_scene(dev, accelerator="kdtree")
    o, d, tm, ah = _launch_rays(cs, dev)
    with pytest.raises(TypeError):
        K.intersect_kdtree(cs.data.kd, o, d, tm, ah.to(torch.int32))
    with pytest.raises(ValueError):
        K.intersect_kdtree(cs.data.kd, o, d.cpu(), tm, ah)


@pytest.mark.parametrize("variant", ["moving", "kdtree", "subsurface", "kdsubsurface"])
def test_slice_forms_on_the_card_match_the_cpu(variant):
    """The small bench scene with a moving camera, under the kd-tree, and
    with a subsurface or kdsubsurface knot: a 16x16 crop bitwise equal over
    two card renders and within rtol 1e-3 / atol 1e-4 of the CPU's on 99%
    of its pixels, the means within 1%; the kd render launches K1 and no
    BVH kernel, the others B1 and not K1."""
    needs_cuda()
    from pbrt_tpu_torch.accel import kdtree as K
    from pbrt_tpu_torch.scene import bench as Bn
    kw = {"moving": dict(motion=Bn.CAMERA_MOTION), "kdtree": dict(accelerator="kdtree"),
          "subsurface": dict(knot_material=Bn.SUBSURFACE_KNOT),
          "kdsubsurface": dict(knot_material=Bn.KDSUBSURFACE_KNOT)}[variant]
    crop = Options(crop_window=(0.5, 0.75, 0.5, 0.75))
    b1, k1 = T.traverse.launches, K.intersect_kdtree.launches
    a, _, _ = render_sampler_integrator(_kd_scene("cuda", crop, **kw), crop)
    torch.cuda.synchronize()
    if variant == "kdtree":
        assert T.traverse.launches == b1 and K.intersect_kdtree.launches > k1
    else:
        assert T.traverse.launches > b1 and K.intersect_kdtree.launches == k1
    b, _, _ = render_sampler_integrator(_kd_scene("cuda", crop, **kw), crop)
    c, _, _ = render_sampler_integrator(_kd_scene("cpu", crop, **kw), crop)
    assert a.shape == (16, 16, 3) and torch.equal(a, b) and float(a.sum()) > 0
    a, c = a.cpu().numpy(), c.numpy()
    assert np.mean(np.all(np.abs(a - c) <= 1e-4 + 1e-3 * np.abs(c), -1)) >= 0.99
    assert abs(a.mean() - c.mean()) <= 0.01 * abs(c.mean())


def test_spectral_crop_on_the_card_matches_the_cpu():
    """The small bench scene under "bool spectral" "true": the scene is
    spectral, a 16x16 crop launches B1, is bitwise equal over two card
    renders and within rtol 1e-3 / atol 1e-4 of the CPU's on 99% of its
    pixels, the means within 1%."""
    needs_cuda()
    crop = Options(crop_window=(0.5, 0.75, 0.5, 0.75))
    kw = dict(integrator='Integrator "path" "integer maxdepth" 4 "bool spectral" "true"')
    b1 = T.traverse.launches
    cs = _kd_scene("cuda", crop, **kw)
    assert cs.flags.spectral
    a, _, _ = render_sampler_integrator(cs, crop)
    torch.cuda.synchronize()
    assert T.traverse.launches > b1
    b, _, _ = render_sampler_integrator(_kd_scene("cuda", crop, **kw), crop)
    c, _, _ = render_sampler_integrator(_kd_scene("cpu", crop, **kw), crop)
    assert a.shape == (16, 16, 3) and torch.equal(a, b) and float(a.sum()) > 0
    a, c = a.cpu().numpy(), c.numpy()
    assert np.mean(np.all(np.abs(a - c) <= 1e-4 + 1e-3 * np.abs(c), -1)) >= 0.99
    assert abs(a.mean() - c.mean()) <= 0.01 * abs(c.mean())


def test_resume_on_the_card_is_bit_identical(tmp_path):
    """The small bench scene at 4 spp, a pass a sample: a checkpoint every
    2 passes leaves one at sample 2, and the render resumed from it on the
    card equals the straight render bit for bit."""
    needs_cuda()
    from pbrt_tpu_torch.utils.checkpoint import load_checkpoint
    cs = build_bench_scene(False, "cuda")
    lanes = len(sample_pixels(cs.film)[0])
    want, _, passes = render_sampler_integrator(cs, Options(wavefront_size=lanes))
    ck = str(tmp_path / "ck.npz")
    render_sampler_integrator(cs, Options(wavefront_size=lanes, checkpoint_path=ck,
                                          checkpoint_every=2))
    assert passes == 4 and load_checkpoint(ck)[1] == 2
    got, _, rest = render_sampler_integrator(
        cs, Options(wavefront_size=lanes, checkpoint_path=ck, resume=True))
    assert rest == 2 and torch.equal(got, want) and float(want.sum()) > 0


def test_sharded_render_on_the_card():
    """The small bench scene by render with devices=2 (on one card a world
    of one rank under NCCL) and by render_sharded over two ranks (on one
    card sharing it under gloo): each within rtol 2e-5 / atol 2e-6 of
    render_sampler_integrator's image, the counters equal."""
    needs_cuda()
    from pbrt_tpu_torch.parallel import mesh as MS
    from pbrt_tpu_torch.render import render
    cs = build_bench_scene(False, "cuda")
    want, cnt, _ = render_sampler_integrator(cs, Options())
    assert MS.backend_for("cuda", MS.n_ranks_for(2, "cuda")) == "nccl"
    assert MS.backend_for("cuda", 2) == ("gloo" if torch.cuda.device_count() == 1 else "nccl")
    for got, cnt2, _ in (render(cs, Options(devices=2)), MS.render_sharded(cs, 2, Options())):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-5, atol=2e-6)
        assert cnt2 == cnt
