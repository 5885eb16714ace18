"""The BVH traversal kernel on the card, in a process without JAX.

Run on a machine with an NVIDIA GPU (`--noconftest` skips tests/conftest.py,
which configures JAX; nothing here imports it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Every test skips where torch sees no CUDA device: the kernel has no CPU mode.
"""
import numpy as np
import pytest
import torch

from torch_port_helpers import needs_cuda, rays_at_knot

from pbrt_tpu_torch.accel import traverse as T
from pbrt_tpu_torch.integrators.common import camera_rays
from pbrt_tpu_torch.render import Options, render_sampler_integrator, sample_pixels
from pbrt_tpu_torch.scene.bench import build_bench_scene


def _launch_rays(cs, dev):
    """A camera launch (every pixel, sample 0) followed by a pair launch of
    20,001 random rays, closest-hit then any-hit: odd N, zero components."""
    px, py = (torch.as_tensor(a, device=dev) for a in sample_pixels(cs.film))
    o_c, d_c, _, _ = camera_rays(cs, px, py, torch.zeros_like(px))
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
