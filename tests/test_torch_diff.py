"""Differentiable path replay (BASELINE config 5): the port's gradients on
tests/test_diff.py's scene (a matte sphere and a checkerboard floor under
a point light and a constant environment) at 16x16, 4 samples, depth 2,
against jax.grad of the reference and against the port's own central
differences.

Tolerances: against jax.grad, every entry of the three gradient tables
within 1e-4 relative of the largest entry (the same paths are traced; the
sums differ in rounding); against central differences, the test_diff.py
rule: within 5% of the difference quotient, with its epsilons (1e-3;
1e-2 for the light). The loss with the tape on is bitwise equal to the
loss without it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_helpers  # noqa: F401  (caps torch's threads)

from pbrt_tpu.diff import get_params as j_get_params, render_samples as j_render_samples
from pbrt_tpu.scene import load_scene_string as j_load_scene_string
from pbrt_tpu_torch.diff import DiffParams, get_params, grad_wrt_params, render_samples
from pbrt_tpu_torch.scene import load_scene_string
from pbrt_tpu_torch.scene.bench import DIFF_SCENE

SCENE = DIFF_SCENE.replace("{RES}", "16")
K, DEPTH = 4, 2
# (table, index, epsilon) of test_diff.py's three derivatives
CASES = {"albedo": ("mat_const", (1, 0, 0), 1e-3),
         "texture": ("tex_params", (0, 1), 1e-3),
         "light": ("light_L", (0, 1), 1e-2)}


def _pixels():
    xs, ys = np.meshgrid(np.arange(16), np.arange(16))
    return xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)


@pytest.fixture(scope="module")
def port():
    """(scene, pixels, the loss and its gradient from grad_wrt_params)."""
    cs = load_scene_string(SCENE, device="cpu")
    px, py = (torch.as_tensor(a) for a in _pixels())
    loss, grad = grad_wrt_params(cs, px, py, n_samples=K, max_depth=DEPTH)
    return cs, px, py, loss, grad


def _loss(cs, params, px, py):
    """The loss of grad_wrt_params without a tape."""
    total = torch.zeros(())
    with torch.no_grad():
        for s in range(K):
            sidx = torch.full(px.shape, s, dtype=torch.int32)
            total = total + torch.mean(render_samples(cs, params, px, py, sidx, DEPTH))
    return total / K


def _bumped(p, table, index, e):
    t = getattr(p, table).clone()
    t[index] += e
    return p._replace(**{table: t})


def test_loss_with_tape_equals_loss_without(port):
    cs, px, py, loss, grad = port
    assert torch.equal(loss, _loss(cs, get_params(cs), px, py))
    assert float(loss) > 0.05
    for g in grad:
        assert torch.isfinite(g).all()


@pytest.mark.parametrize("case", list(CASES))
def test_gradient_matches_central_differences(port, case):
    cs, px, py, _, grad = port
    table, index, eps = CASES[case]
    p0 = DiffParams(*(t.detach() for t in get_params(cs)))
    fd = (float(_loss(cs, _bumped(p0, table, index, eps), px, py))
          - float(_loss(cs, _bumped(p0, table, index, -eps), px, py))) / (2 * eps)
    ad = float(getattr(grad, table)[index])
    assert abs(ad - fd) < 0.05 * max(abs(fd), 1e-4), (ad, fd)
    if case != "texture":
        assert ad > 0.0


def test_scene_is_test_diffs():
    import re
    from test_diff import SCENE as REF
    assert SCENE == REF
    assert re.search(r"xresolution\" \[16\]", SCENE)


def test_gradients_match_jax_grad(port):
    """jax.grad of the reference's loss, formed as tests/test_diff.py forms
    it: the 4 samples of each pixel in one batched pass."""
    grad = port[4]
    jcs = j_load_scene_string(SCENE)
    px, py = (jnp.asarray(a) for a in _pixels())

    def loss(p):
        pxs, pys = jnp.tile(px, (K,)), jnp.tile(py, (K,))
        sidx = jnp.repeat(jnp.arange(K), px.shape[0]).astype(jnp.int32)
        return jnp.mean(j_render_samples(jcs, p, pxs, pys, sidx, max_depth=DEPTH))

    jgrad = jax.jit(jax.grad(loss))(j_get_params(jcs))
    for name in ("mat_const", "tex_params", "light_L"):
        got, want = getattr(grad, name).numpy(), np.asarray(getattr(jgrad, name))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=name)
        assert np.array_equal(got != 0, want != 0), name
