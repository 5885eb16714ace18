"""Differentiable rendering: gradients of radiance with respect to scene
parameters (port of pbrt_tpu/diff/__init__.py), by torch.autograd.

Every sample is a pure hash of (pixel, sample index, dimension), so a
forward render is its own replay: backpropagating through `li_path`
differentiates the shading along the very paths it traced, while geometry
(intersections, visibility) stays a constant of the tape, as pbrt's
"detached" discontinuities (scene/intersect.py detaches it).

`DiffParams` holds the differentiable leaves: material constants, texture
parameters and light emission. `with_params` puts a set of them into a
scene; `grad_wrt_params` backpropagates a scalar image loss, one sample
index (one pass) at a time, so the tape is never larger than one pass.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class DiffParams(NamedTuple):
    mat_const: torch.Tensor   # [M, slots, 3] material constants (albedos, ...)
    tex_params: torch.Tensor  # [X, 16] texture parameters (colours, scales)
    light_L: torch.Tensor     # [L, 3] light emission


def get_params(cs) -> DiffParams:
    return DiffParams(cs.data.mats.const, cs.data.tex.params, cs.data.lights.L)


def with_params(cs, p: DiffParams):
    """The scene with its parameter tables replaced by p's tensors."""
    data = cs.data
    data = dataclasses.replace(
        data, mats=dataclasses.replace(data.mats, const=p.mat_const),
        tex=dataclasses.replace(data.tex, params=p.tex_params),
        lights=dataclasses.replace(data.lights, L=p.light_L))
    return dataclasses.replace(cs, data=data)


def render_samples(cs, params: DiffParams, px, py, sample_idx, max_depth: int = 3):
    """Radiance [N, 3] of the given pixels and samples under params;
    differentiable where params require gradients."""
    from pbrt_tpu_torch.integrators.path import li_path
    return li_path(with_params(cs, params), px, py, sample_idx, max_depth=max_depth)[0]


def grad_wrt_params(cs, px, py, n_samples: int = 8, max_depth: int = 3, loss_fn=None):
    """The loss, the mean over sample indices s < n_samples of
    loss_fn(radiance of every (px, py) at s) (default: the mean), and its
    gradient with respect to every DiffParams leaf -> (loss, DiffParams).
    One backward pass per sample index; the gradients add up."""
    loss_fn = loss_fn or torch.mean
    leaves = DiffParams(*(t.detach().clone().requires_grad_(True) for t in get_params(cs)))
    total = torch.zeros((), device=px.device)
    for s in range(n_samples):
        sidx = torch.full(px.shape, s, dtype=torch.int32, device=px.device)
        loss = loss_fn(render_samples(cs, leaves, px, py, sidx, max_depth))
        (loss / n_samples).backward()
        total = total + loss.detach()
    return total / n_samples, DiffParams(*(t.grad if t.grad is not None else torch.zeros_like(t)
                                           for t in leaves))
