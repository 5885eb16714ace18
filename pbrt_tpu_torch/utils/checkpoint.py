"""Checkpoint and resume of a progressive render (port of
pbrt_tpu/utils/checkpoint.py).

A render's whole state is its film and its sample cursor (every sample is
a pure function of pixel and sample index), so a checkpoint is one .npz
and a resumed render equals a straight-through one. The file has the
reference's keys, so a checkpoint of either package loads in the other.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from pbrt_tpu_torch.film import FilmState


def save_checkpoint(path: str, film: FilmState, sample_index: int, meta: dict = None):
    """Write film and cursor to path: a sibling temporary file, then
    os.replace, so a kill during the save never leaves a truncated file.
    A film without splats saves zero splats."""
    rgb = film.rgb_sum.detach().cpu().numpy()
    splat = film.splat.detach().cpu().numpy() if film.splat is not None else np.zeros_like(rgb)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, rgb_sum=rgb, weight_sum=film.weight_sum.detach().cpu().numpy(),
                            splat=splat, sample_index=np.int64(sample_index),
                            **{f"meta_{k}": v for k, v in (meta or {}).items()})
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cpu"):
    """-> (FilmState on device, sample_index, meta), or None where the file
    is missing or corrupt. All-zero splats load as a film without splats
    (a sampler integrator's)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            to = lambda k: torch.as_tensor(np.asarray(z[k], np.float32), device=device)
            splat = to("splat") if np.any(z["splat"]) else None
            film = FilmState(to("rgb_sum"), to("weight_sum"), splat)
            meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
            return film, int(z["sample_index"]), meta
    except Exception:  # noqa: BLE001 - a corrupt checkpoint restarts the render
        return None
