"""Stateless sample generators (port of pbrt_tpu/samplers/__init__.py).

    sample_dim(spec, px, py, sample_index, dim) -> [N] float32 in [0,1)

is a pure function of its integer inputs, so the port's samples equal the
reference's bit for bit. The slice ports the `random` and `02sequence`
families; the others raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from pbrt_tpu_torch.samplers import hashing as H
from pbrt_tpu_torch.samplers import lds

PORTED_KINDS = ("random", "02sequence")


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    kind: str = "random"
    spp: int = 16
    seed: int = 0
    resolution: Tuple[int, int] = (0, 0)

    def rounded_spp(self) -> int:
        """(0,2)-sequence samplers need a power-of-two spp."""
        if self.kind == "02sequence":
            return 1 << max(0, (self.spp - 1).bit_length())
        return self.spp


def make_sampler(kind: str, params: dict, resolution: Tuple[int, int],
                 seed: int = 0) -> SamplerSpec:
    """SamplerSpec from a .pbrt ParamSet dict (name -> values)."""
    if kind == "lowdiscrepancy":
        kind = "02sequence"
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"sampler {kind!r} is not ported")
    if params.get("owenscramble", [False])[0]:
        raise NotImplementedError("sampler option 'owenscramble' is not ported")
    spp = int(params.get("pixelsamples", [16])[0])
    return SamplerSpec(kind, spp, seed, resolution)


def _dim_key(spec, dim):
    return H.hash_combine(torch.tensor(spec.seed, dtype=torch.int64), dim)


def sample_dim(spec: SamplerSpec, px, py, sample_idx, dim: int):
    """[N] float32 sample for static dimension `dim`; px, py, sample_idx are
    [N] integer tensors."""
    pix = H.hash3(H.u32(px), H.u32(py), spec.seed)
    s = H.u32(sample_idx)
    if spec.kind == "random":
        return H.u32_to_float(H.hash3(pix, s, dim))
    if spec.kind == "02sequence":
        mask = spec.rounded_spp() - 1
        # every 2D slot reuses the (0,2) matrix pair, scrambled per slot
        shuffled = H.nested_uniform_shuffle(
            s, mask, H.hash_combine(pix, dim // 2)) & mask
        v = lds.sobol_sample_u32(shuffled, lds.sobol_matrices()[dim % 2],
                                 bits=mask.bit_length())
        key = H.hash_combine(pix, _dim_key(spec, dim).to(pix.device))
        return H.u32_to_float(H.owen_scramble_u32(v, key))
    raise NotImplementedError(f"sampler {spec.kind!r} is not ported")


def sample_2d(spec: SamplerSpec, px, py, sample_idx, dim: int):
    """[N, 2] sample for the 2D slot at (dim, dim+1)."""
    return torch.stack([sample_dim(spec, px, py, sample_idx, dim),
                        sample_dim(spec, px, py, sample_idx, dim + 1)], -1)
