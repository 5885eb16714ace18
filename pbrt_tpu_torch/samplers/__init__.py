"""Stateless sample generators (port of pbrt_tpu/samplers/__init__.py).

    sample_dim(spec, px, py, sample_index, dim) -> [N] float32 in [0,1)

is a pure function of its integer inputs, so the port's samples equal the
reference's bit for bit. Families:
  random       counter-based PCG hash;
  stratified   shuffled (CMJ permutation) jittered strata, the 2D slots
               drawn jointly from the xsamples x ysamples grid;
  halton       the global Halton enumeration with pixel stride 2^j 3^k,
               digit-permutation scrambled from dimension 2 on;
  sobol        the reference-matched global Sobol' enumeration
               (sobol_ref.py); with owenscramble, per-pixel shuffled and
               Owen-scrambled Sobol' over the generated matrices;
  02sequence   that machinery on the (0,2) matrix pair, scrambled per 2D
               slot ("lowdiscrepancy" is its other name);
  maxmindist   02sequence with the C_MAX_MIN_DIST matrices in its first
               2D slot.
Every table (digit permutations, Sobol' byte tables) lives on the device
of the pixel coordinates. Each call of sample_dim or sample_2d is one
utils/trace.py span, "sampler".
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from pbrt_tpu_torch.samplers import hashing as H
from pbrt_tpu_torch.samplers import lds, sobol_ref
from pbrt_tpu_torch.utils.trace import span

KINDS = ("random", "stratified", "halton", "sobol", "02sequence", "maxmindist")


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    kind: str = "random"
    spp: int = 16
    seed: int = 0
    resolution: Tuple[int, int] = (0, 0)   # the film's full resolution
    xsamples: int = 4            # stratified: strata in x
    ysamples: int = 4            # and in y
    jitter: bool = True
    dimensions: int = 1024
    owen: bool = False           # sobol: the Owen-scrambled padded variant

    def rounded_spp(self) -> int:
        """Sobol-family samplers need a power-of-two spp; stratified takes
        xsamples x ysamples."""
        if self.kind in ("sobol", "02sequence", "maxmindist"):
            return 1 << max(0, (self.spp - 1).bit_length())
        if self.kind == "stratified":
            return self.xsamples * self.ysamples
        return self.spp


def make_sampler(kind: str, params: dict, resolution: Tuple[int, int],
                 seed: int = 0) -> SamplerSpec:
    """SamplerSpec from a .pbrt ParamSet dict (name -> values)."""
    spp = int(params.get("pixelsamples", [16])[0])
    if kind == "stratified":
        xs = int(params.get("xsamples", [4])[0])
        ys = int(params.get("ysamples", [4])[0])
        return SamplerSpec("stratified", xs * ys, seed, resolution, xs, ys,
                           bool(params.get("jitter", [True])[0]))
    if kind == "lowdiscrepancy":
        kind = "02sequence"
    if kind not in KINDS:
        raise ValueError(f"unknown sampler kind {kind!r}")
    return SamplerSpec(kind, spp, seed, resolution,
                       owen=bool(params.get("owenscramble", [False])[0]))


def _dim_key(spec, dim):
    return H.hash_combine(torch.tensor(spec.seed, dtype=torch.int64), dim)


@functools.lru_cache(None)
def _dim_key_int(seed: int, dim: int) -> int:
    """_dim_key as a host int, the key of the kinds other than 02sequence
    (02sequence keeps the tensor form: its op count is pinned for the
    scenes that use it)."""
    return int(H.hash_combine(torch.tensor(seed, dtype=torch.int64), dim))


def sample_dim(spec: SamplerSpec, px, py, sample_idx, dim: int):
    """[N] float32 sample for static dimension `dim`; px, py, sample_idx are
    [N] integer tensors."""
    with span("sampler"):
        return _sample_dim(spec, px, py, sample_idx, dim)


def _sample_dim(spec, px, py, sample_idx, dim):
    if spec.kind == "halton":
        return _halton_dim(spec, H.u32(px), H.u32(py), H.u32(sample_idx), dim)
    if spec.kind == "sobol" and not spec.owen:
        return sobol_ref.sobol_dim(spec.resolution, spec.rounded_spp(), H.u32(px),
                                   H.u32(py), H.u32(sample_idx), dim)
    pix = H.hash3(H.u32(px), H.u32(py), spec.seed)
    s = H.u32(sample_idx)
    if spec.kind == "random":
        return H.u32_to_float(H.hash3(pix, s, dim))
    if spec.kind == "stratified":
        return _stratified_dim(spec, pix, s, dim)
    mask = spec.rounded_spp() - 1
    if spec.kind == "sobol" or (spec.kind == "maxmindist" and dim < 2):
        shuffled = H.nested_uniform_shuffle(s, mask, pix) & mask
        if spec.kind == "maxmindist":
            return sobol_ref.maxmin_first_slot(spec.rounded_spp(), shuffled, dim)
        v = lds.sobol_sample_u32(shuffled, lds.sobol_matrices()[dim % lds.N_SOBOL_DIMS],
                                 bits=mask.bit_length())
        return H.u32_to_float(H.owen_scramble_u32(
            v, H.hash_combine(pix, _dim_key_int(spec.seed, dim))))
    if spec.kind in ("02sequence", "maxmindist"):
        # every 2D slot reuses the (0,2) matrix pair, scrambled per slot
        shuffled = H.nested_uniform_shuffle(
            s, mask, H.hash_combine(pix, dim // 2)) & mask
        v = lds.sobol_sample_u32(shuffled, lds.sobol_matrices()[dim % 2],
                                 bits=mask.bit_length())
        key = H.hash_combine(pix, _dim_key(spec, dim).to(pix.device))
        return H.u32_to_float(H.owen_scramble_u32(v, key))
    raise ValueError(f"unknown sampler kind {spec.kind!r}")


def sample_2d(spec: SamplerSpec, px, py, sample_idx, dim: int):
    """[N, 2] sample for the 2D slot at (dim, dim+1); stratified draws the
    pair jointly from its xsamples x ysamples grid."""
    with span("sampler"):
        if spec.kind == "stratified":
            return _stratified_2d(spec, H.hash3(H.u32(px), H.u32(py), spec.seed),
                                  H.u32(sample_idx), dim)
        return torch.stack([_sample_dim(spec, px, py, sample_idx, dim),
                            _sample_dim(spec, px, py, sample_idx, dim + 1)], -1)


def _div(x, n: int):
    """x / n rounded as IEEE division on every device (CUDA multiplies by
    the reciprocal of a scalar divisor, which rounds otherwise)."""
    return x / torch.full_like(x, n)


def _stratified_dim(spec, pix, s, dim):
    spp = spec.rounded_spp()
    key = H.hash_combine(pix, _dim_key_int(spec.seed, dim))
    stratum = H.cmj_permute(s, spp, key)
    j = H.u32_to_float(H.hash3(key, s, 0x55)) if spec.jitter else 0.5
    return torch.clamp(_div(stratum.to(torch.float32) + j, spp), max=H.ONE_MINUS_EPS)


def _stratified_2d(spec, pix, s, dim):
    xs, ys = spec.xsamples, spec.ysamples
    key = H.hash_combine(pix, _dim_key_int(spec.seed, dim))
    stratum = H.cmj_permute(s, xs * ys, key)
    sx = (stratum % xs).to(torch.float32)
    sy = (stratum // xs).to(torch.float32)
    if spec.jitter:
        ju = H.u32_to_float(H.hash3(key, s, 0xa1))
        jv = H.u32_to_float(H.hash3(key, s, 0xb2))
    else:
        ju = jv = 0.5
    return torch.stack([torch.clamp(_div(sx + ju, xs), max=H.ONE_MINUS_EPS),
                        torch.clamp(_div(sy + jv, ys), max=H.ONE_MINUS_EPS)], -1)


def _mult_inverse(a: int, n: int) -> int:
    t, new_t, r, new_r = 0, 1, n, a % n
    while new_r != 0:
        q = r // new_r
        t, new_t = new_t, t - q * new_t
        r, new_r = new_r, r - q * new_r
    return t % n


@functools.lru_cache(None)
def _halton_consts(resolution):
    """(j, k, 2^j, 3^k, stride, the CRT inverses) of a film resolution:
    2^j and 3^k are the least powers at or over min(extent, 128)."""
    rx = max(int(resolution[0]), 1)
    ry = max(int(resolution[1]), 1)
    j = 0
    while (1 << j) < min(rx, 128):
        j += 1
    k = 0
    while 3 ** k < min(ry, 128):
        k += 1
    b0, b1 = 1 << j, 3 ** k
    stride = b0 * b1
    return j, k, b0, b1, stride, _mult_inverse(stride // b0, b0), _mult_inverse(stride // b1, b1)


def _halton_index(spec, px, py, s):
    """Global Halton index of (pixel, sample): the CRT enumeration."""
    j, k, b0, b1, stride, inv0, inv1 = _halton_consts(tuple(spec.resolution))
    d0 = lds.inverse_radical_inverse(2, px % b0, j)
    d1 = lds.inverse_radical_inverse(3, py % b1, k)
    off = (d0 * (stride // b0 * inv0) + d1 * (stride // b1 * inv1)) % stride
    return (off + s * stride) & H.M32


@functools.lru_cache(None)
def _halton_perms(seed: int, device):
    """The digit permutation table on `device`, its offsets and primes."""
    table, offs, ps = lds.radical_inverse_permutations(seed)
    return torch.as_tensor(table, device=device), table, offs, ps


def _halton_dim(spec, px, py, s, dim):
    j, _, _, b1, _, _, _ = _halton_consts(tuple(spec.resolution))
    index = _halton_index(spec, px, py, s)
    if dim == 0:
        return lds.radical_inverse(2, index >> j)
    if dim == 1:
        return lds.radical_inverse(3, index // b1)
    perms, table, offs, ps = _halton_perms(spec.seed, index.device)
    d = min(dim, len(ps) - 1)
    base, off = int(ps[d]), int(offs[d])
    return lds.scrambled_radical_inverse(base, index, perms[off:off + base], int(table[off]))
