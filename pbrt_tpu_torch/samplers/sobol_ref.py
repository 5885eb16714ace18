"""Reference-matched global Sobol' enumeration (port of
pbrt_tpu/samplers/sobol_ref.py).

  * generator matrices: the pbrt-v3 / Joe-Kuo tables in data/ (copies of
    the reference's .npy files: sobol_matrices_32, the van der Corput
    matrices and their inverses, C_MAX_MIN_DIST);
  * global sample enumeration: sobol_interval_to_index maps (pixel, sample
    number) to an index into one global Sobol' sequence;
  * sobol_dim: dims 0/1 are remapped from [0,1)^2 over the whole
    power-of-two sample-resolution square (the film's full resolution, not
    its crop) back into the current pixel;
  * maxmin_first_slot: the C_MAX_MIN_DIST matrices drive the maxmindist
    sampler's first 2D slot.

The 46-bit global index rides in one int64 (the reference carries a (hi,
lo) u32 pair). Each matrix product is a XOR of columns over the set bits
of its input; the port tabulates it per byte: for each byte of the input
and each of its 256 values, the XOR of the 8 columns it selects. A product
is then one gather per byte of the input's width and a XOR per byte, bit
for bit the reference's column loop. The tables are built on the host and
kept on each device that asks for them.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from pbrt_tpu_torch.samplers.hashing import ONE_MINUS_EPS, u32_to_float

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
INDEX_BITS = 52     # the columns of sobol_matrices_32: index bits 0 - 51


@functools.lru_cache(None)
def tables():
    """(sobol_matrices_32 [1024, 52], vdc [25, 52], vdc_inv [26, 52],
    C_MAX_MIN_DIST [17, 32]) as int64 numpy arrays."""
    return tuple(np.load(os.path.join(_DATA, f"{name}.npy")).astype(np.int64) for name in (
        "sobol_matrices_32", "vdc_sobol_matrices", "vdc_sobol_matrices_inv", "c_max_min_dist"))


def byte_tables(cols: np.ndarray, bits: int) -> np.ndarray:
    """[..., C] matrix columns -> [..., ceil(bits / 8), 256]: entry (k, v)
    is the XOR of columns 8k + j over the set bits j of v, for columns
    below `bits` (the others are left out)."""
    nb = -(-bits // 8)
    c = np.zeros(cols.shape[:-1] + (8 * nb,), np.int64)
    c[..., :bits] = cols[..., :bits]
    c = c.reshape(cols.shape[:-1] + (nb, 8))
    v = np.arange(256)
    out = np.zeros(cols.shape[:-1] + (nb, 256), np.int64)
    for j in range(8):
        out ^= np.where(((v >> j) & 1).astype(bool), c[..., j:j + 1], 0)
    return out


@functools.lru_cache(None)
def _on(name: str, row: int, bits: int, device) -> torch.Tensor:
    """Byte tables of one matrix row of a data table, on `device`."""
    m32, vdc, vdci, cmm = tables()
    cols = {"m32": m32, "vdc": vdc, "vdci": vdci, "cmm": cmm}[name][row]
    return torch.as_tensor(byte_tables(cols, bits), device=device)


def xor_bytes(tab: torch.Tensor, x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """The matrix product of byte tables tab with words x (int64 tensor) whose
    set bits lie in their low nbytes bytes."""
    v = tab[0][x & 255]
    for k in range(1, nbytes):
        v = v ^ tab[k][(x >> (8 * k)) & 255]
    return v


def log2_resolution(resolution) -> int:
    """Exponent of the next power of two of the larger extent."""
    r = max(int(resolution[0]), int(resolution[1]), 1)
    return int(np.ceil(np.log2(r))) if r > 1 else 0


def frame_bits(spp: int) -> int:
    return max(int(spp - 1).bit_length(), 1)


def sobol_interval_to_index(m: int, spp: int, frame, px, py) -> torch.Tensor:
    """Global sample index (int64, below 2^52) of sample number `frame` of
    pixel (px, py): u32 words in int64 tensors; m, the log2 of the
    power-of-two sample resolution; spp a power of two."""
    if m == 0:
        return torch.zeros_like(frame)
    dev = frame.device
    fbits, m2 = frame_bits(spp), 2 * m
    delta = xor_bytes(_on("vdc", m - 1, fbits, dev), frame, -(-fbits // 8))
    b = ((px << m) | py) ^ delta
    index = (frame << m2) ^ xor_bytes(_on("vdci", m - 1, m2, dev), b, -(-m2 // 8))
    return index & ((1 << INDEX_BITS) - 1)


def sobol_sample_u32(index: torch.Tensor, dim: int, index_bits: int = INDEX_BITS):
    """Raw u32 sample of `dim` at global indices below 2^index_bits
    (scramble 0)."""
    tab = _on("m32", dim % tables()[0].shape[0], INDEX_BITS, index.device)
    return xor_bytes(tab, index, -(-min(index_bits, INDEX_BITS) // 8))


def sobol_dim(resolution, spp: int, px, py, sample_idx, dim: int):
    """The reference-matched Sobol' sample of dimension `dim` for u32 pixel
    coordinates and sample numbers (int64 tensors; the sample bounds start
    at (0, 0)) -> [N] float32."""
    m = log2_resolution(resolution)
    index = sobol_interval_to_index(m, spp, sample_idx, px, py)
    v = u32_to_float(sobol_sample_u32(index, dim, 2 * m + frame_bits(spp)))
    if dim in (0, 1):
        pixc = (px if dim == 0 else py).to(torch.float32)
        v = torch.clamp(v * float(1 << m) - pixc, 0.0, ONE_MINUS_EPS)
    return v


def maxmin_first_slot(spp: int, shuffled_idx: torch.Tensor, dim: int):
    """The maxmindist sampler's first 2D slot: (i / spp, C_MAX_MIN_DIST[log2
    spp] applied to i) for the per-pixel-shuffled sample numbers i."""
    if dim == 0:
        return torch.clamp(shuffled_idx.to(torch.float32) / spp, max=ONE_MINUS_EPS)
    lg = min(int(spp - 1).bit_length(), 16)
    tab = _on("cmm", lg, 32, shuffled_idx.device)
    return u32_to_float(xor_bytes(tab, shuffled_idx, min(-(-frame_bits(spp) // 8), 4)))
