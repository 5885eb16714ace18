"""Counter-based hashing primitives (port of pbrt_tpu/samplers/hashing.py).

Every sample value is a pure hash of (pixel, sample index, dimension), so
the port draws the reference's samples bit for bit. PyTorch has no `+`,
`<<` or `>>` for torch.uint32 on the CPU, so u32 words ride in int64
tensors masked to 32 bits after every op that can carry past bit 31. A
product of two u32 words is formed in 16-bit halves so that no
intermediate leaves the int64 range. The same code runs on CUDA.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_INV_U32 = 2.3283064365386963e-10  # 1/2^32
ONE_MINUS_EPS = 1.0 - 2.0 ** -24


def u32(x) -> torch.Tensor:
    """Any integer tensor -> int64 holding its u32 bit pattern."""
    return x.to(torch.int64) & M32


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for u32 words a (int64 tensor) and a python int c."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def mul32t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for two tensors of u32 words, in 16-bit halves of b
    so that no product leaves the int64 range."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG-RXS-M-XS style 32-bit mix."""
    state = (mul32(x, 747796405) + 2891336453) & M32
    word = mul32((state >> ((state >> 28) + 4)) ^ state, 277803737)
    return (word >> 22) ^ word


def hash_combine(a: torch.Tensor, b) -> torch.Tensor:
    """Mix two u32 streams (boost-style). b may be a tensor or an int."""
    return pcg_hash(a ^ ((b + 0x9E3779B9 + ((a << 6) & M32) + (a >> 2))
                         & M32))


def hash3(a, b, c):
    return hash_combine(hash_combine(a, b), c)


def hash4(a, b, c, d):
    return hash_combine(hash3(a, b, c), d)


def u32_to_float(u: torch.Tensor) -> torch.Tensor:
    """u32 word -> float32 in [0, 1)."""
    return torch.clamp(u.to(torch.float32) * _INV_U32, max=ONE_MINUS_EPS)


def uniform_float(*keys):
    """Hash u32 keys (the first a tensor) to a float32 in [0, 1)."""
    h = keys[0]
    for k in keys[1:]:
        h = hash_combine(h, k)
    return u32_to_float(h)


def reverse_bits32(x: torch.Tensor) -> torch.Tensor:
    x = ((x << 16) & M32) | (x >> 16)
    x = ((x & 0x00ff00ff) << 8) | ((x & 0xff00ff00) >> 8)
    x = ((x & 0x0f0f0f0f) << 4) | ((x & 0xf0f0f0f0) >> 4)
    x = ((x & 0x33333333) << 2) | ((x & 0xcccccccc) >> 2)
    x = ((x & 0x55555555) << 1) | ((x & 0xaaaaaaaa) >> 1)
    return x


def laine_karras_permutation(x: torch.Tensor, seed) -> torch.Tensor:
    """Hash-based Owen scramble of a bit-reversed index (Burley 2020)."""
    x = (x + seed) & M32
    x = x ^ mul32(x, 0x6c50b47c)
    x = x ^ mul32(x, 0xb82f1e52)
    x = x ^ mul32(x, 0xc7afe638)
    x = x ^ mul32(x, 0x8d22f6e6)
    return x


def owen_scramble_u32(x: torch.Tensor, seed) -> torch.Tensor:
    return reverse_bits32(laine_karras_permutation(reverse_bits32(x), seed))


def nested_uniform_shuffle(i: torch.Tensor, n_pow2_mask: int, seed):
    """Owen-shuffle index i within a power-of-two domain."""
    x = laine_karras_permutation(reverse_bits32(i), seed)
    return reverse_bits32(x) & n_pow2_mask


def cmj_permute(i: torch.Tensor, l: int, p: torch.Tensor) -> torch.Tensor:
    """Kensler's cycle-walking pseudorandom permutation of [0, l) for u32
    indices i and pattern keys p (the stratified sampler's stratum
    shuffle): 8 cycle-walk rounds, then i % l for the rare lane still out
    of range, as the reference unrolls it."""
    if l <= 1:
        return torch.zeros_like(i)
    w = (1 << (l - 1).bit_length()) - 1

    def rounds(i):
        i = i ^ p
        i = mul32(i, 0xe170893d)
        i = i ^ (p >> 16)
        i = i ^ ((i & w) >> 4)
        i = i ^ (p >> 8)
        i = mul32(i, 0x0929eb3f)
        i = i ^ (p >> 23)
        i = i ^ ((i & w) >> 1)
        i = mul32t(i, 1 | (p >> 27))
        i = mul32(i, 0x6935fa69)
        i = i ^ ((i & w) >> 11)
        i = mul32(i, 0x74dcca23)
        i = i ^ ((i & w) >> 2)
        i = mul32(i, 0x9e501cc3)
        i = i ^ ((i & w) >> 2)
        i = mul32(i, 0xc860a3df)
        i = i & w
        return i ^ (i >> 5)

    out = rounds(i)
    for _ in range(8):
        out = torch.where(out >= l, rounds(out), out)
    out = torch.where(out >= l, i % l, out)
    return ((out + p) & M32) % l
