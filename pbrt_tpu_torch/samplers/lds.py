"""Low-discrepancy machinery: Sobol' generator matrices, primes, radical
inverses and their digit permutations (port of pbrt_tpu/samplers/lds.py).

The matrices are GENERATED from primitive polynomials over GF(2) with the
reference's seeded direction numbers, not copied; the first n_dims rows
do not depend on how many rows are asked for. Radical inverses sum their
digits in float32 with the reference's float32 digit weights, so their
values are the reference's bit for bit.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from pbrt_tpu_torch.samplers.hashing import M32, ONE_MINUS_EPS, reverse_bits32, u32

N_SOBOL_DIMS = 256
SOBOL_BITS = 32


def _is_primitive(poly: int, degree: int) -> bool:
    """Primitivity of a GF(2) polynomial given as a bitmask."""
    order = (1 << degree) - 1

    def polymulmod(a, b, mod, deg):
        r = 0
        while b:
            if b & 1:
                r ^= a
            b >>= 1
            a <<= 1
            if a >> deg & 1:
                a ^= mod
        return r

    def polypowmod(a, e, mod, deg):
        r = 1
        while e:
            if e & 1:
                r = polymulmod(r, a, mod, deg)
            a = polymulmod(a, a, mod, deg)
            e >>= 1
        return r

    if polypowmod(2, order, poly, degree) != 1:
        return False
    n = order
    factors = set()
    d = 2
    while d * d <= n:
        while n % d == 0:
            factors.add(d)
            n //= d
        d += 1
    if n > 1:
        factors.add(n)
    return all(polypowmod(2, order // q, poly, degree) != 1 for q in factors)


@functools.lru_cache(None)
def _primitive_polys(count: int):
    """First `count` primitive polynomials, ascending degree, as
    (degree, interior coefficient bits) pairs."""
    out = []
    degree = 1
    while len(out) < count:
        for interior in range(1 << max(degree - 1, 0)):
            poly = (1 << degree) | (interior << 1) | 1
            if _is_primitive(poly, degree):
                out.append((degree, interior))
                if len(out) >= count:
                    break
        degree += 1
    return tuple(out)


@functools.lru_cache(None)
def sobol_matrices(n_dims: int = N_SOBOL_DIMS, seed: int = 7) -> np.ndarray:
    """[n_dims, 32] generator matrices (columns v_k, MSB-aligned), as the
    reference's `lds.sobol_matrices` builds them."""
    rng = np.random.default_rng(seed)
    M = np.zeros((n_dims, SOBOL_BITS), np.int64)
    for k in range(SOBOL_BITS):
        M[0, k] = 1 << (31 - k)
    polys = _primitive_polys(max(n_dims - 1, 0))
    for d in range(1, n_dims):
        s, a = polys[d - 1]
        m = [1]
        for k in range(2, s + 1):
            m.append(int(rng.integers(0, 1 << (k - 1))) * 2 + 1)
        for k in range(s + 1, SOBOL_BITS + 1):
            new = m[k - s - 1] ^ (m[k - s - 1] << s)
            for i in range(1, s):
                if (a >> (s - 1 - i)) & 1:
                    new ^= m[k - i - 1] << i
            m.append(new)
        for k in range(SOBOL_BITS):
            M[d, k] = (m[k] << (31 - k)) & 0xFFFFFFFF
    return M


def sobol_sample_u32(index: torch.Tensor, dim_matrix, bits: int = SOBOL_BITS):
    """Sobol' u32 word for u32 `index` (int64 tensor) with one matrix row.
    `bits` bounds the index's set bits; higher columns contribute zero."""
    v = torch.zeros_like(index)
    for b in range(bits):
        v = v ^ (((index >> b) & 1) * int(dim_matrix[b]))
    return v


# ---------------------------------------------------------------------------
# primes and radical inverses
# ---------------------------------------------------------------------------

@functools.lru_cache(None)
def primes(n: int):
    """First n primes."""
    out = []
    cand = 2
    while len(out) < n:
        if all(cand % p for p in out if p * p <= cand):
            out.append(cand)
        cand += 1
    return tuple(out)


@functools.lru_cache(None)
def prime_sums(n: int):
    ps = primes(n)
    sums = [0]
    for p in ps[:-1]:
        sums.append(sums[-1] + p)
    return tuple(sums)


def n_digits(base: int, bits: int = 32) -> int:
    return int(math.ceil(bits / math.log2(base)))


@functools.lru_cache(None)
def _digit_factors(base: int):
    """The reference's float32 digit weights base^-1, base^-2, ... (each the
    float32 product of the last and 1/base) and the weight after the last
    digit, as python floats holding float32 values."""
    inv_base = np.float32(1.0 / base)
    factor, out = inv_base, []
    for _ in range(n_digits(base)):
        out.append(float(factor))
        factor = np.float32(factor * inv_base)
    return tuple(out), float(factor)


def radical_inverse(base: int, index) -> torch.Tensor:
    """Van der Corput radical inverse of u32 indices (an integer tensor or
    array) in `base` -> float32 in [0, 1): base 2 by bit reversal, other
    bases by accumulating the digits in float32 as the reference does
    (digits below float32's precision drop out)."""
    index = u32(torch.as_tensor(index))
    if base == 2:
        return torch.clamp(reverse_bits32(index).to(torch.float32)
                           * np.float32(2.3283064365386963e-10), max=ONE_MINUS_EPS)
    inv = torch.zeros(index.shape, dtype=torch.float32, device=index.device)
    for factor in _digit_factors(base)[0]:
        nxt = index // base
        inv = inv + (index - nxt * base).to(torch.float32) * factor
        index = nxt
    return torch.clamp(inv, max=ONE_MINUS_EPS)


def scrambled_radical_inverse(base: int, index: torch.Tensor, perm: torch.Tensor, perm0: int):
    """Radical inverse of u32 indices with the digit permutation perm
    ([base] integer tensor on index's device; perm0 its first entry) plus
    the infinite tail of permuted zero digits, perm0 times the weights
    past the last digit, summed as the reference sums it."""
    factors, last = _digit_factors(base)
    inv = torch.zeros(index.shape, dtype=torch.float32, device=index.device)
    for factor in factors:
        nxt = index // base
        inv = inv + perm[index - nxt * base].to(torch.float32) * factor
        index = nxt
    tail = np.float32(np.float32(perm0) * np.float32(last)) \
        * np.float32(base / (base - 1.0))
    return torch.clamp(inv + float(tail), max=ONE_MINUS_EPS)


def inverse_radical_inverse(base: int, inverse: torch.Tensor, num_digits: int):
    """The index whose num_digits base-`base` digits, reversed, are those of
    `inverse` (u32 words in int64)."""
    index = torch.zeros_like(inverse)
    for _ in range(num_digits):
        digit = inverse % base
        inverse = inverse // base
        index = index * base + digit
    return index & M32


@functools.lru_cache(None)
def radical_inverse_permutations(seed: int = 0, n_dims: int = 128):
    """Random digit permutations of the first n_dims primes, flattened, with
    their offsets and the primes (the reference's, from numpy's
    default_rng(seed)) -> host numpy (table, offsets, primes)."""
    rng = np.random.default_rng(seed)
    ps = primes(n_dims)
    offs = prime_sums(n_dims)
    table = np.zeros(offs[-1] + ps[-1], np.int64)
    for i, p in enumerate(ps):
        table[offs[i]:offs[i] + p] = rng.permutation(p)
    return table, np.asarray(offs, np.int64), np.asarray(ps, np.int64)
