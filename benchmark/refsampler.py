"""The plain reference's sample draws, in NumPy u32 arithmetic.

Two samplers, as the port documents them (its samplers are pure functions
of pixel, sample index, dimension and seed, so a second implementation of
the same definitions draws the same numbers):

  stratified  jittered strata of an xsamples x ysamples grid (16 in one
              dimension), shuffled per pixel and dimension by Kensler's
              cycle-walking permutation, keyed by PCG hashes of the pixel,
              the seed and the dimension; 2D slots draw their pair jointly;
  sobol       pbrt-v3's global Sobol' sampler: SobolIntervalToIndex over
              the power-of-two square of the film's resolution, then
              SobolSample with scramble 0, dimensions 0 and 1 taken back
              into the pixel. The seed plays no part.

The Sobol' generator matrices are pbrt-v3's tables (data/*.npy). A scene's
Sampler directive is turned into one of these by samplers/<kind>.py; a
sampler gives prepare(px, py, s) and d1 / d2 of that state, which Stream
caches by dimension.
"""
from __future__ import annotations

import os

import numpy as np

M32 = 0xFFFFFFFF
ONE_MINUS_EPS = np.float32(1.0 - 2.0 ** -24)
_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
U32 = np.uint32


def pcg(x):
    """PCG-RXS-M-XS 32-bit mix of u32 words."""
    x = np.asarray(x, U32)
    state = x * U32(747796405) + U32(2891336453)
    word = ((state >> ((state >> U32(28)) + U32(4))) ^ state) * U32(277803737)
    return (word >> U32(22)) ^ word


def mix(a, b):
    """Boost-style combine of u32 words a (array) with b (array or int)."""
    a = np.asarray(a, U32)
    m = np.uint64(M32)
    b = np.uint64(b & M32) if isinstance(b, int) else np.asarray(b, np.uint64) & m
    a64 = a.astype(np.uint64)
    s = (b + np.uint64(0x9E3779B9) + ((a64 << np.uint64(6)) & m) + (a64 >> np.uint64(2))) & m
    return pcg(a ^ s.astype(U32))


def mix_int(a: int, b: int) -> int:
    """mix for one integer a of any width (the seed) and int b, as the
    port's int64 arithmetic combines them: a is not cut to 32 bits before
    its shifts."""
    s = (b + 0x9E3779B9 + ((a << 6) & M32) + (a >> 2)) & M32
    return int(pcg(np.array([(a ^ s) & M32], U32))[0])


def to_unit(u):
    """u32 words -> float32 in [0, 1)."""
    return np.minimum(np.asarray(u, U32).astype(np.float32) * np.float32(2.0 ** -32),
                      ONE_MINUS_EPS)


def permute(i, l, p):
    """Kensler's permutation of [0, l) at indices i with pattern keys p:
    eight cycle-walk rounds, then i % l for a lane still out of range."""
    i, p = np.asarray(i, U32), np.asarray(p, U32)
    if l <= 1:
        return np.zeros_like(i)
    w = U32((1 << (l - 1).bit_length()) - 1)

    def rounds(v):
        v = v ^ p
        v = v * U32(0xe170893d)
        v = v ^ (p >> U32(16))
        v = v ^ ((v & w) >> U32(4))
        v = v ^ (p >> U32(8))
        v = v * U32(0x0929eb3f)
        v = v ^ (p >> U32(23))
        v = v ^ ((v & w) >> U32(1))
        v = v * (U32(1) | (p >> U32(27)))
        v = v * U32(0x6935fa69)
        v = v ^ ((v & w) >> U32(11))
        v = v * U32(0x74dcca23)
        v = v ^ ((v & w) >> U32(2))
        v = v * U32(0x9e501cc3)
        v = v ^ ((v & w) >> U32(2))
        v = v * U32(0xc860a3df)
        v = v & w
        return v ^ (v >> U32(5))

    out = rounds(i)
    for _ in range(8):
        out = np.where(out >= l, rounds(out), out)
    out = np.where(out >= l, i % U32(l), out)
    return (out + p) % U32(l)


class Stratified:
    def __init__(self, xs, ys, jitter, seed):
        self.xs, self.ys, self.jitter, self.seed = xs, ys, jitter, int(seed)
        self.spp = xs * ys
        self._keys = {}

    def _key(self, dim):
        if dim not in self._keys:
            self._keys[dim] = mix_int(self.seed, dim)
        return self._keys[dim]

    def _pix(self, px, py):
        return mix(mix(np.asarray(px, U32), np.asarray(py, U32)), self.seed)

    def dim1(self, px, py, s, dim):
        key = mix(self._pix(px, py), self._key(dim))
        s = np.asarray(s, U32)
        stratum = permute(s, self.spp, key)
        j = to_unit(mix(mix(key, s), 0x55)) if self.jitter else np.float32(0.5)
        return np.minimum((stratum.astype(np.float32) + j) / np.float32(self.spp),
                          ONE_MINUS_EPS)

    def prepare(self, px, py, s):
        return px, py, s

    def d1(self, state, dim):
        return self.dim1(*state, dim)

    def d2(self, state, dim):
        return self.dim2(*state, dim)

    def dim2(self, px, py, s, dim):
        key = mix(self._pix(px, py), self._key(dim))
        s = np.asarray(s, U32)
        stratum = permute(s, self.spp, key)
        sx = (stratum % U32(self.xs)).astype(np.float32)
        sy = (stratum // U32(self.xs)).astype(np.float32)
        if self.jitter:
            ju, jv = to_unit(mix(mix(key, s), 0xa1)), to_unit(mix(mix(key, s), 0xb2))
        else:
            ju = jv = np.float32(0.5)
        return np.stack([np.minimum((sx + ju) / np.float32(self.xs), ONE_MINUS_EPS),
                         np.minimum((sy + jv) / np.float32(self.ys), ONE_MINUS_EPS)], -1)


class Sobol:
    def __init__(self, spp, resolution):
        self.spp = 1 << max(0, (spp - 1).bit_length())
        r = max(resolution)
        self.m = int(np.ceil(np.log2(r))) if r > 1 else 0
        self.mats = np.load(os.path.join(_DATA, "sobol_matrices_32.npy")).astype(np.uint64)
        self.vdc = np.load(os.path.join(_DATA, "vdc_sobol_matrices.npy")).astype(np.uint64)
        self.vdc_inv = np.load(os.path.join(_DATA, "vdc_sobol_matrices_inv.npy")).astype(np.uint64)

    @staticmethod
    def _apply(cols, x):
        """XOR of the columns of cols over the set bits of x (u64)."""
        v = np.zeros_like(x)
        c = 0
        while (x >> np.uint64(c)).any() and c < cols.shape[0]:
            bit = (x >> np.uint64(c)) & np.uint64(1)
            v ^= np.where(bit == 1, cols[c], np.uint64(0))
            c += 1
        return v

    def index(self, px, py, s):
        m = self.m
        s = np.asarray(s, np.uint64)
        if m == 0:
            return np.zeros_like(s)
        delta = self._apply(self.vdc[m - 1], s)
        b = ((np.asarray(px, np.uint64) << np.uint64(m)) | np.asarray(py, np.uint64)) ^ delta
        return (s << np.uint64(2 * m)) ^ self._apply(self.vdc_inv[m - 1], b)

    def prepare(self, px, py, s):
        return self.index(px, py, s), px, py

    def d1(self, state, dim):
        return self.dim1_at(*state, dim)

    def d2(self, state, dim):
        return np.stack([self.d1(state, dim), self.d1(state, dim + 1)], -1)

    def dim1(self, px, py, s, dim):
        return self.dim1_at(self.index(px, py, s), px, py, dim)

    def dim1_at(self, index, px, py, dim):
        v = self._apply(self.mats[dim % self.mats.shape[0]], index)
        u = to_unit((v & np.uint64(M32)).astype(U32))
        if dim in (0, 1):
            pix = np.asarray(px if dim == 0 else py).astype(np.float32)
            u = np.clip(u * np.float32(1 << self.m) - pix, np.float32(0), ONE_MINUS_EPS)
        return u

    def dim2(self, px, py, s, dim):
        return np.stack([self.dim1(px, py, s, dim), self.dim1(px, py, s, dim + 1)], -1)


class Stream:
    """The draws of one set of (pixel, sample index) lanes: d1(dim) [N]
    and d2(dim) [N, 2] float32, cached by dimension. A sampler gives
    prepare(px, py, s) -> its state of the lanes, and d1(state, dim),
    d2(state, dim)."""

    def __init__(self, sampler, px, py, s):
        self.sampler = sampler
        self.state = sampler.prepare(np.asarray(px), np.asarray(py), np.asarray(s))
        self._cache = {}

    def d1(self, dim):
        key = (1, dim)
        if key not in self._cache:
            self._cache[key] = self.sampler.d1(self.state, dim)
        return self._cache[key]

    def d2(self, dim):
        key = (2, dim)
        if key not in self._cache:
            self._cache[key] = self.sampler.d2(self.state, dim)
        return self._cache[key]
