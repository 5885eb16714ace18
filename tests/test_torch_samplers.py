"""pbrt_tpu_torch samplers against pbrt_tpu: bit-equal sample values for
every kind, and the hash, low-discrepancy and Sobol' pieces under them."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import lanes  # noqa: F401  (caps torch threads)

from pbrt_tpu.samplers import SamplerSpec as JSpec, sample_dim as jdim, sample_2d as j2d
from pbrt_tpu.samplers import hashing as JH, lds as jlds, sobol_ref as jsr
from pbrt_tpu_torch.samplers import SamplerSpec, sample_dim, sample_2d, make_sampler
from pbrt_tpu_torch.samplers import hashing as H, lds, sobol_ref as sr

N_LANES = 4096
DIMS = range(85)


@pytest.mark.parametrize("kind,spp", [("02sequence", 4), ("random", 4)])
def test_sample_dim_bit_equal(kind, spp):
    px, py, s = lanes(N_LANES, 256, spp, seed=1)
    spec_j = JSpec(kind, spp, 0, resolution=(256, 256))
    spec_t = SamplerSpec(kind, spp, 0, (256, 256))
    tx, ty, ts = (torch.as_tensor(a) for a in (px, py, s))
    jx, jy, js = (jnp.asarray(a) for a in (px, py, s))
    for dim in DIMS:
        want = np.asarray(jdim(spec_j, jx, jy, js, dim))
        got = sample_dim(spec_t, tx, ty, ts, dim).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (kind, dim)
    for dim in (0, 2, 9, 21, 84):
        want = np.asarray(j2d(spec_j, jx, jy, js, dim))
        got = sample_2d(spec_t, tx, ty, ts, dim).numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (kind, dim)


def test_hash_primitives_bit_equal():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    ta, tb = (torch.as_tensor(x.astype(np.int64)) for x in (a, b))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pairs = [(H.pcg_hash(ta), JH.pcg_hash(ja)),
             (H.hash_combine(ta, tb), JH.hash_combine(ja, jb)),
             (H.reverse_bits32(ta), JH.reverse_bits32(ja)),
             (H.laine_karras_permutation(ta, tb), JH.laine_karras_permutation(ja, jb)),
             (H.owen_scramble_u32(ta, tb), JH.owen_scramble_u32(ja, jb)),
             (H.nested_uniform_shuffle(ta, 15, tb), JH.nested_uniform_shuffle(ja, 15, jb)),
             (H.u32_to_float(ta), JH.u32_to_float(ja))]
    for got, want in pairs:
        want = np.asarray(want)
        got = got.numpy().astype(want.dtype)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_sobol_matrices_match_reference():
    want = np.asarray(jlds.sobol_matrices())[:4].astype(np.int64)
    assert np.array_equal(lds.sobol_matrices(4), want)
    idx = torch.arange(64, dtype=torch.int64)
    for d in range(4):
        got = lds.sobol_sample_u32(idx, lds.sobol_matrices(4)[d]).numpy()
        ref = np.asarray(jlds.sobol_sample_u32(jnp.arange(64, dtype=jnp.uint32),
                                               jnp.asarray(jlds.sobol_matrices()[d])))
        assert np.array_equal(got, ref.astype(np.int64))


def test_make_sampler_kinds():
    """Every kind builds, with the reference's spec and sample count."""
    from pbrt_tpu.samplers import make_sampler as j_make_sampler
    spec = make_sampler("lowdiscrepancy", {"pixelsamples": [3]}, (8, 8))
    assert spec.kind == "02sequence" and spec.rounded_spp() == 4
    assert make_sampler("random", {"pixelsamples": [3]}, (8, 8)).rounded_spp() == 3
    for kind, params, spp in (("halton", {"pixelsamples": [3]}, 3),
                              ("sobol", {"pixelsamples": [5]}, 8),
                              ("sobol", {"pixelsamples": [5], "owenscramble": [True]}, 8),
                              ("stratified", {"xsamples": [3], "ysamples": [5],
                                              "jitter": [False]}, 15),
                              ("maxmindist", {"pixelsamples": [16]}, 16)):
        spec = make_sampler(kind, params, (8, 8))
        want = j_make_sampler(kind, params, (8, 8))
        assert spec.rounded_spp() == want.rounded_spp() == spp
        assert dataclasses.asdict(spec) == {**dataclasses.asdict(want), "resolution": (8, 8)}
    with pytest.raises(ValueError, match="bogus"):
        make_sampler("bogus", {}, (8, 8))


# every kind of the reference, with the spec fields it takes
KINDS = [("random", {}), ("stratified", dict(xsamples=4, ysamples=4)),
         ("stratified", dict(xsamples=3, ysamples=5, jitter=False)), ("halton", {}),
         ("sobol", {}), ("sobol", dict(owen=True)), ("02sequence", {}), ("maxmindist", {})]
SAMPLE_LANES = N_LANES


@pytest.mark.parametrize("kind,kw", KINDS,
                         ids=["random", "stratified4x4", "stratified3x5", "halton", "sobol",
                              "sobol-owen", "02sequence", "maxmindist"])
def test_every_kind_bit_equal(kind, kw):
    """sample_dim for dims 0-44 and sample_2d on 9 slots, at spp 1, 4 and 16
    (stratified: its xs x ys), on a 256x256 film and a 37x23 one (not a
    power of two, for Halton's and Sobol's resolution math): bit-equal."""
    for res in ((256, 256), (37, 23)):
        for spp in ((1, 4, 16) if kind != "stratified" else (None,)):
            spp = spp or kw["xsamples"] * kw["ysamples"]
            js = JSpec(kind, spp, 0, resolution=res, **kw)
            ts = SamplerSpec(kind, spp, 0, res, **kw)
            assert ts.rounded_spp() == js.rounded_spp()
            rng = np.random.default_rng(spp)
            px, py = (rng.integers(0, r, SAMPLE_LANES).astype(np.int32) for r in res)
            s = rng.integers(0, ts.rounded_spp(), SAMPLE_LANES).astype(np.int32)
            tx, ty, tsi = (torch.as_tensor(a) for a in (px, py, s))
            jx, jy, jsi = (jnp.asarray(a) for a in (px, py, s))
            for dim in range(45):
                want = np.asarray(jdim(js, jx, jy, jsi, dim))
                got = sample_dim(ts, tx, ty, tsi, dim).numpy()
                assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (res, spp, dim)
            for dim in range(0, 45, 5):
                want = np.asarray(j2d(js, jx, jy, jsi, dim))
                got = sample_2d(ts, tx, ty, tsi, dim).numpy()
                assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (res, spp, dim)


@pytest.mark.parametrize("l", [1, 2, 3, 5, 16, 17, 100])
def test_cmj_permute_bit_equal(l):
    """Kensler's permutation, its u32 tensor product and its fallback."""
    rng = np.random.default_rng(l)
    i = rng.integers(0, max(l, 1), 4096, dtype=np.uint64).astype(np.uint32)
    p = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    got = H.cmj_permute(torch.as_tensor(i.astype(np.int64)), l,
                        torch.as_tensor(p.astype(np.int64))).numpy()
    want = np.asarray(JH.cmj_permute(jnp.asarray(i), l, jnp.asarray(p)))
    assert np.array_equal(got, want.astype(np.int64))
    a, b = (rng.integers(0, 2 ** 32, 4096, dtype=np.uint64) for _ in range(2))
    assert np.array_equal(H.mul32t(torch.as_tensor(a.astype(np.int64)),
                                   torch.as_tensor(b.astype(np.int64))).numpy(),
                          ((a * b) & 0xFFFFFFFF).astype(np.int64))
    k = [jnp.asarray(x) for x in (i, p, i ^ p, p >> 3)]
    got = H.hash4(*(torch.as_tensor(np.asarray(x).astype(np.int64)) for x in k))
    assert np.array_equal(got.numpy(), np.asarray(JH.hash4(*k)).astype(np.int64))
    got = H.uniform_float(*(torch.as_tensor(np.asarray(x).astype(np.int64)) for x in k[:3]))
    assert np.array_equal(got.numpy().view(np.uint32),
                          np.asarray(JH.uniform_float(*k[:3])).view(np.uint32))


def test_lds_pieces_bit_equal():
    """primes, prime sums, digit counts, radical inverses of every base the
    Halton sampler reaches (plain and scrambled), their inverse and the
    digit permutations; the generated Sobol' matrices at 256 dimensions."""
    assert lds.primes(128) == jlds.primes(128)
    assert lds.prime_sums(128) == jlds.prime_sums(128)
    assert [lds.n_digits(b) for b in lds.primes(50)] == [jlds.n_digits(b) for b in jlds.primes(50)]
    table, offs, ps = lds.radical_inverse_permutations(0)
    jt, jo, jp = jlds.radical_inverse_permutations(0)
    assert np.array_equal(table, jt) and np.array_equal(offs, jo) and np.array_equal(ps, jp)
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    ti, ji = torch.as_tensor(idx.astype(np.int64)), jnp.asarray(idx)
    for d, base in enumerate(lds.primes(48)):
        got = lds.radical_inverse(base, ti).numpy()
        assert np.array_equal(got.view(np.uint32),
                              np.asarray(jlds.radical_inverse(base, ji)).view(np.uint32)), base
        perm = table[offs[d]:offs[d] + base]
        got = lds.scrambled_radical_inverse(base, ti, torch.as_tensor(perm), int(perm[0])).numpy()
        want = np.asarray(jlds.scrambled_radical_inverse(base, ji, perm.astype(np.uint32)))
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), base
    for base, nd in ((2, 7), (3, 5), (5, 3)):
        small = idx % base ** nd
        got = lds.inverse_radical_inverse(base, torch.as_tensor(small.astype(np.int64)), nd)
        want = jlds.inverse_radical_inverse(base, jnp.asarray(small), nd)
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert np.array_equal(lds.sobol_matrices(), np.asarray(jlds.sobol_matrices()).astype(np.int64))


def test_sobol_ref_pieces_bit_equal():
    """The copied tables, the global index (one int64 against the
    reference's (hi, lo) pair), the byte-table products against the column
    loops, and maxmindist's first slot."""
    for got, want in zip(sr.tables(), jsr.tables()):
        assert np.array_equal(got, want.astype(np.int64))
    rng = np.random.default_rng(6)
    for res, spp in (((256, 256), 256), ((37, 23), 16), ((1000, 3), 1)):
        m = sr.log2_resolution(res)
        assert m == jsr.log2_resolution(res)
        px, py = (rng.integers(0, r, 4096).astype(np.uint32) for r in res)
        s = rng.integers(0, spp, 4096).astype(np.uint32)
        tx, ty, ts = (torch.as_tensor(a.astype(np.int64)) for a in (px, py, s))
        index = sr.sobol_interval_to_index(m, spp, ts, tx, ty)
        hi, lo = jsr.sobol_interval_to_index(m, spp, jnp.asarray(s), jnp.asarray(px),
                                             jnp.asarray(py))
        hi, lo = np.asarray(hi).astype(np.int64), np.asarray(lo).astype(np.int64)
        assert np.array_equal(index.numpy(), ((hi & 0xFFFFF) << 32) | lo)
        for dim in (0, 1, 2, 7, 63, 1023):
            want = jsr.sobol_sample_u32(jnp.asarray(hi.astype(np.uint32)),
                                        jnp.asarray(lo.astype(np.uint32)), dim)
            got = sr.sobol_sample_u32(index, dim)
            assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64)), dim
    wide = rng.integers(0, 2 ** 52, 4096, dtype=np.uint64)
    hi, lo = (wide >> 32).astype(np.uint32), (wide & 0xFFFFFFFF).astype(np.uint32)
    got = sr.sobol_sample_u32(torch.as_tensor(wide.astype(np.int64)), 5)
    want = jsr.sobol_sample_u32(jnp.asarray(hi), jnp.asarray(lo), 5)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    for spp in (1, 4, 16, 256):
        i = rng.integers(0, spp, 4096).astype(np.uint32)
        for dim in (0, 1):
            got = sr.maxmin_first_slot(spp, torch.as_tensor(i.astype(np.int64)), dim).numpy()
            want = np.asarray(jsr.maxmin_first_slot(spp, jnp.asarray(i), dim))
            assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (spp, dim)
