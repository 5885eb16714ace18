"""pbrt_tpu_torch samplers against pbrt_tpu: bit-equal sample values."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import lanes  # noqa: F401  (caps torch threads)

from pbrt_tpu.samplers import SamplerSpec as JSpec, sample_dim as jdim, sample_2d as j2d
from pbrt_tpu.samplers import hashing as JH, lds as jlds
from pbrt_tpu_torch.samplers import SamplerSpec, sample_dim, sample_2d, make_sampler
from pbrt_tpu_torch.samplers import hashing as H, lds

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
    spec = make_sampler("lowdiscrepancy", {"pixelsamples": [3]}, (8, 8))
    assert spec.kind == "02sequence" and spec.rounded_spp() == 4
    assert make_sampler("random", {"pixelsamples": [3]}, (8, 8)).rounded_spp() == 3
    for kind in ("halton", "sobol", "stratified", "maxmindist"):
        with pytest.raises(NotImplementedError, match=kind):
            make_sampler(kind, {}, (8, 8))
