"""Point, spot and distant lights, and the slice as a whole, against pbrt_tpu
on the CPU: sample_li, pdf_li and light_power on the tables of a scene with
every new shape and light, carried across by the bridge, and li_path on
that scene (32x32, depth 4)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import jax_scene_arrays, lanes, pallas_tables

from pbrt_tpu import lights as JL
from pbrt_tpu.integrators.path import li_path as j_li_path
from pbrt_tpu.scene import load_scene_string as j_load_scene_string
from pbrt_tpu_torch import lights as LT
from pbrt_tpu_torch.integrators.path import li_path
from pbrt_tpu_torch.scene.bench import quadric_scene_text
from pbrt_tpu_torch.scene.bridge import from_jax_arrays


@pytest.fixture(scope="module")
def scene():
    """(pbrt_tpu's scene with kernel tables, on its XLA walk; the port's
    scene on the same tables)."""
    with pallas_tables():
        jcs = j_load_scene_string(quadric_scene_text(res=32, spp=4, n_grass=1))
    arrays, specs = jax_scene_arrays(jcs)
    jcpu = dataclasses.replace(jcs, flags=dataclasses.replace(jcs.flags, use_pallas=False))
    return jcpu, from_jax_arrays(arrays, specs, device="cpu")


def test_light_table_holds_every_kind(scene):
    """Infinite, point, spot, distant, the emitting sphere's area light on
    its tessellation (params[0] = 0, params[1] = its quadric row) and the
    floor-lamp quad's on its triangles."""
    _, cs = scene
    lt = cs.data.lights
    assert lt.kind.tolist() == [LT.L_INFINITE, LT.L_AREA, LT.L_POINT, LT.L_SPOT, LT.L_DISTANT,
                                LT.L_AREA]
    quad = lt.params[5]
    assert float(quad[0]) == 0.0 and int(quad[1]) == 0 and int(quad[3]) > 1000
    assert float(lt.params[1, 0]) == 1.0 and int(lt.params[1, 3]) == 2


def test_sample_li_pdf_li_and_power_match_reference(scene):
    """4,096 lanes over every light of the table: wi, li, pdf, p_light
    within rtol 2e-5 and is_delta equal; pdf_li (0 for the delta lights)
    and each light's power for the selection distribution. The spot's li
    is held to rtol 1e-4: its falloff, ((cos - cos_total) / (cos_falloff -
    cos_total))^4 with a denominator of 0.05, multiplies the rounding of
    the dot product by about 80."""
    jcs, cs = scene
    n = 4096
    rng = np.random.default_rng(11)
    ref_p = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    idx = rng.integers(0, cs.flags.n_lights, n)
    jd = jcs.data
    ls = LT.sample_li(cs.data.lights, torch.as_tensor(idx), torch.as_tensor(ref_p),
                      torch.as_tensor(u2), cs.data.world_radius)
    ref = JL.sample_li(jd.lights, jd, jnp.asarray(idx, jnp.int32), jnp.asarray(ref_p),
                       jnp.asarray(u2), jd.world_center, jd.world_radius)
    kinds = cs.data.lights.kind.numpy()[idx]
    spot = kinds == LT.L_SPOT
    for f in ("wi", "li", "pdf", "p_light"):
        g, w = getattr(ls, f).numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_allclose(g[~spot], w[~spot], rtol=2e-5, atol=1e-6, err_msg=f)
        np.testing.assert_allclose(g[spot], w[spot], rtol=1e-4 if f == "li" else 2e-5,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(ls.is_delta.numpy(), np.asarray(ref.is_delta))
    assert 0 < (ls.li.numpy()[spot].sum(1) > 0).sum() < spot.sum()   # inside and outside the cone
    hit_t = rng.uniform(0.1, 5, n).astype(np.float32)
    hit_cos = rng.uniform(0, 1, n).astype(np.float32)
    got = LT.pdf_li(cs.data.lights, torch.as_tensor(idx), torch.as_tensor(hit_t),
                    torch.as_tensor(hit_cos)).numpy()
    want = np.asarray(JL.pdf_li(jd.lights, jd, jnp.asarray(idx, jnp.int32), jnp.asarray(ref_p),
                                jnp.asarray(ls.wi.numpy()), jnp.asarray(hit_t),
                                jnp.asarray(hit_cos), jd.world_radius))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert np.all(got[np.isin(kinds, LT.DELTA_KINDS)] == 0)
    lt = cs.data.lights
    wr = cs.data.world_radius
    for k, L, p in zip(lt.kind.tolist(), lt.L.numpy(), lt.params.numpy()):
        assert LT.light_power(k, L, p, wr) == JL.light_power(k, L, p, wr)
    np.testing.assert_array_equal(cs.data.light_distr.func.numpy(),
                                  np.asarray(jd.light_distr.func))


def test_li_path_matches_reference(scene):
    """1,024 lanes at depth 4 on the scene with every new shape and light:
    >= 99% of lanes within rtol 1e-3 / atol 1e-4, the mean within 1%,
    p_film equal and the live-ray counts within 1%. The reference runs
    eagerly (its loops are compiled as they come)."""
    jcs, cs = scene
    px, py, s = lanes(1024, 32, 4, seed=4)
    L, p_film, _, cnt = li_path(cs, *(torch.as_tensor(a) for a in (px, py, s)), max_depth=4)
    jL, jp, _, jcnt = j_li_path(jcs, jnp.asarray(px), jnp.asarray(py), jnp.asarray(s),
                                max_depth=4, with_stats=True)
    L, jL = L.numpy(), np.asarray(jL)
    ok = np.all(np.abs(L - jL) <= 1e-4 + 1e-3 * np.abs(jL), axis=1)
    assert ok.mean() >= 0.99
    assert abs(L.mean() - jL.mean()) <= 0.01 * abs(jL.mean())
    assert L.mean() > 0.05
    np.testing.assert_array_equal(p_film.numpy(), np.asarray(jp))
    for k in ("camera_rays", "shadow_rays", "bounce_rays", "valid_hits"):
        assert abs(int(cnt[k]) - float(jcnt[k])) <= 0.01 * float(jcnt[k]), k
