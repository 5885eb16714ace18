"""The instance slice as a whole: the port's li_path against pbrt_tpu's on a
small scene with shared-prototype instances and an animated shape, both
computing on the reference's tables carried across by the bridge (the
instance world included). CPU only."""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import jax_scene_arrays, lanes, pallas_tables
from test_torch_instance import HEAD, MOVING, OBJECT, ROTATED, instances

from pbrt_tpu.integrators.path import li_path as j_li_path
from pbrt_tpu.scene import load_scene_string as j_load_scene_string
from pbrt_tpu_torch.integrators.path import li_path
from pbrt_tpu_torch.scene.bridge import from_jax_arrays


def grid_floor(k=6, half=20.0, y=-1.0):
    """A k x k quad floor (2k^2 triangles): enough world triangles for the
    reference to build its BVH kernel tables."""
    xs = np.linspace(-half, half, k + 1)
    pts = " ".join(f"{x:g} {y:g} {z:g}" for z in xs for x in xs)
    idx = []
    for r in range(k):
        for c in range(k):
            a = r * (k + 1) + c
            idx += [a, a + 1, a + k + 2, a, a + k + 2, a + k + 1]
    return ('AttributeBegin\n  Material "matte" "rgb Kd" [0.5 0.5 0.5]\n'
            f'  Shape "trianglemesh" "integer indices" [{" ".join(map(str, idx))}]\n'
            f'    "point P" [{pts}]\nAttributeEnd\n')


SCENE = (HEAD.split("AttributeBegin")[0] + grid_floor() + OBJECT + instances() + ROTATED
         + MOVING + "WorldEnd\n")


def test_li_path_matches_reference_on_instances():
    """1,024 lanes at depth 2: >= 99% of lanes within rtol 1e-3 / atol 1e-4,
    the mean within 1%, p_film equal and the same live-ray counts."""
    with pallas_tables():
        jcs = j_load_scene_string(SCENE)
    arrays, specs = jax_scene_arrays(jcs)
    cs = from_jax_arrays(arrays, specs, device="cpu")
    assert cs.flags.n_instances == 7 and cs.flags.any_animated_inst
    assert cs.data.tri_attr.shape[0] == 72 + 4 + 4
    jcpu = dataclasses.replace(jcs, flags=dataclasses.replace(jcs.flags, use_pallas=False))
    px, py, s = lanes(1024, 24, 8, seed=4)
    L, p_film, _, cnt = li_path(cs, *(torch.as_tensor(a) for a in (px, py, s)), max_depth=2)
    jL, jp, _, jcnt = jax.jit(lambda *a: j_li_path(jcpu, *a, max_depth=2, with_stats=True))(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(s))
    L, jL = L.numpy(), np.asarray(jL)
    ok = np.all(np.abs(L - jL) <= 1e-4 + 1e-3 * np.abs(jL), axis=1)
    assert ok.mean() >= 0.99
    assert abs(L.mean() - jL.mean()) <= 0.01 * abs(jL.mean())
    assert L.mean() > 0.05
    np.testing.assert_array_equal(p_film.numpy(), np.asarray(jp))
    for k in ("camera_rays", "shadow_rays", "bounce_rays", "valid_hits"):
        assert int(cnt[k]) == int(jcnt[k]), k
