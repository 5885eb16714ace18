"""Count the tensor ops of one wavefront pass of the port's scenes, on the
CPU: python3 count_ops.py [--lanes N] [SCENE ...]

Each non-view tensor op is one device kernel on the card, and the renders
are bound by the host's time to issue them, so the count of a pass is the
first figure of its cost. The BVH walk counts as one launch (on the CPU its
plain walk runs outside the count). For each scene the script prints the
ops of one call of its integrator's radiance function (BDPT: one
_bdpt_sample) on N lanes of its film, the share of them that the
sampler's draws issue, and the tracking loops' host reads (the op count
does not depend on N except through those loops).
Scenes: config2, config4, volpath, bdpt (the large bench scene under
bdpt at depth 4), whitted, direct_all, direct_one (BASELINE config 3
under each, depth 5) and bdpt_env, bdpt_fog (the env-lit and fog
calibration scenes under bdpt at depth 3), all from scene/bench.py;
bench (the large bench scene, depth 4).
"""
import argparse
import sys
import tempfile

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from pbrt_tpu_torch import media as MD
from pbrt_tpu_torch import samplers as S
from pbrt_tpu_torch.accel import traverse as T
from pbrt_tpu_torch.integrators import (bdpt as BD, common as CM, direct as DR, path as P,
                                        volpath as V, whitted as W)
from pbrt_tpu_torch.render import li_fn
from pbrt_tpu_torch.scene import bench as Bn, intersect as SI
from pbrt_tpu_torch.scene.build import load_scene


class Count(TorchDispatchMode):
    """Non-view ops (`n`), of which the sampler's (`sampler`), and walks."""

    def __init__(self):
        super().__init__()
        self.n = self.sampler = self.walks = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not func.is_view
        return func(*args, **(kwargs or {}))


def instrument(count):
    """Count each walk as one launch and the sampler's ops apart."""
    walk = T.traverse

    def one_launch(*a, **k):
        count.walks += 1
        with _disable_current_modes():
            return walk(*a, **k)

    def sampler(fn):
        def counted(*a, **k):
            n0, s0 = count.n, count.sampler
            out = fn(*a, **k)
            count.sampler = s0 + count.n - n0
            return out
        return counted

    SI.traverse = one_launch
    dim, two = sampler(S.sample_dim), sampler(S.sample_2d)
    for m in (P, CM, V, W, DR, BD):
        m.sample_dim, m.sample_2d = dim, two


INTEGRATOR_LINES = {"whitted": 'Integrator "whitted" "integer maxdepth" 5',
                    "direct_all": 'Integrator "directlighting" "integer maxdepth" 5',
                    "direct_one": 'Integrator "directlighting" "integer maxdepth" 5 '
                                  '"string strategy" "one"'}


def scene(name, tmp):
    """-> (the scene on the CPU, the radiance function of a pass on lanes)."""
    if name == "bench":
        cs = Bn.build_bench_scene(True, "cpu")
        return cs, lambda *lanes: P.li_path(cs, *lanes, max_depth=4)
    if name in INTEGRATOR_LINES:
        path = Bn.write_env_material_scene(tmp, integrator=INTEGRATOR_LINES[name])
    elif name.startswith("bdpt_"):
        path = f"{tmp}/scene.pbrt"
        with open(path, "w") as f:
            f.write(Bn.calibration_scene(name[5:], 'Integrator "bdpt" "integer maxdepth" 3'))
    else:
        path = {"config2": lambda: Bn.write_config2_scene(tmp),
                "config4": lambda: Bn.write_config4_scene(tmp),
                "volpath": lambda: Bn.write_volpath_scene(tmp),
                "bdpt": lambda: Bn.write_bdpt_scene(tmp)}[name]()
    cs = load_scene(path, None, "cpu")
    if cs.integrator_kind == "bdpt":
        D = int(cs.integrator_params["maxdepth"][0]) + 1
        return cs, lambda *lanes: BD._bdpt_sample(cs, *lanes, D)
    li = li_fn(cs)
    return cs, lambda *lanes: li(cs, *lanes)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("scenes", nargs="*", default=["bench", "config2", "config4", "volpath",
                                                  "bdpt", "whitted", "direct_all",
                                                  "direct_one", "bdpt_env", "bdpt_fog"])
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    rng = np.random.default_rng(0)
    for name in args.scenes:
        with tempfile.TemporaryDirectory() as tmp:
            cs, li = scene(name, tmp)
            res = cs.film.full_resolution
            px, py = (torch.as_tensor(rng.integers(0, r, args.lanes).astype(np.int32))
                      for r in res)
            s = torch.as_tensor(rng.integers(0, cs.sampler.rounded_spp(), args.lanes)
                                .astype(np.int32))
            count = Count()
            instrument(count)
            MD.HOST_READS["blocks"] = 0
            with torch.no_grad(), count:
                li(px, py, s)
            depth = cs.integrator_params.get("maxdepth", [5])[0]
            print(f"{name}: {count.n} non-view tensor ops a pass of {args.lanes} lanes at depth "
                  f"{depth} ({count.walks} walk launches, each counted once); the sampler "
                  f"({cs.sampler.kind}) {count.sampler} ({100 * count.sampler / count.n:.1f}%); "
                  f"tracking-loop host reads {MD.HOST_READS['blocks']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
