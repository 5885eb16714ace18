"""Parts of the benchmark found by name: `load(kind, name)` imports
<kind>/<name>.py from the benchmark's folder.

Each kind is a folder of small modules, one for each name a configuration
or BENCHMARK.json can give, so that a later configuration, traffic mix or
metric adds files and edits none:

  metrics/      a metric's reader: read(ctx) -> number or None
  generators/   a mesh file writer: write(path, **params), scaled(params, f)
  shapes/       a Shape directive's triangles: triangles(params, scene_dir)
  materials/    a Material's BSDF: parse(params), f_pdf(m, wo, wi),
                sample(m, wo, u_lobe, u_dir), SPECULAR
  lights/       a LightSource: make(params, ctm)
  area_lights/  an AreaLightSource: make(params, tris)
  cameras/      a Camera: make(params, cam_to_world, resolution, dtype, device)
  samplers/     a Sampler's draws: make(params, resolution, seed)
  integrators/  an Integrator's radiance: make(params, reference)
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent
_LOADED = {}


def load(kind, name, folder=HERE):
    """The module <folder>/<kind>/<name>.py, imported once per path."""
    path = Path(folder) / kind / f"{name}.py"
    if path not in _LOADED:
        if not path.is_file():
            have = sorted(p.stem for p in (Path(folder) / kind).glob("*.py"))
            raise ValueError(f"no {kind[:-1]} {name!r} in {kind}/ (there are: {', '.join(have)})")
        spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]
