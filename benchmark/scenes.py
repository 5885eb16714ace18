"""A configuration's scene, written into a directory: its scene text and
the meshes it names, each made by the generator that the configuration
file names (generators/<name>.py, found by name).
"""
from __future__ import annotations

import os

import plugins


def scene_text(config, resolution=None, spp=None):
    """The configuration's scene text; resolution and spp, where given,
    replace the film's and the sampler's (the CPU tests' small crops)."""
    text = "\n".join(config["scene"]) + "\n"
    if resolution is not None:
        text = text.replace('"integer xresolution" [{0}] "integer yresolution" [{1}]'.format(
            *config["resolution"]),
            '"integer xresolution" [{0}] "integer yresolution" [{1}]'.format(*resolution))
    if spp is not None:
        text = text.replace(f'"integer pixelsamples" {config["spp"]}',
                            f'"integer pixelsamples" {spp}')
    return text


def write_scene(config, dirname, resolution=None, spp=None, mesh_scale=None):
    """Write the configuration's scene.pbrt and its meshes into dirname ->
    the scene file's path. mesh_scale: a factor on each mesh's size (the
    CPU tests' small meshes)."""
    os.makedirs(dirname, exist_ok=True)
    for name, spec in config.get("meshes", {}).items():
        args = dict(spec)
        gen = plugins.load("generators", args.pop("generator"))
        if mesh_scale is not None:
            args = gen.scaled(args, mesh_scale)
        gen.write(os.path.join(dirname, name), **args)
    path = os.path.join(dirname, "scene.pbrt")
    with open(path, "w") as f:
        f.write(scene_text(config, resolution, spp))
    return path
