"""setup.scene_build_s: the benchmark's span around the port's load_scene
(parse, PLY read, BVH build, tables to the device), in seconds."""


def read(ctx):
    return ctx.get("spans", {}).get("scene_build")
