"""pbrt_tpu_torch — the PyTorch + CUDA port of the pbrt_tpu path tracer.

The JAX package `pbrt_tpu/` is the reference; this package keeps its module
paths (`pbrt_tpu_torch/integrators/path.py` ports
`pbrt_tpu/integrators/path.py`) and its numbers: samplers are bit-equal,
the BVH walk returns the same leaf slots on the same tables.

It imports torch, numpy and the standard library, never jax. Tensors live
on an explicit device that callers pass down (scene build) or that
functions read off their inputs. The one hand-written kernel, the BVH
traversal (csrc/bvh_traverse.cu), is built with nvcc at first use into
build/pbrt_tpu_torch/; CPU tensors take its plain PyTorch version.

Entry points: `python -m pbrt_tpu_torch scene.pbrt`, or
scene.load_scene(...) + render.render_sampler_integrator(...).
"""
