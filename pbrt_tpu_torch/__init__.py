"""pbrt_tpu_torch — the PyTorch + CUDA port of the pbrt_tpu path tracer.

The JAX package `pbrt_tpu/` is the reference; this package keeps its module
paths (`pbrt_tpu_torch/integrators/path.py` ports
`pbrt_tpu/integrators/path.py`) and its numbers: samplers are bit-equal,
the BVH walk returns the same leaf slots on the same tables.

It imports torch, numpy and the standard library, never jax. Tensors live
on an explicit device that callers pass down (scene build) or that
functions read off their inputs. The hand-written kernels, the BVH
traversal (csrc/bvh_traverse.cu) and the two-level instance traversal
(csrc/instance_traverse.cu), are built with nvcc at first use into
build/pbrt_tpu_torch/; CPU tensors take their plain PyTorch versions.

Entry points: `python -m pbrt_tpu_torch scene.pbrt`, or
scene.load_scene(...) + render.render(...) (which sends SPPM, BDPT and MLT
to their own drivers, a render asked to run on several devices to
parallel/mesh.py::render_sharded, and every other to
render.render_sampler_integrator). They run on the card unless given the
CPU (`--device cpu`, device="cpu").
"""
