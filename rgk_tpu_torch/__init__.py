"""rgk_tpu_torch — the PyTorch/CUDA port of the rgk_tpu path tracer.

A second package beside `rgk_tpu/`, which stays the reference: module
names mirror it one for one, plain tensor code is PyTorch, and every
Pallas kernel on the ported path is a hand-written CUDA kernel for
Hopper (`csrc/`, built at first use by `kernels/`).  Nothing here
imports JAX; the numpy-only modules of `rgk_tpu` (EXR/OBJ/texture I/O,
JSON helpers, primitives, transforms, utils, the progress monitor) are
imported from there as they are, since `rgk_tpu/__init__.py` imports
nothing.

Slice 1 (this package today): unidirectional renders (`reverse == 0`)
of JSON scenes of at most 4096 triangles, every ray-triangle query
through the flat-sweep kernel (`ops/flat_intersect.py`).

Public entry points:
    rgk_tpu_torch.scene.config.load_config / build_scene
    rgk_tpu_torch.driver.render.RenderDriver
    rgk_tpu_torch.driver.cli.main   (python -m rgk_tpu_torch.driver.cli)
"""

__version__ = "0.1.0"
