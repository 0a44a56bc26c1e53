"""rgk_tpu_torch — the PyTorch/CUDA port of the rgk_tpu path tracer.

A second package beside `rgk_tpu/`, which stays the reference: module
names mirror it one for one, plain tensor code is PyTorch, and every
Pallas kernel on the ported path is a hand-written CUDA kernel for
Hopper (`csrc/`, built at first use by `kernels/`).  Nothing here
imports JAX; the numpy-only modules of `rgk_tpu` (EXR/OBJ/texture I/O,
re-exported by `io.py`, JSON helpers, primitives, transforms, utils, the
progress monitor) are imported from there as they are, since
`rgk_tpu/__init__.py` imports nothing.

What renders today: unidirectional renders (`reverse == 0`) of JSON
scenes of any size.  Up to 4096 triangles every ray-triangle query goes
through the flat-sweep kernel K1 (`ops/flat_intersect.py`); above that
the commit builds a BVH and a cluster tree (`scene/bvh.py`,
`scene/clusters.py`) and every query goes through the cluster kernel K2
(`ops/cluster_intersect.py`), or, as `RGK_BINNED=any|all` asks, through
the binned pipeline of the walk-emit kernel K3 and the chunk-sweep
kernel K4 (`ops/binned_intersect.py`).  On the CPU the kernels' plain
versions run, and BVH scenes walk `ops/intersect.intersect_bvh`, the
reference's own non-TPU route.

Still raising NotImplementedError: `reverse > 0` (BDPT),
`tint-thinglass` and line-based `.rtc` configs.

Public entry points:
    rgk_tpu_torch.scene.config.load_config / build_scene
    rgk_tpu_torch.driver.render.RenderDriver
    rgk_tpu_torch.driver.cli.main   (python -m rgk_tpu_torch.driver.cli)
    python -m rgk_tpu_torch.tools.prof_smem_probe   (probe P1, on a card)
    python -m rgk_tpu_torch.tools.prof_sync         (probe P2, on a card)
"""

__version__ = "0.1.0"
