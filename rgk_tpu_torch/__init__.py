"""rgk_tpu_torch — the PyTorch/CUDA port of the rgk_tpu path tracer.

A second package beside `rgk_tpu/`, which stays the reference: module
names mirror it one for one, plain tensor code is PyTorch, and every
Pallas kernel of the reference is a hand-written CUDA kernel for Hopper
(`csrc/`, built at first use by `kernels/`).  The port stands alone: it
imports neither JAX nor anything of `rgk_tpu`, and keeps its own copies
of the reference's numpy-only modules (the `io/` package for EXR, OBJ
and textures, JSON helpers, primitives, transforms, `utils/`, the
progress monitor), of the LTC tables and of the native BVH and OBJ
builders (`native/`, compiled with `c++` at first use).

What renders: JSON scenes of any size, unidirectional (`reverse == 0`,
`integrator/path.trace_wavefront_queued`) and bidirectional (`reverse >
0`, `trace_wavefront_queued_bdpt`), with thin glass and the
`tint-thinglass` extension (`ops/thinglass.py`); the per-sample path
(`render_lanes`, `render_image_round`) too.  Up to 4096 triangles every
ray-triangle query goes through the flat-sweep kernel K1
(`ops/flat_intersect.py`); above that the commit builds a BVH and a
cluster tree (`scene/bvh.py`, `scene/clusters.py`) and every query goes
through the cluster kernel K2 (`ops/cluster_intersect.py`), or, as
`RGK_BINNED=any|all` asks, through the binned pipeline of the walk-emit
kernel K3 and the chunk-sweep kernel K4 (`ops/binned_intersect.py`).
On the CPU the kernels' plain versions run, and BVH scenes walk
`ops/intersect.intersect_bvh`, the reference's own non-TPU route.

Also ported: line-based `.rtc` configs (`scene/rtc.py`); gradients
(`diff/params.py`: autograd through `render_lanes`, hits detached;
`diff/graph.py`: the forward and backward as one CUDA graph on the
card);
the `-d X Y` per-bounce replay (`integrator/debug.py`); lanes sharded
over several devices of one process (`parallel/mesh.py`) and rendering
in several processes over `torch.distributed`, NCCL on the card and
gloo on the CPU (`parallel/multihost.py`).  The port does everything
`rgk_tpu` does; a device other than the CPU or a CUDA card raises.

Public entry points:
    rgk_tpu_torch.scene.config.load_config / build_scene
    rgk_tpu_torch.driver.render.RenderDriver
    rgk_tpu_torch.driver.cli.main   (python -m rgk_tpu_torch.driver.cli)
    rgk_tpu_torch.diff.params.extract_params / apply_params / make_loss_fn
    rgk_tpu_torch.diff.graph.make_value_and_grad
    rgk_tpu_torch.integrator.debug.trace_pixel_debug
    rgk_tpu_torch.parallel.mesh.MeshContext
    python -m rgk_tpu_torch.tools.prof_smem_probe   (probe P1, on a card)
    python -m rgk_tpu_torch.tools.prof_sync         (probe P2, on a card)
"""

__version__ = "0.1.0"
