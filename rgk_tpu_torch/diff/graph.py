"""The gradient step as one CUDA graph: the counterpart of the
reference's jitted `jax.value_and_grad(loss_fn)` (`rgk_tpu/diff/params.py`
`make_loss_fn`, which its users jit).

`make_value_and_grad` returns fn(params) -> (loss, grads).  On a card
the runner holds static leaves that require grad (copies of the scene's
parameters) and one graph captured around `loss_fn(leaves)` and
`torch.autograd.grad(loss, leaves, allow_unused=True)`, the forward
and the backward in one capture (PyTorch's whole-network capture; the
backward's kernels go to the capturing stream).  A call copies `params`
into the leaves and replays the graph; the loss and the gradients it
returns are the graph's output buffers, rewritten by the next call.

The loss is `make_loss_fn`'s: the per-sample path with
`differentiable=True` (every bounce, no host read), K1's flat-hit
record recomputed from its row and the BVH hits detached, the
light-pick tables held by `apply_params`.  The seed and the lanes are
baked into the capture, as `make_loss_fn` fixes them: a new seed or new
lanes need a new runner.  The capture follows `integrator/graph.py`:
warm-up steps on a side stream under `set_sync_debug_mode("error")`,
the launch counters' delta added per replay, no eager fallback on the
card.  On the CPU a call is plain autograd on the same leaves.

The step stamps its phases into the runner's probe (`tgraph._Probe`):
a mark at its start, `grad_fwd_ns` after the loss, `grad_bwd_ns` after
`torch.autograd.grad`; `tgraph.read_stats()` sums them with
`grad_steps`, the calls since the capture.  While the step runs (and is
captured) the probe is `graph_while.grad_probe`: the texel gathers'
backward and the BxDF kernel's backward launches stamp themselves into
`tex_bwd_ns` and `bxdf_bwd_ns`, parts of the backward that `read_stats`
adds back into `grad_bwd_ns`, and the forward counts its textured
lookups into `tex_fetches`.
"""

from __future__ import annotations

import torch

from ..integrator import graph as tgraph
from ..ops import graph_while as gw
from ..utils import trace
from .params import extract_params, make_loss_fn


class ValueAndGrad(tgraph._Runner):
    """fn(params) -> (loss f32 [], {key: gradient or None}) of
    `make_loss_fn(scene, meta, settings, cam, px, py, sample_idx, seed,
    target, sampler_mode)` (module doc)."""

    def __init__(self, scene, meta, settings, cam, px, py, sample_idx, seed,
                 target, sampler_mode: int = 1):
        dev = scene.tri_pack.device
        super().__init__(dev, "gradient step")
        self.loss_fn = make_loss_fn(scene, meta, settings, cam, px, py,
                                    sample_idx, seed, target, sampler_mode)
        self.leaves = extract_params(scene)
        self.out = None
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                self._build(self._warm, [("step", self._step)])
        self._register()

    def _step(self) -> None:
        gw.grad_probe = self.probe
        try:
            self.probe.stamp()
            loss = self.loss_fn(self.leaves)
            self.probe.stamp("grad_fwd_ns")
            grads = torch.autograd.grad(loss, list(self.leaves.values()),
                                        allow_unused=True)
            self.probe.stamp("grad_bwd_ns")
        finally:
            gw.grad_probe = None
        self.out = (loss.detach(), dict(zip(self.leaves, grads)))

    def _warm(self) -> None:
        for _ in range(tgraph.WARMUP_STEPS):
            self._step()

    def __call__(self, params):
        with trace.span("grad.step"), self._device():
            with torch.no_grad():
                for k, leaf in self.leaves.items():
                    leaf.copy_(params[k])
            if self.device.type == "cuda":
                self._replay("step")
            else:
                self._step()
        tgraph._bump(grad_steps=1)
        return self.out


def make_value_and_grad(scene, meta, settings, cam, px, py, sample_idx, seed,
                        target, sampler_mode: int = 1) -> ValueAndGrad:
    """The L2 loss of `make_loss_fn` and its gradients as one call,
    fn(params) -> (loss, grads), a graph replay on a card (module
    doc)."""
    return ValueAndGrad(scene, meta, settings, cam, px, py, sample_idx, seed,
                        target, sampler_mode)
