"""Device ms of the gradient graph's `torch.autograd.grad` a step: the
phase stamps' `grad_bwd_ns` over `grad_steps`."""

from rgkbench.metrics import _program


def read(rec):
    st = _program.stats(rec, "grad_bwd_ns", "grad_steps")
    return None if st is None else st["grad_bwd_ns"] / st["grad_steps"] / 1e6
