"""Device ms of the gradient graph's forward (`make_loss_fn`, every
bounce) a step: the phase stamps' `grad_fwd_ns` over `grad_steps`."""

from rgkbench.metrics import _program


def read(rec):
    st = _program.stats(rec, "grad_fwd_ns", "grad_steps")
    return None if st is None else st["grad_fwd_ns"] / st["grad_steps"] / 1e6
