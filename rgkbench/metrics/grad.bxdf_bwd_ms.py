"""Device ms of the gradient graph's BxDF backward a step (the BxDF
kernel's `eval_bwd` and `sample_bwd` launches): the phase stamps'
`bxdf_bwd_ns` over `grad_steps`."""

from rgkbench.metrics import _program


def read(rec):
    st = _program.stats(rec, "bxdf_bwd_ns", "grad_steps")
    return None if st is None else st["bxdf_bwd_ns"] / st["grad_steps"] / 1e6
