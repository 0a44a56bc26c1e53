"""Device ms of the gradient graph's texel backward a step (the texel
gathers' accumulate into the texel gradient table): the phase stamps'
`tex_bwd_ns` over `grad_steps`."""

from rgkbench.metrics import _program


def read(rec):
    st = _program.stats(rec, "tex_bwd_ns", "grad_steps")
    return None if st is None else st["tex_bwd_ns"] / st["grad_steps"] / 1e6
