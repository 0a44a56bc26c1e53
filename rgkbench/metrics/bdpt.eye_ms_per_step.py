"""Device ms of a queued BDPT step on the graph route, its connections
included: the phase stamps' `step_ns` (the sum of the step's time
slots) over the queued iterations, in the window."""

from rgkbench.metrics import _bdpt


def read(rec):
    st = _bdpt.window(rec, "step_ns", "iterations")
    return None if st is None else st["step_ns"] / st["iterations"] / 1e6
