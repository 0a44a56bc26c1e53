"""Device ms a queued step spends outside the intersector on the graph
route (shading, sampler, lights, textures, the step's copies): the phase
stamps' `step_ns - intersect_ns` over the queued iterations."""

from rgkbench.metrics import _program


def read(rec):
    st = _program.stats(rec, "step_ns", "intersect_ns", "iterations")
    if st is None:
        return None
    return (st["step_ns"] - st["intersect_ns"]) / st["iterations"] / 1e6
