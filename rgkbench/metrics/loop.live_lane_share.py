"""Share of the queued loop's lane-steps that trace an extension ray:
the program's `live_lanes` over `lane_steps` (lanes x iterations).  The
rest of a block's lanes run the step's intersection and shading idle."""

from rgkbench.metrics import _program


def read(rec):
    st = _program.stats(rec, "live_lanes", "lane_steps")
    return None if st is None else st["live_lanes"] / st["lane_steps"]
