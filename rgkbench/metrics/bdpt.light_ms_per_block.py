"""Device ms of a block's light phase on the graph route (the WHILE
graph's prologue: every light subpath of the block, their splat query
and the scatter, the vertices packed): the phase stamps' `light_ns` +
`light_intersect_ns` over the light phases run, in the window."""

from rgkbench.metrics import _bdpt


def read(rec):
    st = _bdpt.window(rec, "light_ns", "light_intersect_ns", "light_replays")
    if st is None:
        return None
    ns = st["light_ns"] + st["light_intersect_ns"]
    return ns / st["light_replays"] / 1e6
