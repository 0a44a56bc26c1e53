"""Device ms a queued BDPT step spends on its eye x light connections
on the graph route (the packed row's gather, `reverse` shadow queries
and two BxDF evaluations each): the phase stamps' `connect_ns` +
`connect_intersect_ns` over the queued iterations, in the window."""

from rgkbench.metrics import _bdpt


def read(rec):
    st = _bdpt.window(rec, "connect_ns", "connect_intersect_ns",
                      "iterations")
    if st is None:
        return None
    ns = st["connect_ns"] + st["connect_intersect_ns"]
    return ns / st["iterations"] / 1e6
