"""What the readers of the bidirectional cell's counters share: the
program's graph counters (`integrator.graph.read_stats()`) over the
window alone, the difference that `drivers/bdpt.py` records as
`graph_window` in a traced run.  A program without a counter, or a
counter still zero, gives None."""


def window(rec, *keys):
    """`rec["graph_window"]` when it has every key of `keys` and each is
    non-zero, else None."""
    got = rec.get("graph_window")
    if "busy_s" not in rec or not got or any(not got.get(k) for k in keys):
        return None
    return got
