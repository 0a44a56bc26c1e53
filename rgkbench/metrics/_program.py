"""What the readers of the program's own counters and spans share.

They read the program at read time: the graph runners' counters
(`integrator.graph.read_stats()`, one read of the device counters) and
the span ring (`utils.trace.spans()`).  Only a traced run's record (it
holds `busy_s`) is read; a program without these counters or spans
gives None, as does a counter that is still zero.
"""


def stats(rec, *keys):
    """`read_stats()` when it has every key of `keys` and each is
    non-zero, else None."""
    if "busy_s" not in rec:
        return None
    from rgk_tpu_torch.integrator import graph

    got = graph.read_stats()
    if any(not got.get(k) for k in keys):
        return None
    return got


def span_seconds(rec, name, less=None):
    """The seconds of the spans named `name`, summed, less those of the
    spans named `less` nested in them (parent ids), or None."""
    if "busy_s" not in rec:
        return None
    try:
        from rgk_tpu_torch.utils import trace
    except ImportError:
        return None
    ring = trace.spans()
    got = [s for s in ring if s.name == name]
    if not got:
        return None
    seconds = sum(s.seconds for s in got)
    if less is not None:
        by_id = {s.id: s for s in ring}
        outer = {s.id for s in got}
        for s in ring:
            if s.name != less:
                continue
            up = by_id.get(s.parent)
            while up is not None and up.id not in outer:
                up = by_id.get(up.parent)
            if up is not None:
                seconds -= s.seconds
    return seconds
