"""The traced run's instruments, in the benchmark's own files: a count of
the ray queries a call makes and one torch.profiler window over it.

`count_queries(fn)` wraps the renderer's query routine while `fn` runs
(`ops.intersect.make_intersector`, which every tracer calls once a
trace): it counts closest and any-hit queries, and the live rays of the
any-hit ones (a shadow ray whose interval is empty asks nothing).  A
closest query's live rays are the tracer's extension-ray counter.

`profile(fn)` runs `fn` twice under one profiler schedule, a warm-up
step and an active one (a bare window can lose its first kernels), and
reads the active step: device ms by kernel name, the seconds in which
some operation ran on the device, the step's length, and the breakdown
of the result line.
"""

from __future__ import annotations

import time

import torch

TOP = 10  # entries of each breakdown list


def count_queries(fn):
    """-> ({"closest": n, "any": n, "any_rays": live any-hit rays},
    fn's result)."""
    from rgk_tpu_torch.ops import intersect as isect

    orig = isect.make_intersector
    counts = {"closest": 0, "any": 0}
    live = []

    def make(meta):
        query = orig(meta)

        def counted(scene, ro, rd, t_min, t_max, exclude=None,
                    any_hit=False):
            counts["any" if any_hit else "closest"] += 1
            if any_hit:
                lo = torch.as_tensor(t_min, device=ro.device)
                hi = torch.as_tensor(t_max, device=ro.device)
                live.append((hi > lo).expand(ro.shape[0]).sum())
            return query(scene, ro, rd, t_min, t_max, exclude=exclude,
                         any_hit=any_hit)

        return counted

    isect.make_intersector = make
    try:
        with torch.no_grad():
            out = fn()
    finally:
        isect.make_intersector = orig
    counts["any_rays"] = int(sum(int(x) for x in live))
    return counts, out


def _union(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _gaps(intervals, lo, hi):
    """The idle (start, end) stretches of [lo, hi] between intervals."""
    out, cursor = [], lo
    for s, e in sorted(intervals):
        if s > cursor:
            out.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
    if cursor < hi:
        out.append((cursor, hi))
    return [(s, e) for s, e in out if e > s]


def _host_names(host, times, longest=500):
    """The innermost host event running at each of `times` (us), or
    "no host op", for at most the `longest` first of them."""
    import numpy as np

    starts = np.array([e.time_range.start for e in host], np.float64)
    ends = np.array([e.time_range.end for e in host], np.float64)
    names = [e.name for e in host]
    out = []
    for t in times[:longest]:
        inside = np.flatnonzero((starts <= t) & (ends >= t))
        if inside.size == 0:
            out.append("no host op")
            continue
        out.append(names[inside[np.argmin(ends[inside] - starts[inside])]])
    return out


def read_window(events, wall_s):
    """The active step's readings from its profiler events."""
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in events if e.device_type == cuda
           and not e.name.startswith("ProfilerStep")]
    host = [e for e in events if e.device_type != cuda]
    steps = [e for e in host if e.name.startswith("ProfilerStep")]
    if steps:
        lo, hi = steps[-1].time_range.start, steps[-1].time_range.end
    else:
        lo = min(e.time_range.start for e in dev)
        hi = lo + wall_s * 1e6
    spans = [(max(lo, e.time_range.start), min(hi, e.time_range.end))
             for e in dev]
    spans = [(s, e) for s, e in spans if e > s]
    kernels = {}
    for e in dev:
        if e.name.startswith(("Memcpy", "Memset")):
            continue
        n, ms = kernels.get(e.name, (0, 0.0))
        kernels[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    host_ops = [e for e in host if not e.name.startswith("ProfilerStep")]
    idle = sorted(_gaps(spans, lo, hi), key=lambda g: g[0] - g[1])
    gaps = {}
    names = _host_names(host_ops, [(s + e) / 2 for s, e in idle])
    for name, (s, e) in zip(names, idle):
        gaps[name] = gaps.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(((n, ms / 1e3) for n, (_, ms) in kernels.items()),
                 key=lambda x: -x[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda x: -x[1])[:TOP]
    return {"kernels": kernels, "busy_s": _union(spans) / 1e6,
            "window_s": (hi - lo) / 1e6,
            "breakdown": {"device_ops": [[n, s] for n, s in ops],
                          "idle_gaps": [[n, s] for n, s in idle]}}


def profile(fn) -> dict:
    """One profiler window over `fn` (module doc)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import schedule

    windows, walls = [], []
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.no_grad(), tprofile(
            activities=acts,
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: windows.append(list(p.events()))) as p:
        for _ in range(2):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            p.step()
    return read_window(windows[-1], walls[-1])
