"""The program's span recorder and its Chrome-trace writer.

`span(name, **attrs)` times a stretch of host code: its start and end by
`time.perf_counter_ns()`, the id of the span that encloses it on the
same thread (its parent, 0 for none) and its attributes.  Finished spans
go into an in-memory ring that keeps the last `RING` of them
(`spans()`); nothing is written until `write_chrome(path)`.  While a
`torch.profiler` is active a span also opens
`torch.profiler.record_function(name)`, which puts the span on the
profiler's clock beside the device's kernels, so that an idle stretch
of the device carries the name of the host code that ran then.

Spans sit at the layer boundaries on the host: the kernel library's load
(`kernels.load`), the scene build's phases (`scene.*`), a graph runner's
warm-up, captures and WHILE-graph instantiation (`graph.*`), a render's
rounds, blocks, accumulation, fetch, EXR write and checkpoint
(`render.*`) and a gradient step (`grad.step`).  There are none per
step: inside their captured bodies the runners time their phases on the
device (`integrator/graph.py`, `ops/graph_while.stamp`), and
`write_chrome` adds those counters (`graph.read_stats()`).  A span
also measures itself (`Span.seconds`), which `SceneBuilder.timings`
reads.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time

import torch

RING = 65536  # spans kept

_ring = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_local = threading.local()


class Span:
    """One span: `name`, `attrs`, `id` and `parent` (0 when outermost),
    `thread`, `start_ns` and `end_ns` (0 while open)."""

    __slots__ = ("name", "attrs", "id", "parent", "thread", "start_ns",
                 "end_ns")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = self.parent = self.start_ns = self.end_ns = 0
        self.thread = threading.get_ident()

    @property
    def seconds(self) -> float:
        return max(0, self.end_ns - self.start_ns) / 1e9


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


@contextlib.contextmanager
def span(name: str, **attrs):
    """Times the `with` block as span `name` (module doc); yields the
    `Span`, whose `attrs` the block may extend."""
    sp = Span(name, attrs)
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    sp.id = next(_ids)
    sp.parent = stack[-1].id if stack else 0
    stack.append(sp)
    marker = (torch.profiler.record_function(name) if _profiling()
              else contextlib.nullcontext())
    try:
        with marker:
            sp.start_ns = time.perf_counter_ns()
            try:
                yield sp
            finally:
                sp.end_ns = time.perf_counter_ns()
    finally:
        stack.pop()
        _ring.append(sp)


def spans(name: str = None) -> list:
    """The finished spans in the ring, oldest first (those named `name`
    only, if given)."""
    got = list(_ring)
    return got if name is None else [s for s in got if s.name == name]


def clear() -> None:
    _ring.clear()


def write_chrome(path: str) -> None:
    """The ring as complete events ("X", microseconds on the
    `perf_counter` clock, the span id and parent among their args) and
    the graph runners' counters (`graph.read_stats()`, one read of the
    device counters) as a counter event and under `otherData`, in the
    Chrome trace format (`traceEvents`)."""
    from ..integrator import graph

    counters = graph.read_stats()
    pid = os.getpid()
    got = spans()
    events = [{"name": s.name, "ph": "X", "pid": pid, "tid": s.thread,
               "ts": s.start_ns / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
               "args": dict(s.attrs, id=s.id, parent=s.parent)}
              for s in got]
    now = max([s.end_ns for s in got], default=time.perf_counter_ns())
    events.append({"name": "graph.read_stats", "ph": "C", "pid": pid,
                   "tid": 0, "ts": now / 1e3, "args": counters})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"read_stats": counters}}, f, default=str)
