"""Host seconds of the graph runners' eager warm-up steps before their
captures (ATen's lazy kernel loads, allocator growth): the program's
`graph.warm` spans, summed, less the kernel library's load
(`kernels.load`, its own metric) where it falls inside one."""

from rgkbench.metrics import _program


def read(rec):
    return _program.span_seconds(rec, "graph.warm", less="kernels.load")
