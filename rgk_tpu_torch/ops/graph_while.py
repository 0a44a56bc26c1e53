"""The reference's `jax.lax.while_loop` on the card: a CUDA graph with a
conditional WHILE node (`csrc/graph_while.cu`), around graphs captured
by PyTorch.

`WhileGraph(body, flag, runs, prologue, epilogue)` takes
`torch.cuda.CUDAGraph`s captured with `keep_graph=True` (their
`raw_cuda_graph()`; the object keeps them, and so their memory pool,
alive), a device flag (bool or int32 []) that the prologue and the body
write, and an int64 [] device counter.  It builds and instantiates

    child(prologue) -> setter -> WHILE { child(body) -> setter }
                    -> child(epilogue)

where the condition setter, one thread, copies the flag into the WHILE
node's condition and adds 1 to `runs`.  `launch()` runs the whole loop
on the current stream: no read of the flag on the host, no body past the
end.  A launch runs the setter (bodies + 1) times, so the bodies a run
of launches ran are `runs` less the launches; `integrator/graph.py`
reads the counters when its statistics are read.  Building refuses (and
names) a node type that a conditional body may not hold, a driver older
than 12.4 and CPU tensors; nothing falls back.

`run_plain` is the same loop with the host reading the flag before every
body call: the setter's plain version, for CPU tensors.

`stamp(acc, slot)` is the phase stamp of `csrc/graph_while.cu`: the
time since the accumulator's last stamp added into one slot, on the
device's clock and with no read on the host, so that a captured body
times its own phases (`integrator/graph.py`).  On a CPU tensor it does
the same with `time.perf_counter_ns()`.  `grad_phase(name)` stamps an
op's backward as its own phase of the gradient step being run
(`grad_probe`, set by `diff/graph.py`), and does nothing outside one.

`launches["setter"]` counts the setter's runs, added from the device
counters when `integrator.graph.read_stats` reads them;
`launches["stamp"]` the stamps launched (a capture's at every replay).
A raw launch does not advance PyTorch's generators as
`CUDAGraph.replay` does: the captured bodies must draw no random numbers
from them (the port's sampler is a counter-based hash;
`integrator/graph.py` checks that a body's warm-up leaves the
generator's state alone).
"""

from __future__ import annotations

import contextlib
import ctypes
import time

import torch

from .. import kernels

launches = {"setter": 0, "stamp": 0}
LAST = 1  # the slot of a stamp accumulator that holds its latest stamp
# The probe (`integrator.graph._Probe`) of the gradient step being run or
# captured, set by `diff/graph.py` around the step; None outside one.  Ops
# whose backward is a phase of its own stamp it (`_Probe.nested`), and the
# texture lookups add their textured lanes to it.
grad_probe = None


def _raise(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} failed (code {rc}): "
                           f"{lib.rgk_while_graph_error().decode()}")


def _check_buffers(flag, runs) -> None:
    if flag.device.type != "cuda" or runs.device.type != "cuda":
        raise ValueError(
            f"a WHILE graph runs on the card: flag on {flag.device}, runs "
            f"on {runs.device}")
    if flag.dtype not in (torch.bool, torch.int32) or flag.numel() != 1:
        raise TypeError(f"the flag must be one bool or int32, got "
                        f"{flag.dtype} {tuple(flag.shape)}")
    if runs.dtype != torch.int64 or runs.numel() != 1:
        raise TypeError(f"runs must be one int64, got {runs.dtype} "
                        f"{tuple(runs.shape)}")
    if flag.device != runs.device:
        raise ValueError(f"flag on {flag.device}, runs on {runs.device}")


def _card():
    if not torch.cuda.is_available():
        raise RuntimeError("a WHILE graph needs a CUDA device")
    return kernels.load()


def driver_version() -> int:
    """The CUDA driver's version (cudaDriverGetVersion, e.g. 12080)."""
    lib = _card()
    v = ctypes.c_int(0)
    _raise(lib, lib.rgk_cuda_driver_version(ctypes.byref(v)),
           "cudaDriverGetVersion")
    return v.value


def node_count(graph, what: str = "captured") -> int:
    """Nodes of a `CUDAGraph(keep_graph=True)` capture, child graphs
    walked; raises on a node that a conditional body may not hold."""
    lib = _card()
    n = ctypes.c_longlong(0)
    _raise(lib, lib.rgk_graph_check(graph.raw_cuda_graph(), what.encode(),
                                    ctypes.byref(n)),
           f"listing the {what} graph")
    return n.value


class WhileGraph:
    """One instantiated WHILE graph (module doc)."""

    def __init__(self, body, flag, runs, prologue=None, epilogue=None):
        _check_buffers(flag, runs)
        lib = _card()
        self.device = flag.device
        # The captures and the buffers the exec reads: kept alive with it.
        self._keep = (body, prologue, epilogue, flag, runs)
        self.flag, self.runs = flag, runs
        exec_ = ctypes.c_void_p(None)

        def raw(g):
            return None if g is None else g.raw_cuda_graph()

        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            _raise(lib, lib.rgk_while_graph_create(
                raw(prologue), raw(body), raw(epilogue), flag.data_ptr(),
                flag.element_size(), runs.data_ptr(), stream,
                ctypes.byref(exec_)), "building the WHILE graph")
        self._exec = exec_.value
        self._lib = lib

    def launch(self) -> None:
        """The loop, on the device's current stream."""
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _raise(self._lib, self._lib.rgk_while_graph_launch(self._exec,
                                                           stream),
               "launching the WHILE graph")

    def __del__(self):
        exec_, self._exec = getattr(self, "_exec", None), None
        if exec_:
            self._lib.rgk_while_graph_destroy(exec_)


def stamp(acc, slot: int = -1) -> None:
    """Adds the nanoseconds since `acc[LAST]` into `acc[slot]` and sets
    `acc[LAST]` to now (slot -1: only the latter).  `acc` is an int64
    vector; on the card one thread reads `%globaltimer` on the current
    stream (a node of the graph being captured, if any), on the CPU the
    host reads `time.perf_counter_ns()`."""
    if acc.dtype != torch.int64 or acc.dim() != 1 or not acc.is_contiguous():
        raise TypeError(f"a stamp accumulator is a contiguous int64 vector, "
                        f"got {acc.dtype} {tuple(acc.shape)}")
    if not (-1 <= slot < acc.shape[0]) or slot == LAST or acc.shape[0] <= LAST:
        raise ValueError(f"slot {slot} of a stamp accumulator of "
                         f"{acc.shape[0]}")
    if acc.device.type == "cpu":
        now = time.perf_counter_ns()
        if slot >= 0:
            acc[slot] += now - int(acc[LAST])
        acc[LAST] = now
        return
    lib = kernels.load()
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        rc = lib.rgk_stamp(acc.data_ptr(), LAST, slot, stream)
    kernels.check_launch(rc, "stamp")
    launches["stamp"] += 1


def grad_phase(name: str):
    """A context around an op's backward: phase `name` of the gradient
    step being run (`grad_probe.nested`), or nothing outside one."""
    probe = grad_probe
    return contextlib.nullcontext() if probe is None else probe.nested(name)


def run_plain(body, flag, prologue=None, epilogue=None) -> int:
    """`WhileGraph`'s loop over callables, the host reading `flag` (a CPU
    tensor) before every `body()`.  -> the bodies run."""
    if flag.device.type != "cpu":
        raise ValueError(f"run_plain reads a CPU flag, got {flag.device}; "
                         f"on the card build a WhileGraph")
    if prologue is not None:
        prologue()
    n = 0
    while bool(flag):
        body()
        n += 1
    if epilogue is not None:
        epilogue()
    return n
