"""Multi-process rendering on `torch.distributed` (port of
rgk_tpu/parallel/multihost.py).

Each process renders a contiguous slice of the frame's pixel blocks
(`host_lane_range`) on its own devices; at the end of a round the
driver sums the per-process partial accumulations (`allreduce_image`):
the processes own disjoint pixels, so the sum recovers the frame
exactly, and a multi-process unidirectional render equals a
one-process render bit for bit.  Process 0 alone writes the EXR and the
checkpoint, decides the timed stop and loads a checkpoint to resume;
`broadcast_scalar` carries its decisions to the others.

The process group is set up by `initialize`: NCCL when the render
device is CUDA (the default; the reductions run on that device), gloo
when it is the CPU (asked for with `device="cpu"`, as the CLI does under
--cpu; they run on the host), rendezvous over TCP at process 0's
address.
It is destroyed at exit.
"""

from __future__ import annotations

import atexit

import torch
import torch.distributed as dist

from ..utils import log as out


def initialize(coordinator: str = "", num_processes: int = 1,
               process_id: int = 0, device="cuda") -> None:
    """Join the process group of `num_processes` processes, this one of
    rank `process_id`, with rendezvous at `coordinator` ("host:port" of
    process 0), for rendering on `device`: the card by default (NCCL),
    the CPU on request (gloo).  A no-op for one process with no
    coordinator."""
    if num_processes <= 1 and not coordinator:
        out.log(3, "multihost: single process, skipping distributed init")
        return
    if not coordinator:
        raise ValueError("multi-process rendering needs --coordinator "
                         "HOST:PORT")
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = torch.device(
            "cuda", device.index if device.index is not None
            else torch.cuda.current_device())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            **kwargs)
    atexit.register(_destroy)
    out.log(2, f"multihost: process {dist.get_rank()} of "
               f"{dist.get_world_size()} ({backend})")


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_lane_range(total_lanes: int) -> tuple:
    """The contiguous slice [lo, hi) of `total_lanes` units this process
    renders: an even split, the remainder spread one apiece over the
    first (total % n) processes, so none carries more than one extra."""
    n = process_count()
    i = process_index()
    per, rem = divmod(total_lanes, n)
    lo = i * per + min(i, rem)
    return lo, lo + per + (1 if i < rem else 0)


def _collective_device(t: torch.Tensor) -> torch.device:
    """Where the group's collectives run: NCCL on this process's card,
    gloo on the host."""
    if dist.get_backend() == "nccl":
        return t.device if t.device.type == "cuda" else torch.device(
            "cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allreduce_image(partial_sum: torch.Tensor) -> torch.Tensor:
    """Sum per-process partial accumulations over the processes.  One
    process: returned as given.  The result has the input's dtype and
    device."""
    if process_count() == 1:
        return partial_sum
    buf = partial_sum.to(_collective_device(partial_sum),
                         copy=True).contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.to(partial_sum.device)


def broadcast_scalar(value: float) -> float:
    """Process 0's `value` (a round index, a stop flag) on every
    process."""
    if process_count() == 1:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64)
    buf = t.to(_collective_device(t))
    dist.broadcast(buf, src=0)
    return float(buf.cpu()[0])
