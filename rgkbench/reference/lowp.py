"""The reference one precision down: every float32 result of every
operation, forward and backward, rounded to bfloat16.

`bfloat16()` is a context in which each ATen operation runs as usual and
then has its float32 outputs cut to bfloat16 and stored back as
float32: shading, warps, the sampler's floats, gathers, ray queries and
autograd's backward alike, as a renderer that kept every value in
bfloat16 would see them.  The cut drops the low 16 bits (rounding toward
zero), so no value grows past a bound it was clamped to: 0.999 stays
below 1 and a table index stays inside its table, as it would in a
renderer written for that type.  Float64 results, the reference's own
sums, are left as they are, and so are views, which share their base's
values.  The control of the benchmark's comparison.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_HIGH16 = -(1 << 16)  # 0xFFFF0000 as an int32


def _rounded(t: torch.Tensor) -> torch.Tensor:
    return (t.view(torch.int32) & _HIGH16).view(torch.float32)


def _f32(x) -> bool:
    return isinstance(x, torch.Tensor) and x.dtype == torch.float32


class _RoundToBfloat16(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        if func._schema.is_mutable:
            # In place or out=: round the written tensors where they are.
            for x in (out if isinstance(out, (tuple, list)) else (out,)):
                if _f32(x):
                    x.copy_(_rounded(x))
            return out
        if isinstance(out, (tuple, list)):
            return type(out)(_rounded(x) if _f32(x) else x for x in out)
        return _rounded(out) if _f32(out) else out


@contextlib.contextmanager
def bfloat16():
    with _RoundToBfloat16():
        yield


def precision(dtype):
    """`bfloat16()` for torch.bfloat16, no change for torch.float32."""
    if dtype == torch.float32:
        return contextlib.nullcontext()
    if dtype == torch.bfloat16:
        return bfloat16()
    raise ValueError(f"no control in {dtype}")
