# The port's own copy of rgk_tpu/utils/format.py, kept equal to it.
"""Human-readable formatting helpers for progress reporting.

Equivalent functionality to the reference's string utilities
(reference src/utils.hpp:41-67, src/utils.cpp:168-182): thousands
separators, h/m/s time formatting, percentages, and a windowed low-pass
filter used to smooth ETA estimates.
"""

from __future__ import annotations

from collections import deque


def format_int_thousands(n: int) -> str:
    return f"{int(n):,}".replace(",", " ")


def format_time(seconds: float) -> str:
    seconds = max(0, int(seconds))
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    if h > 0:
        return f"{h}h {m:02d}m {s:02d}s"
    if m > 0:
        return f"{m}m {s:02d}s"
    return f"{s}s"


def format_percent(x: float) -> str:
    return f"{100.0 * x:5.1f}%"


class LowPass:
    """Windowed running mean, used to smooth noisy ETA estimates."""

    def __init__(self, window: int = 20):
        self.buffer: deque = deque(maxlen=window)

    def push(self, value: float) -> float:
        self.buffer.append(float(value))
        return sum(self.buffer) / len(self.buffer)
