# The port's own copy of rgk_tpu/utils/log.py, kept equal to it.
"""Leveled console logger.

Mirrors the reference's verbosity-gated stream logger (reference
src/out.hpp:6-34): messages carry a level, and anything above the global
verbosity threshold (default 2) is discarded.  ``-v``/``-q`` CLI flags
adjust the threshold.
"""

from __future__ import annotations

import sys

_verbosity = 2


def set_verbosity(level: int) -> None:
    global _verbosity
    _verbosity = level


def get_verbosity() -> int:
    return _verbosity


def log(level: int, *args, **kwargs) -> None:
    """Print to stdout if `level` <= current verbosity."""
    if level <= _verbosity:
        print(*args, **kwargs)
        sys.stdout.flush()


def err(level: int, *args, **kwargs) -> None:
    """Print to stderr if `level` <= current verbosity."""
    if level <= _verbosity:
        print(*args, file=sys.stderr, **kwargs)
        sys.stderr.flush()
