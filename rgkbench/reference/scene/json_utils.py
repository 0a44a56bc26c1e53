# The port's own copy of rgk_tpu/scene/json_utils.py, kept equal to it.
"""JSON config helpers: comment-tolerant parsing, typed getters,
*255-scaled color variants, and unused-key linting.

Parity target: the reference's jsonutils (reference src/jsonutils.cpp)
plus jsoncpp's comment support — the scene corpus uses ``//`` comments.
Vec3 getters accept either a 3-array or a scalar broadcast
(jsonutils.cpp JSONToVec3), and every ``<key>`` color getter also
accepts ``<key>255`` meaning value/255 (jsonutils.cpp *_255 variants).
Keys actually consumed are tracked so `find_unused` can warn about
typos after load (reference config.cpp PerformPostCheck).
"""

from __future__ import annotations

import json
import re
from typing import Any, List, Optional, Sequence

import numpy as np


class ConfigError(Exception):
    pass


def strip_json_comments(text: str) -> str:
    """Remove // and /* */ comments outside of string literals."""
    out = []
    i, n = 0, len(text)
    in_str = False
    while i < n:
        c = text[i]
        if in_str:
            out.append(c)
            if c == "\\" and i + 1 < n:
                out.append(text[i + 1])
                i += 2
                continue
            if c == '"':
                in_str = False
            i += 1
        elif c == '"':
            in_str = True
            out.append(c)
            i += 1
        elif c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
        elif c == "/" and i + 1 < n and text[i + 1] == "*":
            i += 2
            while i + 1 < n and not (text[i] == "*" and text[i + 1] == "/"):
                i += 1
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def loads_tolerant(text: str) -> Any:
    """Parse JSON with jsoncpp's leniencies used by the reference's
    scene corpus: comments, trailing commas, and numbers with leading
    zeros (e.g. `000.0` in scenes/conference.json)."""
    text = strip_json_comments(text)
    text = re.sub(r",(\s*[}\]])", r"\1", text)
    # Leading zeros: 000.0 -> 0.0, -007 -> -7 (only outside strings —
    # applied after a split that protects string literals).
    parts = re.split(r'("(?:[^"\\]|\\.)*")', text)
    for i in range(0, len(parts), 2):
        parts[i] = re.sub(r"(?<![\w.])(-?)0+(\d)", r"\1\2", parts[i])
    return json.loads("".join(parts))


class Node:
    """A JSON dict wrapper that tracks key usage and a semantic name."""

    def __init__(self, data: dict, name: str = "the config file",
                 used: Optional[set] = None):
        if not isinstance(data, dict):
            raise ConfigError(f"{name} must be a dictionary")
        self.data = data
        self.name = name
        self.used: set = used if used is not None else set()

    # -- raw access -------------------------------------------------
    def has(self, key: str) -> bool:
        return key in self.data

    def mark_used(self, key: str) -> None:
        self.used.add(key)

    def raw(self, key: str) -> Any:
        self.mark_used(key)
        return self.data[key]

    def child(self, key: str, name: str) -> "Node":
        self.mark_used(key)
        return Node(self.data[key], name)

    def child_list(self, key: str, name: str) -> List["Node"]:
        self.mark_used(key)
        v = self.data[key]
        if not isinstance(v, list):
            raise ConfigError(f'Value "{key}" in {self.name} must be an array.')
        return [Node(x, f"{name} {i}") for i, x in enumerate(v)]

    # -- typed getters ---------------------------------------------
    def req_str(self, key: str) -> str:
        if key not in self.data:
            raise ConfigError(f'Required value "{key}" is missing from {self.name}.')
        v = self.raw(key)
        if not isinstance(v, str):
            raise ConfigError(f'Required value "{key}" in {self.name} must be a string.')
        return v

    def req_int(self, key: str) -> int:
        if key not in self.data:
            raise ConfigError(f'Required value "{key}" is missing from {self.name}.')
        v = self.raw(key)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ConfigError(f'Required value "{key}" in {self.name} must be a number.')
        return int(v)

    def req_float(self, key: str) -> float:
        if key not in self.data:
            raise ConfigError(f'Required value "{key}" is missing from {self.name}.')
        v = self.raw(key)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ConfigError(f'Required value "{key}" in {self.name} must be a number.')
        return float(v)

    def _to_vec3(self, v: Any, key: str) -> np.ndarray:
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return np.full(3, float(v), np.float32)
        if isinstance(v, Sequence) and len(v) == 3 and all(
            isinstance(x, (int, float)) and not isinstance(x, bool) for x in v
        ):
            return np.asarray(v, np.float32)
        raise ConfigError(
            f'Value "{key}" in {self.name} must be an array of 3 numbers or a single number.'
        )

    def req_vec3(self, key: str) -> np.ndarray:
        if key not in self.data:
            raise ConfigError(f'Required value "{key}" is missing from {self.name}.')
        return self._to_vec3(self.raw(key), key)

    def req_vec3_255(self, key: str) -> np.ndarray:
        """Color getter: `<key>` as-is, or `<key>255` divided by 255."""
        if key in self.data:
            return self.req_vec3(key)
        if key + "255" in self.data:
            return self.req_vec3(key + "255") / 255.0
        raise ConfigError(f'Required value "{key}" is missing from {self.name}.')

    def opt_str(self, key: str, default: str = "") -> str:
        return self.req_str(key) if key in self.data else default

    def opt_int(self, key: str, default: int = 0) -> int:
        return self.req_int(key) if key in self.data else default

    def opt_float(self, key: str, default: float = 0.0) -> float:
        return self.req_float(key) if key in self.data else default

    def opt_bool(self, key: str, default: bool = False) -> bool:
        if key not in self.data:
            return default
        v = self.raw(key)
        if not isinstance(v, bool):
            raise ConfigError(f'Value "{key}" in {self.name} must be a boolean.')
        return v

    def opt_vec3(self, key: str, default) -> np.ndarray:
        if key not in self.data:
            return np.asarray(default, np.float32)
        return self.req_vec3(key)

    def opt_vec3_255(self, key: str, default) -> np.ndarray:
        if key in self.data or key + "255" in self.data:
            return self.req_vec3_255(key)
        return np.asarray(default, np.float32)

    def find_unused(self, prefix: str = "") -> List[str]:
        """Top-level keys never consumed — likely config typos."""
        return sorted(
            f"{prefix}{k}" for k in self.data.keys() if k not in self.used
        )
