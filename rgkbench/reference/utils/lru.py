# The port's own copy of rgk_tpu/utils/lru.py, kept equal to it.
"""O(1) LRU cache (parity with reference src/LRU.hpp:11-39 — an
unused-but-compiled utility there; here it backs optional caching of
decoded textures across SceneBuilder instances)."""

from __future__ import annotations

from collections import OrderedDict
from typing import Generic, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class LRU(Generic[K, V]):
    """Fixed-capacity least-recently-used map."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("LRU capacity must be positive")
        self.capacity = capacity
        self._d: "OrderedDict[K, V]" = OrderedDict()

    def get(self, key: K, default=None):
        if key not in self._d:
            return default
        self._d.move_to_end(key)
        return self._d[key]

    def put(self, key: K, value: V) -> None:
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = value
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def __contains__(self, key: K) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)
