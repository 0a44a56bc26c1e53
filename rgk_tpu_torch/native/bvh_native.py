# The port's own copy of rgk_tpu/native/bvh_native.py, building into
# rgk_tpu_torch/build/.
"""ctypes bridge to the native BVH builder (bvh_builder.cpp).

Compiles the shared library on first use (`native.build`, into
rgk_tpu_torch/build/); when no compiler builds it, scene/bvh.py falls
back to its numpy builder, which produces the identical layout and
reports itself as `SceneBuilder.sah_builder == "numpy"`.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import build

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = build("bvh_builder.cpp", "bvh")
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.rgk_build_bvh.restype = ctypes.c_int64
    lib.rgk_build_bvh.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # centroids
        ctypes.POINTER(ctypes.c_float),  # prim_min
        ctypes.POINTER(ctypes.c_float),  # prim_max
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),  # node_min
        ctypes.POINTER(ctypes.c_float),  # node_max
        ctypes.POINTER(ctypes.c_int64),  # first
        ctypes.POINTER(ctypes.c_int64),  # count
        ctypes.POINTER(ctypes.c_int64),  # skip
        ctypes.POINTER(ctypes.c_int64),  # order
    ]
    _LIB = lib
    return lib


def build_binned_sah(centroids, prim_min, prim_max, leaf_size):
    """Same return signature as scene/bvh._build_numpy, or raises
    RuntimeError if the native library is unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native BVH library unavailable")

    n = centroids.shape[0]
    c = np.ascontiguousarray(centroids, np.float32)
    lo = np.ascontiguousarray(prim_min, np.float32)
    hi = np.ascontiguousarray(prim_max, np.float32)
    max_nodes = max(1, 2 * n)
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    first = np.empty(max_nodes, np.int64)
    count = np.empty(max_nodes, np.int64)
    skip = np.empty(max_nodes, np.int64)
    order = np.empty(n, np.int64)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int64)
    n_nodes = lib.rgk_build_bvh(
        c.ctypes.data_as(fp), lo.ctypes.data_as(fp), hi.ctypes.data_as(fp),
        ctypes.c_int64(n), ctypes.c_int64(leaf_size),
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        first.ctypes.data_as(ip), count.ctypes.data_as(ip),
        skip.ctypes.data_as(ip), order.ctypes.data_as(ip))
    if n_nodes <= 0:
        raise RuntimeError("native BVH build failed")
    return (node_min[:n_nodes], node_max[:n_nodes], first[:n_nodes],
            count[:n_nodes], skip[:n_nodes], order)
