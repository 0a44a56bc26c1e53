# The port's own copy of rgk_tpu/native/obj_native.py, building into
# rgk_tpu_torch/build/.
"""ctypes bridge to the native OBJ tokenizer (obj_loader.cpp).

Compiles the shared library on first use (`native.build`, into
rgk_tpu_torch/build/); returns None-equivalent failure so io/obj.py
can fall back to the pure Python tokenizer (the test oracle)."""

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
    so = build("obj_loader.cpp", "obj")
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.rgk_obj_load.restype = ctypes.c_void_p
    lib.rgk_obj_load.argtypes = [ctypes.c_char_p]
    lib.rgk_obj_counts.restype = None
    lib.rgk_obj_counts.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.rgk_obj_fill.restype = None
    lib.rgk_obj_fill.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_char_p]
    lib.rgk_obj_free.restype = None
    lib.rgk_obj_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def tokenize_obj(path: str):
    """Native tokenize: returns (positions [nv,3], uvs [nt,2],
    normals [nn,3], corners [nf,3,3], group [nf], group_names list,
    mtllib list) or raises RuntimeError when the library is
    unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native OBJ library unavailable")
    h = lib.rgk_obj_load(path.encode())
    if not h:
        raise RuntimeError(f"native OBJ load failed for {path}")
    try:
        counts = (ctypes.c_int64 * 8)()
        lib.rgk_obj_counts(h, counts)
        nv, nt, nn, nf, ng, gb, mb = [int(counts[i]) for i in range(7)]
        pos = np.empty((nv, 3), np.float32)
        uv = np.empty((nt, 2), np.float32)
        nrm = np.empty((nn, 3), np.float32)
        corners = np.empty((nf, 3, 3), np.int32)
        group = np.empty((nf,), np.int32)
        group_blob = ctypes.create_string_buffer(gb + 1)
        mtllib_blob = ctypes.create_string_buffer(mb + 1)
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        lib.rgk_obj_fill(h, pos.ctypes.data_as(fp), uv.ctypes.data_as(fp),
                         nrm.ctypes.data_as(fp),
                         corners.ctypes.data_as(ip),
                         group.ctypes.data_as(ip), group_blob, mtllib_blob)
        group_names = (group_blob.raw[:gb].decode(errors="replace")
                       .split("\n") if gb else [])
        if len(group_names) < ng:
            # A solitary unnamed group ("") produces an empty blob;
            # pad so ids keep a name slot.
            group_names += [""] * (ng - len(group_names))
        mtllibs = (mtllib_blob.raw[:mb].decode(errors="replace")
                   .split("\n") if mb else [])
        return pos, uv, nrm, corners, group, group_names, mtllibs
    finally:
        lib.rgk_obj_free(h)
