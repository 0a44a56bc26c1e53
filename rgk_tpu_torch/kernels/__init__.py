"""Build the port's CUDA kernels at first use and load them.

`load()` compiles every `csrc/*.cu` of the package with `nvcc` into one
shared library with a plain C interface, under `rgk_tpu_torch/build/`,
and loads it with ctypes.  Each source compiles to an object in its own
nvcc process, all started together, and one more nvcc links them.  The
library is named by a hash of the sources and the headers they include
(`csrc/*.cuh`), the flags and the compiler, so an edited source or
header rebuilds and an unchanged tree loads from the cache.
A failed build raises with nvcc's output.  Nothing is built or loaded
at import time.  The first `load()` of a process is the span
`kernels.load` (`utils/trace.py`), with attributes `built` (whether nvcc
ran) and `nvcc_s` (its seconds).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
import time
from functools import lru_cache

from ..utils import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "port's kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _sources(csrc):
    srcs = sorted(glob.glob(os.path.join(csrc, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {csrc}")
    return srcs


def _headers(csrc):
    return sorted(glob.glob(os.path.join(csrc, "*.cuh")))


def library_path() -> str:
    """Where the library for the current sources, headers and flags
    lives."""
    return _library_path(CSRC)


def _library_path(csrc):
    h = hashlib.sha256()
    for src in _sources(csrc) + _headers(csrc):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    h.update(_nvcc().encode())
    return os.path.join(BUILD_DIR, f"librgk_kernels_{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile the library if it is not cached.  Returns the path, the
    build seconds (0.0 when cached) and nvcc's output (ptxas resource
    usage), which is also kept beside the library as a .log."""
    return _build_from(CSRC)


def _build_from(csrc):
    """`build()` for the sources under another directory with the same
    entry points (an earlier version's, to time the two in one process)."""
    path = _library_path(csrc)
    log_path = path[:-3] + ".log"
    if os.path.exists(path):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return {"path": path, "seconds": 0.0, "log": log}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources(csrc):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    link = [nvcc, *LINK_FLAGS, "-o", tmp, *objs]
    logs, failed = [], []
    for cmd, proc in procs:
        logs.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} -> {proc.returncode}")
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"{' '.join(link)} -> {proc.returncode}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed) + "\n"
                           + log)
    os.replace(tmp, path)
    with open(log_path, "w") as f:
        f.write(log)
    return {"path": path, "seconds": seconds, "log": log}


_LOAD_LOCK = threading.Lock()


def load() -> ctypes.CDLL:
    """The built library, with the argument types of its entry points.
    Built and opened once per process, whichever thread asks first (the
    threads of a device mesh launch concurrently)."""
    with _LOAD_LOCK:
        return _load()


@lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    with trace.span("kernels.load") as sp:
        got = build()
        sp.attrs.update(built=got["seconds"] > 0, nvcc_s=got["seconds"])
        return _open(got["path"])


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# Each entry point's (argument types, result type).  A library built from
# an earlier tree (chip_smoke.py --parent) lacks the newer entries.
_SIGNATURES = {
    "rgk_flat_intersect": ([_P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                            _I, _P, _P, _P], _I),
    "rgk_cluster_intersect": ([_P, _P, _P, _I, _I, _P, _I, _P, _P, _P, _P,
                               _P, _P, _P, _I, _P, _P, _P, _P, _I, _P], _I),
    "rgk_binned_walk": ([_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                         _P, _P, _P, _P, _P], _I),
    "rgk_binned_sweep": ([_P, _P, _LL, _I, _P, _I, _I, _P, _P, _P, _P, _P,
                          _P, _P, _P], _I),
    "rgk_take_rows": ([_P, _I, _I, _P, _I, _P, _P], _I),
    "rgk_take_rows_partials": ([_I], _I),
    "rgk_take_rows_backward_smem": ([_I, _I], _LL),
    "rgk_take_rows_backward": ([_P, _P, _I, _I, _I, _P, _P, _P], _I),
    "rgk_sampler_hash": ([_P, _I, _LL, _P, _P], _I),
    "rgk_sampler_sample": ([_P, _LL, _P, _P], _I),
    "rgk_bxdf_eval": ([_P, _P], _I),
    "rgk_bxdf_sample": ([_P, _P], _I),
    "rgk_bxdf_eval_bwd": ([_P, _P], _I),
    "rgk_bxdf_sample_bwd": ([_P, _P], _I),
    "rgk_while_graph_error": ([], ctypes.c_char_p),
    "rgk_cuda_driver_version": ([_P], _I),
    "rgk_graph_check": ([_P, ctypes.c_char_p, _P], _I),
    "rgk_while_graph_create": ([_P, _P, _P, _P, _I, _P, _P, _P], _I),
    "rgk_while_graph_launch": ([_P, _P], _I),
    "rgk_while_graph_destroy": ([_P], _I),
    "rgk_stamp": ([_P, _I, _I, _P], _I),
    "rgk_cuda_error_string": ([_I], ctypes.c_char_p),
    "rgk_device_smem_optin": ([_I], _I),
    "rgk_probe_smem": ([_P, _P, _I, _P], _I),
    "rgk_probe_unpack": ([_P, _P, _P, _P], _I),
    "rgk_probe_row_copy": ([_P, _I, _I, _P, _P], _I),
    "rgk_probe_sync": ([_I, _P, _P, _I, ctypes.c_float, _P, _P, _P], _I),
    "rgk_probe_fetch": ([_P, _I, _I, _I, ctypes.c_float, _P, _P], _I),
}


def _open(path):
    """The library at `path`, with the argument types of each entry point
    it exports."""
    lib = ctypes.CDLL(path)
    for name, (args, res) in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
    return lib


def check_launch(rc: int, what: str) -> None:
    """Raises unless an entry point returned 0 (cudaSuccess), naming
    the CUDA error."""
    if rc != 0:
        msg = load().rgk_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc} "
                           f"({msg})")
