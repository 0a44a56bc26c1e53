"""Build the port's CUDA kernels at first use and load them.

`load()` compiles every `csrc/*.cu` of the package with `nvcc` into one
shared library with a plain C interface, under `rgk_tpu_torch/build/`,
and loads it with ctypes.  Each source compiles to an object in its own
nvcc process, all started together, and one more nvcc links them.  The
library is named by a hash of the sources and the headers they include
(`csrc/*.cuh`), the flags and the compiler, so an edited source or
header rebuilds and an unchanged tree loads from the cache.
A failed build raises with nvcc's output.  Nothing is built or loaded
at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import time
from functools import lru_cache

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


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _headers():
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256()
    for src in _sources() + _headers():
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
    path = library_path()
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
    for src in _sources():
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


@lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The built library, with the argument types of its entry points."""
    lib = ctypes.CDLL(build()["path"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rgk_flat_intersect.argtypes = [p, i, p, p, p, p, p, i, p, p, p, p,
                                       i, p]
    lib.rgk_flat_intersect.restype = i
    lib.rgk_cluster_intersect.argtypes = [p, p, p, i, i, p, i, p, p, p, p,
                                          p, p, p, i, p, p, p, p, i, p]
    lib.rgk_cluster_intersect.restype = i
    lib.rgk_binned_walk.argtypes = [p, p, p, i, i, p, p, p, p, p, p, i, i,
                                    p, p, p, p, p]
    lib.rgk_binned_walk.restype = i
    lib.rgk_binned_sweep.argtypes = [p, p, ctypes.c_longlong, i, p, i, i, p,
                                     p, p, p, p, p, p, p]
    lib.rgk_binned_sweep.restype = i
    lib.rgk_cuda_error_string.argtypes = [i]
    lib.rgk_cuda_error_string.restype = ctypes.c_char_p
    lib.rgk_device_smem_optin.argtypes = [i]
    lib.rgk_probe_smem.argtypes = [p, p, i, p]
    lib.rgk_probe_unpack.argtypes = [p, p, p, p]
    lib.rgk_probe_row_copy.argtypes = [p, i, i, p, p]
    lib.rgk_probe_sync.argtypes = [i, p, p, i, ctypes.c_float, p, p, p]
    lib.rgk_probe_fetch.argtypes = [p, i, i, i, ctypes.c_float, p, p]
    for fn in (lib.rgk_device_smem_optin, lib.rgk_probe_smem,
               lib.rgk_probe_unpack, lib.rgk_probe_row_copy,
               lib.rgk_probe_sync, lib.rgk_probe_fetch):
        fn.restype = i
    return lib


def check_launch(rc: int, what: str) -> None:
    """Raises unless an entry point returned 0 (cudaSuccess), naming
    the CUDA error."""
    if rc != 0:
        msg = load().rgk_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc} "
                           f"({msg})")
