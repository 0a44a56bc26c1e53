"""The port's native C++ host helpers: the binned-SAH BVH builder
(`bvh_builder.cpp`, bridge `bvh_native.py`) and the OBJ tokenizer
(`obj_loader.cpp`, bridge `obj_native.py`), copies of the reference's
`rgk_tpu/native/`.

`build(source, name)` compiles a source at first use, never at import,
with the first C++ compiler that works and the reference's flags (so the
BVH arrays stay bit-equal to the reference's), into
`rgk_tpu_torch/build/`.  The library is named by a hash of the source,
the flags, the compiler and what the compiler makes of `-march=native`
on this host (its predefined macros), so a tree copied to another
machine rebuilds instead of loading a library built for another CPU.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
COMPILERS = ("c++", "g++", "clang++")


def _target(cxx: str) -> str:
    """The compiler's predefined macros under CXX_FLAGS: its version and
    the instruction set `-march=native` selects here."""
    proc = subprocess.run([cxx, *CXX_FLAGS[:2], "-E", "-dM", "-x", "c++",
                           "-"], input="", capture_output=True, text=True,
                          timeout=60)
    if proc.returncode != 0:
        raise OSError(proc.stderr)
    return proc.stdout


def library_path(source: str, name: str, cxx: str) -> str:
    """Where the library of `source` built by `cxx` for this host lives."""
    h = hashlib.sha256()
    with open(os.path.join(_HERE, source), "rb") as f:
        h.update(f.read())
    for part in (" ".join(CXX_FLAGS), cxx, _target(cxx)):
        h.update(part.encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(source: str, name: str):
    """-> the path of the built library, or None when no compiler builds
    it here."""
    for cxx in COMPILERS:
        exe = shutil.which(cxx)
        if exe is None:
            continue
        try:
            path = library_path(source, name, exe)
        except (OSError, subprocess.SubprocessError):
            continue
        if os.path.exists(path):
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run(
                [exe, *CXX_FLAGS, os.path.join(_HERE, source), "-o", tmp],
                capture_output=True, timeout=120)
        except subprocess.SubprocessError:
            continue
        if proc.returncode == 0:
            os.replace(tmp, path)
            return path
        if os.path.exists(tmp):
            os.remove(tmp)
    return None
