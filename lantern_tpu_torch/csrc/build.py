"""Build-at-first-use for the port's native code.

CUDA sources (``csrc/*.cu``) are compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ctypes; the host HNSW
engine (``native/hnsw_engine.cpp``) goes through ``g++`` the same way. Each
library is keyed by a hash of its source and command line and built into
``lantern_tpu_torch/_build/`` (git-ignored), so a fresh checkout builds
everything from its own sources on the first call, and a rebuild happens only
when a source or a flag changes. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

CSRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(CSRC_DIR), "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def build_shared(src: str, cmd: list[str], name: str) -> str:
    """Compile ``src`` with ``cmd + ["-o", out, src]`` unless a library for
    the same source and command already exists; return its path. The
    compiler's output is kept beside the library as ``<lib>.log``. Raises
    RuntimeError with the compiler's messages when the build fails."""
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(cmd).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"lib{name}_{key}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    proc = subprocess.run(cmd + ["-o", tmp, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {os.path.basename(src)} failed ({cmd[0]}, rc "
            f"{proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    with open(f"{so}.log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, so)  # atomic: concurrent builds race harmlessly
    return so


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")


def library_path(name: str) -> str:
    """Path of the built library for ``csrc/<name>.cu`` (building it if
    needed); its compiler log, with ptxas's register and spill report, is
    the same path plus ``.log``."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    return build_shared(src, [find_nvcc()] + NVCC_FLAGS, name)


_cuda_libs: dict[str, ctypes.CDLL] = {}


def cuda_library(name: str) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu`` as a ctypes library, building it if needed."""
    if name not in _cuda_libs:
        _cuda_libs[name] = ctypes.CDLL(library_path(name))
    return _cuda_libs[name]
