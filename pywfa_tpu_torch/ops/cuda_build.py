"""Build and bind the hand-written CUDA kernels.

`nvcc` compiles `csrc/fused_loop.cu` into a shared library with a plain C
interface, loaded with ctypes. The library lands in `build/pywfa_tpu_torch/`
at the repository root, named by the hash of its source and flags, so it is
built at first use and again whenever the source changes; deleting that
directory forces a rebuild. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "fused_loop.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pywfa_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
# (seconds, compiler output) of the build this process ran, if any
last_build: Optional[tuple] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path() -> str:
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libfused_loop_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernel library unless it is already built; returns its
    path. Raises RuntimeError with the compiler's output on failure."""
    global last_build
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stdout}"
                               f"{r.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    last_build = (time.perf_counter() - t0, r.stdout + r.stderr)
    return path


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.wfa_fused_loop.argtypes = ([vp] * 6 + [ctypes.POINTER(ci)]
                                       + [ci] * 14
                                       + [ctypes.POINTER(ci), ci, vp])
        lib.wfa_fused_loop.restype = ci
        lib.wfa_cuda_error_string.argtypes = [ci]
        lib.wfa_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def error_string(err: int) -> str:
    return f"{err} ({load().wfa_cuda_error_string(err).decode()})"
