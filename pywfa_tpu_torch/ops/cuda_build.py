"""Build and bind the hand-written CUDA kernels.

`nvcc` compiles each source of `csrc/` (`fused_loop.cu`, `lcp_table.cu`,
`walk.cu`) into a shared library of its own with a plain C interface,
loaded with ctypes. The libraries land in `build/pywfa_tpu_torch/` at the
repository root, each named by the hash of its source and flags, so they
are built at first use and again whenever a source changes; deleting that
directory forces a rebuild. The first use of any kernel builds every
source that is not built yet, one `nvcc` a source, all started together.
Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {name: os.path.join(_PKG, "csrc", name + ".cu")
           for name in ("fused_loop", "lcp_table", "walk")}
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pywfa_tpu_torch")
# --split-compile=0: the fused loop's instantiations are optimised on every
# host core at once instead of one after another
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--split-compile=0",
              "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, compiler output) of the builds this process ran
last_build: Dict[str, tuple] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str = "fused_loop") -> str:
    with open(SOURCES[name], "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"lib{name}_{digest.hexdigest()[:16]}.so")


def build() -> Dict[str, str]:
    """Compile every kernel library that is not built yet, side by side;
    returns each library's path by name. Raises RuntimeError with the
    compiler's output on failure."""
    paths = {name: library_path(name) for name in SOURCES}
    todo = [name for name, path in paths.items() if not os.path.exists(path)]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs, tmps = {}, {}
    try:
        for name in todo:
            fd, tmps[name] = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            procs[name] = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmps[name], SOURCES[name]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        failed = []
        for name, proc in procs.items():
            out, _ = proc.communicate(timeout=600)
            last_build[name] = (time.perf_counter() - t0, out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {name}.cu "
                              f"({proc.returncode}):\n{out}")
            else:
                os.replace(tmps[name], paths[name])
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for tmp in tmps.values():
            if os.path.exists(tmp):
                os.unlink(tmp)
    return paths


def load(name: str = "fused_loop") -> ctypes.CDLL:
    """The bound kernel library `name`, built on first use."""
    if name not in _libs:
        lib = ctypes.CDLL(build()[name])
        vp, ci = ctypes.c_void_p, ctypes.c_int
        ints = ctypes.POINTER(ci)
        if name == "fused_loop":
            lib.wfa_fused_loop.argtypes = (
                [vp, vp, ci, ci, vp, vp] + [ci] * 4 + [vp] * 8 + [ci] * 6
                + [ints] + [ci] * 14
                + [ints, ci, vp])
            lib.wfa_fused_loop.restype = ci
            lib.wfa_fused_loop_active_clusters.argtypes = []
            lib.wfa_fused_loop_active_clusters.restype = ci
        elif name == "lcp_table":
            lib.wfa_lcp_table.argtypes = [vp] * 3 + [ci] * 11 + [vp]
            lib.wfa_lcp_table.restype = ci
        else:
            lib.wfa_walk.argtypes = ([vp] * 3 + [ci] + [vp] * 12 + [ci] * 6
                                     + [vp])
            lib.wfa_walk.restype = ci
        lib.wfa_cuda_error_string.argtypes = [ci]
        lib.wfa_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def error_string(err: int, name: str = "fused_loop") -> str:
    return f"{err} ({load(name).wfa_cuda_error_string(err).decode()})"
