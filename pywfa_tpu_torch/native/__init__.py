"""ctypes bindings for the native post-processing library.

The port's own copy of `pywfa_tpu/native/`: `wfa_native.cpp` beside this
file, compiled with g++ at first use into `build/pywfa_tpu_torch/` at the
repository root. The library is named by the hash of its source, its flags
and the host CPU's feature flags (it is built with -march=native), so an
edited source, or a tree copied to another machine, rebuilds by itself.
All callers must handle `lib() is None` (pure-Python fallback paths exist).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "wfa_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "pywfa_tpu_torch")
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-Wall", "-pthread"]
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cpu_fingerprint() -> str:
    """What -march=native resolves to on this host: the machine type plus
    the CPU feature flags the kernel reports."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    flags = line
                    break
    except OSError:
        pass
    return platform.machine() + flags


def library_path() -> str:
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(CXXFLAGS).encode()
                                + _cpu_fingerprint().encode())
    return os.path.join(BUILD_DIR,
                        f"libwfa_native_{digest.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS, "-o",
                            tmp, SOURCE], check=True, capture_output=True,
                           timeout=120)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return True
    except Exception:
        return False


def lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    path = library_path()
    if not os.path.exists(path) and not _build(path):
        return None
    try:
        L = ctypes.CDLL(path)
    except OSError:
        return None
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    if not hasattr(L, "wfa_abi_version"):
        return None  # stale .so predating the ABI version sentinel
    L.wfa_abi_version.restype = ctypes.c_int64
    L.wfa_abi_version.argtypes = []
    if L.wfa_abi_version() != 3:
        return None  # stale .so with a different exported-signature set
    L.wfa_encode_pack_batch.argtypes = [
        c_u8p, c_i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint8,
        c_u8p, c_u8p, ctypes.c_int64,
    ]
    L.wfa_encode_pack_batch.restype = ctypes.c_int64
    L.wfa_match_fill_batch.argtypes = [
        c_u8p, ctypes.c_int64, c_i64p, c_i64p,
        c_u8p, ctypes.c_int64, c_i64p,
        c_u8p, ctypes.c_int64, c_i64p,
        c_i64p, c_i64p, c_i64p,
        ctypes.c_int32, ctypes.c_int64,
        c_u8p, ctypes.c_int64, c_i64p,
    ]
    L.wfa_match_fill_batch.restype = None
    L.wfa_rle.argtypes = [c_u8p, ctypes.c_int64, c_i32p, c_i32p,
                          ctypes.c_int64]
    L.wfa_rle.restype = ctypes.c_int64
    L.wfa_pack2_batch.argtypes = [c_u8p, ctypes.c_int64, ctypes.c_int64,
                                  c_i64p, c_u8p, ctypes.c_int64]
    L.wfa_pack2_batch.restype = ctypes.c_int64
    _lib = L
    return _lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def match_fill_batch(ops_fwd: np.ndarray, n_ops: np.ndarray,
                     k_start: np.ndarray, pat: np.ndarray, plens: np.ndarray,
                     txt: np.ndarray, tlens: np.ndarray,
                     trail_i: np.ndarray, trail_d: np.ndarray,
                     wildcard: int,
                     caps: Optional[np.ndarray] = None) -> Optional[tuple]:
    """Batched match-fill; returns (ascii_ops [B, Lmax], lens [B]) or None.

    Output rows are ASCII op chars (M/I/D/X). All array args must be
    C-contiguous with the documented dtypes: ops_fwd/pat/txt uint8 2-D;
    the rest int64 1-D. caps[b] >= 0 forces the pair's FINAL run to end
    exactly at that text offset (dropped-pair partial walks); -1/None =
    greedy (clean completions).
    """
    L = lib()
    if L is None:
        return None
    B = ops_fwd.shape[0]
    if caps is None:
        caps = np.full(B, -1, dtype=np.int64)
    out_stride = int(plens.max() + tlens.max() + 2) if B else 2
    out = np.empty((B, out_stride), dtype=np.uint8)
    out_lens = np.empty(B, dtype=np.int64)
    u8, i64 = ctypes.c_uint8, ctypes.c_int64
    L.wfa_match_fill_batch(
        _ptr(ops_fwd, u8), ops_fwd.shape[1],
        _ptr(n_ops, i64), _ptr(k_start, i64),
        _ptr(pat, u8), pat.shape[1], _ptr(plens, i64),
        _ptr(txt, u8), txt.shape[1], _ptr(tlens, i64),
        _ptr(trail_i, i64), _ptr(trail_d, i64),
        _ptr(np.ascontiguousarray(caps, dtype=np.int64), i64),
        wildcard, B,
        _ptr(out, u8), out_stride, _ptr(out_lens, i64))
    return out, out_lens


def rle(ops: np.ndarray):
    """RLE one uint8 op row -> (codes int32, lens int32) or None."""
    L = lib()
    if L is None:
        return None
    n = len(ops)
    cap = n + 1
    out_ops = np.empty(cap, dtype=np.int32)
    out_lens = np.empty(cap, dtype=np.int32)
    m = L.wfa_rle(_ptr(ops, ctypes.c_uint8), n,
                  _ptr(out_ops, ctypes.c_int32),
                  _ptr(out_lens, ctypes.c_int32), cap)
    if m < 0:
        return None
    return out_ops[:m], out_lens[:m]


def encode_pack_batch(flat: bytes, lens: np.ndarray, stride: int,
                      sentinel: int, pack: bool = True,
                      pack_width: int = 0):
    """Fused encode + 2-bit pack of concatenated sequences.

    pack_width > 0 packs only the leading pack_width columns (lens must
    all be <= pack_width); 0 packs the full stride.

    Returns (tokens [B, stride] int8, packed [B, ceil(width/4)] uint8 or
    None when pack failed/disabled), or None when the lib is unavailable.
    """
    L = lib()
    if L is None:
        return None
    B = len(lens)
    lens64 = np.ascontiguousarray(lens, dtype=np.int64)
    tokens = np.empty((B, stride), dtype=np.uint8)
    width = min(pack_width, stride) if pack_width > 0 else stride
    Wout = -(-width // 4) if pack else 0
    packed = np.empty((B, max(Wout, 1)), dtype=np.uint8)
    flat_a = np.frombuffer(flat, dtype=np.uint8)
    rc = L.wfa_encode_pack_batch(
        _ptr(flat_a, ctypes.c_uint8), _ptr(lens64, ctypes.c_int64),
        B, stride, sentinel,
        _ptr(tokens, ctypes.c_uint8), _ptr(packed, ctypes.c_uint8), Wout)
    return tokens.view(np.int8), (packed if (pack and rc == 0) else None)


def pack2_batch(mat: np.ndarray, lens: np.ndarray,
                width: Optional[int] = None) -> Optional[np.ndarray]:
    """Fused 2-bit pack of a [B, Wm] int8/uint8 token matrix (leading
    `width` columns; lens must be <= width).

    Returns [B, ceil(width/4)] uint8, or None when the lib is unavailable
    OR any in-length byte is not uppercase ACGT (caller falls back).
    """
    L = lib()
    if L is None:
        return None
    B, Wm = mat.shape
    Wout = -(-(min(width, Wm) if width is not None else Wm) // 4)
    out = np.empty((B, Wout), dtype=np.uint8)
    rc = L.wfa_pack2_batch(
        _ptr(mat.view(np.uint8), ctypes.c_uint8), B, Wm,
        _ptr(np.ascontiguousarray(lens, dtype=np.int64), ctypes.c_int64),
        _ptr(out, ctypes.c_uint8), Wout)
    if rc != 0:
        return None
    return out
