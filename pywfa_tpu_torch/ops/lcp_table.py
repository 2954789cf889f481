"""The per-diagonal run-length table, h-major.

The twin of `pywfa_tpu/ops/pallas/lcp_table.py`. R[h, b, w] is the number
of consecutive matches along diagonal k = kmin + w starting at text
position h (pattern[h - k + j] against text[h + j]). Both rows are padded
with distinct sentinels and a pattern index outside the row reads the
pattern's sentinel, so a run ends at either sequence's end by itself. With
the table, the fused score loop extends a cell with one load,
`off += R[off, b, w]` (`fused_loop.align_batch_fused_loop(..., table=R)`).

`build_lcp_table_hmajor` is the entry point. On CUDA tensors it launches
the hand-written kernel in `csrc/lcp_table.cu`; on CPU tensors it runs
`build_lcp_table_hmajor_ref`, the plain torch version (a reverse running
minimum over the mismatch positions, as the reference's XLA version).

Match classes never come here: the kernel compares raw tokens, and the
callers route a class-matching config to the equality bits instead, as
the reference does.
"""
from __future__ import annotations

import torch

from .config import PATTERN_PAD, TEXT_PAD

# kernel launches made by build_lcp_table_hmajor (plain version excluded)
launches = {"lcp_table": 0}

# the text rows the table is built for: beyond this the runs would pass
# int16 and the table [Ltp, B, W] the memory it is worth
MAX_LTP = 2048


def supported(Ltp: int) -> bool:
    return 0 < Ltp <= MAX_LTP


def table_dtype(Ltp: int) -> torch.dtype:
    """uint8 while every run fits a byte, else int16 (the reference's
    rule)."""
    return torch.uint8 if Ltp < 250 else torch.int16


def _check(W, pat, txt):
    if pat.dim() != 2 or txt.dim() != 2 or pat.shape[0] != txt.shape[0]:
        raise ValueError(f"pat and txt must be [B, Lpp] and [B, Ltp], got "
                         f"{tuple(pat.shape)} and {tuple(txt.shape)}")
    if pat.dtype != torch.int8 or txt.dtype != torch.int8:
        raise TypeError(f"pat and txt must be int8, got {pat.dtype} and "
                        f"{txt.dtype}")
    if pat.device != txt.device:
        raise ValueError(f"pat is on {pat.device}, txt on {txt.device}")
    if not supported(txt.shape[1]):
        raise NotImplementedError(
            f"the run-length table is built for text rows up to {MAX_LTP}, "
            f"got {txt.shape[1]}; longer rows extend by the equality bits")
    if W <= 0:
        raise ValueError(f"W must be positive, got {W}")


def build_lcp_table_hmajor(W: int, kmin: int, wildcard: int, pat, txt
                           ) -> torch.Tensor:
    """[Ltp, B, W] run-length table from padded token rows.

    pat: [B, Lpp] int8 (PATTERN_PAD-padded), txt: [B, Ltp] int8
    (TEXT_PAD-padded); wildcard: a byte that matches any real character,
    or -1. uint8 when Ltp < 250, else int16."""
    _check(W, pat, txt)
    if pat.device.type == "cpu":
        return build_lcp_table_hmajor_ref(W, kmin, wildcard, pat, txt)
    if pat.device.type != "cuda":
        raise ValueError(f"no run-length table for device {pat.device}")
    if not (pat.is_contiguous() and txt.is_contiguous()):
        raise ValueError("pat and txt must be contiguous")
    from . import cuda_build
    lib = cuda_build.load("lcp_table")
    B, Lpp = pat.shape
    Ltp = txt.shape[1]
    dt = table_dtype(Ltp)
    out = torch.empty((Ltp, B, W), dtype=dt, device=pat.device)
    with torch.cuda.device(pat.device):
        stream = torch.cuda.current_stream(pat.device).cuda_stream
        rc = lib.wfa_lcp_table(pat.data_ptr(), txt.data_ptr(),
                               out.data_ptr(), B, W, Lpp, Ltp, kmin,
                               wildcard, int(dt == torch.uint8), stream)
    if rc != 0:
        raise RuntimeError("run-length table kernel launch failed: "
                           + cuda_build.error_string(rc, "lcp_table"))
    launches["lcp_table"] += 1
    return out


def build_lcp_table_hmajor_ref(W: int, kmin: int, wildcard: int, pat, txt
                               ) -> torch.Tensor:
    """The plain torch version: the equality of every (diagonal, text
    position), then the distance to the next mismatch by a reverse running
    minimum. Runs on any device, in groups of pairs that bound the
    temporaries to about 2^27 elements."""
    B, Lpp = pat.shape
    Ltp = txt.shape[1]
    dev = pat.device
    dt = table_dtype(Ltp)
    out = torch.empty((Ltp, B, W), dtype=dt, device=dev)
    # pattern index of (w, h): h - (kmin + w); outside the row: the pad
    h = torch.arange(Ltp, device=dev)
    j = h[None, :] - (kmin + torch.arange(W, device=dev))[:, None]  # [W, Ltp]
    inside = (j >= 0) & (j < Lpp)
    jc = j.clamp(0, Lpp - 1)
    G = max(1, (1 << 27) // max(1, W * Ltp))
    for b0 in range(0, B, G):
        p = pat[b0:b0 + G]
        t = txt[b0:b0 + G][:, None, :]                          # [g, 1, Ltp]
        pv = torch.where(inside, p[:, jc], PATTERN_PAD)         # [g, W, Ltp]
        eq = pv == t
        if wildcard >= 0:
            eq = ((eq | (pv == wildcard) | (t == wildcard))
                  & (pv != PATTERN_PAD) & (t != TEXT_PAD))
        # the next mismatch at or after h, Ltp when there is none
        mism = torch.where(eq, Ltp, h.to(torch.int32))
        nxt = mism.flip(2).cummin(2).values.flip(2)
        out[:, b0:b0 + G] = (nxt - h).permute(2, 0, 1).to(dt)
    return out
