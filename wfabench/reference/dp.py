"""Optimal end-to-end gap-affine cost by dynamic programming (Gotoh).

Costs: a mismatch `x`, a gap of length L `o + e * L` (WFA2-lib's and
pywfa's convention: gap_opening + gap_extension per base), a match 0. The
pair's pywfa score is minus this cost.

One row of the pattern at a time, over every pair and every text column at
once: the vertical gap and the diagonal come from the row above, the
horizontal gap is a prefix minimum along the row. Integer arithmetic, so
the device and the block size change nothing.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

INF = 1 << 29


def pad_bytes(seqs: Sequence[bytes], fill: int) -> tuple:
    """(uint8 [n, max_len] rows padded with `fill`, int64 lengths [n])."""
    lens = np.fromiter(map(len, seqs), dtype=np.int64, count=len(seqs))
    width = max(int(lens.max()) if len(seqs) else 0, 1)
    out = np.full((len(seqs), width), fill, dtype=np.uint8)
    flat = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    rows = np.repeat(np.arange(len(seqs)), lens)
    starts = np.cumsum(lens) - lens
    cols = np.arange(flat.size) - np.repeat(starts, lens)
    out[rows, cols] = flat
    return out, lens


def affine_costs(patterns: Sequence[bytes], texts: Sequence[bytes],
                 x: int, o: int, e: int, device="cpu",
                 block_cells: int = 1 << 26,
                 dtype: torch.dtype = torch.int32) -> np.ndarray:
    """The optimal end-to-end cost of each pair, int64 [n]; pairs run in
    blocks of about `block_cells` DP cells of one row. `dtype` is the type
    every DP cell is held and added in (two's-complement wrap past its
    range): int32 is exact at any length this benchmark makes; a narrower
    one is the control's lower precision."""
    n = len(patterns)
    out = np.empty(n, dtype=np.int64)
    if n == 0:
        return out
    tl = np.fromiter(map(len, texts), dtype=np.int64, count=n)
    # similar text lengths side by side keep the padding small
    order = np.argsort(tl, kind="stable")
    i = 0
    while i < n:
        j = i + 1
        while j < n and (j - i + 1) * (int(tl[order[j]]) + 1) <= block_cells:
            j += 1
        idx = order[i:j]
        out[idx] = _block([patterns[t] for t in idx], [texts[t] for t in idx],
                          x, o, e, device, dtype)
        i = j
    return out


def _block(patterns, texts, x, o, e, device, dtype) -> np.ndarray:
    dev = torch.device(device)
    inf = min(INF, torch.iinfo(dtype).max)
    pat, plen = pad_bytes(patterns, 255)
    txt, tlen = pad_bytes(texts, 254)
    n, T = txt.shape
    P = torch.from_numpy(pat).to(dev)
    Tx = torch.from_numpy(txt).to(dev)
    plen_t = torch.from_numpy(plen).to(dev)
    tlen_t = torch.from_numpy(tlen).to(dev)
    j = torch.arange(T + 1, device=dev, dtype=torch.int32).to(dtype)
    # row 0: a leading horizontal gap of j bases
    H = (o + e * j).expand(n, T + 1).clone()
    H[:, 0] = 0
    F = torch.full((n, T + 1), inf, dtype=dtype, device=dev)
    best = torch.zeros(n, dtype=dtype, device=dev)
    ej = (e * j)[None, :]
    ends = set(plen.tolist())
    for i in range(1, int(plen.max()) + 1):
        # vertical gap: a pattern base against nothing (a deletion)
        F = torch.minimum(H + (o + e), F + e)
        sub = torch.where(P[:, i - 1:i] == Tx, 0, x).to(dtype)
        H0 = F.clone()
        H0[:, 1:] = torch.minimum(H[:, :-1] + sub, F[:, 1:])
        # horizontal gap: E[j] = min over j' < j of H0[j'] + o + e (j - j')
        run = torch.cummin(H0 - ej, dim=1).values
        E = torch.full_like(H0, inf)
        E[:, 1:] = run[:, :-1] + o + ej[:, 1:]
        H = torch.minimum(H0, E)
        if i in ends:
            best = torch.where(plen_t == i, H.gather(1, tlen_t[:, None])[:, 0],
                               best)
    # an empty pattern: one gap over the whole text
    best = torch.where(plen_t == 0, (o + e * tlen_t).to(dtype), best)
    best = torch.where((plen_t == 0) & (tlen_t == 0), 0, best)
    return best.cpu().numpy().astype(np.int64)
