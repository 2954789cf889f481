"""The frozen yardstick of the fused loop's roofline share.

The work is counted from the penalties, each pair's lengths and its optimal
score alone, never from what an implementation did (its band, rungs,
builds, launches or choice record), so a later change to the program cannot
move it.

Cells: exact WFA computes, at every score up to the pair's optimum that
carries a wavefront, one range of diagonals for all its components. The
ranges follow from the penalties (Marco-Sola et al., Bioinformatics 2021;
WFA2-lib's `wavefront_compute_limits_input`): at score s the union of the
range at s - x, the range at s - o - e widened by one diagonal each side,
and, where gap wavefronts exist at s - e, that range widened by one; then
clipped to the pair's matrix, [-len(pattern), len(text)]. A cell is one
diagonal of one score; its operations cover every component of the metric.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s, and 67 T 32-bit
# operations/s outside the tensor cores (at the card's 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# integer operations of one cell of one score step, by the metric's
# components (1: edit, indel, gap-linear; 3: gap-affine; 5: gap-affine
# 2-piece), counted from the fused loop's CUDA source at the end of the
# bring-up: extension, termination test, candidates, priority maximum,
# bounds, band, trim
OPS_PER_CELL = {1: 60, 3: 110, 5: 170}
# bytes a pair's results take when written once: status, score, end
# diagonal and end offset as 32-bit words; a full-scope answer adds its
# operations at 4 bits each, of which there are at least max(lengths)
RESULT_META_BYTES = 16
OP_BITS = 4


@lru_cache(maxsize=16)
def score_ranges(x: int, o: int, e: int, max_score: int) -> tuple:
    """(carries bool [S+1], lo int64 [S+1], hi int64 [S+1]) for scores
    0..max_score, unclipped: which scores carry a wavefront and its range of
    diagonals. Clipping to a pair's matrix commutes with the recurrence."""
    S = max_score + 1
    carries = np.zeros(S, dtype=bool)
    gaps = np.zeros(S, dtype=bool)
    lo = np.zeros(S, dtype=np.int64)
    hi = np.zeros(S, dtype=np.int64)
    carries[0] = True
    for s in range(1, S):
        cand = []
        if s - x >= 0 and carries[s - x]:
            cand.append((lo[s - x], hi[s - x]))
        opened = s - o - e >= 0 and carries[s - o - e]
        if opened:
            cand.append((lo[s - o - e] - 1, hi[s - o - e] + 1))
        extended = s - e >= 0 and gaps[s - e]
        if extended:
            cand.append((lo[s - e] - 1, hi[s - e] + 1))
        if cand:
            carries[s] = True
            gaps[s] = opened or extended
            lo[s] = min(c[0] for c in cand)
            hi[s] = max(c[1] for c in cand)
    return carries, lo, hi


def cells(x: int, o: int, e: int, costs, plens, tlens) -> np.ndarray:
    """The (score, diagonal) cells exact WFA computes for each pair, from
    its optimal cost (minus pywfa's score) and its lengths."""
    costs = np.asarray(costs, dtype=np.int64)
    plens = np.asarray(plens, dtype=np.int64)
    tlens = np.asarray(tlens, dtype=np.int64)
    out = np.zeros(costs.shape, dtype=np.int64)
    if costs.size == 0:
        return out
    carries, lo, hi = score_ranges(x, o, e, int(costs.max()))
    s_idx = np.flatnonzero(carries)
    # pairs of one cost share the scores they sum over
    for cost in np.unique(costs):
        sel = costs == cost
        ss = s_idx[s_idx <= cost]
        w = (np.minimum(hi[ss][None, :], tlens[sel][:, None])
             - np.maximum(lo[ss][None, :], -plens[sel][:, None]) + 1)
        out[sel] = np.clip(w, 0, None).sum(axis=1)
    return out


def work(x: int, o: int, e: int, components: int, full_scope: bool,
         costs, plens, tlens) -> tuple:
    """(operations, bytes) of aligning the pairs: every cell's operations;
    the 2-bit sequences read once and the results written once."""
    plens = np.asarray(plens, dtype=np.int64)
    tlens = np.asarray(tlens, dtype=np.int64)
    n_ops = int(cells(x, o, e, costs, plens, tlens).sum()) * \
        OPS_PER_CELL[components]
    nbytes = int(((plens + 3) // 4 + (tlens + 3) // 4).sum())
    nbytes += RESULT_META_BYTES * plens.size
    if full_scope:
        nbytes += int(((np.maximum(plens, tlens) * OP_BITS + 7) // 8).sum())
    return n_ops, nbytes


def share(n_ops: int, n_bytes: int, device_s: float) -> tuple:
    """(percent, bound): the least time the card could take over the
    measured device time, and which of operations or bytes bounds it."""
    t_ops = n_ops / PEAK_OPS_PER_S
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    bound = "operations" if t_ops >= t_bytes else "bytes"
    return 100.0 * max(t_ops, t_bytes) / device_s, bound
