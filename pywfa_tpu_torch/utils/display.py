"""Debug display tooling: dense DP score matrix for small pairs.

Analog of the reference's alignment/score_matrix.c + wavefront_display.c
(debug-only tooling, not on the alignment hot path): tabulates the optimal
score to every DP cell under the configured penalties and renders it, with
the traced alignment path marked.

A copy of `pywfa_tpu/utils/display.py`, which the port does not import.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..attributes import Penalties
from ..constants import DistanceMetric

INF = 10**9


def score_matrix(pattern: str, text: str, penalties: Penalties) -> np.ndarray:
    """[plen+1, tlen+1] matrix of minimal penalties (internal model)."""
    n, m = len(pattern), len(text)
    x = penalties.mismatch
    metric = penalties.distance_metric
    M = np.full((n + 1, m + 1), INF, dtype=np.int64)
    M[0, 0] = 0
    if metric in (DistanceMetric.INDEL, DistanceMetric.EDIT,
                  DistanceMetric.GAP_LINEAR):
        o = penalties.gap_opening1
        for i in range(n + 1):
            for j in range(m + 1):
                if i > 0:
                    M[i, j] = min(M[i, j], M[i - 1, j] + o)
                if j > 0:
                    M[i, j] = min(M[i, j], M[i, j - 1] + o)
                if i > 0 and j > 0:
                    sub = 0 if pattern[i - 1] == text[j - 1] else (
                        INF if metric == DistanceMetric.INDEL else x)
                    M[i, j] = min(M[i, j], M[i - 1, j - 1] + sub)
        return M
    o1, e1 = penalties.gap_opening1, penalties.gap_extension1
    two_p = metric == DistanceMetric.GAP_AFFINE_2P
    o2 = penalties.gap_opening2 if two_p else 0
    e2 = penalties.gap_extension2 if two_p else 0
    I1 = np.full((n + 1, m + 1), INF, dtype=np.int64)
    D1 = np.full((n + 1, m + 1), INF, dtype=np.int64)
    I2 = np.full((n + 1, m + 1), INF, dtype=np.int64)
    D2 = np.full((n + 1, m + 1), INF, dtype=np.int64)
    for i in range(n + 1):
        for j in range(m + 1):
            if i == 0 and j == 0:
                continue
            if j > 0:
                I1[i, j] = min(M[i, j - 1] + o1 + e1, I1[i, j - 1] + e1)
                if two_p:
                    I2[i, j] = min(M[i, j - 1] + o2 + e2, I2[i, j - 1] + e2)
            if i > 0:
                D1[i, j] = min(M[i - 1, j] + o1 + e1, D1[i - 1, j] + e1)
                if two_p:
                    D2[i, j] = min(M[i - 1, j] + o2 + e2, D2[i - 1, j] + e2)
            best = min(I1[i, j], D1[i, j], I2[i, j], D2[i, j])
            if i > 0 and j > 0:
                sub = 0 if pattern[i - 1] == text[j - 1] else x
                best = min(best, M[i - 1, j - 1] + sub)
            M[i, j] = best
    return M


def print_score_matrix(pattern: str, text: str, penalties: Penalties,
                       ops: Optional[str] = None, file=None) -> None:
    """Render the DP matrix; cells on the alignment path marked with '*'."""
    import sys
    stream = file or sys.stdout
    M = score_matrix(pattern, text, penalties)
    path = set()
    if ops:
        v = h = 0
        path.add((0, 0))
        for c in ops:
            if c in "MX":
                v += 1
                h += 1
            elif c == "I":
                h += 1
            else:
                v += 1
            path.add((v, h))
    hdr = "      " + " ".join(f"{c:>4}" for c in " " + text)
    print(hdr, file=stream)
    for i in range(M.shape[0]):
        row = [f"{(pattern[i-1] if i else ' '):>3}  "]
        for j in range(M.shape[1]):
            val = M[i, j]
            cell = "  ~ " if val >= INF else f"{val:>3} "
            if (i, j) in path:
                cell = cell[:-1] + "*"
            row.append(cell)
        print(" ".join(row), file=stream)


def print_wavefronts(run, score_begin: int, score_end: int,
                     file=None) -> None:
    """Render wavefront CONTENTS per score: a table with one row per
    diagonal k and one column group per score, each group holding the
    per-component offsets ('[  ]' where the component has no cell).

    Analog of the reference's wavefront debug dump
    (reference: wavefront_display.c:110-284, wavefront_aligner_print);
    `run` is an oracle run with retained wavefronts -- align with
    `OracleAligner(attr, keep_wavefronts=True)` and pass its `.last_run`.
    """
    import sys

    from ..constants import Component, DistanceMetric

    stream = file or sys.stdout
    metric = run.metric
    if metric in (DistanceMetric.INDEL, DistanceMetric.EDIT,
                  DistanceMetric.GAP_LINEAR):
        comps = [(Component.M, "M")]
    elif metric == DistanceMetric.GAP_AFFINE:
        comps = [(Component.M, "M"), (Component.I1, "I1"),
                 (Component.D1, "D1")]
    else:
        comps = [(Component.M, "M"), (Component.I1, "I1"),
                 (Component.D1, "D1"), (Component.I2, "I2"),
                 (Component.D2, "D2")]
    scores = list(range(score_begin, score_end + 1))
    # union band over the displayed scores
    lo = hi = None
    for s in scores:
        for comp, _ in comps:
            wf = run.wfs[comp].get(s)
            if wf is None or wf.null:
                continue
            lo = wf.lo if lo is None else min(lo, wf.lo)
            hi = wf.hi if hi is None else max(hi, wf.hi)
    print(f">[SCORE {score_begin}-{score_end}]", file=stream)
    if lo is None:
        print("(all wavefronts null)", file=stream)
        return
    cw = 5 * len(comps)  # one column group per score
    head = "       |" + "|".join(f"{f's={s}':^{cw}}" for s in scores) + "|"
    sub = "   k   |" + "|".join(
        "".join(f"{name:^5}" for _, name in comps) for _ in scores) + "|"
    print(head, file=stream)
    print(sub, file=stream)
    for k in range(hi, lo - 1, -1):
        cells = []
        for s in scores:
            grp = ""
            for comp, _ in comps:
                wf = run.wfs[comp].get(s)
                if (wf is None or wf.null or k < wf.lo or k > wf.hi
                        or wf.off[k + run.koff] < 0):
                    grp += "[  ] "
                else:
                    grp += f"[{int(wf.off[k + run.koff]):>2d}] "
            cells.append(grp.rstrip().ljust(cw))
        print(f"{k:>6} |" + "|".join(cells) + "|", file=stream)
