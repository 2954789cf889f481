"""Judge answered alignments: does an op string align its pair, and at what
cost.

An op string holds one letter an operation: M a match, X a mismatch, I an
insertion (a text base against nothing), D a deletion (a pattern base
against nothing). It aligns a pair when its M, X and D ops consume the
pattern and its M, X and I ops the text, exactly, and every M pairs equal
bases and every X differing ones. Its gap-affine cost is x a mismatch and
o + e * L a run of L insertions or of L deletions.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .dp import pad_bytes

_M, _X, _I, _D = (ord(c) for c in "MXID")


def judge_ops(patterns: Sequence[bytes], texts: Sequence[bytes],
              ops: Sequence[bytes], x: int, o: int, e: int) -> tuple:
    """(aligns bool [n], cost int64 [n]) of each pair's op string; the cost
    is meaningful where the string aligns its pair."""
    n = len(ops)
    if n == 0:
        return np.zeros(0, dtype=bool), np.zeros(0, dtype=np.int64)
    pat, plen = pad_bytes(patterns, 0)
    txt, tlen = pad_bytes(texts, 0)
    op, nops = pad_bytes(ops, 0)
    is_m, is_x = op == _M, op == _X
    is_i, is_d = op == _I, op == _D
    known = is_m | is_x | is_i | is_d | (op == 0)
    step_p = is_m | is_x | is_d
    step_t = is_m | is_x | is_i
    pi = np.cumsum(step_p, axis=1) - 1
    ti = np.cumsum(step_t, axis=1) - 1
    both = is_m | is_x
    inside = (pi < plen[:, None]) & (ti < tlen[:, None])
    rows = np.arange(n)[:, None]
    pc = pat[rows, np.clip(pi, 0, pat.shape[1] - 1)]
    tc = txt[rows, np.clip(ti, 0, txt.shape[1] - 1)]
    wrong_pair = both & (~inside | ((pc == tc) != is_m))
    aligns = (known.all(axis=1) & ~wrong_pair.any(axis=1)
              & (step_p.sum(axis=1) == plen) & (step_t.sum(axis=1) == tlen))
    prev = np.zeros_like(op)
    prev[:, 1:] = op[:, :-1]
    opens = (is_i & (prev != _I)) | (is_d & (prev != _D))
    cost = (x * is_x.sum(axis=1) + o * opens.sum(axis=1)
            + e * (is_i | is_d).sum(axis=1))
    return aligns, cost.astype(np.int64)


def cigartuples_to_ops(cigartuples) -> bytes:
    """pywfa's cigartuples (0 M, 1 I, 2 D, 8 X) as an op string."""
    letters = {0: b"M", 1: b"I", 2: b"D", 7: b"M", 8: b"X"}
    return b"".join(letters.get(code, b"?") * count
                    for code, count in cigartuples)
