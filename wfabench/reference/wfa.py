"""A plain wavefront aligner: gap-affine, end to end, one pair.

The recurrences of Marco-Sola et al. (Bioinformatics 2021) as WFA2-lib
states them: at score s the wavefronts M, I and D share one range of
diagonals k = h - v, the union of M(s - x), M(s - o - e) widened by one and
I, D(s - e) widened by one, clipped to the matrix ([-len(pattern),
len(text)]);

    I(s, k) = max(M(s - o - e, k - 1), I(s - e, k - 1)) + 1
    D(s, k) = max(M(s - o - e, k + 1), D(s - e, k + 1))
    M(s, k) = max(M(s - x, k) + 1, I(s, k), D(s, k)),

an M offset past either sequence's end is null, and every M offset then
extends along its diagonal while the bases are equal. The traceback takes,
at each step, the candidate with the furthest offset, ties going to the
mismatch, then the deletion's extension and opening, then the insertion's
(WFA2-lib's order). Slow and plain: for tests at small sizes.
"""
from __future__ import annotations

import numpy as np

NULL = -(1 << 40)
_BT_M, _BT_D_EXT, _BT_D_OPEN, _BT_I_EXT, _BT_I_OPEN = 9, 6, 5, 2, 1


def align(pattern: bytes, text: bytes, x: int = 4, o: int = 6, e: int = 2):
    """(score, ops, limits): pywfa's score (minus the cost), the op string
    (M, X, I, D) and the (s, lo, hi) diagonal range of every score that
    carried a wavefront, up to the final one."""
    P = np.frombuffer(pattern, dtype=np.uint8)
    T = np.frombuffer(text, dtype=np.uint8)
    plen, tlen = len(P), len(T)
    kmin, kmax = -plen, tlen
    ks = np.arange(kmin, kmax + 1)
    width = kmax - kmin + 1
    M, I, D, lims, gaps = {}, {}, {}, {}, {}

    def empty():
        return np.full(width, NULL, dtype=np.int64)

    def shifted(arr, dk):
        # out[k] = arr[k - dk]
        out = empty()
        if arr is None:
            return out
        if dk > 0:
            out[dk:] = arr[:-dk]
        else:
            out[:dk] = arr[-dk:]
        return out

    m0 = empty()
    m0[-kmin] = 0
    M[0], lims[0], gaps[0] = m0, (0, 0), False
    s = 0
    k_end = tlen - plen
    while True:
        if s in M:
            lo, hi = lims[s]
            _extend(M[s], ks, P, T, lo - kmin, hi - kmin + 1)
            if lo <= k_end <= hi and M[s][k_end - kmin] >= tlen:
                break
        s += 1
        srcs = []
        if s - x in M:
            srcs.append((lims[s - x], 0))
        if s - o - e in M:
            srcs.append((lims[s - o - e], 1))
        if gaps.get(s - e, False):
            srcs.append((lims[s - e], 1))
        if not srcs:
            continue
        lo = max(kmin, min(r[0] - w for r, w in srcs))
        hi = min(kmax, max(r[1] + w for r, w in srcs))
        m_open = M.get(s - o - e)
        i_ext = I.get(s - e)
        d_ext = D.get(s - e)
        ins = np.maximum(shifted(m_open, 1), shifted(i_ext, 1)) + 1
        dele = np.maximum(shifted(m_open, -1), shifted(d_ext, -1))
        mis = (M[s - x] + 1) if s - x in M else empty()
        m = np.maximum(mis, np.maximum(ins, dele))
        out = (m - ks > plen) | (m > tlen) | (m < 0)
        m[out] = NULL
        outside = np.ones(width, dtype=bool)
        outside[lo - kmin:hi - kmin + 1] = False
        for arr in (m, ins, dele):
            arr[outside] = NULL
            arr[arr < 0] = NULL
        M[s], lims[s] = m, (lo, hi)
        gaps[s] = m_open is not None or i_ext is not None or d_ext is not None
        if gaps[s]:
            I[s], D[s] = ins, dele
    ops = _backtrace(M, I, D, lims, s, k_end, tlen, x, o, e, kmin)
    limits = [(t, lims[t][0], lims[t][1]) for t in sorted(lims)]
    return -s, ops, limits


def _extend(off, ks, P, T, a, b):
    o = off[a:b]
    k = ks[a:b]
    live = o >= 0
    while live.any():
        v = o - k
        inb = live & (v < len(P)) & (o < len(T)) & (v >= 0)
        if not inb.any():
            break
        eq = np.zeros_like(inb)
        eq[inb] = P[v[inb]] == T[o[inb]]
        o = np.where(eq, o + 1, o)
        live = eq
    off[a:b] = o


def _backtrace(M, I, D, lims, s, k, offset, x, o, e, kmin) -> str:
    def cand(comp, score, kk, delta, kind):
        wf = comp.get(score)
        if wf is None:
            return NULL
        lo, hi = lims[score]
        if kk < lo or kk > hi or wf[kk - kmin] < 0:
            return NULL
        return ((int(wf[kk - kmin]) + delta) << 4) | kind

    rev = []
    matrix = "M"
    v, h = offset - k, offset
    while v > 0 and h > 0 and s > 0:
        if matrix == "M":
            cands = [cand(M, s - x, k, 1, _BT_M),
                     cand(M, s - o - e, k - 1, 1, _BT_I_OPEN),
                     cand(I, s - e, k - 1, 1, _BT_I_EXT),
                     cand(M, s - o - e, k + 1, 0, _BT_D_OPEN),
                     cand(D, s - e, k + 1, 0, _BT_D_EXT)]
        elif matrix == "I":
            cands = [cand(M, s - o - e, k - 1, 1, _BT_I_OPEN),
                     cand(I, s - e, k - 1, 1, _BT_I_EXT)]
        else:
            cands = [cand(M, s - o - e, k + 1, 0, _BT_D_OPEN),
                     cand(D, s - e, k + 1, 0, _BT_D_EXT)]
        best = max(cands)
        if best < 0:
            break
        if matrix == "M":
            nm = offset - (best >> 4)
            rev.append("M" * nm)
            offset = best >> 4
            v, h = offset - k, offset
            if v <= 0 or h <= 0:
                break
        kind = best & 0xF
        if kind == _BT_M:
            s, matrix = s - x, "M"
            rev.append("X")
            offset -= 1
        elif kind in (_BT_I_OPEN, _BT_I_EXT):
            s, matrix = ((s - o - e, "M") if kind == _BT_I_OPEN
                         else (s - e, "I"))
            rev.append("I")
            k -= 1
            offset -= 1
        else:
            s, matrix = ((s - o - e, "M") if kind == _BT_D_OPEN
                         else (s - e, "D"))
            rev.append("D")
            k += 1
        v, h = offset - k, offset
    if matrix == "M" and v > 0 and h > 0:
        n = min(v, h)
        rev.append("M" * n)
        v, h = v - n, h - n
    rev.append("D" * v)
    rev.append("I" * h)
    return "".join(reversed(rev))
