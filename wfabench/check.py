"""The comparison that decides `correct`.

Every answer the window kept is judged against the plain reference: the
pair's optimal gap-affine cost from `reference.dp`, and, in the full
scope, whether its op string aligns the pair at that cost
(`reference.cigar`). The number compared is `wrong_answers`, with the limit
0, since the configurations state an exact optimum: the answers that

- never came (missing: a result list shorter than its batch),
- did not reach the end (unfinished: a status other than 0),
- scored other than minus the optimal cost (wrong_score), or
- in the full scope, carry an op string that does not align the pair at
  the optimal cost (wrong_cigar).

The four counts are printed beside it, to say what went wrong.
"""
from __future__ import annotations

import numpy as np

from wfabench.reference.cigar import judge_ops
from wfabench.reference.dp import affine_costs

LIMITS = {"wrong_answers": 0}
KINDS = ("missing", "unfinished", "wrong_score", "wrong_cigar")
CHUNK_OPS = 1 << 24


def reference_costs(pats, txts, idx, penalties, device) -> dict:
    """pair index -> optimal cost, for the pairs `idx` of the pool."""
    idx = sorted(set(idx))
    if not idx:
        return {}
    costs = affine_costs([pats[j] for j in idx], [txts[j] for j in idx],
                         penalties["mismatch"], penalties["gap_opening"],
                         penalties["gap_extension"], device=device)
    return dict(zip(idx, costs.tolist()))


def judge(pats, txts, answers, cost_of: dict, penalties: dict,
          full: bool) -> dict:
    """The compared numbers over `answers`, (pair index, (status, score,
    ops or None) or None) pairs."""
    x, o, e = (penalties["mismatch"], penalties["gap_opening"],
               penalties["gap_extension"])
    out = dict.fromkeys(KINDS, 0)
    wrong = set()
    done = []
    for i, (j, ans) in enumerate(answers):
        if ans is None:
            out["missing"] += 1
            wrong.add(i)
        elif ans[0] != 0:
            out["unfinished"] += 1
            wrong.add(i)
        else:
            if ans[1] != -cost_of[j]:
                out["wrong_score"] += 1
                wrong.add(i)
            if full:
                done.append((i, j, ans[2]))
    a = 0
    while a < len(done):
        # blocks of about CHUNK_OPS operations
        z, size = a, 0
        while z < len(done) and (z == a or size + len(done[z][2])
                                 <= CHUNK_OPS):
            size += len(done[z][2])
            z += 1
        part, a = done[a:z], z
        js = [j for _, j, _ in part]
        aligns, cost = judge_ops([pats[j] for j in js], [txts[j] for j in js],
                                 [ops or b"" for _, _, ops in part], x, o, e)
        want = np.array([cost_of[j] for j in js], dtype=np.int64)
        bad = np.flatnonzero(~aligns | (cost != want))
        out["wrong_cigar"] += int(bad.size)
        wrong.update(part[b][0] for b in bad.tolist())
    out["wrong_answers"] = len(wrong)
    out["judged"] = len(answers)
    return out


def verdict(numbers: dict) -> bool:
    """Correct: some answers judged, and no number past its limit."""
    return numbers["judged"] > 0 and all(
        numbers[k] <= lim for k, lim in LIMITS.items())
