"""Single-pair adapter onto the port's batch pipeline.

The twin of `pywfa_tpu/engine_adapter.py`: buckets (pattern_len,
text_len) into power-of-two padded shapes and runs the pair through
`batch.align_pairs` on one device, returning the oracle's result type.
"""
from __future__ import annotations

from typing import Optional

from .attributes import AlignerAttributes, validate_alignment
from .batch import align_pairs
from .oracle import OracleAligner, OracleResult
from .parallel.bucketing import DEFAULT_SCHEDULE, _bucket_len


def align_single(attr: AlignerAttributes, pattern: bytes, text: bytes,
                 wildcard: Optional[int], device="cuda") -> OracleResult:
    """Align one pair of any length on `device`; a long pair's rungs run
    with several diagonals a thread and, past the memory mode's record
    budget, segmented (see batch._align_pairs_remat)."""
    plen, tlen = len(pattern), len(text)
    if plen == 0:
        # degenerate; the oracle holds the edge semantics, as in the
        # reference's adapter
        return OracleAligner(attr, wildcard).align(pattern, text)
    Lp = _bucket_len(plen, DEFAULT_SCHEDULE)
    Lt = _bucket_len(tlen, DEFAULT_SCHEDULE)
    attr0 = validate_alignment(attr, plen, tlen)
    # caps escalate inside align_pairs; bucketed Lp/Lt keep shapes stable
    res = align_pairs(attr0, [pattern], [text], wildcard=wildcard, Lp=Lp,
                      Lt=Lt, device=device)[0]
    return OracleResult(status=res.status, score=res.score, ops=res.ops,
                        end_v=res.end_v, end_h=res.end_h,
                        wf_score=res.wf_score, dropped=res.dropped)
