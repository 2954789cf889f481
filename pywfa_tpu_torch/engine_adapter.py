"""Single-pair adapter onto the port's batch pipeline.

The twin of `pywfa_tpu/engine_adapter.py`: buckets (pattern_len,
text_len) into power-of-two padded shapes and runs the pair through
`batch.align_pairs` on one device, returning the oracle's result type.
"""
from __future__ import annotations

from typing import Optional, Sequence

from .attributes import AlignerAttributes, validate_alignment
from .batch import align_pairs
from .oracle import OracleAligner, OracleResult
from .ops import config as C
from .ops import fused_loop

# power-of-two length buckets of `pywfa_tpu.parallel.bucketing`, copied:
# that package's __init__ imports jax
DEFAULT_SCHEDULE = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                    65536)


def _bucket_len(n: int, schedule: Sequence[int]) -> int:
    for b in schedule:
        if n <= b:
            return b
    # beyond the schedule: next power of two
    b = schedule[-1] if schedule else 16
    while b < n:
        b *= 2
    return b


def align_single(attr: AlignerAttributes, pattern: bytes, text: bytes,
                 wildcard: Optional[int], device="cuda") -> OracleResult:
    """Align one pair on `device`.

    Raises NotImplementedError, before any work, when the pair's terminal
    rung needs a band wider than the fused loop's one-thread-per-diagonal
    block (pairs past 256 bp bucket to 512 and a band of 1152).
    """
    plen, tlen = len(pattern), len(text)
    if plen == 0:
        # degenerate; the oracle holds the edge semantics, as in the
        # reference's adapter
        return OracleAligner(attr, wildcard).align(pattern, text)
    Lp = _bucket_len(plen, DEFAULT_SCHEDULE)
    Lt = _bucket_len(tlen, DEFAULT_SCHEDULE)
    attr0 = validate_alignment(attr, plen, tlen)
    terminal = C.full_config(attr0, Lp, Lt)
    if terminal.W > fused_loop.MAX_THREADS:
        raise NotImplementedError(
            f"a {plen} x {tlen} bp pair buckets to {Lp} x {Lt}, whose "
            f"terminal rung needs W={terminal.W}, more than one thread per "
            "diagonal; long reads are not ported yet (ROADMAP queue 1 item "
            "6)")
    # caps escalate inside align_pairs; bucketed Lp/Lt keep shapes stable
    res = align_pairs(attr0, [pattern], [text], wildcard=wildcard, Lp=Lp,
                      Lt=Lt, device=device)[0]
    return OracleResult(status=res.status, score=res.score, ops=res.ops,
                        end_v=res.end_v, end_h=res.end_h,
                        wf_score=res.wf_score, dropped=res.dropped)
