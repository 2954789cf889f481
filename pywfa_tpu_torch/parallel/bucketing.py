"""Length bucketing for batched alignment.

Pairs are grouped by (bucketed pattern length, bucketed text length) so each
group runs under one compiled engine configuration with minimal padding
waste; score caps start small and escalate only for the pairs that need it
(batch.align_pairs handles escalation). A copy of
`pywfa_tpu/parallel/bucketing.py`, which the port does not import.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple


def _bucket_len(n: int, schedule: Sequence[int]) -> int:
    for b in schedule:
        if n <= b:
            return b
    # beyond the schedule: next power of two
    b = schedule[-1] if schedule else 16
    while b < n:
        b *= 2
    return b


DEFAULT_SCHEDULE = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)


def bucket_pairs(patterns: Sequence[bytes], texts: Sequence[bytes],
                 schedule: Sequence[int] = DEFAULT_SCHEDULE,
                 ) -> Dict[Tuple[int, int], List[int]]:
    """Group pair indices by (Lp_bucket, Lt_bucket)."""
    groups: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for i, (p, t) in enumerate(zip(patterns, texts)):
        key = (_bucket_len(len(p), schedule), _bucket_len(len(t), schedule))
        groups[key].append(i)
    return dict(groups)
