"""Timers, counters and per-alignment verbose reporting.

Analog of WFA2-lib's profiler_timer/profiler_counter and the verbose TSV
report (reference: system/profiler_timer.c, profiler_counter.c,
wavefront_debug.c:123-204). Pure host-side; device timings come from
blocking on results.
"""
from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional


class Counter:
    """Streaming count/min/max/mean/stddev (reference: profiler_counter.c)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._m2 = 0.0
        self._mean = 0.0

    def add(self, x: float) -> None:
        self.n += 1
        self.total += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        d = x - self._mean
        self._mean += d / self.n
        self._m2 += d * (x - self._mean)

    @property
    def mean(self) -> float:
        return self._mean if self.n else 0.0

    @property
    def stddev(self) -> float:
        return math.sqrt(self._m2 / self.n) if self.n else 0.0


class Timer:
    """start/stop/lap wall-clock timer (reference: profiler_timer.c)."""

    def __init__(self) -> None:
        self.counter = Counter()
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        assert self._t0 is not None, "timer not started"
        dt = time.perf_counter() - self._t0
        self.counter.add(dt)
        self._t0 = None
        return dt

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    @property
    def total_s(self) -> float:
        return self.counter.total


def report_alignment(stream, *, score: int, status: int, plen: int, tlen: int,
                     cigar: str, seconds: float, pattern: str = "",
                     text: str = "", config: str = "") -> None:
    """One-line TSV per-alignment report (verbose >= 1 analog;
    reference: wavefront_debug.c:123-204)."""
    edit_ops = sum(1 for c in cigar if c in "XID")
    divergence = edit_ops / max(1, min(plen, tlen))
    fields = [
        f"score={score}", f"div={divergence:.4f}", f"plen={plen}",
        f"tlen={tlen}", f"status={status}", f"ms={seconds*1e3:.3f}",
        config, cigar,
    ]
    if pattern:
        fields += [pattern, text]
    print("\t".join(str(f) for f in fields), file=stream or sys.stderr)
