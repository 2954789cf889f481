"""Spans of the port's layers: one tree with self time, under PYWFA_PROF.

A span is a named interval of host time whose parent is the span open
when it began. Closing one adds its duration to `total_s[name]`, one to
`n[name]`, and its duration less its children's to `self_s[name]`, so
that the self times of a tree sum to its root's duration. The spans run
from the public entry (`align.WavefrontAligner.__call__`, or a stream's
`batch.align_pairs_dispatch`, `align_pairs_pull` and
`align_pairs_finish`) down to the walk's host syncs
(`ops/engine.walk_segment`); `batch.PROF` keeps the reference's nine flat
keys beside them.

The switch is `batch._PROF` (PYWFA_PROF, read when batch.py is
imported), looked up each time a site runs, so that setting or patching
it turns every span on or off. With it off a site costs one test of the
switch (and a decorated function one call more); nothing runs in the
walk's loop. While torch.profiler runs, each span also opens a
`record_function` range named "wfa:<name>", so that spans and device
events share the profiler's clock.

Each closed span is also kept, as (end time, name, parent's name or "",
duration, self time, count), in `log`, the last LOG_MAX of them: a
reader totals any interval of time from it, such as a measured window,
without resetting the totals (a full log holds about 100 MB). The count is
what the span did a number of times: the steps of a walk, the pairs of
an escalation, else 0.
"""
from __future__ import annotations

import collections
import functools
import sys
import time

from torch.autograd import profiler as _profiler

PREFIX = "wfa:"
LOG_MAX = 2**19

total_s = collections.defaultdict(float)
self_s = collections.defaultdict(float)
n = collections.defaultdict(int)
log: collections.deque = collections.deque(maxlen=LOG_MAX)

# where the switch lives
_BATCH = __package__ + ".batch"
_modules = sys.modules

# the open spans, innermost last:
# [name, start, children's seconds, range, parent's name]
_stack: list = []


def on() -> bool:
    """The switch, batch._PROF, as it is now."""
    return _modules[_BATCH]._PROF


def begin(name: str) -> float:
    """Open span `name` inside the innermost open one; returns its start
    (time.perf_counter())."""
    rng = None
    if _profiler._is_profiler_enabled:
        rng = _profiler.record_function(PREFIX + name)
        rng.__enter__()
    t0 = time.perf_counter()
    _stack.append([name, t0, 0.0, rng, _stack[-1][0] if _stack else ""])
    return t0


def end(count: int = 0) -> float:
    """Close the innermost open span, with `count` for the log; returns
    its end (time.perf_counter())."""
    name, t0, kids, rng, parent = _stack.pop()
    t1 = time.perf_counter()
    if rng is not None:
        rng.__exit__(None, None, None)
    d = t1 - t0
    total_s[name] += d
    self_s[name] += d - kids
    n[name] += 1
    if _stack:
        _stack[-1][2] += d
    log.append((t1, name, parent, d, d - kids, count))
    return t1


class span:
    """`with span(name):` a span over the block. Leaving it also closes
    the spans begun inside and left open by an exception."""

    __slots__ = ("name", "depth")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.depth = len(_stack)
        begin(self.name)

    def __exit__(self, *exc):
        while len(_stack) > self.depth:
            end()


def traced(name: str):
    """Decorator: each call is a span `name` while the switch is on."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _modules[_BATCH]._PROF:
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def waited(t) -> bool:
    """bool(t) as a span "sync": the host blocked until the device has
    computed `t`."""
    begin("sync")
    r = bool(t)
    end()
    return r


def reset() -> None:
    """Forget every closed span (open ones close into the new totals)."""
    total_s.clear()
    self_s.clear()
    n.clear()
    log.clear()


def report(units: int = 1) -> str:
    """One line a span, the largest self time first: self and total ms
    and the count, each per unit (a call or a batch)."""
    return "\n".join(
        f"{k:12s} self {self_s[k] * 1e3 / units:9.3f} ms  total "
        f"{total_s[k] * 1e3 / units:9.3f} ms  x {n[k] / units:8.2f}"
        for k in sorted(self_s, key=self_s.get, reverse=True))
