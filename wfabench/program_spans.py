"""The program's own spans over the measured window, for the per-layer
readers.

Under PYWFA_PROF, which a traced run turns on, `pywfa_tpu_torch.spans`
keeps every closed span with its end time, its parent, its duration, its
self time (the duration less its children's) and a count (a walk's score
steps, an escalation's pairs). The spans that ran inside the window,
between its first and last result, are totalled here by name. (The
window opens and closes between results, where no span is open; a span
that crossed an edge would be left out, so that the self times, which
never overlap, sum to no more than the window.) None where
the program keeps no such record, or where its record no longer reaches
back to the window's start.
"""
from __future__ import annotations

import collections
import math

# the layers' spans (pywfa_tpu_torch/spans.py), each counted by its self
# time: the dispatch's host work of every rung and of the segmented
# executor outside its loops and walks, and the finish's of every rung
DISPATCH = ("dispatch", "config", "encode", "push", "stage_out",
            "segmented", "snapshot", "restore", "gather")
FINISH = ("pull_wait", "finish", "pull", "native_fill", "assemble",
          "escalate", "oracle")


def window_spans(ctx):
    """{"total", "self", "n", "count", "outer"}: seconds, numbers and
    counts by span name over the window, or None; "outer" sums the counts
    of the spans that ran inside no span of their own name (the first
    rung's escalations, not those of the rungs it escalated to). Kept on
    ctx for the next reader."""
    if not hasattr(ctx, "program_spans"):
        ctx.program_spans = _read(getattr(ctx, "window", None) or {})
    return ctx.program_spans


def _read(window):
    if "t_start" not in window:
        return None
    try:
        from pywfa_tpu_torch import spans
    except ImportError:
        return None
    log = list(spans.log)
    t0, t1 = window["t_start"], window["t_end"]
    if not log or (len(log) == spans.LOG_MAX and log[0][0] > t0):
        return None
    total = collections.defaultdict(float)
    own = collections.defaultdict(float)
    n = collections.defaultdict(int)
    count = collections.defaultdict(int)
    inside = []
    for t, name, _, d, s, c in log:
        if t0 <= t - d and t <= t1:
            total[name] += d
            own[name] += s
            n[name] += 1
            count[name] += c
            inside.append((t - d, -t, name, c))
    if not n:
        return None
    # spans of one name nest or miss each other: in order of start, one
    # ends past every earlier one of its name unless it ran inside one
    outer = collections.defaultdict(int)
    reach = {}
    for a, neg_end, name, c in sorted(inside):
        if -neg_end > reach.get(name, -math.inf):
            outer[name] += c
            reach[name] = -neg_end
    return {"total": dict(total), "self": dict(own), "n": dict(n),
            "count": dict(count), "outer": dict(outer)}


def per_unit(ctx, unit: str, kind: str, names) -> float | None:
    """The sum of `kind` ("total", "self" or "count") over the spans
    `names` in the window, per `unit` ("batches" or "calls") of it; None
    without the window's spans or units, or where no such span closed in
    the window. Seconds come out in ms."""
    sp = window_spans(ctx)
    units = ctx.window.get(unit) if sp else None
    if not units or not any(k in sp["n"] for k in names):
        return None
    v = sum(sp[kind].get(k, 0) for k in names) / units
    return v if kind == "count" else 1e3 * v
