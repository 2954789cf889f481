"""The benchmark's own spans around the program's layers, and the reading of
a profiled slice of the cell's traffic.

Spans wrap the program's functions where their callers look them up (a
module attribute), so the program is not edited: each wrapped call adds its
host time to a total under the span's name and, while the profiler runs,
opens a `torch.profiler.record_function` range of that name, which labels
the device's idle gaps.
"""
from __future__ import annotations

import collections
import functools
import time

SPAN_PREFIX = "wfa:"

# (module, attribute, span name): what a traced run wraps. Callers look
# each one up in that module: align_pairs_stream calls align_pairs_dispatch
# and align_pairs_finish there, _assemble calls _native_fill, the engine's
# walks call walk_segment, engine_adapter.align_single calls align_pairs.
SPANS = (
    ("pywfa_tpu_torch.batch", "align_pairs_dispatch", "dispatch"),
    ("pywfa_tpu_torch.batch", "_encode_side", "encode"),
    ("pywfa_tpu_torch.batch", "align_pairs_pull", "pull_wait"),
    ("pywfa_tpu_torch.batch", "align_pairs_finish", "finish"),
    ("pywfa_tpu_torch.batch", "_native_fill", "native_fill"),
    ("pywfa_tpu_torch.ops.engine", "walk_segment", "walk"),
    ("pywfa_tpu_torch.engine_adapter", "align_pairs", "align_pairs"),
)


class Spans:
    """Host-time totals of the wrapped functions, by span name."""

    def __init__(self):
        self.total = collections.defaultdict(float)
        self._undo = []

    def install(self):
        import importlib

        import torch
        record = torch.profiler.record_function
        for modname, attr, name in SPANS:
            mod = importlib.import_module(modname)
            orig = getattr(mod, attr)

            def wrapped(*a, _orig=orig, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    with record(SPAN_PREFIX + _name):
                        return _orig(*a, **kw)
                finally:
                    self.total[_name] += time.perf_counter() - t0

            functools.update_wrapper(wrapped, orig)
            setattr(mod, attr, wrapped)
            self._undo.append((mod, attr, orig))
        return self

    def reset(self):
        self.total.clear()

    def uninstall(self):
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo.clear()


class Slice:
    """torch.profiler (CPU and CUDA activities) over a bounded slice of
    the cell's traffic right after the window, opened by start() and
    closed by stop(); read() reads its events afterwards."""

    def __init__(self):
        self.prof = None
        self._range = None
        self.result = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._range = record_function(SPAN_PREFIX + "slice")
        self._range.__enter__()

    def stop(self):
        self._range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def read(self) -> dict:
        """read_slice of the closed session; its events are read once."""
        if self.result is None and self.prof is not None:
            self.result = read_slice(self.prof.events())
            self.prof = None
        return self.result


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def read_slice(events) -> dict:
    """What the slice's trace says, in seconds: its wall (the slice range),
    the device's busy time (the union of kernel, copy and set intervals
    inside it), the device time by operation name, the fused loop's device
    time and kernel count, and the idle time by the innermost span open at
    each gap's middle."""
    from torch.autograd import DeviceType
    dev, spans, wall = [], [], None
    for ev in events:
        a, b = ev.time_range.start, ev.time_range.end
        if ev.name.startswith(SPAN_PREFIX):
            if ev.device_type == DeviceType.CUDA:
                # the profiler's copy of a range on the device's timeline
                continue
            if ev.name == SPAN_PREFIX + "slice":
                wall = (a, b)
            else:
                spans.append((a, b, ev.name[len(SPAN_PREFIX):]))
        elif ev.device_type == DeviceType.CUDA:
            dev.append((ev.name, a, b))
    if wall is None or not dev:
        return {"device_events": 0}
    lo, hi = wall
    busy_iv = _union([(max(a, lo), min(b, hi)) for _, a, b in dev
                      if b > lo and a < hi])
    busy = sum(b - a for a, b in busy_iv)
    by_op = collections.defaultdict(float)
    fused, fused_n = 0.0, 0
    for name, a, b in dev:
        by_op[_short(name)] += b - a
        if "fused_loop" in name:
            fused += b - a
            fused_n += 1
    gaps = collections.defaultdict(float)
    edge = lo
    for a, b in busy_iv + [[hi, hi]]:
        if a > edge:
            mid = (edge + a) / 2
            open_ = [s for s in spans if s[0] <= mid <= s[1]]
            label = max(open_)[2] if open_ else "harness"
            gaps[label] += a - edge
        edge = max(edge, b)
    us = 1e-6
    return {
        "device_events": len(dev),
        "wall_s": (hi - lo) * us,
        "busy_s": busy * us,
        "fused_loop_s": fused * us,
        "fused_loop_kernels": fused_n,
        "device_ops": sorted(((k, v * us) for k, v in by_op.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(((k, v * us) for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:10],
    }


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces' parentheses,
    template arguments and parameters."""
    head = name.replace("(anonymous namespace)::", "")
    if head.startswith("void "):
        head = head[5:]
    for cut in ("<", "("):
        head = head.split(cut)[0]
    return head.strip()[:96] or name[:96]
