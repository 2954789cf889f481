"""The call driver: pywfa's one-pair call, one caller waiting for each
answer.

A pool of the traffic's `pool_pairs` pairs, made from the seed, is cycled
in an order drawn from the seed through one
`pywfa_tpu_torch.WavefrontAligner(device=...)` with the traffic's scope and
span and the configuration's penalties: `aligner(text, pattern)` a call.
Set-up makes `warmup_calls` calls; the window then times every call on the
host clock until its length has passed. Every answer of the window is kept
and judged.
"""
from __future__ import annotations

import time

import numpy as np

from wfabench import reads
from wfabench.program import aligner_kwargs
from wfabench.reference.cigar import cigartuples_to_ops


def make_pool(cell: dict, rng: np.random.Generator) -> tuple:
    """(patterns, texts) of the pool: the first draws of the seed's
    Generator."""
    return reads.make_pairs(cell["config"]["reads"],
                            cell["traffic"]["pool_pairs"], rng)


class Run:
    def __init__(self, cell: dict, rng: np.random.Generator, device):
        import pywfa_tpu_torch as P
        self.config, self.traffic = cell["config"], cell["traffic"]
        n = self.traffic["pool_pairs"]
        self.pats, self.txts = make_pool(cell, rng)
        self.pat_s = [p.decode() for p in self.pats]
        self.txt_s = [t.decode() for t in self.txts]
        self.order = rng.permutation(n).tolist()
        self.aligner = P.WavefrontAligner(
            device=device, **aligner_kwargs(self.config, self.traffic))
        self.full = self.traffic["scope"] == "full"
        self.i = 0

    def _call(self):
        j = self.order[self.i % len(self.order)]
        self.i += 1
        t0 = time.perf_counter()
        res = self.aligner(self.txt_s[j], self.pat_s[j])
        t1 = time.perf_counter()
        return j, res, t1 - t0

    def warm_up(self):
        for _ in range(self.traffic["warmup_calls"]):
            self._call()

    def window(self, seconds: float, on_start) -> dict:
        lat, kept = [], []
        t_start = time.perf_counter()
        on_start()
        while True:
            j, res, dt = self._call()
            lat.append(dt)
            # plain tuples, which the collector stops tracking, in place of
            # the result objects
            kept.append((j, self.aligner.status, res.score,
                         cigartuples_to_ops(res.cigartuples)
                         if self.full else None))
            t = time.perf_counter()
            if t - t_start >= seconds:
                break
        return {"t_start": t_start, "t_end": t, "calls": len(lat),
                "pairs": len(lat), "latencies": lat, "kept": kept}

    def traced_slice(self, tracer) -> list:
        """Make `trace_slice_calls` more calls under the profiler, after
        the window; returns their pool pair indices."""
        sliced = []
        tracer.start()
        for _ in range(self.traffic["trace_slice_calls"]):
            sliced.append(self._call()[0])
        tracer.stop()
        return sliced

    def drain(self):
        pass

    def answers(self, kept) -> list:
        return [(j, (status, score, ops)) for j, status, score, ops in kept]

    def pairs(self) -> tuple:
        return self.pats, self.txts

    def close(self):
        self.aligner = None
