"""The stream driver: a read-set pipeline's closed loop.

The configuration's pool of `pool_batches` batches of `batch_pairs` pairs,
made from the seed, is cycled through
`pywfa_tpu_torch.BatchWavefrontAligner(...).align_stream(batches, depth)`.
Set-up runs `warmup_batches` results through the same stream; the window
opens at the next result and closes at the first result past its length.
Batches still in flight then drain outside the window. A share of the
window's batches, drawn from the seed, is kept to be judged.
"""
from __future__ import annotations

import time

import numpy as np

from wfabench import reads
from wfabench.program import aligner_kwargs


def make_pool(cell: dict, rng: np.random.Generator) -> tuple:
    """(patterns, texts) of the pool, in pool pair order: the first draws
    of the seed's Generator."""
    config = cell["config"]
    return reads.make_pairs(config["reads"],
                            config["batch_pairs"] * config["pool_batches"],
                            rng)


class Run:
    def __init__(self, cell: dict, rng: np.random.Generator, device):
        import pywfa_tpu_torch as P
        self.config, self.traffic = cell["config"], cell["traffic"]
        B = self.config["batch_pairs"]
        nb = self.config["pool_batches"]
        pats, txts = make_pool(cell, rng)
        self.pool = [(pats[i * B:(i + 1) * B], txts[i * B:(i + 1) * B])
                     for i in range(nb)]
        self.keep_rng = np.random.default_rng(rng.integers(2**63))
        self.aligner = P.BatchWavefrontAligner(
            device=device, **aligner_kwargs(self.config, self.traffic))
        self._stop = False
        self._fed = []
        self._slice_fed = None
        self._results = iter(self.aligner.align_stream(
            self._feed(), depth=self.traffic["depth"]))
        self.done = 0

    def _feed(self):
        i = 0
        while not self._stop:
            b = i % len(self.pool)
            self._fed.append(b)
            if self._slice_fed is not None:
                self._slice_fed.append(b)
            yield self.pool[b]
            i += 1

    def _next(self):
        res = next(self._results)
        b = self._fed[self.done]
        self.done += 1
        return b, res

    def warm_up(self):
        for _ in range(self.config["warmup_batches"]):
            self._next()

    def window(self, seconds: float, on_start) -> dict:
        """Measure for `seconds`; returns what the window saw. The last
        batch of the window is always kept."""
        share = self.config["check_batch_share"]
        kept, completed, batches = [], 0, 0
        t_start = time.perf_counter()
        on_start()
        while True:
            b, res = self._next()
            t = time.perf_counter()
            batches += 1
            completed += len(res)
            last = t - t_start >= seconds
            if last or self.keep_rng.random() < share:
                # plain tuples, which the collector stops tracking, in place
                # of the result objects
                kept.append((b, [None if r is None else
                                 (r.status, r.score, r.ops) for r in res]))
            if last:
                break
        return {"t_start": t_start, "t_end": t, "batches": batches,
                "pairs": completed, "kept": kept}

    def traced_slice(self, tracer) -> list:
        """Run `trace_slice_batches` more batches under the profiler, after
        the window; returns the pool pair indices of the batches dispatched
        while it ran."""
        self._slice_fed = []
        tracer.start()
        for _ in range(self.config["trace_slice_batches"]):
            self._next()
        tracer.stop()
        fed, self._slice_fed = self._slice_fed, None
        B = self.config["batch_pairs"]
        return [b * B + j for b in fed for j in range(B)]

    def drain(self):
        """Let the batches still in flight finish, outside the window."""
        self._stop = True
        for _ in self._results:
            pass
        self._results = None

    def answers(self, kept) -> tuple:
        """(pool pair index, answer) of every kept result: an answer is
        (status, score, op string or None)."""
        B = self.config["batch_pairs"]
        full = self.traffic["scope"] == "full"
        out = []
        for b, res in kept:
            for j in range(B):
                if j < len(res) and res[j] is not None:
                    status, score, ops = res[j]
                    out.append((b * B + j, (status, score,
                                            ops.encode() if full else None)))
                else:
                    out.append((b * B + j, None))
        return out

    def pairs(self) -> tuple:
        """(patterns, texts) of the whole pool, in pool pair order."""
        pats = [p for batch in self.pool for p in batch[0]]
        txts = [t for batch in self.pool for t in batch[1]]
        return pats, txts

    def close(self):
        self.aligner = None
        self._results = None
