"""The lengths driver: a read-set pipeline's closed loop over reads of
many lengths, in sequencing order.

The configuration's `reads.lengths` names a read set: `set` lengths, the
quantiles at (i + 0.5) / set of a log-normal of the given mean and
standard deviation, so that every seed holds the same lengths. Each
length's pairs come from `reads.make_pairs` with the configuration's edit
model at that length (one call a length). The pool is `batch_pairs *
pool_batches / set` copies of the set, each copy in an order drawn from
the seed, laid end to end and cut into batches: a batch of `set` pairs
holds the whole set once. Everything else, the window, the traced slice,
the drain and the answers, is the stream driver's (`drivers/stream.py`).
"""
from __future__ import annotations

import math
import statistics

import numpy as np

from wfabench import reads
from wfabench.drivers import stream
from wfabench.program import aligner_kwargs


def read_lengths(lengths: dict) -> np.ndarray:
    """int64 [set]: round(exp(mu + sigma * Phi^-1((i + 0.5) / set))), with
    sigma^2 = ln(1 + sd^2 / mean^2) and mu = ln(mean) - sigma^2 / 2."""
    if lengths["family"] != "lognormal":
        raise ValueError(f"unknown length family {lengths['family']!r}")
    n, mean, sd = lengths["set"], lengths["mean"], lengths["sd"]
    s2 = math.log1p((sd / mean) ** 2)
    mu = math.log(mean) - s2 / 2
    q = statistics.NormalDist().inv_cdf
    return np.array([round(math.exp(mu + math.sqrt(s2) * q((i + 0.5) / n)))
                     for i in range(n)], dtype=np.int64)


def make_pool(cell: dict, rng: np.random.Generator) -> tuple:
    """(patterns, texts) of the pool, in pool pair order: the first draws
    of the seed's Generator."""
    config = cell["config"]
    model = dict(config["reads"])
    lengths = read_lengths(model.pop("lengths"))
    n = config["batch_pairs"] * config["pool_batches"]
    copies = -(-n // lengths.size)
    by_length = [reads.make_pairs(dict(model, length=int(L)), copies, rng)
                 for L in lengths]
    order = [(i, c) for c in range(copies)
             for i in rng.permutation(lengths.size).tolist()][:n]
    return ([by_length[i][0][c] for i, c in order],
            [by_length[i][1][c] for i, c in order])


class Run(stream.Run):
    """The stream driver's run over this driver's pool (stream.Run's
    set-up, with the pool made here)."""

    def __init__(self, cell: dict, rng: np.random.Generator, device):
        import pywfa_tpu_torch as P
        self.config, self.traffic = cell["config"], cell["traffic"]
        B = self.config["batch_pairs"]
        pats, txts = make_pool(cell, rng)
        self.pool = [(pats[i:i + B], txts[i:i + B])
                     for i in range(0, len(pats), B)]
        self.keep_rng = np.random.default_rng(rng.integers(2**63))
        self.aligner = P.BatchWavefrontAligner(
            device=device, **aligner_kwargs(self.config, self.traffic))
        self._stop = False
        self._fed = []
        self._slice_fed = None
        self._results = iter(self.aligner.align_stream(
            self._feed(), depth=self.traffic["depth"]))
        self.done = 0
