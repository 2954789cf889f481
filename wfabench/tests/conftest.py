"""Shared helpers of the benchmark's own tests (CPU; the card's test skips
without one): the repository root on the path, and cells cut to a size a
test run holds."""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def shrink(cell: dict, pairs: int = 16, length: int = None) -> dict:
    """A copy of `cell` at a test's size: batches (or a call pool) of
    `pairs` pairs, two batches in the pool, every batch judged."""
    cell = copy.deepcopy(cell)
    c, t = cell["config"], cell["traffic"]
    c.update(batch_pairs=pairs, pool_batches=2, warmup_batches=1,
             trace_slice_batches=1, check_batch_share=1.0)
    if length is not None:
        c["reads"] = dict(c["reads"], length=length)
    if t["driver"] == "call":
        t.update(pool_pairs=pairs, warmup_calls=2, trace_slice_calls=2)
    return cell


@pytest.fixture
def small_cell():
    from wfabench import manifest
    bench = manifest.load(ROOT)

    def make(name, pairs=16, length=None):
        """The cell `name` at a test's size."""
        cell = manifest.resolve(bench, name, ROOT)
        if length is None and cell["config"]["reads"]["length"] > 1000:
            length = 300
        return shrink(cell, pairs, length)
    return make


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
