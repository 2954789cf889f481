"""The reader of the segmented executor's state copies,
`state_pairs.stream`: the counts of the program's `compact` and `expand`
spans inside the window, a batch of it; None without its input or where
no such span closed in the window; and on the CPU a traced run of the
10 kb cell, its rungs forced segmented, that reports it."""
import collections
import time
from types import SimpleNamespace

import pytest

from wfabench import harness, manifest

NAME = "state_pairs.stream"


def read(ctx):
    return manifest.load_reader(NAME).read(ctx)


def ctx_of(window):
    return SimpleNamespace(window=window, slice=None)


@pytest.fixture
def program_log(monkeypatch):
    """The program's span log, replaced by a list the test fills."""
    from pywfa_tpu_torch import spans
    log = collections.deque(maxlen=spans.LOG_MAX)
    monkeypatch.setattr(spans, "log", log)
    return log


def test_totals_the_compact_and_expand_counts_a_batch(program_log):
    program_log.extend([
        (0.9, "compact", "snapshot", 0.5, 0.5, 999),   # before the window
        (1.2, "compact", "snapshot", 0.001, 0.001, 512),
        (1.3, "compact", "snapshot", 0.001, 0.001, 40),
        (1.4, "walk", "replay", 0.002, 0.002, 31),
        (1.5, "expand", "restore", 0.001, 0.001, 40),
        (1.6, "snapshot", "segmented", 0.003, 0.002, 0),
        (2.5, "expand", "restore", 0.1, 0.1, 999)])    # after it
    ctx = ctx_of({"t_start": 1.0, "t_end": 2.0, "batches": 2})
    assert read(ctx) == pytest.approx((512 + 40 + 40) / 2)


def test_reads_none_where_no_such_span_closed(program_log):
    assert read(ctx_of({})) is None
    window = {"t_start": 1.0, "t_end": 2.0, "batches": 2}
    assert read(ctx_of(dict(window))) is None
    # spans of other names inside the window, and ours outside it
    program_log.extend([(1.2, "walk", "replay", 0.01, 0.01, 4),
                        (1.3, "snapshot", "segmented", 0.01, 0.01, 0),
                        (2.5, "compact", "snapshot", 0.01, 0.01, 16)])
    assert read(ctx_of(dict(window))) is None


def test_a_traced_cpu_run_of_the_segmented_cell_reports_it(small_cell,
                                                           monkeypatch):
    from pywfa_tpu_torch import batch, spans
    monkeypatch.setattr(batch, "_PROF", batch._PROF)  # restored after
    monkeypatch.setenv("PYWFA_STREAM_GC", "1")
    # every rung segmented, as a 10 kb batch of 512 is on the card
    monkeypatch.setattr(batch, "CHOICES_BYTES_CAP", 1)
    cell = small_cell("ont10k-full-stream")
    assert NAME in {m["name"] for m in cell["per_layer"]}
    spans.reset()
    out = harness.run_cell(cell, 2**31 + 11, 0.5, True, "cpu",
                           time.perf_counter())
    assert out["result"]["correct"]
    got = out["result"]["metrics"][NAME]
    # at least one snapshot of a 16-pair batch and its replay's restore
    assert got["unit"] == "pairs/batch" and got["value"] >= 2
    spans.reset()
