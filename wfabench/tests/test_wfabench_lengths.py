"""The lengths driver: the read set is the same 512 lengths for every seed
in another order, with the configuration's edits; and a cut-down copy of
the cell runs correct on the CPU, traced and untraced, while the reference
in 8-bit integers in the program's place answers every pair wrong."""
import copy
import time

import numpy as np
import pytest

from conftest import ROOT
from pywfa_tpu_torch.parallel import bucketing
from wfabench import harness, manifest, reads

CELL = "ont-lognormal-lengths-stream"


@pytest.fixture
def cell():
    return manifest.resolve(manifest.load(ROOT), CELL, ROOT)


def driver():
    return manifest.load_driver("lengths")


def test_the_read_set_is_pbsim2s_lengths(cell):
    L = driver().read_lengths(cell["config"]["reads"]["lengths"])
    assert L.size == 512 and L.min() == 844 and L.max() == 59801
    assert round(float(L.mean())) == 8990 and (L > 32768).sum() == 7
    assert (np.diff(L) >= 0).all()


def test_every_batch_holds_the_set_in_an_order_from_the_seed(cell):
    config = cell["config"]
    B = config["batch_pairs"]
    want = sorted(driver().read_lengths(config["reads"]["lengths"]).tolist())
    pools = [driver().make_pool(cell, np.random.default_rng(s))
             for s in (2**31 + 1, 2**31 + 2)]
    assert pools[0] == driver().make_pool(cell,
                                          np.random.default_rng(2**31 + 1))
    for pats, txts in pools:
        assert len(pats) == len(txts) == B * config["pool_batches"]
        for b in range(config["pool_batches"]):
            assert sorted(map(len, pats[b * B:(b + 1) * B])) == want
    order = [[len(p) for p in pats] for pats, _ in pools]
    assert order[0] != order[1]
    assert order[0][:B] != order[0][B:2 * B]


def test_the_edits_are_five_percent_at_the_profiles_ratio(cell):
    r = cell["config"]["reads"]
    pats, txts = driver().make_pool(cell, np.random.default_rng(9))
    shares = np.zeros(3)
    for p, t in zip(pats[:512], txts[:512]):
        k = round(len(p) * r["error_rate"])
        split = reads.splits(k, r["ratio"], r["size_set"], r["sizes_seed"])[0]
        # insertions less deletions move the text's length
        assert len(t) - len(p) == split[1] - split[2]
        assert set(p) | set(t) <= set(b"ACGT")
        shares += split
    assert np.allclose(shares / shares.sum(), [0.23, 0.31, 0.46], atol=0.01)


def small(cell):
    """The cell cut to a test's size: a set of 32 reads of 13-200 bp, one
    set a batch, two batches, every batch judged."""
    cell = copy.deepcopy(cell)
    c = cell["config"]
    c["reads"]["lengths"] = dict(c["reads"]["lengths"], mean=60, sd=40,
                                 set=32)
    c.update(batch_pairs=32, pool_batches=2, warmup_batches=1,
             trace_slice_batches=1, check_batch_share=1.0)
    return cell


def test_a_cut_down_cell_is_correct_and_reports_its_metrics(cell,
                                                            monkeypatch):
    from pywfa_tpu_torch import batch, spans
    monkeypatch.setattr(batch, "_PROF", batch._PROF)  # restored after
    monkeypatch.setenv("PYWFA_STREAM_GC", "1")
    c = small(cell)
    pats, _ = driver().make_pool(c, np.random.default_rng(3))
    # every batch spans several of the CLI's length buckets
    assert len({bucketing._bucket_len(len(p), bucketing.DEFAULT_SCHEDULE)
                for p in pats[:32]}) >= 3
    out = harness.run_cell(c, 2**31 + 11, 0.3, False, "cpu",
                           time.perf_counter())["result"]
    assert out["correct"] and out["failed"] == 0, out["compared"]
    assert set(out["metrics"]) == {"alignments_per_s", "setup_s"}
    spans.reset()
    out = harness.run_cell(c, 2**31 + 12, 0.3, True, "cpu",
                           time.perf_counter())["result"]
    assert out["correct"], out["compared"]
    assert {"dispatch_self_ms.stream", "finish_self_ms.stream",
            "escalated_share.stream", "walk_self_ms.stream",
            "walk_steps.stream"} <= set(out["metrics"])
    spans.reset()


def test_the_int8_reference_is_not_correct_on_the_cut_down_cell(cell):
    from wfabench import check, control
    nums = control.int8_reading(small(cell), 5, "cpu")
    assert nums["judged"] == 64
    assert nums["wrong_score"] > 0
    assert nums["wrong_answers"] == nums["judged"]
    assert not check.verdict(nums)
