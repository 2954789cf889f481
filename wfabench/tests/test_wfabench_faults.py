"""A run with the timed path broken underneath comes out not correct: the
harness is driven on the CPU past its look for a card, once for each fault
a cell can have: half of a batch's answers left out, an answer's score
altered where it is produced, and an op of an answer altered."""
import dataclasses
import time

import pytest

from wfabench import harness

STREAMS = ["illumina150-full-stream", "ont10k-full-stream"]


def flip(ops: str) -> str:
    """The first op lost (not undone when an escalated pair's answer
    passes the broken step twice)."""
    return ops[1:]


def run(cell):
    """The result line, with the wrong answers by kind beside it."""
    out = harness.run_cell(cell, 77, 0.5, False, "cpu", time.perf_counter())
    res = out["result"]
    assert res["compared"]["wrong_answers"]["value"] == res["failed"]
    return dict(res, kinds=out["judged"])


def break_finish(monkeypatch, change):
    from pywfa_tpu_torch import batch
    orig = batch.align_pairs_finish

    def broken(h):
        return change(orig(h))
    monkeypatch.setattr(batch, "align_pairs_finish", broken)


@pytest.mark.parametrize("name", STREAMS)
def test_half_the_batch_left_out(name, small_cell, monkeypatch):
    break_finish(monkeypatch, lambda res: res[:len(res) // 2])
    res = run(small_cell(name))
    assert not res["correct"] and res["kinds"]["missing"] > 0


@pytest.mark.parametrize("name", STREAMS)
def test_a_score_altered(name, small_cell, monkeypatch):
    def change(res):
        if res:
            res[0] = dataclasses.replace(res[0], score=res[0].score - 2)
        return res
    break_finish(monkeypatch, change)
    res = run(small_cell(name))
    assert not res["correct"] and res["kinds"]["wrong_score"] > 0


@pytest.mark.parametrize("name", STREAMS)
def test_an_op_altered(name, small_cell, monkeypatch):
    def change(res):
        if res:
            res[-1] = dataclasses.replace(res[-1], ops=flip(res[-1].ops))
        return res
    break_finish(monkeypatch, change)
    res = run(small_cell(name))
    assert not res["correct"] and res["kinds"]["wrong_cigar"] > 0


@pytest.mark.parametrize("fault", ["score", "op"])
def test_the_call_broken(fault, small_cell, monkeypatch):
    from pywfa_tpu_torch import engine_adapter
    orig = engine_adapter.align_pairs

    def broken(*a, **kw):
        res = orig(*a, **kw)
        r = res[0]
        res[0] = (dataclasses.replace(r, score=r.score - 2)
                  if fault == "score"
                  else dataclasses.replace(r, ops=flip(r.ops)))
        return res
    monkeypatch.setattr(engine_adapter, "align_pairs", broken)
    res = run(small_cell("illumina150-api-call"))
    key = "wrong_score" if fault == "score" else "wrong_cigar"
    assert not res["correct"] and res["kinds"][key] > 0
