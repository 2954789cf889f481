"""A batch of mixed lengths, as a read set streams it, on the CPU.

The pairs of one batch spread over several of the align CLI's length
buckets (`parallel.bucketing.bucket_pairs`); the batch runs as one, sized
by its longest pair. The answers are the plain reference's
(`wfabench/reference`: the optimal gap-affine cost by dynamic programming,
and an op string that aligns its pair at that cost), come back in input
order, and are byte for byte those of each length bucket aligned as a
batch of its own, one shot or segmented. Tolerance: zero.
"""
import numpy as np
import pytest
import torch

from pywfa_tpu_torch import BatchWavefrontAligner
from pywfa_tpu_torch import batch as PB
from pywfa_tpu_torch.align import WavefrontAligner
from pywfa_tpu_torch.parallel.bucketing import bucket_pairs
from wfabench import reads
from wfabench.reference.cigar import judge_ops
from wfabench.reference.dp import affine_costs

torch.set_num_threads(1)

PROFILE = {"model": "profile", "error_rate": 0.05, "ratio": [23, 31, 46],
           "size_set": 1, "sizes_seed": 0}


def mixed_batch(n=48, median=110, sigma=0.7, longest=480, seed=17):
    """n pairs of log-normal lengths (30 to `longest` bp) at 5% error,
    substitutions, insertions and deletions 23:31:46, in drawn order."""
    rng = np.random.default_rng(seed)
    lens = np.clip(np.round(np.exp(rng.normal(np.log(median), sigma, n))),
                   30, longest).astype(int)
    pairs = [reads.make_pairs(dict(PROFILE, length=int(L)), 1, rng)
             for L in lens]
    return [p[0][0] for p in pairs], [t[0] for _, t in pairs]


PATS, TXTS = mixed_batch()


def attr_of(**kw):
    kw.setdefault("span", "end-to-end")
    return WavefrontAligner(backend="numpy", **kw)._attributes()


def check_against_reference(pats, txts, results):
    cost = affine_costs(pats, txts, 4, 6, 2)
    assert [r.status for r in results] == [0] * len(pats)
    assert [r.score for r in results] == (-cost).tolist()
    aligns, got = judge_ops(pats, txts, [r.ops.encode() for r in results],
                            4, 6, 2)
    assert aligns.all() and (got == cost).all()


def check_each_bucket_alone(attr, pats, txts, res, wildcard=None):
    """Every bucket of the CLI's schedule, aligned as a batch of its own,
    answers as its pairs did inside the mixed batch."""
    for idx in bucket_pairs(pats, txts).values():
        alone = PB.align_pairs(attr, [pats[i] for i in idx],
                               [txts[i] for i in idx], wildcard,
                               device="cpu")
        assert [res[i] for i in idx] == alone


def test_the_batch_spans_several_buckets():
    groups = bucket_pairs(PATS, TXTS)
    assert len({max(k) for k in groups}) >= 3
    assert sorted(i for g in groups.values() for i in g) == list(
        range(len(PATS)))


@pytest.mark.parametrize("entry", ["align", "align_stream"])
def test_mixed_batch_against_the_reference(entry):
    aligner = BatchWavefrontAligner(device="cpu", span="end-to-end")
    if entry == "align":
        res = aligner.align(PATS, TXTS)
    else:
        # the batch twice in a stream, the second reversed: each comes back
        # whole and in its own input order
        out = list(aligner.align_stream(
            [(PATS, TXTS), (PATS[::-1], TXTS[::-1])], depth=1))
        assert len(out) == 2
        assert out[1] == out[0][::-1]
        res = out[0]
    assert len(res) == len(PATS)
    check_against_reference(PATS, TXTS, res)


def test_same_answers_as_each_bucket_alone():
    attr = attr_of()
    res = PB.align_pairs(attr, PATS, TXTS, device="cpu")
    check_each_bucket_alone(attr, PATS, TXTS, res)


def test_a_segmented_mixed_batch(monkeypatch):
    """With the record cap under the mixed batch's first rung, the batch
    runs segmented, and its answers do not move."""
    pats, txts = mixed_batch(n=48, median=80, sigma=0.6)
    attr = attr_of()
    want = PB.align_pairs(attr, pats, txts, device="cpu")
    h = PB.align_pairs_dispatch(attr, pats, txts, device="cpu")
    monkeypatch.setattr(PB, "CHOICES_BYTES_CAP",
                        h.cfg.S_cap * h.B * h.cfg.W - 1)
    before = dict(PB.segmented_runs)
    res = PB.align_pairs(attr, pats, txts, device="cpu")
    assert PB.segmented_runs["runs"] > before["runs"]
    assert PB.segmented_runs["replays"] > before["replays"]
    assert res == want
    check_against_reference(pats, txts, res)


OPTIONS = {
    "indel": dict(distance="indel"),
    "levenshtein": dict(distance="levenshtein"),
    "linear": dict(distance="linear"),
    "affine": dict(distance="affine"),
    "affine2p": dict(distance="affine2p"),
    "affine-score": dict(distance="affine", scope="score"),
    "ends-free": dict(span="ends-free", pattern_begin_free=20,
                      pattern_end_free=20, text_begin_free=20,
                      text_end_free=20),
    "adaptive": dict(heuristic="adaptive"),
    "xdrop": dict(heuristic="X-drop", xdrop=60),
    "wildcard": dict(wildcard="N"),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_other_options_answer_as_each_bucket_alone(name):
    pats, txts = mixed_batch(n=40, median=90, longest=300, seed=5)
    assert len(bucket_pairs(pats, txts)) >= 2
    attr = attr_of(**OPTIONS[name])
    wildcard = ord("N") if name == "wildcard" else None
    res = PB.align_pairs(attr, pats, txts, wildcard, device="cpu")
    assert all(r.status == 0 for r in res)
    check_each_bucket_alone(attr, pats, txts, res, wildcard)
