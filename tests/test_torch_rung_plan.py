"""The batch layer's rung plan (`batch._plan_rung`, `batch._next_caps`),
read without aligning anything.

Each benchmark cell's first batch, made as its driver makes it, gets the
rungs the batch path has always given it: one shot at 150 bp, a one-shot
first rung and a segmented second at 10 kb, a segmented first rung at the
log-normal set's 60 kb read, and the API call's 16-pair batch at 256 bp.
The ladder is walked to the worst-case caps under every metric, scope and
span; past a segmented rung the band grows 4x with no score cap; the one
shot or segmented choice flips exactly at the memory mode's record cap.

A rung is written (segmented, W, S_cap, ops_out, use_lcp_table,
record_choices, at_full_caps); a segmented rung's S_cap is its segment
length K.
"""
import functools

import numpy as np
import pytest
import torch

import pywfa_tpu_torch as P
from pywfa_tpu_torch import batch as PB
from pywfa_tpu_torch import engine_adapter as EA
from pywfa_tpu_torch.attributes import validate_alignment
from pywfa_tpu_torch.ops import config as C
from wfabench import manifest
from wfabench.drivers import call, lengths, stream
from wfabench.program import aligner_kwargs

CPU = torch.device("cpu")

# (B, Lp, Lt, the ladder) of each cell's first batch
CELLS = {
    "illumina150-full-stream": (4096, 160, 160, [
        (0, 256, 96, 32, 1, 1, 0), (0, 384, 384, 128, 1, 1, 0),
        (0, 384, 649, 0, 1, 1, 1)]),
    "ont10k-full-stream": (512, 10240, 10240, [
        (0, 1792, 1664, 554, 1, 1, 0), (1, 6784, 154, 2218, 0, 0, 0),
        (1, 20608, 64, 0, 0, 0, 1)]),
    "ont-lognormal-lengths-stream": (512, 61440, 61440, [
        (1, 9984, 105, 3306, 0, 0, 0), (1, 39936, 64, 81924, 0, 0, 0),
        (1, 123008, 64, 0, 0, 0, 1)]),
    "illumina150-api-call": (16, 256, 256, [
        (0, 256, 96, 32, 1, 1, 0), (0, 512, 384, 128, 1, 1, 0),
        (0, 640, 1033, 0, 1, 1, 1)]),
}

# the ladder of the 150 bp and the 10 kb cell's first batch under each
# metric and scope (pywfa's default penalties); both spans give the same
FULL_150 = {
    "affine": [(0, 256, 96, 32, 1, 1, 0), (0, 384, 384, 128, 1, 1, 0),
               (0, 384, 649, 0, 1, 1, 1)],
    "affine2p": [(0, 384, 96, 32, 1, 1, 0), (0, 512, 384, 128, 1, 1, 0),
                 (0, 512, 649, 0, 1, 1, 1)],
    "linear": [(0, 128, 96, 32, 1, 1, 0), (0, 384, 384, 128, 1, 1, 0),
               (0, 384, 643, 0, 1, 1, 1)],
    "levenshtein": [(0, 256, 96, 32, 1, 1, 0), (0, 384, 163, 0, 1, 1, 1)],
    "indel": [(0, 256, 96, 32, 1, 1, 0), (0, 384, 163, 0, 1, 1, 1)],
}
SEG_10K = [(1, 20608, 64, 0, 0, 0, 1)]
FULL_10K = {
    "affine": [(0, 1792, 1664, 554, 1, 1, 0),
               (1, 6784, 154, 2218, 0, 0, 0)] + SEG_10K,
    "affine2p": [(0, 3456, 1664, 554, 1, 1, 0),
                 (1, 13440, 78, 2218, 0, 0, 0)] + SEG_10K,
    "linear": [(0, 1792, 1664, 554, 1, 1, 0),
               (1, 6784, 154, 2218, 0, 0, 0)] + SEG_10K,
    "levenshtein": [(0, 3456, 1664, 554, 1, 1, 0),
                    (1, 13440, 78, 2218, 0, 0, 0)] + SEG_10K,
    "indel": [(0, 3456, 1664, 554, 1, 1, 0),
              (1, 13440, 78, 2218, 0, 0, 0)] + SEG_10K,
}
# the score-only scope records nothing, so it never runs segmented
SCORE_10K = {
    "affine": [(0, 1792, 1664, 0, 1, 0, 0), (0, 6784, 6656, 0, 1, 0, 0),
               (0, 20608, 26624, 0, 1, 0, 0), (0, 20608, 40969, 0, 1, 0, 1)],
    "affine2p": [(0, 3456, 1664, 0, 1, 0, 0), (0, 13440, 6656, 0, 1, 0, 0),
                 (0, 20608, 26624, 0, 1, 0, 0),
                 (0, 20608, 40969, 0, 1, 0, 1)],
    "linear": [(0, 1792, 1664, 0, 1, 0, 0), (0, 6784, 6656, 0, 1, 0, 0),
               (0, 20608, 26624, 0, 1, 0, 0), (0, 20608, 40963, 0, 1, 0, 1)],
    "levenshtein": [(0, 3456, 1664, 0, 1, 0, 0),
                    (0, 13440, 6656, 0, 1, 0, 0),
                    (0, 20608, 10243, 0, 1, 0, 1)],
    "indel": [(0, 3456, 1664, 0, 1, 0, 0), (0, 13440, 6656, 0, 1, 0, 0),
              (0, 20608, 10243, 0, 1, 0, 1)],
}
LADDERS = {
    ("illumina150-full-stream", "full"): FULL_150,
    # the score-only scope: no op output, no record
    ("illumina150-full-stream", "score"): {
        m: [r[:3] + (0, 1, 0, r[6]) for r in lad]
        for m, lad in FULL_150.items()},
    ("ont10k-full-stream", "full"): FULL_10K,
    ("ont10k-full-stream", "score"): SCORE_10K,
}

# the memory modes' shares of the record cap
DIVISOR = {"high": 1, "medium": 4, "low": 16, "biwfa": 64}


@functools.lru_cache(maxsize=None)
def _first_batch(name):
    """(the cell's attributes, its first batch's patterns and texts), as
    the cell's driver makes them from seed 0."""
    cell = manifest.resolve(manifest.load(), name)
    kw = aligner_kwargs(cell["config"], cell["traffic"])
    rng = np.random.default_rng(0)
    if name == "illumina150-api-call":
        pats, txts = call.make_pool(cell, rng)
        return P.WavefrontAligner(device="cpu", **kw)._attributes(), \
            pats[:1], txts[:1]
    drv = lengths if cell["traffic"]["driver"] == "lengths" else stream
    pats, txts = drv.make_pool(cell, rng)
    B = cell["config"]["batch_pairs"]
    return P.BatchWavefrontAligner(device="cpu", **kw)._attr, pats[:B], \
        txts[:B]


def _handle(attr, pats, txts):
    """The handle the dispatch would make: a call's single pair bucketed
    as engine_adapter.align_single buckets it."""
    if len(pats) > 1:
        return PB._prepare(attr, pats, txts, None, CPU)
    plen, tlen = len(pats[0]), len(txts[0])
    return PB._prepare(validate_alignment(attr, plen, tlen), pats, txts,
                       None, CPU,
                       Lp=EA._bucket_len(plen, EA.DEFAULT_SCHEDULE),
                       Lt=EA._bucket_len(tlen, EA.DEFAULT_SCHEDULE))


def _key(rung):
    c = rung.cfg
    return (int(rung.segmented), c.W, c.S_cap, c.ops_out,
            int(c.use_lcp_table), int(c.record_choices),
            int(rung.at_full_caps))


def _ladder(h):
    """Every rung from the handle's to the worst-case caps, as the
    escalation walks it when all the batch's pairs overflow."""
    rungs = [h.rung]
    while not rungs[-1].at_full_caps:
        W, S_cap = PB._next_caps(rungs[-1], h.attr0, h.maxLp, h.maxLt)
        rungs.append(PB._plan_rung(h.attr0, h.Lp, h.Lt,
                                   min(h.maxLp, h.maxLt), h.B, h.wildcard,
                                   W, S_cap, True))
        assert len(rungs) < 8
    return rungs


@pytest.mark.parametrize("name", list(CELLS))
def test_each_cells_first_batch_gets_its_rungs(name):
    B, Lp, Lt, ladder = CELLS[name]
    h = _handle(*_first_batch(name))
    assert (h.B, h.Lp, h.Lt) == (B, Lp, Lt)
    rungs = _ladder(h)
    assert [_key(r) for r in rungs] == ladder
    for r in rungs:
        assert r.cfg.Lp == Lp and r.cfg.Lt == Lt
        assert r.choices_cap == 4 * 2**30
        assert (r.full_probe.W, r.full_probe.S_cap) == \
            (ladder[-1][1], C.full_config(h.attr0, Lp, Lt).S_cap)


@pytest.mark.parametrize("span", ["end-to-end", "ends-free"])
@pytest.mark.parametrize("scope", ["full", "score"])
@pytest.mark.parametrize("metric", list(FULL_150))
@pytest.mark.parametrize("cell", ["illumina150-full-stream",
                                  "ont10k-full-stream"])
def test_every_ladder_reaches_the_worst_case_caps(cell, metric, scope, span):
    _, pats, txts = _first_batch(cell)
    attr = P.WavefrontAligner(backend="numpy", distance=metric, scope=scope,
                              span=span)._attributes()
    rungs = _ladder(_handle(attr, pats, txts))
    assert [_key(r) for r in rungs] == LADDERS[cell, scope][metric]
    assert rungs[-1].at_full_caps and not any(
        r.at_full_caps for r in rungs[:-1])


@pytest.mark.parametrize("name,rung,W", [
    # 4 x 6784, bounded by the worst case's band
    ("ont10k-full-stream", 1, 20608),
    ("ont-lognormal-lengths-stream", 0, 4 * 9984),
    ("ont-lognormal-lengths-stream", 1, 123008)])
def test_past_a_segmented_rung_the_band_grows_4x_with_no_score_cap(name,
                                                                   rung, W):
    h = _handle(*_first_batch(name))
    r = _ladder(h)[rung]
    assert r.segmented
    assert PB._next_caps(r, h.attr0, h.maxLp, h.maxLt) == (W, None)


@pytest.mark.parametrize("mode", list(DIVISOR))
def test_the_choice_flips_exactly_at_the_record_cap(mode, monkeypatch):
    """The 10 kb cell's first rung keeps its record [S_cap, B, W] on the
    device while the mode's share of the cap holds it, and runs segmented
    one byte below."""
    _, pats, txts = _first_batch("ont10k-full-stream")
    attr = P.BatchWavefrontAligner(
        device="cpu", span="end-to-end", memory_mode=mode)._attr
    record = 1664 * 512 * 1792
    for cap, segmented in ((record, False), (record - 1, True)):
        monkeypatch.setattr(PB, "CHOICES_BYTES_CAP", cap * DIVISOR[mode])
        r = _handle(attr, pats, txts).rung
        assert r.choices_cap == cap and r.segmented == segmented
        assert (r.cfg.W, r.cfg.record_choices) == (1792, not segmented)
        # segmented: K scores a replayed block of 512 MiB at most
        assert r.cfg.S_cap == (585 if segmented else 1664)
