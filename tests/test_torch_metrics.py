"""The port's fused loop under all five distance metrics, against the JAX
package.

For affine2p, gap-linear, edit (levenshtein) and indel, on both spans
(ends-free with match 0) and in both scopes, the same seeded inputs go
through the plain fused loop, the Pallas kernel in interpret mode and the
XLA engine: status, final_s, end_k, end_off and the whole choices tensor
must be equal. The stages around the loop and the API under these metrics
are in `tests/test_torch_metrics_api.py`.

Everything is an integer: tolerance zero.
"""
import dataclasses

import numpy as np
import pytest
import torch

from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.ops import engine as E
from pywfa_tpu_torch import batch as PB
from pywfa_tpu_torch.ops import config as C
from tests.corpus import mutate, random_pairs
from tests.test_torch_engine import README_PAIRS, window_pairs
from tests.test_torch_fused_loop import (KEYS, _all_three,
                                         _assert_equal_keys, _encode)

torch.set_num_threads(1)

METRICS = ("affine2p", "linear", "levenshtein", "indel")
ALL_METRICS = ("affine",) + METRICS
FIELDS = ("status", "score", "ops", "end_v", "end_h", "wf_score", "dropped")


def long_gap_pairs(seed, n, lo, hi, gap_lo, gap_hi):
    """Pairs at 2% divergence whose text also lost or gained one run of
    gap_lo..gap_hi bases: the gaps the second affine piece is for."""
    import random
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        L = rng.randint(lo, hi)
        p = "".join(rng.choice("ACGT") for _ in range(L))
        t = mutate(rng, p, 0.02, 0.0)
        g = rng.randint(gap_lo, gap_hi)
        at = rng.randint(5, max(5, len(t) - g - 5))
        if rng.random() < 0.5:
            t = t[:at] + t[at + g:]
        else:
            t = t[:at] + "".join(rng.choice("ACGT") for _ in range(g)) + t[at:]
        out.append((p.encode(), t.encode()))
    return out


PAIRS = {
    "div5": random_pairs(51, 10, 20, 90, 0.05, 0.05, as_bytes=True)
    + README_PAIRS,
    "div25": random_pairs(52, 8, 30, 90, 0.15, 0.1, unrelated=0.25,
                          as_bytes=True),
    "gaps": long_gap_pairs(53, 8, 60, 90, 12, 30),
}
# frees row (pattern begin, pattern end, text begin, text end)
EF_PAIRS = {
    "zero": (PAIRS["div5"], (0, 0, 0, 0)),
    "text": (window_pairs(54, 8, 30, 70, 10), (0, 0, 10, 10)),
    "all": (window_pairs(55, 6, 30, 60, 6) + README_PAIRS, (5, 6, 7, 4)),
}


def _attr(metric, span="end-to-end", scope="full", frees=(0, 0, 0, 0)):
    return WavefrontAligner(
        backend="numpy", distance=metric, span=span, scope=scope,
        pattern_begin_free=frees[0], pattern_end_free=frees[1],
        text_begin_free=frees[2], text_end_free=frees[3])._attributes()


def _inputs(attr, pairs, caps, record=True):
    """(cfg, pat, txt, plen, tlen, frees): the batch path's first rung or
    its terminal one, frees clamped per pair."""
    maxLp = max(len(p) for p, _ in pairs)
    maxLt = max(len(t) for _, t in pairs)
    if caps == "full":
        cfg = E.full_config(attr, maxLp, maxLt, record_choices=record)
    else:
        W = E._round_up(PB._band_for_score(attr, 96, maxLp, maxLt), 128)
        cfg = E.full_config(attr, maxLp, maxLt, W=W, S_cap=96,
                            record_choices=record)
    pat, txt, plen, tlen = _encode(cfg, pairs)
    frees = PB._build_frees(attr, len(plen), plen, tlen)
    return cfg, pat, txt, plen, tlen, frees


@pytest.mark.parametrize("case", sorted(PAIRS))
@pytest.mark.parametrize("caps", ["full", "rung1"])
@pytest.mark.parametrize("metric", METRICS)
def test_plain_loop_matches_pallas_and_xla(metric, caps, case):
    cfg, *inputs = _inputs(_attr(metric), PAIRS[case], caps)
    port, xla, pallas = _all_three(cfg, *inputs)
    _assert_equal_keys(port, xla, True)
    _assert_equal_keys(port, pallas, True)
    status = port["status"].numpy()
    if caps == "full" and metric != "indel":
        assert (status == C.ST_END_REACHED).all()
    assert (status == C.ST_END_REACHED).any()


@pytest.mark.parametrize("case", sorted(EF_PAIRS))
@pytest.mark.parametrize("caps", ["full", "rung1"])
@pytest.mark.parametrize("metric", METRICS)
def test_ends_free_plain_loop_matches_pallas_and_xla(metric, caps, case):
    pairs, row = EF_PAIRS[case]
    cfg, *inputs = _inputs(_attr(metric, "ends-free", frees=row), pairs, caps)
    port, xla, pallas = _all_three(cfg, *inputs)
    _assert_equal_keys(port, xla, True)
    _assert_equal_keys(port, pallas, True)
    assert (port["status"].numpy() == C.ST_END_REACHED).any()


@pytest.mark.parametrize("span,case", [("end-to-end", "zero"),
                                       ("ends-free", "all")])
@pytest.mark.parametrize("metric", METRICS)
def test_score_only_plain_loop_matches_pallas_and_xla(metric, span, case):
    pairs, row = EF_PAIRS[case]
    if span == "end-to-end":
        row = (0, 0, 0, 0)
    cfg, *inputs = _inputs(_attr(metric, span, frees=row), pairs, "rung1",
                           record=False)
    port, xla, pallas = _all_three(cfg, *inputs)
    _assert_equal_keys(port, xla, False)
    _assert_equal_keys(port, pallas, False)
    full = _all_three(dataclasses.replace(cfg, record_choices=True),
                      *inputs)[0]
    _assert_equal_keys(port, {k: full[k].numpy() for k in KEYS[:4]}, False)


@pytest.mark.parametrize("metric", METRICS)
def test_max_steps_and_unreachable_match_xla(metric):
    """The user step cap ends pairs with ST_MAX_STEPS at the same score in
    both packages."""
    cfg, *inputs = _inputs(_attr(metric), PAIRS["div25"], "full")
    port, xla, pallas = _all_three(cfg, *inputs, max_steps=5)
    _assert_equal_keys(port, xla, True)
    _assert_equal_keys(port, pallas, True)
    assert (port["status"].numpy() == C.ST_MAX_STEPS).any()


@pytest.mark.parametrize("metric", METRICS)
def test_undersized_band_reports_overflow_w(metric):
    """A 128-diagonal band cannot hold unrelated pairs: the port flags
    ST_OVERFLOW_W where the XLA engine does, edit and indel included,
    whose step flags it without the null-step term."""
    pairs = random_pairs(56, 8, 60, 120, 0.1, 0.1, unrelated=1.0,
                         as_bytes=True) + PAIRS["div5"][:4]
    attr = _attr(metric)
    cfg = dataclasses.replace(E.full_config(attr, 120, 120), W=128)
    pat, txt, plen, tlen = _encode(cfg, pairs)
    frees = np.zeros((len(plen), 4), dtype=np.int32)
    port, xla, _ = _all_three(cfg, pat, txt, plen, tlen, frees)
    _assert_equal_keys(port, xla, True)
    status = port["status"].numpy()
    assert (status == C.ST_OVERFLOW_W).any()
    assert (status == C.ST_END_REACHED).any()
