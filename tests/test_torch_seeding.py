"""Ends-free alignment with a match bonus in the fused score loop's plain
torch version against the JAX package.

With match != 0 WF0 is the single cell k = 0 and the boundary is seeded at
every score divisible by -match (`engine._endsfree_seed`); on a null step
the seeds form a wavefront of their own. `align_batch_fused_loop_ref` is
compared with the Pallas kernel in interpret mode and with the XLA engine,
byte for byte: status, final_s, end_k, end_off and the choices tensor.
"""
import dataclasses

import numpy as np
import pytest

from pywfa_tpu_torch.ops import config as C
from pywfa_tpu_torch.ops import fused_loop as TFL
from tests.corpus import random_pairs
from tests.test_torch_engine import window_pairs
from tests.test_torch_heuristics import (HEURISTICS, assert_equal, build,
                                         pairs_for, run_pallas, run_port,
                                         run_xla)

# distance -> the match bonus and the other penalties
PENALTIES = {
    "affine": dict(match=-2, mismatch=5, gap_opening=7, gap_extension=2),
    "affine2p": dict(match=-3, mismatch=4, gap_opening=6, gap_extension=2),
    "linear": dict(match=-1, mismatch=4, gap_extension=3),
}
# begin frees of zero, below the scores' reach and past it (the frees are
# clamped to each pair's lengths)
FREES = {"zero": (0, 5, 0, 5), "small": (4, 4, 8, 8), "large": (60, 6, 90, 6),
         "pattern": (7, 0, 0, 3)}


def seeded_pairs(seed):
    """Divergent pairs, reads inside windows (the alignment starts off the
    corner) and windows inside reads."""
    wins = window_pairs(seed, 4, 30, 60, 10)
    return (pairs_for(seed)[:6] + wins + [(t, p) for p, t in wins[:2]])


@pytest.mark.parametrize("scope", ["full", "score"])
@pytest.mark.parametrize("frees", sorted(FREES))
@pytest.mark.parametrize("metric", sorted(PENALTIES))
def test_seeding_matches_pallas_and_xla(metric, frees, scope):
    record = scope == "full"
    seed = 400 + 5 * sorted(PENALTIES).index(metric)
    inputs = build(seeded_pairs(seed), "ends-free", FREES[frees], metric,
                   None, record=record, **PENALTIES[metric])
    assert TFL.variant(C.from_reference(inputs[0])).endswith(
        "endsfreeseed" + ("" if record else "_score"))
    port = run_port(*inputs)
    assert_equal(port, run_xla(*inputs), record, "xla")
    assert_equal(port, run_pallas(*inputs), record, "pallas")
    if record and frees != "zero":
        assert (port["choices"] == C.MSRC_SEED).any()


@pytest.mark.parametrize("metric", sorted(PENALTIES))
@pytest.mark.parametrize("name", ["zdrop", "wfadaptive", "banded_adaptive"])
def test_seeding_under_a_heuristic(name, metric):
    """The wavefront of the seeds alone keeps the heuristics' cadence
    ticking: unrelated pairs walk through null steps under a cutoff with
    steps_between_cutoffs > 1."""
    h = dataclasses.replace(HEURISTICS[name], steps_between_cutoffs=2,
                            zdrop=14)
    inputs = build(seeded_pairs(420), "ends-free", (5, 5, 9, 5), metric, h,
                   **PENALTIES[metric])
    port = run_port(*inputs)
    assert_equal(port, run_xla(*inputs), True, "xla")
    assert_equal(port, run_pallas(*inputs), True, "pallas")


def test_seed_past_the_band_reports_overflow_w():
    """Frees past the band: at the score whose seed leaves it the pair
    reports ST_OVERFLOW_W, as the XLA engine's step does (the Pallas
    kernel clips the band silently). Unrelated pairs score that far."""
    pairs = random_pairs(430, 8, 100, 120, 0.3, 0.2, unrelated=0.8,
                         as_bytes=True)
    cfg, pat, txt, plen, tlen, frees = build(
        pairs, "ends-free", (0, 0, 90, 0), "affine", None,
        **PENALTIES["affine"])
    small = dataclasses.replace(cfg, W=128)
    port = run_port(small, pat, txt, plen, tlen, frees)
    assert_equal(port, run_xla(small, pat, txt, plen, tlen, frees), True,
                 "xla")
    status = port["status"].numpy()
    over = status == C.ST_OVERFLOW_W
    assert over.any()
    # an overflowed pair reports no final score; at full width the same
    # pairs reach their end
    assert (port["final_s"].numpy()[over] == 0).all()
    wide = run_port(cfg, pat, txt, plen, tlen, frees)
    assert (wide["status"].numpy() == C.ST_END_REACHED).all()
