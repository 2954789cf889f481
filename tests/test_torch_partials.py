"""Partial results of the port against the JAX package: dropped pairs,
heuristic dead ends and WF-extension mode, assembled from the device walk
with no pair sent to the host oracle.

The twins of tests/test_partials_native.py: the same corpora through
`pywfa_tpu_torch.batch.align_pairs(device="cpu")`, `pywfa_tpu.batch.
align_pairs` and the scalar oracle, every BatchResult field equal
(tolerance zero), `oracle_fallbacks` all zero.
"""
import dataclasses
import random

import pytest
import torch

from pywfa_tpu import batch as BT
from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.attributes import HeuristicParams
from pywfa_tpu.constants import HeuristicStrategy as HS
from pywfa_tpu.oracle import OracleAligner
from pywfa_tpu_torch import BatchWavefrontAligner
from pywfa_tpu_torch import batch as PB
from pywfa_tpu_torch.ops import config as C
from tests.corpus import mutate, random_pairs

torch.set_num_threads(1)

FIELDS = ("status", "score", "ops", "end_v", "end_h", "wf_score", "dropped")


def _pairs(seed, n, sub, ind, unrelated=0.2, lo=40, hi=150):
    return random_pairs(seed, n, lo, hi, sub, ind, unrelated=unrelated,
                        as_bytes=True)


def _attr(heur=None, distance="affine", scope="full", span="end-to-end",
          **kw):
    attr = WavefrontAligner(backend="numpy", distance=distance, scope=scope,
                            span=span, **kw)._attributes()
    if heur is not None:
        attr = dataclasses.replace(attr, heuristic=heur)
    return attr


def _fields(results):
    return [tuple(getattr(r, f) for f in FIELDS) for r in results]


def check_parity(attr, pairs, reference=True):
    """The port's results equal the oracle's (and the reference batch
    path's) with no pair answered by the host oracle; returns them."""
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    PB.oracle_fallbacks.update(dict.fromkeys(PB.oracle_fallbacks, 0))
    port = PB.align_pairs(C.attributes_from_reference(attr), pats, txts,
                          device="cpu")
    assert PB.oracle_fallbacks == dict.fromkeys(PB.oracle_fallbacks, 0)
    orc = OracleAligner(attr)
    assert _fields(port) == _fields([orc.align(p, t) for p, t in pairs])
    if reference:
        assert _fields(port) == _fields(BT.align_pairs(attr, pats, txts))
    return port


@pytest.mark.parametrize("distance", ["affine", "affine2p"])
@pytest.mark.parametrize("scope", ["full", "score"])
def test_zdrop(distance, scope):
    h = HeuristicParams(strategy=HS.ZDROP, zdrop=15, steps_between_cutoffs=1)
    res = check_parity(_attr(h, distance=distance, scope=scope),
                       _pairs(11, 24, sub=0.35, ind=0.15))
    assert sum(r.dropped for r in res) >= 4


def test_zdrop_ends_free():
    h = HeuristicParams(strategy=HS.ZDROP, zdrop=10, steps_between_cutoffs=2)
    attr = _attr(h, span="ends-free", pattern_begin_free=12,
                 pattern_end_free=12, text_begin_free=12, text_end_free=12)
    res = check_parity(attr, _pairs(12, 16, sub=0.5, ind=0.25))
    assert sum(r.dropped for r in res) >= 3


def test_zdrop_with_match_bonus_ends_free():
    """A drop under ends-free with a match bonus: the walk stops at a
    boundary seed."""
    h = HeuristicParams(strategy=HS.ZDROP, zdrop=12, steps_between_cutoffs=1)
    attr = _attr(h, span="ends-free", match=-2, mismatch=5, gap_opening=7,
                 gap_extension=2, pattern_begin_free=6, pattern_end_free=6,
                 text_begin_free=9, text_end_free=9)
    res = check_parity(attr, _pairs(17, 16, sub=0.4, ind=0.2))
    assert sum(r.dropped for r in res) >= 3


def test_xdrop_dead_end():
    """X-drop prunes to extinction: no end position, an empty partial."""
    h = HeuristicParams(strategy=HS.XDROP, xdrop=8, steps_between_cutoffs=1)
    res = check_parity(_attr(h), _pairs(13, 16, sub=0.4, ind=0.2,
                                        unrelated=0.5))
    assert sum(r.dropped for r in res) >= 3


def test_wfadaptive_dead_end():
    h = HeuristicParams(strategy=HS.WFADAPTIVE, min_wavefront_length=3,
                        max_distance_threshold=8, steps_between_cutoffs=1)
    check_parity(_attr(h), _pairs(14, 16, sub=0.3, ind=0.2, unrelated=0.4))


@pytest.mark.parametrize("scope", ["full", "score"])
def test_extension_mode(scope):
    """WF-extension: begin frees 0, end frees the lengths, and the
    completed alignment trimmed to its best-scoring prefix."""
    rng = random.Random(15)
    pairs = []
    for _ in range(12):
        p = "".join(rng.choice("ACGT") for _ in range(rng.randint(40, 150)))
        t = mutate(rng, p, 0.25, 0.1) + "".join(
            rng.choice("ACGT") for _ in range(rng.randint(0, 50)))
        pairs.append((p.encode(), t.encode()))
    attr = _attr(span="ends-free", scope=scope, pattern_begin_free=0,
                 pattern_end_free=1, text_begin_free=0, text_end_free=1)
    attr = dataclasses.replace(attr, form=dataclasses.replace(
        attr.form, extension=True))
    res = check_parity(attr, pairs)
    if scope == "full":
        assert sum(r.status == 1 for r in res) >= 2  # trims occur


DROP_GRID = [
    HeuristicParams(strategy=HS.ZDROP, zdrop=15, steps_between_cutoffs=1),
    HeuristicParams(strategy=HS.XDROP, xdrop=15, steps_between_cutoffs=2),
    HeuristicParams(strategy=HS.WFADAPTIVE | HS.ZDROP,
                    min_wavefront_length=5, max_distance_threshold=20,
                    zdrop=25, steps_between_cutoffs=1),
    HeuristicParams(strategy=HS.BANDED_STATIC | HS.ZDROP, min_k=-15,
                    max_k=15, zdrop=15, steps_between_cutoffs=1),
    HeuristicParams(strategy=HS.WFADAPTIVE | HS.XDROP,
                    min_wavefront_length=5, max_distance_threshold=20,
                    xdrop=10, steps_between_cutoffs=1),
]


@pytest.mark.parametrize("ci", range(len(DROP_GRID)))
def test_drop_grid_without_the_oracle(ci):
    """The pruning x drop strategy grid: every pair completes or comes
    back partial, equal to the oracle's, none through the host oracle."""
    attr = _attr(DROP_GRID[ci], distance="affine2p" if ci % 2 else "affine")
    pairs = _pairs(100 + ci, 32, sub=0.25, ind=0.08, unrelated=0.25, lo=50,
                   hi=150)
    res = check_parity(attr, pairs, reference=False)
    assert all(r.status in (0, 1) for r in res)
    if ci in (0, 3):
        # the z-drop configurations drop the unrelated pairs of this corpus
        assert sum(r.dropped for r in res) > len(res) // 4


def test_dropped_pairs_through_the_stream():
    """The slice as a whole: BatchWavefrontAligner.align_stream with a
    heuristic, batches whose dropped pairs are assembled on the way."""
    h = HeuristicParams(strategy=HS.ZDROP, zdrop=20, steps_between_cutoffs=1)
    attr = _attr(h)
    aligner = BatchWavefrontAligner(span="end-to-end", device="cpu")
    aligner._attr = C.attributes_from_reference(attr)
    batches = [_pairs(16 + i, 16, sub=0.3, ind=0.1, unrelated=0.3, lo=60)
               for i in range(3)]
    PB.oracle_fallbacks.update(dict.fromkeys(PB.oracle_fallbacks, 0))
    out = list(aligner.align_stream(
        ([p.decode() for p, _ in b], [t.decode() for _, t in b])
        for b in batches))
    assert not any(PB.oracle_fallbacks.values())
    orc = OracleAligner(attr)
    for b, res in zip(batches, out):
        assert _fields(res) == _fields([orc.align(p, t) for p, t in b])
    assert sum(r.dropped for res in out for r in res) >= 6
