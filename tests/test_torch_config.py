"""The port's engine config is the reference's, field by field.

pywfa_tpu_torch.ops.config twins the configuration half of
pywfa_tpu.ops.engine; one config must drive both packages, so every
derived field, width and wire layout is compared exactly.
"""
import dataclasses

import pytest
import torch

from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.attributes import HeuristicParams
from pywfa_tpu.constants import HeuristicStrategy
from pywfa_tpu.ops import engine as E
from pywfa_tpu_torch.ops import config as C

torch.set_num_threads(1)

PENALTIES = [dict(), dict(match=-1, mismatch=5, gap_opening=7,
                          gap_extension=3), dict(mismatch=2, gap_opening=0,
                                                 gap_extension=1)]
LENGTHS = [(1, 1), (30, 45), (150, 150), (147, 203)]


def _attr(distance="affine", span="end-to-end", **kw):
    return WavefrontAligner(backend="numpy", distance=distance, span=span,
                            **kw)._attributes()


@pytest.mark.parametrize("pen", PENALTIES)
@pytest.mark.parametrize("lens", LENGTHS)
@pytest.mark.parametrize("span", ["end-to-end", "ends-free"])
def test_full_config_matches_reference(pen, lens, span):
    attr = _attr(span=span, **pen)
    for kw in (dict(), dict(W=200, S_cap=96), dict(Lp=160, Lt=224),
               dict(record_choices=False, wildcard=78)):
        ref = E.full_config(attr, *lens, **kw)
        port = C.full_config(attr, *lens, **kw)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert C.from_reference(ref) == port
        assert (port.n_comp, port.scope, port.kmin) == (
            ref.n_comp, ref.scope, ref.kmin)
        assert C.fused_widths(port) == E.fused_widths(ref)
        assert C.packed_widths(port) == E.packed_widths(ref)


@pytest.mark.parametrize("distance", ["indel", "levenshtein", "linear",
                                      "affine2p"])
def test_other_metrics_config_matches_reference(distance):
    attr = _attr(distance=distance)
    attr = dataclasses.replace(attr, heuristic=HeuristicParams(
        strategy=HeuristicStrategy.XDROP, xdrop=33))
    ref = E.full_config(attr, 90, 110)
    assert C.from_reference(ref) == C.full_config(attr, 90, 110)
    assert (C.from_reference(ref).scope, C.from_reference(ref).n_comp) == (
        ref.scope, ref.n_comp)


def test_worst_case_score_matches_reference():
    for distance in ("indel", "levenshtein", "linear", "affine", "affine2p"):
        pen = _attr(distance=distance).penalties
        for plen, tlen in LENGTHS:
            assert C._worst_case_score(pen, plen, tlen) == \
                E._worst_case_score(pen, plen, tlen)


@pytest.mark.parametrize("ops_out", [0, 32, 96, 200])
@pytest.mark.parametrize("S_cap", [96, 384, 40000])
def test_packed_layout_matches_reference(ops_out, S_cap):
    ref = dataclasses.replace(E.full_config(_attr(), 150, 150, S_cap=S_cap),
                              ops_out=ops_out)
    assert C.packed_layout(C.from_reference(ref)) == E.packed_layout(ref)


HEURISTICS = [
    HeuristicParams(strategy=HeuristicStrategy.WFADAPTIVE,
                    min_wavefront_length=7, max_distance_threshold=33,
                    steps_between_cutoffs=3),
    HeuristicParams(strategy=HeuristicStrategy.WFMASH,
                    min_wavefront_length=5, max_distance_threshold=12),
    HeuristicParams(strategy=HeuristicStrategy.XDROP, xdrop=17),
    HeuristicParams(strategy=HeuristicStrategy.ZDROP, zdrop=41,
                    steps_between_cutoffs=2),
    HeuristicParams(strategy=HeuristicStrategy.BANDED_STATIC, min_k=-7,
                    max_k=19),
    HeuristicParams(strategy=(HeuristicStrategy.BANDED_ADAPTIVE
                              | HeuristicStrategy.XDROP), min_k=-30,
                    max_k=4, xdrop=9),
]


@pytest.mark.parametrize("heur", HEURISTICS,
                         ids=[str(int(h.strategy)) for h in HEURISTICS])
@pytest.mark.parametrize("pen", PENALTIES[:2])
def test_heuristic_fields_come_across(heur, pen):
    """Every field of the cascade (strategy bits, the three cutoff
    parameters, both drops, the static band, the gap-extension unit), the
    match weight and the matching mode reach the port's config from the
    reference's and from the port's own attributes."""
    attr = dataclasses.replace(_attr(span="ends-free", **pen), heuristic=heur,
                               match_classes="iupac")
    ref = E.full_config(attr, 150, 150, W=256, S_cap=96)
    port = C.from_reference(ref)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port == C.full_config(C.attributes_from_reference(attr), 150, 150,
                                 W=256, S_cap=96)
    assert (port.strategy, port.min_wavefront_length,
            port.max_distance_threshold, port.steps_between_cutoffs,
            port.xdrop, port.zdrop, port.band_min_k, port.band_max_k) == (
        int(heur.strategy), heur.min_wavefront_length,
        heur.max_distance_threshold, heur.steps_between_cutoffs, heur.xdrop,
        heur.zdrop, heur.min_k, heur.max_k)
    assert port.match == pen.get("match", 0)
    assert port.match_classes == "iupac"
    from pywfa_tpu_torch.ops import fused_loop as TFL
    params = TFL.heuristic_params(port)
    assert params[0] == int(heur.strategy)
    assert params[-1] == (-port.match if port.match else 1)
