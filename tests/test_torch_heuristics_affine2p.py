"""The heuristic cascade of the fused score loop's plain torch version
against the Pallas kernel in interpret mode and the XLA engine, under the
affine2p metric: the grid of tests/test_torch_heuristics.py, byte for
byte."""
import pytest

from tests.test_torch_heuristics import HEURISTICS, SPANS, check_cascade


@pytest.mark.parametrize("scope", ["full", "score"])
@pytest.mark.parametrize("span", sorted(SPANS))
@pytest.mark.parametrize("name", sorted(HEURISTICS))
def test_cascade_matches_pallas_and_xla(name, span, scope):
    check_cascade(name, "affine2p", span, scope)
