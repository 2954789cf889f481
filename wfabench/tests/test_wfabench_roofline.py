"""The frozen work count: cells from the penalties, lengths and optimal
score alone, equal to the wavefront limits the plain aligner walks."""
import inspect

import pytest

from wfabench import roofline
from wfabench.reference import wfa
from test_wfabench_reference import random_pairs


@pytest.mark.parametrize("seed", [3, 4])
def test_cells_equal_the_limits_the_reference_walks(seed):
    pats, txts = random_pairs(seed, 80, max_len=40, rate=0.2)
    for p, t in zip(pats, txts):
        score, _, limits = wfa.align(p, t)
        walked = sum(hi - lo + 1 for _, lo, hi in limits)
        assert roofline.cells(4, 6, 2, [-score], [len(p)], [len(t)])[0] \
            == walked


def test_cells_by_hand():
    # a mismatch: scores 0 and 4 carry one diagonal each
    assert roofline.cells(4, 6, 2, [4], [4], [4])[0] == 2
    # one deletion: scores 0 and 4 one diagonal, 8 three ([-1, 1])
    assert roofline.cells(4, 6, 2, [8], [4], [3])[0] == 5
    # ... and the gap's extension at 10 widens to [-2, 2], cut to the
    # text's [.., 1] when the text is one base long
    assert roofline.cells(4, 6, 2, [10], [3], [1])[0] == 1 + 1 + 3 + 4
    carries, lo, hi = roofline.score_ranges(4, 6, 2, 12)
    assert carries.tolist() == [True, False, False, False, True, False,
                                False, False, True, False, True, False,
                                True]
    assert (lo[8], hi[8], lo[12], hi[12]) == (-1, 1, -3, 3)


def test_work_reads_no_implementation_detail():
    params = set(inspect.signature(roofline.work).parameters)
    assert params == {"x", "o", "e", "components", "full_scope", "costs",
                      "plens", "tlens"}
    ops, nbytes = roofline.work(4, 6, 2, 3, True, [4, 8], [4, 4], [4, 3])
    assert ops == (2 + 5) * roofline.OPS_PER_CELL[3]
    # 2-bit sequences, 16 bytes of meta each, 4-bit ops (max length)
    assert nbytes == (1 + 1) + (1 + 1) + 32 + 2 + 2
    pct, bound = roofline.share(ops, nbytes, 1e-6)
    assert bound in ("operations", "bytes") and 0 < pct < 100
