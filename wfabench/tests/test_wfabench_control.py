"""The controls at a size a test run holds, on the CPU: the reference in
8-bit integers put in the program's place comes out not correct in every
cell, while the program itself, through the same harness, comes out
correct (the lower reading, 0 of every number)."""
import time

import pytest

from wfabench import check, control, harness

CELLS = ["illumina150-full-stream", "ont10k-full-stream",
         "illumina150-api-call"]


@pytest.mark.parametrize("name", CELLS)
def test_int8_reference_is_not_correct(name, small_cell):
    cell = small_cell(name, pairs=16)
    for seed in (1, 2, 3):
        nums = control.int8_reading(cell, seed, "cpu")
        assert nums["judged"] == len(
            control_pool(cell, seed)[0])
        assert nums["wrong_score"] > 0
        assert nums["wrong_answers"] == nums["judged"]
        assert not check.verdict(nums)


def control_pool(cell, seed):
    import numpy as np

    from wfabench import manifest
    driver = manifest.load_driver(cell["traffic"]["driver"])
    return driver.make_pool(cell, np.random.default_rng(seed))


@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct_at_the_same_size(name, small_cell):
    cell = small_cell(name, pairs=16)
    out = harness.run_cell(cell, 2**31 + 5, 0.5, False, "cpu",
                           time.perf_counter())
    res = out["result"]
    assert res["correct"], res["compared"]
    assert res["compared"]["wrong_answers"]["value"] == 0
    assert not any(out["judged"].values())
