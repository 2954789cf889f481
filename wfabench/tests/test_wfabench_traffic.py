"""The generator of read pairs: deterministic for a seed, the sizes each
edit model promises, seeds past 32 bits."""
import numpy as np
import pytest

from wfabench import manifest, reads

DATASET = {"model": "dataset", "length": 150, "error_rate": 0.02}
PROFILE = {"model": "profile", "length": 2000, "error_rate": 0.05,
           "ratio": [23, 31, 46], "size_set": 32, "sizes_seed": 0}


@pytest.mark.parametrize("model", [DATASET, PROFILE],
                         ids=["dataset", "profile"])
def test_same_seed_same_pairs(model):
    a = reads.make_pairs(model, 64, np.random.default_rng(7))
    b = reads.make_pairs(model, 64, np.random.default_rng(7))
    c = reads.make_pairs(model, 64, np.random.default_rng(8))
    assert a == b
    assert a != c
    pats, txts = a
    assert all(len(p) == model["length"] for p in pats)
    assert all(set(s) <= set(b"ACGT") for s in pats + txts)


def test_dataset_edits_are_exact():
    """int(length * error_rate) edits at distinct positions: the text's
    length moves by at most that many bases, and the three kinds come in
    about equal shares."""
    pats, txts = reads.make_pairs(DATASET, 2000, np.random.default_rng(1))
    n = int(150 * 0.02)
    d = np.array([len(t) - len(p) for p, t in zip(pats, txts)])
    assert np.abs(d).max() <= n
    # with 3 edits of three equally likely kinds, more insertions than
    # deletions in 10/27 of the reads, and as often the other way
    grown = (d > 0).mean()
    shrunk = (d < 0).mean()
    assert 0.2 < grown < 0.6 and 0.2 < shrunk < 0.6


def test_profile_sizes_are_the_same_for_every_seed():
    """Every size_set reads hold the same set of text lengths whatever the
    seed, in another order; the splits follow the ratio; and no pair
    costs more than its own edits."""
    k = round(2000 * 0.05)
    runs = [reads.make_pairs(PROFILE, 64, np.random.default_rng(s))
            for s in (2, 3)]
    lens = [np.array([len(t) for t in txts]) for _, txts in runs]
    for tile in (slice(0, 32), slice(32, 64)):
        assert sorted(lens[0][tile]) == sorted(lens[1][tile])
    assert (lens[0] != lens[1]).any()
    assert all(len(p) == 2000 for p in runs[0][0])
    split = reads.splits(k, PROFILE["ratio"], 4096, 0)
    assert (split.sum(axis=1) == k).all()
    share = split.sum(axis=0) / split.sum()
    assert np.allclose(share, [0.23, 0.31, 0.46], atol=0.01)
    # texts shorter than patterns on the whole, as deletions lead
    assert lens[0].mean() < 2000
    from wfabench.reference.dp import affine_costs
    pats, txts = runs[0]
    costs = affine_costs(pats[:8], txts[:8], 4, 6, 2)
    # k edits, each a mismatch at 4 or a one-base gap at 8 at most
    assert (costs <= k * 8).all() and (costs > 0).all()


@pytest.mark.parametrize("cell", ["illumina150-full-stream",
                                  "illumina150-api-call"])
def test_pool_from_large_seed(cell, small_cell):
    c = small_cell(cell, pairs=8)
    driver = manifest.load_driver(c["traffic"]["driver"])
    seed = 2**31 + 12345
    a = driver.make_pool(c, np.random.default_rng(seed % 2**64))
    b = driver.make_pool(c, np.random.default_rng(seed % 2**64))
    assert a == b and len(a[0]) in (8, 16)
