"""The traceback walk's two paths, on the CPU.

`ops/engine.walk_segment` launches the kernel of `csrc/walk.cu` on CUDA
tensors and runs `walk_segment_ref`, the plain loop, elsewhere; the card
tests (`tests/test_torch_walk_cuda.py`) hold the kernel against the plain
loop. Here: the CPU path is the plain loop and is counted as such, and the
packed table words the kernel reads (with the score deltas beside them)
decode back to `_walk_tables` for every metric. `tests/test_torch_engine.py` and
`tests/test_torch_metrics_api.py` hold the walk against the JAX package.

`random_case` makes a walk's inputs that reach every branch of the step:
choice bytes with every source (none, a seed, the gap sources with their
extend bits), scores inside, below and above the segment, diagonals inside
and outside the band, active and inactive pairs, pairs already fallen
back. The card tests share it.
"""
import numpy as np
import pytest
import torch

from pywfa_tpu_torch.align import WavefrontAligner as RefAligner
from pywfa_tpu_torch.ops import config as C
from pywfa_tpu_torch.ops import engine as TE

# (distance, aligner kwargs): every metric, and the affine ones with other
# penalties
METRICS = [
    ("gap-affine", {}),
    ("gap-affine", dict(mismatch=3, gap_opening=5, gap_extension=1)),
    ("affine2p", {}),
    ("affine2p", dict(mismatch=5, gap_opening=3, gap_extension=4,
                      gap_opening2=17, gap_extension2=1)),
    ("linear", {}),
    ("levenshtein", {}),
    ("indel", {}),
]
DISTANCE = {"gap-affine": "affine"}


def walk_config(distance, kw=(), span="end-to-end", L=64):
    """A full-scope config of the metric, recording choices."""
    attr = RefAligner(backend="numpy",
                      distance=DISTANCE.get(distance, distance), span=span,
                      **dict(kw))._attributes()
    return C.full_config(attr, L, L, record_choices=True)


def random_case(cfg, rng, K, B, W, seg_base):
    """(choices [K, B, W] uint8, carry) on the CPU: random bytes whose
    sources are those the metric's loop writes (gap-affine never writes
    I2 or D2, and its tables have no rows for them), and carries around
    the segment."""
    ch = rng.integers(0, 256, size=(K, B, W)).astype(np.uint8)
    src = rng.choice([C.MSRC_X, C.MSRC_I1, C.MSRC_D1, C.MSRC_I2, C.MSRC_D2,
                      C.MSRC_SEED, C.MSRC_NONE], size=(K, B, W),
                     p=[.3, .2, .2, .1, .1, .06, .04]).astype(np.uint8)
    if cfg.n_comp == 3:
        src = np.where((src == C.MSRC_I2) | (src == C.MSRC_D2), C.MSRC_X,
                       src).astype(np.uint8)
    ch = (ch & np.uint8(0xF8)) | src
    s = rng.integers(seg_base - 3, seg_base + K + 3, size=B)
    k = rng.integers(cfg.kmin - 3, cfg.kmin + W + 3, size=B)
    comp = rng.integers(0, cfg.n_comp, size=B)
    carry = (torch.from_numpy(s.astype(np.int32)),
             torch.from_numpy(k.astype(np.int32)),
             torch.from_numpy(comp.astype(np.int32)),
             torch.from_numpy(rng.random(B) < 0.85),
             torch.from_numpy(rng.random(B) < 0.1))
    return torch.from_numpy(ch), carry


@pytest.mark.parametrize("seg_base", [0, 37])
@pytest.mark.parametrize("distance,kw", METRICS)
def test_walk_segment_on_cpu_runs_the_plain_loop(distance, kw, seg_base):
    cfg = walk_config(distance, kw)
    rng = np.random.default_rng(seg_base + len(kw))
    choices, carry = random_case(cfg, rng, 29, 70, 13, seg_base)
    before = dict(TE.walk_runs)
    ops, got = TE.walk_segment(cfg, choices, seg_base, carry)
    assert TE.walk_runs == {"kernel": before["kernel"],
                            "plain": before["plain"] + 1}
    want_ops, want = TE.walk_segment_ref(cfg, choices, seg_base, carry)
    assert torch.equal(ops, want_ops)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # every branch of the step was taken: moves, stops, fallbacks
    assert (ops != 0).any() and (want[3] != carry[3]).any()
    assert (want[4] & ~carry[4]).any()


@pytest.mark.parametrize("span", ["end-to-end", "ends-free"])
@pytest.mark.parametrize("distance,kw", METRICS)
def test_walk_table_words_decode_to_the_tables(distance, kw, span):
    cfg = walk_config(distance, kw, span)
    tb = TE._walk_tables(cfg, torch.device("cpu"))
    word = tb["word"].numpy().view(np.uint32)
    assert word.shape == (256 * cfg.n_comp,)
    np.testing.assert_array_equal(word & 0xFF, tb["emit"].numpy())
    np.testing.assert_array_equal((word >> 8) & 3, tb["kind"].numpy())
    np.testing.assert_array_equal((word >> 10) & 7, tb["next"].numpy())
    np.testing.assert_array_equal(((word >> 13) & 3).astype(np.int32) - 1,
                                  tb["dk"].numpy())
    assert (word >> 15 == 0).all()
    assert tb["ds"].dtype == torch.int32 and tb["ds"].shape == word.shape
    if cfg.n_comp == 5:
        # the 2-piece metric's M block follows the extend bits 5-6 of the
        # I2 and D2 sources
        ch = np.arange(256)
        for src, bit, comp in ((C.MSRC_I2, 5, C.I2), (C.MSRC_D2, 6, C.D2)):
            rows = ch[(ch & 7) == src]
            ext = (rows >> bit) & 1 == 1
            nxt = (word[rows] >> 10) & 7
            assert (nxt[ext] == comp).all() and (nxt[~ext] == C.M).all()


def test_walk_tables_keep_a_distance_past_16_bits():
    """The score deltas are a table of their own, int32: a penalty past
    16 bits packs the same words and walks."""
    cfg = walk_config("gap-affine", dict(gap_opening=40000))
    tb = TE._walk_tables(cfg, torch.device("cpu"))
    small = TE._walk_tables(walk_config("gap-affine", {}),
                            torch.device("cpu"))
    assert int(tb["ds"].max()) == cfg.gap_opening1 + cfg.gap_extension1 > 2**15
    assert torch.equal(tb["word"], small["word"])
    rng = np.random.default_rng(11)
    choices, carry = random_case(cfg, rng, 29, 70, 13, 0)
    ops, got = TE.walk_segment(cfg, choices, 0, carry)
    assert (ops != 0).any()
