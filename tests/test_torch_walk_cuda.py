"""The walk's kernel (`csrc/walk.cu`) against its plain version, on the card.

`ops/engine.walk_segment` on CUDA tensors launches the kernel;
`walk_segment_ref` is the plain loop. Every comparison is byte-exact: the
ops rows, all five carry fields, and through `traceback_walk` n_ops,
k_start and fallback. Cases: random records that take every branch of the
step (a k outside the band, a score below and above the segment, seeds,
sources that point nowhere, chains below score 0), bottom and upper
segments (level 0 an alias of the segment below), every metric, both
spans with the match bonus's later seeds, a score delta past 16 bits,
batches of 1 pair and of sizes
that are not a multiple of the block, a record past 2**31 bytes, the
steps the traced walk reads, and a segmented 10 kb batch through
`batch._align_pairs_remat` against the same batch walked by the plain
loop.

Runs only where a CUDA device is present (marker `cuda`); imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_walk_cuda.py -q
"""
import numpy as np
import pytest
import torch

import pywfa_tpu_torch
from pywfa_tpu_torch import batch as PB
from pywfa_tpu_torch.ops import config as C
from pywfa_tpu_torch.ops import engine as TE
from pywfa_tpu_torch.ops import fused_loop
from tests.corpus import random_pairs
from tests.test_torch_cuda import BONUS, _inputs, _window_pairs
from tests.test_torch_walk import METRICS, random_case, walk_config

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _both(cfg, choices, seg_base, carry):
    """The kernel's and the plain loop's walk of one segment; the kernel
    must have run."""
    before = dict(TE.walk_runs)
    got = TE.walk_segment(cfg, choices, seg_base, carry)
    assert TE.walk_runs == {"kernel": before["kernel"] + 1,
                            "plain": before["plain"]}
    want = TE.walk_segment_ref(cfg, choices, seg_base, carry)
    torch.cuda.synchronize()
    return got, want


def _equal(got, want):
    (gops, gcarry), (wops, wcarry) = got, want
    assert gops.shape == wops.shape and torch.equal(gops, wops)
    for g, w, name in zip(gcarry, wcarry, ("s", "k", "comp", "act", "fb")):
        assert g.dtype == w.dtype and torch.equal(g, w), name


def _plain_traceback(cfg, choices, final_s, end_k, ok):
    ops, (_, k, _, act, fb) = TE.walk_segment_ref(
        cfg, choices, 0, TE.walk_carry_init(final_s, end_k, ok))
    return ops, (ops != 0).sum(1, dtype=torch.int32), k, fb | act


@pytest.mark.parametrize("B", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("seg_base", [0, 1, 300])
@pytest.mark.parametrize("distance,kw", METRICS)
def test_random_records_match_plain(dev, distance, kw, seg_base, B):
    cfg = walk_config(distance, kw)
    rng = np.random.default_rng(B * 1000 + seg_base + len(kw))
    choices, carry = random_case(cfg, rng, 41, B, 23, seg_base)
    choices = choices.to(dev)
    carry = tuple(x.to(dev) for x in carry)
    kept = tuple(x.clone() for x in carry)
    got, want = _both(cfg, choices, seg_base, carry)
    _equal(got, want)
    # the carry went in unchanged
    assert all(torch.equal(a, b) for a, b in zip(carry, kept))


@pytest.mark.parametrize("distance,kw", METRICS)
def test_every_branch_of_the_step_matches_plain(dev, distance, kw):
    """One batch large enough that every branch is taken: moves, stops at
    score 0 and at later seeds, sources that point nowhere, chains below
    score 0, a k outside the band, pairs inactive or above the segment."""
    cfg = walk_config(distance, kw)
    rng = np.random.default_rng(7)
    choices, carry = random_case(cfg, rng, 57, 4099, 31, 0)
    choices = choices.to(dev)
    carry = tuple(x.to(dev) for x in carry)
    got, want = _both(cfg, choices, 0, carry)
    _equal(got, want)
    s, k, _, act, fb = (x.cpu() for x in carry)
    ws, _, _, wact, wfb = (x.cpu() for x in want[1])
    here = act & (s >= 0) & (s < 57)
    assert (here & ~wact & ~wfb & (ws == 0)).any()          # score 0
    assert (here & ~wact & ~wfb & (ws > 0)).any()           # a later seed
    assert (here & wfb & ~fb & (ws > 0)).any()              # no source
    if max(fused_loop.score_distances(cfg)) > 1:  # edit steps 1 at most
        assert (here & wfb & ~fb & (ws < 0)).any()          # below 0
    assert (here & ((k < cfg.kmin) | (k >= cfg.kmin + 31))).any()
    assert (~here & (s >= 57)).any() and (~act).any()


@pytest.mark.parametrize("span,frees_row,bonus", [
    ("end-to-end", (0, 0, 0, 0), False),
    ("ends-free", (8, 8, 20, 20), False),
    ("ends-free", (4, 4, 8, 8), True),
])
@pytest.mark.parametrize("distance,kw", METRICS)
def test_traceback_walk_on_real_records_matches_plain(dev, distance, kw,
                                                      span, frees_row,
                                                      bonus):
    """The fused loop's own records at full caps, walked one shot: ops,
    n_ops, k_start (not 0 where the span frees the ends) and fallback."""
    name = {"gap-affine": "affine"}.get(distance, distance)
    if bonus:
        if name not in BONUS or kw:
            pytest.skip("edit and indel carry no match weight")
        kw = BONUS[name]
    cfg = walk_config(distance, kw, span, L=192)
    pairs = (_window_pairs(54, 48, 120, 20)
             + random_pairs(55, 17, 20, 150, 0.1, 0.05, unrelated=0.3,
                            as_bytes=True))
    args = _inputs(cfg, pairs, dev, frees_row)
    out = fused_loop.align_batch_fused_loop(cfg, *args, 2**31 - 1)
    ok = TE.walkable(out)
    before = TE.walk_runs["kernel"]
    got = TE.traceback_walk(cfg, out["choices"], out["final_s"],
                            out["end_k"], ok)
    assert TE.walk_runs["kernel"] == before + 1
    want = _plain_traceback(cfg, out["choices"], out["final_s"],
                            out["end_k"], ok)
    torch.cuda.synchronize()
    for g, w, field in zip(got, want, ("ops", "n_ops", "k_start", "fb")):
        assert torch.equal(g, w), field
    assert ok.any() and bool((got[1] > 0).any())
    if span == "ends-free":
        assert bool((got[2][ok] != 0).any())
    if bonus:
        assert bool((out["choices"] == C.MSRC_SEED).any())


@pytest.mark.parametrize("seg_base", [0, 40000])
def test_a_distance_past_16_bits_matches_plain(dev, seg_base):
    """Score deltas past 16 bits (a gap opening of 40000) walk on the card
    as in the plain loop: the deltas are a table of their own."""
    cfg = walk_config("gap-affine", dict(gap_opening=40000))
    rng = np.random.default_rng(13)
    choices, carry = random_case(cfg, rng, 41, 300, 23, seg_base)
    got, want = _both(cfg, choices.to(dev), seg_base,
                      tuple(x.to(dev) for x in carry))
    _equal(got, want)
    # moves that open a gap leave the segment: below score 0 at the bottom
    s, fb = want[1][0].cpu(), want[1][4].cpu()
    assert bool((want[0] != 0).any()) and bool((s < seg_base - 2**15).any())
    if seg_base == 0:
        assert bool((fb & ~carry[4] & (s < 0)).any())


def test_upper_segments_chain_like_plain(dev):
    """A real record cut into segments of K levels (each upper one starts
    with the alias of the level below) and walked top down, carry to
    carry, equals the plain loop's chain and the one-shot walk."""
    cfg = walk_config("gap-affine", {}, "ends-free", L=192)
    pairs = _window_pairs(60, 64, 150, 20)
    args = _inputs(cfg, pairs, dev, (8, 8, 20, 20))
    out = fused_loop.align_batch_fused_loop(cfg, *args, 2**31 - 1)
    ok = TE.walkable(out)
    choices = out["choices"]
    K = 17
    bases = list(range(0, int(out["final_s"].max()) + 1, K - 1))
    carry = want_carry = TE.walk_carry_init(out["final_s"], out["end_k"], ok)
    blocks, want_blocks = [], []
    for base in reversed(bases):
        seg = choices[base:base + K].contiguous()
        if seg.shape[0] < K:
            seg = torch.cat([seg, torch.zeros(
                (K - seg.shape[0],) + seg.shape[1:], dtype=seg.dtype,
                device=dev)])
        ops, carry = TE.walk_segment(cfg, seg, base, carry)
        wops, want_carry = TE.walk_segment_ref(cfg, seg, base, want_carry)
        _equal((ops, carry), (wops, want_carry))
        # the alias level of an upper segment is the segment below's
        blocks.insert(0, ops if base == 0 else ops[:, 1:])
        want_blocks.insert(0, wops if base == 0 else wops[:, 1:])
    one = TE.traceback_walk(cfg, choices, out["final_s"], out["end_k"], ok)
    chained = torch.cat(blocks, 1)
    n = min(chained.shape[1], one[0].shape[1])
    assert torch.equal(chained[:, :n], one[0][:, :n])
    assert not chained[:, n:].any() and not one[0][:, n:].any()
    assert torch.equal(chained, torch.cat(want_blocks, 1))
    assert torch.equal(carry[1], one[2])
    assert torch.equal(carry[4] | carry[3], one[3])


def test_record_past_2_31_bytes(dev):
    """Offsets into a record of K x B x W > 2**31 bytes: every pair
    starts at the top level, far past 2**31."""
    cfg = walk_config("gap-affine", {})
    K, B, W = 36, 1024, 60000
    assert K * B * W > 2**31 and (K - 1) * B * W > 2**31
    gen = torch.Generator(device=dev).manual_seed(5)
    choices = torch.randint(0, 256, (K, B, W), dtype=torch.uint8,
                            device=dev, generator=gen)
    # sources the gap-affine loop writes: X, I1, D1, and a seed in 16
    src = torch.where(choices >= 0xF0, C.MSRC_SEED, choices % 3 + 1)
    choices = (choices & 0xF8) | src.to(torch.uint8)
    del src
    s = torch.full((B,), K - 1, dtype=torch.int32, device=dev)
    k = torch.randint(cfg.kmin, cfg.kmin + W, (B,), dtype=torch.int32,
                      device=dev, generator=gen)
    carry = (s, k, torch.zeros(B, dtype=torch.int32, device=dev),
             torch.ones(B, dtype=torch.bool, device=dev),
             torch.zeros(B, dtype=torch.bool, device=dev))
    got, want = _both(cfg, choices, 0, carry)
    _equal(got, want)
    # most pairs walk on (a seed stops one in 16 at once)
    assert int(((got[0] != 0).sum(1) > 1).sum()) > B // 2


def test_traced_walk_reads_its_steps(dev, monkeypatch):
    """Under the switch the kernel path ends in one sync, a span "sync"
    inside the span "walk", which carries the most steps a pair took; the
    bytes are those of the untraced walk."""
    from pywfa_tpu_torch import spans
    cfg = walk_config("gap-affine", {})
    rng = np.random.default_rng(3)
    choices, carry = random_case(cfg, rng, 41, 130, 23, 0)
    choices = choices.to(dev)
    carry = tuple(x.to(dev) for x in carry)
    plain = TE.walk_segment(cfg, choices, 0, carry)
    monkeypatch.setattr(PB, "_PROF", True)
    n_sync = spans.n["sync"]
    traced = TE.walk_segment(cfg, choices, 0, carry)
    _equal(traced, plain)
    walk = [e for e in list(spans.log)[-3:] if e[1] == "walk"][-1]
    assert spans.n["sync"] == n_sync + 1
    # a pair's steps: its moves (one op each, every level once: each step
    # lowers s) and the step that stopped it, unless that was a move
    # below score 0
    ops, (s, _, _, act, _) = plain
    steps = ((ops != 0).sum(1)
             + (carry[3] & ~act & (s >= 0)).to(torch.int64))
    assert walk[5] == int(steps.max()) > 0
    assert walk[5] <= TE._walk_iters(cfg, 41)


def test_segmented_10kb_batch_matches_the_plain_walk(dev, monkeypatch):
    """`batch._align_pairs_remat` on 10 kb pairs, its replays walked by the
    kernel, against the same batch with every walk the plain loop's."""
    pairs = random_pairs(81, 24, 9800, 10200, 0.02, 0.03, as_bytes=True)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    monkeypatch.setattr(PB, "CHOICES_BYTES_CAP", 2**26)
    monkeypatch.setattr(PB, "REPLAY_CHOICES_BYTES", 2**26)
    PB.oracle_fallbacks.update(dict.fromkeys(PB.oracle_fallbacks, 0))
    aligner = pywfa_tpu_torch.BatchWavefrontAligner(span="end-to-end",
                                                    device=dev)
    replays = PB.segmented_runs["replays"]
    kernel = TE.walk_runs["kernel"]
    got = aligner.align(pats, txts)
    assert PB.segmented_runs["replays"] > replays
    assert TE.walk_runs["kernel"] - kernel >= 2

    monkeypatch.setattr(TE, "walk_segment", TE.walk_segment_ref)
    kernel = TE.walk_runs["kernel"]
    want = aligner.align(pats, txts)
    assert TE.walk_runs["kernel"] == kernel
    assert not any(PB.oracle_fallbacks.values())
    key = lambda r: (r.status, r.score, r.ops, r.end_v, r.end_h)
    assert list(map(key, got)) == list(map(key, want))
    assert all(r.status == 0 for r in got)
