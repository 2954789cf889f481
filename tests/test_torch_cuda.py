"""The CUDA kernels against their plain torch versions, on the card.

Every variant of the fused loop (each of the five distance metrics,
end-to-end or ends-free span, with or without a match bonus, with or
without a heuristic, full-CIGAR or score-only scope) is held against the
plain version, and the API paths against the scalar oracle; so are the
run-length table's kernel, the fused loop's table extension, its
wide-band layouts (several diagonals a thread; the ring in global memory),
its segments with the state in and out, and a segmented batch.

Runs only where a CUDA device is present (marker `cuda`; skipped
elsewhere). The file imports no jax, so on a GPU host without jax run it
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Every comparison is of integers and byte-exact (tolerance zero).
"""
import dataclasses
import gc
import random

import numpy as np
import pytest
import torch

import pywfa_tpu_torch
from pywfa_tpu_torch import batch as PB
from pywfa_tpu_torch.align import WavefrontAligner as RefAligner
from pywfa_tpu_torch.attributes import (AlignerAttributes, AlignmentForm,
                                        HeuristicParams)
from pywfa_tpu_torch.constants import AlignmentSpan
from pywfa_tpu_torch.constants import HeuristicStrategy as HS
from pywfa_tpu_torch.oracle import OracleAligner
from pywfa_tpu_torch.ops import config as C
from pywfa_tpu_torch.ops import engine as TE
from pywfa_tpu_torch.ops import fused_loop, lcp_table
from tests.corpus import mutate, random_pairs

pytestmark = pytest.mark.cuda

KEYS = ("status", "final_s", "end_k", "end_off", "choices")
ATTR = AlignerAttributes(form=AlignmentForm(span=AlignmentSpan.END_TO_END))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(cfg, pairs, dev, frees_row=(0, 0, 0, 0)):
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    plens = np.array([len(p) for p in pats], dtype=np.int32)
    tlens = np.array([len(t) for t in txts], dtype=np.int32)
    pat = PB.encode_batch(pats, cfg.Lp, cfg.extend_chunk,
                          PB.PATTERN_SENTINEL, plens)
    txt = PB.encode_batch(txts, cfg.Lt, cfg.extend_chunk, PB.TEXT_SENTINEL,
                          tlens)
    bits = TE.build_eq_bits(cfg, torch.from_numpy(pat).to(dev),
                            torch.from_numpy(txt).to(dev))
    lens = np.stack([plens, plens, tlens, tlens], axis=1)
    frees = np.minimum(np.array([frees_row], dtype=np.int32), lens)
    return (bits, torch.from_numpy(plens).to(dev),
            torch.from_numpy(tlens).to(dev), torch.from_numpy(frees).to(dev))


def _window_pairs(seed, n, length, flank):
    """n reads of `length` bp, each mutated inside a window of random
    flanks of up to `flank` bases a side."""
    rng = random.Random(seed)

    def rand(k):
        return "".join(rng.choice("ACGT") for _ in range(k))

    out = []
    for _ in range(n):
        p = rand(length)
        t = (rand(rng.randint(0, flank)) + mutate(rng, p, 0.03, 0.01)
             + rand(rng.randint(0, flank)))
        out.append((p.encode(), t.encode()))
    return out


@pytest.mark.parametrize("span,record,W,S_cap,frees_row", [
    ("ends-free", True, None, None, (8, 8, 20, 20)),
    ("ends-free", True, 256, 96, (8, 8, 20, 20)),
    ("ends-free", False, 256, 96, (8, 8, 20, 20)),
    ("ends-free", True, 256, 96, (0, 0, 0, 0)),
    ("end-to-end", False, None, None, (0, 0, 0, 0)),
    ("end-to-end", False, 256, 96, (0, 0, 0, 0)),
    # text-begin-free seeds past the band: ST_OVERFLOW_W at WF0
    ("ends-free", True, 128, 96, (0, 0, 70, 70)),
])
def test_kernel_variants_match_plain_version(dev, span, record, W, S_cap,
                                             frees_row):
    spans = {"ends-free": AlignmentSpan.ENDS_FREE,
             "end-to-end": AlignmentSpan.END_TO_END}
    attr = AlignerAttributes(form=AlignmentForm(span=spans[span]))
    pairs = (_window_pairs(54, 48, 120, 20)
             + random_pairs(55, 16, 20, 150, 0.1, 0.05, unrelated=0.3,
                            as_bytes=True))
    cfg = C.full_config(attr, 192, 192, W=W, S_cap=S_cap,
                        record_choices=record)
    args = _inputs(cfg, pairs, dev, frees_row)
    name = fused_loop.variant(cfg)
    before = fused_loop.variant_launches[name]
    got = fused_loop.align_batch_fused_loop(cfg, *args, 2**31 - 1)
    assert fused_loop.variant_launches[name] == before + 1
    want = fused_loop.align_batch_fused_loop_ref(cfg, *args, 2**31 - 1)
    torch.cuda.synchronize()
    keys = KEYS if record else KEYS[:4]
    assert set(got) == set(want) and ("choices" in got) == record
    for k in keys:
        assert torch.equal(got[k], want[k]), k
    if W == 128:
        assert (got["status"] == C.ST_OVERFLOW_W).any()


@pytest.mark.parametrize("W,S_cap,max_steps", [
    (None, None, 2**31 - 1),   # full caps
    (256, 96, 2**31 - 1),      # first rung: some pairs overflow S_cap
    (128, None, 2**31 - 1),    # undersized band: ST_OVERFLOW_W
    (None, None, 9),           # max_steps stops pairs
])
def test_kernel_matches_plain_version(dev, W, S_cap, max_steps):
    pairs = random_pairs(51, 64, 20, 150, 0.1, 0.05, unrelated=0.2,
                         as_bytes=True)
    cfg = C.full_config(ATTR, 160, 160, W=W, S_cap=S_cap)
    args = _inputs(cfg, pairs, dev)
    before = fused_loop.variant_launches["e2e"]
    got = fused_loop.align_batch_fused_loop(cfg, *args, max_steps)
    assert fused_loop.variant_launches["e2e"] == before + 1
    want = fused_loop.align_batch_fused_loop_ref(cfg, *args, max_steps)
    torch.cuda.synchronize()
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k


def test_kernel_with_large_scope_uses_big_shared_memory(dev):
    """Penalties with a large scope push the ring past 48 KB of shared
    memory, which needs the opt-in attribute."""
    attr = dataclasses.replace(ATTR, penalties=dataclasses.replace(
        ATTR.penalties, mismatch=9, gap_opening1=20, gap_extension1=3))
    cfg = C.full_config(attr, 160, 160, W=384, S_cap=400)
    assert fused_loop.smem_bytes(cfg) > 48 * 1024
    pairs = random_pairs(52, 32, 100, 150, 0.05, 0.02, as_bytes=True)
    args = _inputs(cfg, pairs, dev)
    got = fused_loop.align_batch_fused_loop(cfg, *args, 2**31 - 1)
    want = fused_loop.align_batch_fused_loop_ref(cfg, *args, 2**31 - 1)
    torch.cuda.synchronize()
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k


def test_align_pairs_on_cuda_matches_oracle(dev):
    pairs = random_pairs(53, 40, 30, 150, 0.15, 0.05, unrelated=0.2,
                         as_bytes=True)
    res = PB.align_pairs(ATTR, [p for p, _ in pairs], [t for _, t in pairs],
                         device=dev)
    oracle = OracleAligner(ATTR)
    for (p, t), r in zip(pairs, res):
        o = oracle.align(p, t)
        assert (r.status, r.score, r.ops) == (o.status, o.score, o.ops)


@pytest.mark.parametrize("scope", ["full", "score"])
def test_wavefront_aligner_on_cuda_matches_oracle(dev, scope):
    """pywfa's defaults (ends-free, zero frees) and a read in a window with
    text frees, through the single-pair API on the card."""
    pairs = (random_pairs(56, 12, 30, 150, 0.05, 0.02, unrelated=0.2,
                          as_bytes=True) + _window_pairs(57, 8, 100, 25))
    for kw in (dict(), dict(text_begin_free=25, text_end_free=25)):
        a = pywfa_tpu_torch.WavefrontAligner(scope=scope, device=dev, **kw)
        o = RefAligner(scope=scope, backend="numpy", **kw)
        for p, t in pairs:
            got = a(t.decode(), p.decode())
            want = o(t.decode(), p.decode())
            assert (a.status, a.score, a.cigarstring) == (
                o.status, o.score, o.cigarstring), (p, t)
            assert (got.pattern_start, got.pattern_end, got.text_start,
                    got.text_end) == (want.pattern_start, want.pattern_end,
                                      want.text_start, want.text_end)


METRICS = ("affine2p", "linear", "levenshtein", "indel")


def _metric_attr(metric, span="end-to-end", scope="full", **frees):
    return RefAligner(backend="numpy", distance=metric, span=span,
                      scope=scope, **frees)._attributes()


@pytest.mark.parametrize("span,record,caps,frees_row", [
    ("end-to-end", True, "rung1", (0, 0, 0, 0)),
    ("end-to-end", True, "full", (0, 0, 0, 0)),
    ("end-to-end", False, "rung1", (0, 0, 0, 0)),
    ("ends-free", True, "rung1", (8, 8, 20, 20)),
    ("ends-free", True, "full", (8, 8, 20, 20)),
    ("ends-free", False, "rung1", (8, 8, 20, 20)),
    # an undersized band: ST_OVERFLOW_W
    ("end-to-end", True, 128, (0, 0, 0, 0)),
])
@pytest.mark.parametrize("metric", METRICS)
def test_metric_variants_match_plain_version(dev, metric, span, record, caps,
                                             frees_row):
    """Each new metric's kernel, at the first rung the batch path derives
    for these lengths, at the terminal rung and at an undersized band."""
    attr = _metric_attr(metric, span)
    pairs = (_window_pairs(64, 40, 120, 20)
             + random_pairs(65, 24, 20, 150, 0.1, 0.05, unrelated=0.3,
                            as_bytes=True))
    if caps == "rung1":
        W = C._round_up(PB._band_for_score(attr, 96, 192, 192), 128)
        cfg = C.full_config(attr, 192, 192, W=W, S_cap=96,
                            record_choices=record)
    elif caps == "full":
        cfg = C.full_config(attr, 192, 192, record_choices=record)
    else:
        cfg = C.full_config(attr, 192, 192, W=caps, record_choices=record)
    args = _inputs(cfg, pairs, dev, frees_row)
    name = fused_loop.variant(cfg)
    before = fused_loop.variant_launches[name]
    got = fused_loop.align_batch_fused_loop(cfg, *args, 2**31 - 1)
    assert fused_loop.variant_launches[name] == before + 1
    want = fused_loop.align_batch_fused_loop_ref(cfg, *args, 2**31 - 1)
    torch.cuda.synchronize()
    keys = KEYS if record else KEYS[:4]
    assert set(got) == set(want) and ("choices" in got) == record
    for k in keys:
        assert torch.equal(got[k], want[k]), k
    assert (got["status"] == C.ST_END_REACHED).any()
    if caps == 128:
        assert (got["status"] == C.ST_OVERFLOW_W).any()


@pytest.mark.parametrize("metric", METRICS)
def test_metric_max_steps_matches_plain_version(dev, metric):
    cfg = C.full_config(_metric_attr(metric), 160, 160)
    pairs = random_pairs(66, 32, 20, 150, 0.1, 0.05, unrelated=0.2,
                         as_bytes=True)
    args = _inputs(cfg, pairs, dev)
    got = fused_loop.align_batch_fused_loop(cfg, *args, 7)
    want = fused_loop.align_batch_fused_loop_ref(cfg, *args, 7)
    torch.cuda.synchronize()
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k
    assert (got["status"] == C.ST_MAX_STEPS).any()


def test_affine2p_terminal_rung_fits_shared_memory(dev):
    """150 bp reads at affine2p's terminal rung: W 512, a scope of 26, a
    ring of 36 rows in 73 KB of shared memory."""
    cfg = C.full_config(_metric_attr("affine2p"), 160, 160)
    assert (cfg.W, cfg.S_cap, cfg.scope) == (512, 649, 26)
    assert 48 * 1024 < fused_loop.smem_bytes(cfg) < 80 * 1024
    pairs = random_pairs(67, 32, 100, 150, 0.1, 0.05, unrelated=0.25,
                         as_bytes=True)
    args = _inputs(cfg, pairs, dev)
    got = fused_loop.align_batch_fused_loop(cfg, *args, 2**31 - 1)
    want = fused_loop.align_batch_fused_loop_ref(cfg, *args, 2**31 - 1)
    torch.cuda.synchronize()
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k
    assert (got["status"] == C.ST_END_REACHED).all()


@pytest.mark.parametrize("scope", ["full", "score"])
@pytest.mark.parametrize("span", ["end-to-end", "ends-free"])
@pytest.mark.parametrize("metric", METRICS)
def test_metric_api_paths_on_cuda_match_oracle(dev, metric, span, scope):
    """align_pairs (with pairs that escalate) and WavefrontAligner under
    each new metric on the card, against the scalar oracle; no pair may
    reach the oracle through an inconsistent walk."""
    frees = ({} if span == "end-to-end" else
             dict(pattern_begin_free=4, pattern_end_free=5,
                  text_begin_free=20, text_end_free=20))
    attr = _metric_attr(metric, span, scope, **frees)
    pairs = (random_pairs(68, 24, 30, 150, 0.15, 0.05, unrelated=0.2,
                          as_bytes=True) + _window_pairs(69, 8, 100, 20))
    PB.oracle_fallbacks.update(dict.fromkeys(PB.oracle_fallbacks, 0))
    res = PB.align_pairs(attr, [p for p, _ in pairs], [t for _, t in pairs],
                         device=dev)
    assert PB.oracle_fallbacks["inconsistent walk"] == 0
    for (p, t), r in zip(pairs, res):
        o = PB._oracle_one(attr, p, t)
        assert (r.status, r.score, r.ops) == (o.status, o.score, o.ops)
    a = pywfa_tpu_torch.WavefrontAligner(distance=metric, span=span,
                                         scope=scope, device=dev, **frees)
    o = RefAligner(distance=metric, span=span, scope=scope, backend="numpy",
                   **frees)
    for p, t in pairs[:12] + pairs[-4:]:
        a(t.decode(), p.decode())
        o(t.decode(), p.decode())
        assert (a.status, a.score, a.cigarstring, a.locations) == (
            o.status, o.score, o.cigarstring, o.locations), (p, t)


HEURISTICS = {
    "wfadaptive": HeuristicParams(
        strategy=HS.WFADAPTIVE, min_wavefront_length=5,
        max_distance_threshold=15, steps_between_cutoffs=1),
    "wfadaptive_default": HeuristicParams(strategy=HS.WFADAPTIVE),
    "wfmash": HeuristicParams(
        strategy=HS.WFMASH, min_wavefront_length=5,
        max_distance_threshold=12, steps_between_cutoffs=1),
    "xdrop": HeuristicParams(strategy=HS.XDROP, xdrop=10,
                             steps_between_cutoffs=1),
    "zdrop": HeuristicParams(strategy=HS.ZDROP, zdrop=12,
                             steps_between_cutoffs=2),
    "banded_static": HeuristicParams(strategy=HS.BANDED_STATIC, min_k=-12,
                                     max_k=12),
    "banded_adaptive": HeuristicParams(strategy=HS.BANDED_ADAPTIVE,
                                       min_k=-10, max_k=10,
                                       steps_between_cutoffs=2),
    "wfadaptive+zdrop": HeuristicParams(
        strategy=HS.WFADAPTIVE | HS.ZDROP, min_wavefront_length=5,
        max_distance_threshold=15, zdrop=15, steps_between_cutoffs=1),
    "xdrop+banded": HeuristicParams(
        strategy=HS.XDROP | HS.BANDED_ADAPTIVE, xdrop=14, min_k=-8, max_k=8,
        steps_between_cutoffs=3),
}
# match bonus and the other penalties, by metric, for the seeded span
BONUS = {
    "affine": dict(match=-2, mismatch=5, gap_opening=7, gap_extension=2),
    "affine2p": dict(match=-3, mismatch=4, gap_opening=6, gap_extension=2),
    "linear": dict(match=-1, mismatch=4, gap_extension=3),
}


def _hard_pairs(seed, n=48):
    """Divergent pairs with unrelated ones among them (the drops end
    pairs, the cuts act), an empty text and an empty pattern."""
    return (random_pairs(seed, n, 30, 90, 0.25, 0.12, unrelated=0.25,
                         as_bytes=True)
            + _window_pairs(seed + 1, 12, 60, 30)
            + [(b"ACGTACGTACGTACGTACGT", b""), (b"", b"ACGTTGCATGCATGCA")])


def _held(cfg, args, max_steps=2**31 - 1):
    """Launch the kernel, run its plain version, compare every output."""
    name = fused_loop.variant(cfg)
    before = fused_loop.variant_launches[name]
    got = fused_loop.align_batch_fused_loop(cfg, *args, max_steps)
    assert fused_loop.variant_launches[name] == before + 1
    want = fused_loop.align_batch_fused_loop_ref(cfg, *args, max_steps)
    torch.cuda.synchronize()
    assert set(got) == set(want)
    assert ("choices" in got) == cfg.record_choices
    for k in (KEYS if cfg.record_choices else KEYS[:4]):
        assert torch.equal(got[k], want[k]), (name, k)
    return got


@pytest.mark.parametrize("span", ["end-to-end", "ends-free", "seeded"])
@pytest.mark.parametrize("metric", ["affine"] + list(METRICS))
@pytest.mark.parametrize("name,record", [(n, True) for n in sorted(HEURISTICS)]
                         + [(n, False) for n in ("wfadaptive", "zdrop",
                                                 "xdrop+banded")])
def test_heuristic_variants_match_plain_version(dev, name, record, metric,
                                                span):
    """The cascade in every metric's kernel, on every span (with the
    choice record under every strategy, score only under three): full
    caps, a first rung (overflows) and a step cap."""
    kw = {}
    frees_row = (0, 0, 0, 0)
    if span == "seeded":
        if metric not in BONUS:
            pytest.skip("edit and indel carry no match weight")
        kw = BONUS[metric]
    if span != "end-to-end":
        frees_row = (6, 6, 25, 25)
    attr = dataclasses.replace(
        RefAligner(backend="numpy", distance=metric,
                   span="end-to-end" if span == "end-to-end" else "ends-free",
                   **kw)._attributes(),
        heuristic=HEURISTICS[name])
    pairs = _hard_pairs(70 + len(name) + len(metric))
    full = C.full_config(attr, 128, 128, record_choices=record)
    assert fused_loop.variant(full).endswith(
        {"end-to-end": "e2e", "ends-free": "endsfree",
         "seeded": "endsfreeseed"}[span] + "_heur"
        + ("" if record else "_score"))
    got = _held(full, _inputs(full, pairs, dev, frees_row))
    assert (got["status"] == C.ST_END_REACHED).any()
    small = dataclasses.replace(full, W=128, S_cap=96)
    _held(small, _inputs(small, pairs, dev, frees_row))
    _held(full, _inputs(full, pairs, dev, frees_row), max_steps=25)


@pytest.mark.parametrize("record", [True, False])
@pytest.mark.parametrize("frees_row", [(0, 5, 0, 5), (4, 4, 8, 8),
                                       (60, 6, 90, 6), (7, 0, 0, 3)])
@pytest.mark.parametrize("metric", sorted(BONUS))
def test_seeded_variants_match_plain_version(dev, metric, frees_row, record):
    """Ends-free with a match bonus, no heuristic: begin frees of zero,
    below the scores' reach and past it; at full caps and at a band the
    seeds outgrow (ST_OVERFLOW_W)."""
    attr = RefAligner(backend="numpy", distance=metric, **BONUS[metric]
                      )._attributes()
    pairs = _hard_pairs(90)
    full = C.full_config(attr, 128, 128, record_choices=record)
    got = _held(full, _inputs(full, pairs, dev, frees_row))
    if record and frees_row[0] + frees_row[2] > 0:
        assert (got["choices"] == C.MSRC_SEED).any()
    small = dataclasses.replace(full, W=128)
    got = _held(small, _inputs(small, pairs, dev, frees_row))
    if frees_row[2] == 90:
        assert (got["status"] == C.ST_OVERFLOW_W).any()


def test_match_bonus_drop_end_to_end(dev):
    """match = -1 on the end-to-end span: the drop heuristics score a
    match with 1 over the transformed penalties."""
    for name in ("zdrop", "xdrop"):
        attr = dataclasses.replace(
            RefAligner(backend="numpy", span="end-to-end", match=-1,
                       mismatch=4, gap_opening=6, gap_extension=2
                       )._attributes(), heuristic=HEURISTICS[name])
        cfg = C.full_config(attr, 128, 128)
        _held(cfg, _inputs(cfg, _hard_pairs(91), dev))


@pytest.mark.parametrize("kw", [
    dict(wildcard="N"), dict(match_classes="iupac"),
    dict(match_classes="iupac", distance="affine2p"),
])
def test_wildcard_and_classes_on_cuda_match_oracle(dev, kw):
    """Wildcard and class equality live in the eq bits, built on the card;
    the host fill repeats them."""
    rng = random.Random(92)
    pairs = []
    for p, t in random_pairs(92, 32, 40, 150, 0.08, 0.04, as_bytes=True):
        for _ in range(3):
            i = rng.randrange(len(p))
            p = p[:i] + rng.choice([b"N", b"R", b"Y"]) + p[i + 1:]
            j = rng.randrange(len(t))
            t = t[:j] + b"N" + t[j + 1:]
        pairs.append((p, t))
    api = RefAligner(backend="numpy", span="end-to-end", **kw)
    attr = api._attributes()
    wc = api._bwildcard if api._wildcard else None
    PB.oracle_fallbacks.update(dict.fromkeys(PB.oracle_fallbacks, 0))
    res = PB.align_pairs(attr, [p for p, _ in pairs], [t for _, t in pairs],
                         wildcard=wc, device=dev)
    assert not any(PB.oracle_fallbacks.values())
    for (p, t), r in zip(pairs, res):
        o = PB._oracle_one(attr, p, t, wc)
        assert (r.status, r.score, r.ops) == (o.status, o.score, o.ops)


@pytest.mark.parametrize("scope", ["full", "score"])
@pytest.mark.parametrize("name", ["zdrop", "xdrop", "wfadaptive",
                                  "wfadaptive+zdrop", "banded_adaptive"])
def test_partial_results_on_cuda_match_oracle(dev, name, scope):
    """Dropped and dead-end pairs are assembled from the card's walk: no
    pair goes to the host oracle, and every field equals the oracle's."""
    attr = dataclasses.replace(
        RefAligner(backend="numpy", span="end-to-end", scope=scope
                   )._attributes(), heuristic=HEURISTICS[name])
    pairs = random_pairs(93, 64, 40, 150, 0.3, 0.12, unrelated=0.3,
                         as_bytes=True)
    PB.oracle_fallbacks.update(dict.fromkeys(PB.oracle_fallbacks, 0))
    res = PB.align_pairs(attr, [p for p, _ in pairs], [t for _, t in pairs],
                         device=dev)
    assert not any(PB.oracle_fallbacks.values()), PB.oracle_fallbacks
    oracle = OracleAligner(attr)
    for (p, t), r in zip(pairs, res):
        o = oracle.align(p, t)
        assert (r.status, r.score, r.ops, r.end_v, r.end_h, r.dropped) == (
            o.status, o.score, o.ops, o.end_v, o.end_h, o.dropped), (p, t)
    if name in ("zdrop", "xdrop"):
        assert sum(r.dropped for r in res) >= 4


@pytest.mark.parametrize("scope", ["full", "score"])
@pytest.mark.parametrize("kw", [
    dict(heuristic="adaptive"), dict(heuristic="X-drop"), dict(match=-1),
    dict(match=-1, text_begin_free=20, text_end_free=20),
    dict(wildcard="N"), dict(extension=True),
    dict(distance="affine2p", heuristic="adaptive", match=-1),
])
def test_wavefront_aligner_new_configurations_on_cuda(dev, kw, scope):
    """pywfa's heuristic, match, wildcard and extension arguments through
    the single-pair API on the card, against the numpy oracle."""
    pairs = (random_pairs(94, 12, 30, 150, 0.1, 0.04, unrelated=0.25,
                          as_bytes=True) + _window_pairs(95, 6, 100, 20))
    a = pywfa_tpu_torch.WavefrontAligner(scope=scope, device=dev, **kw)
    o = RefAligner(scope=scope, backend="numpy", **kw)
    PB.oracle_fallbacks.update(dict.fromkeys(PB.oracle_fallbacks, 0))
    for p, t in pairs:
        if "wildcard" in kw:
            p = p[:7] + b"N" + p[8:]
        a(t.decode(), p.decode())
        o(t.decode(), p.decode())
        assert (a.status, a.score, a.cigarstring, a.locations) == (
            o.status, o.score, o.cigarstring, o.locations), (p, t)
    assert not any(PB.oracle_fallbacks.values()), PB.oracle_fallbacks


def _token_rows(cfg, pairs, dev):
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    plens = np.array([len(p) for p in pats], dtype=np.int32)
    tlens = np.array([len(t) for t in txts], dtype=np.int32)
    pat = PB.encode_batch(pats, cfg.Lp, cfg.extend_chunk,
                          PB.PATTERN_SENTINEL, plens)
    txt = PB.encode_batch(txts, cfg.Lt, cfg.extend_chunk, PB.TEXT_SENTINEL,
                          tlens)
    return (torch.from_numpy(pat).to(dev), torch.from_numpy(txt).to(dev),
            torch.from_numpy(plens).to(dev), torch.from_numpy(tlens).to(dev),
            torch.zeros((len(pairs), 4), dtype=torch.int32, device=dev))


@pytest.mark.parametrize("L,W,B,wildcard,extra", [
    (160, 256, 64, -1, {}), (160, 64, 3, 78, {}), (233, 192, 16, -1, {}),
    (234, 192, 16, 78, {}), (600, 320, 16, -1, {}), (1024, 1152, 16, -1, {}),
    (2000, 2176, 4, -1, {}),
    # band widths that are not a multiple of a thread's lane group
    (160, 61, 16, -1, {}), (233, 255, 16, 78, {}), (234, 257, 16, -1, {}),
    (600, 1153, 8, 78, {}),
    # windows that start and end outside the pattern row
    (160, 256, 16, -1, dict(kmin=-400)), (160, 256, 16, 78, dict(kmin=100)),
    (600, 320, 8, -1, dict(kmin=-700)),
    # Ltp 249 and 250 (the uint8 / int16 edge) and 2048
    (233, 256, 16, 78, {}), (234, 256, 16, 78, {}), (2032, 512, 8, -1, {}),
    # a wildcard in both rows and at the rows' ends
    (160, 256, 16, 78, dict(ends=True)), (600, 384, 8, 78, dict(ends=True)),
    # the first kernel's two refusals: more pairs than a grid dimension of
    # 65535 holds, and a pattern row past 48 KiB against a text row of 1040
    (48, 64, 65537, -1, {}), (1024, 896, 1, -1, dict(Lp=49152, kmin=-48848)),
])
def test_lcp_table_kernel_matches_plain_version(dev, L, W, B, wildcard,
                                                extra):
    """K3 at the uint8 shapes, both sides of the uint8 / int16 edge, int16
    shapes and bands past one block of 256 threads, with a wildcard; band
    widths off the lane groups, windows outside the pattern row, a wildcard
    at the rows' ends, 65537 pairs and a 49 kb pattern row (Ltp = L + 16;
    `extra`: kmin, the pattern's length Lp, wildcards at the ends)."""
    Lp = extra.get("Lp", L)
    if Lp > L:
        # the text: a mutated copy of the pattern from 48400 on, diagonal
        # -48400, inside the band
        rng = random.Random(73)
        p = "".join(rng.choice("ACGT") for _ in range(Lp))
        pairs = [(p.encode(), mutate(rng, p[48400:48400 + L], 0.05,
                                     0.0).encode()[:L])]
    else:
        pairs = random_pairs(71, B, L // 2, L, 0.08, 0.05, as_bytes=True)
    if wildcard >= 0:
        pairs = [(p[:9] + b"N" + p[10:], t[:5] + b"N" + t[6:])
                 for p, t in pairs]
    if extra.get("ends"):
        pairs = [(b"N" + p[1:-1] + b"N", b"N" + t[1:-1] + b"N")
                 for p, t in pairs]
    cfg = C.full_config(ATTR, Lp, L, W=W, wildcard=wildcard)
    kmin = extra.get("kmin", cfg.kmin)
    pat, txt, *_ = _token_rows(cfg, pairs, dev)
    assert txt.shape[1] == L + 16
    before = lcp_table.launches["lcp_table"]
    got = lcp_table.build_lcp_table_hmajor(W, kmin, wildcard, pat, txt)
    assert lcp_table.launches["lcp_table"] == before + 1
    want = lcp_table.build_lcp_table_hmajor_ref(W, kmin, wildcard, pat, txt)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == lcp_table.table_dtype(txt.shape[1])
    assert torch.equal(got, want)
    # every diagonals-a-thread and segments-a-group the kernel takes gives
    # the same bytes
    for cells in lcp_table.CELLS[got.dtype]:
        for segments in lcp_table.SEGMENTS:
            assert torch.equal(lcp_table.build_lcp_table_hmajor(
                W, kmin, wildcard, pat, txt, cells=cells, segments=segments),
                want), (cells, segments)


def test_align_batch_past_65535_pairs_matches_slices(dev):
    """engine.align_batch, which builds the run-length table for its
    batch, on 65537 short pairs in one call: equal, choices included, to
    the same pairs in slices of 4096 (the first K3 kernel refused a batch
    past 65535 pairs)."""
    B = 65537
    pairs = random_pairs(74, B, 40, 60, 0.04, 0.02, as_bytes=True)
    cfg = C.full_config(ATTR, 64, 64, W=128, S_cap=96)
    assert TE.extend_mode(cfg, B, cfg.Lt + cfg.extend_chunk) == "table"
    pat, txt, plen, tlen, frees = _token_rows(cfg, pairs, dev)
    before = lcp_table.launches["lcp_table"]
    whole = TE.align_batch(cfg, pat, txt, plen, tlen, frees, 2**31 - 1)
    assert lcp_table.launches["lcp_table"] == before + 1
    for b0 in range(0, B, 4096):
        sl = slice(b0, b0 + 4096)
        part = TE.align_batch(cfg, pat[sl].contiguous(), txt[sl].contiguous(),
                              plen[sl].contiguous(), tlen[sl].contiguous(),
                              frees[sl].contiguous(), 2**31 - 1)
        for k in KEYS:
            got = whole[k][:, sl] if k == "choices" else whole[k][sl]
            assert torch.equal(got, part[k]), (b0, k)
    torch.cuda.synchronize()
    assert bool((whole["status"] == 1).any())


@pytest.mark.parametrize("kw,frees_row", [
    (dict(span="end-to-end"), (0, 0, 0, 0)),
    (dict(span="end-to-end", scope="score"), (0, 0, 0, 0)),
    (dict(text_begin_free=20, text_end_free=20), (0, 0, 20, 20)),
    (dict(span="end-to-end", distance="affine2p"), (0, 0, 0, 0)),
    (dict(span="end-to-end", distance="levenshtein", heuristic="adaptive"),
     (0, 0, 0, 0)),
    (dict(match=-1, text_begin_free=20, text_end_free=20), (0, 0, 20, 20)),
])
@pytest.mark.parametrize("W", [512, 1152])
def test_table_variants_match_plain_and_bits(dev, kw, frees_row, W):
    attr = RefAligner(backend="numpy", **kw)._attributes()
    pairs = _window_pairs(72, 24, 300, 20 if frees_row[2] else 0)
    cfg = C.full_config(attr, 320, 352, W=W, S_cap=400,
                        record_choices=kw.get("scope") != "score")
    bits, plen, tlen, frees = _inputs(cfg, pairs, dev, frees_row)
    pat, txt, *_ = _token_rows(cfg, pairs, dev)
    table = lcp_table.build_lcp_table_hmajor(W, cfg.kmin, -1, pat, txt)
    name = fused_loop.variant(cfg, table=True)
    before = fused_loop.variant_launches[name]
    got = fused_loop.align_batch_fused_loop(cfg, None, plen, tlen, frees,
                                            2**31 - 1, table=table)
    assert fused_loop.variant_launches[name] == before + 1
    plain = fused_loop.align_batch_fused_loop_ref(cfg, None, plen, tlen,
                                                  frees, 2**31 - 1,
                                                  table=table)
    by_bits = fused_loop.align_batch_fused_loop(cfg, bits, plen, tlen, frees,
                                                2**31 - 1)
    torch.cuda.synchronize()
    for k in KEYS:
        if k in plain:
            assert torch.equal(got[k], plain[k]), k
            assert torch.equal(got[k], by_bits[k]), k
    assert int((got["status"] == C.ST_END_REACHED).sum()) >= 12


@pytest.mark.parametrize("kw,frees_row", [
    (dict(span="end-to-end"), (0, 0, 0, 0)),
    (dict(span="end-to-end", scope="score"), (0, 0, 0, 0)),
    (dict(text_begin_free=20, text_end_free=20), (0, 0, 20, 20)),
    (dict(span="end-to-end", distance="affine2p", heuristic="adaptive"),
     (0, 0, 0, 0)),
    (dict(span="end-to-end", distance="levenshtein"), (0, 0, 0, 0)),
    (dict(match=-1, text_begin_free=20, text_end_free=20), (0, 0, 20, 20)),
])
def test_narrow_and_general_kernels_match_plain_version(dev, kw, frees_row):
    """A one-shot run of a band of at most 1024 diagonals on the equality
    words launches the group build; at G = 1, 2, 4 and 8 warps a pair (a
    stride of 32, 64, 128 and 256 diagonals; 8 is the widest group a block
    of the kernel's launch bound holds) it gives the plain version's bytes,
    and so do the narrow build on the same run and the general build with
    a state to fill."""
    attr = RefAligner(backend="numpy", **kw)._attributes()
    pairs = _window_pairs(75, 24, 300, 20 if frees_row[2] else 0)
    cfg = C.full_config(attr, 320, 352, W=512, S_cap=400,
                        record_choices=kw.get("scope") != "score")
    args = _inputs(cfg, pairs, dev, frees_row)
    assert fused_loop.kernel_build(cfg, len(pairs)) == "group"
    gs = (1, 2, 4, fused_loop.GROUP_MAX_THREADS // 32)
    before = dict(fused_loop.build_launches)
    before_g = {G: fused_loop.group_launches.get(G, 0) for G in gs}
    groups = {G: fused_loop.align_batch_fused_loop(
        cfg, *args, 2**31 - 1, build="group", group=G) for G in gs}
    narrow = fused_loop.align_batch_fused_loop(cfg, *args, 2**31 - 1,
                                               build="narrow")
    general = fused_loop.align_batch_fused_loop(
        cfg, *args, 2**31 - 1, state=fused_loop.new_state(cfg, len(pairs),
                                                          dev), fresh=True,
        build="general")
    assert {k: v - before[k] for k, v in fused_loop.build_launches.items()
            } == {"group": len(gs), "narrow": 1, "general": 1, "cluster": 0}
    assert all(fused_loop.group_launches[G] == before_g[G] + 1 for G in gs)
    plain = fused_loop.align_batch_fused_loop_ref(cfg, *args, 2**31 - 1)
    torch.cuda.synchronize()
    for k in KEYS:
        if k in plain:
            for G in gs:
                assert torch.equal(groups[G][k], plain[k]), (G, k)
            assert torch.equal(narrow[k], plain[k]), k
            assert torch.equal(general[k], plain[k]), k
    assert int((plain["status"] == C.ST_END_REACHED).sum()) >= 12


def _terminal_case(case):
    """(config, pairs, frees row) of one terminal-rung case of the group
    build: 150 bp reads, half of them unrelated, whose live bands grow to
    hundreds of diagonals."""
    pairs = random_pairs(110, 32, 120, 150, 0.1, 0.05, unrelated=0.5,
                         as_bytes=True)
    if case.startswith("metric_"):
        _, metric, scope = case.split("_")
        attr = _metric_attr(metric, scope=scope)
        return (C.full_config(attr, 160, 160, record_choices=scope == "full"),
                pairs, (0, 0, 0, 0))
    if case.startswith("endsfree"):
        kw = dict(BONUS["affine"]) if case.endswith("bonus") else {}
        attr = RefAligner(backend="numpy", pattern_begin_free=10,
                          pattern_end_free=10, text_begin_free=30,
                          text_end_free=30, **kw)._attributes()
        return C.full_config(attr, 160, 160), pairs, (10, 10, 30, 30)
    # every heuristic, at parameters that leave bands wider than 64
    # diagonals (two warps' stride) on the unrelated pairs
    params = {
        "wfadaptive": HeuristicParams(
            strategy=HS.WFADAPTIVE, min_wavefront_length=5,
            max_distance_threshold=120, steps_between_cutoffs=1),
        "wfmash": HeuristicParams(
            strategy=HS.WFMASH, min_wavefront_length=5,
            max_distance_threshold=100, steps_between_cutoffs=1),
        "xdrop": HeuristicParams(strategy=HS.XDROP, xdrop=150,
                                 steps_between_cutoffs=1),
        "zdrop": HeuristicParams(strategy=HS.ZDROP, zdrop=200,
                                 steps_between_cutoffs=2),
        "banded_static": HeuristicParams(strategy=HS.BANDED_STATIC,
                                         min_k=-100, max_k=100),
        "banded_adaptive": HeuristicParams(strategy=HS.BANDED_ADAPTIVE,
                                           min_k=-90, max_k=90,
                                           steps_between_cutoffs=2),
    }[case]
    attr = dataclasses.replace(_metric_attr("affine"), heuristic=params)
    return C.full_config(attr, 160, 160), pairs, (0, 0, 0, 0)


TERMINAL_CASES = ([f"metric_{m}_{s}" for m in ("affine",) + METRICS
                   for s in ("full", "score")]
                  + ["endsfree", "endsfree_bonus", "wfadaptive", "wfmash",
                     "xdrop", "zdrop", "banded_static", "banded_adaptive"])


@pytest.mark.parametrize("case", TERMINAL_CASES)
def test_group_build_matches_plain_at_terminal_shapes(dev, case):
    """The terminal rung of 150 bp reads (W=384, or 512 under the 2-piece
    metric) on the group build, at the G the rule gives 32 pairs (8: two
    strides over the widest band) and at G = 2 (several strides a pass),
    and on the build the routing takes (the narrow build where the score
    cap passes W, else the group build), against the plain version byte
    for byte: every metric in both scopes, ends-free with and without a
    match bonus, every heuristic over bands wider than 32 * G."""
    cfg, pairs, frees_row = _terminal_case(case)
    args = _inputs(cfg, pairs, dev, frees_row)
    G = fused_loop.group_size(cfg, len(pairs))
    assert G > 2
    routed = fused_loop.kernel_build(cfg, len(pairs))
    assert routed == ("narrow" if cfg.S_cap > cfg.W else "group")
    outs = {g: fused_loop.align_batch_fused_loop(cfg, *args, 2**31 - 1,
                                                 build="group", group=g)
            for g in (G, 2)}
    outs[routed] = fused_loop.align_batch_fused_loop(cfg, *args, 2**31 - 1)
    want = fused_loop.align_batch_fused_loop_ref(cfg, *args, 2**31 - 1)
    torch.cuda.synchronize()
    for g, got in outs.items():
        assert set(got) == set(want)
        for k in (KEYS if cfg.record_choices else KEYS[:4]):
            assert torch.equal(got[k], want[k]), (g, k)
    # bands past two warps' stride: some pair reaches a score whose
    # wavefront may span more than 64 diagonals
    pad = 2 * (cfg.scope + 4) + 8
    reach = max((C.score_band(cfg.metric, cfg.gap_opening1,
                              cfg.gap_extension1, cfg.gap_extension2,
                              cfg.scope, int(s), 0) - pad) // 2
                for s in want["final_s"])
    assert reach > 32


def _warp_case(case):
    """(config, pairs, frees row, max_steps) of one warp-build case."""
    e2e = dict(span="end-to-end")
    if case.startswith("metric_"):
        _, metric, scope = case.split("_")
        attr = _metric_attr(metric if metric != "affine" else "affine",
                            scope=scope)
        pairs = _hard_pairs(96)
        return (C.full_config(attr, 128, 128,
                              record_choices=scope == "full"),
                pairs, (0, 0, 0, 0), 2**31 - 1)
    if case == "wfadaptive_narrow_band":
        # the cut leaves a band far narrower than W = 256
        attr = dataclasses.replace(
            RefAligner(backend="numpy", **e2e)._attributes(),
            heuristic=HEURISTICS["wfadaptive"])
        pairs = random_pairs(97, 48, 100, 150, 0.12, 0.04, unrelated=0.2,
                             as_bytes=True)
        return (C.full_config(attr, 160, 160, W=256, S_cap=400), pairs,
                (0, 0, 0, 0), 2**31 - 1)
    if case in ("xdrop_banded", "zdrop_banded"):
        # the drop reads a band that wf-adaptive cut in the same step, and
        # a static band then cuts M's row: the drop's maximum and its
        # first diagonal come from a band narrower than M's row
        name = case.split("_")[0]
        params = dataclasses.replace(
            HEURISTICS[name], strategy=HEURISTICS[name].strategy
            | HS.WFADAPTIVE | HS.BANDED_STATIC, min_wavefront_length=5,
            max_distance_threshold=10, min_k=-6, max_k=6)
        attr = dataclasses.replace(
            RefAligner(backend="numpy", **e2e)._attributes(),
            heuristic=params)
        return (C.full_config(attr, 128, 128), _hard_pairs(98),
                (0, 0, 0, 0), 2**31 - 1)
    if case == "overflow_w":
        attr = RefAligner(backend="numpy", **e2e)._attributes()
        pairs = random_pairs(99, 32, 20, 150, 0.1, 0.1, unrelated=0.5,
                             as_bytes=True)
        return (C.full_config(attr, 160, 160, W=128), pairs, (0, 0, 0, 0),
                2**31 - 1)
    if case == "unrelated_wide_band":
        # unrelated 150 bp pairs: a live band of a hundred diagonals and
        # more, several chunks of 32 a step
        attr = RefAligner(backend="numpy", **e2e)._attributes()
        pairs = random_pairs(100, 24, 140, 150, 0.0, 0.0, unrelated=1.0,
                             as_bytes=True)
        return C.full_config(attr, 160, 160), pairs, (0, 0, 0, 0), 2**31 - 1
    if case == "seeded_null_steps":
        attr = RefAligner(backend="numpy", **BONUS["affine"])._attributes()
        return (C.full_config(attr, 128, 128), _hard_pairs(101),
                (10, 4, 30, 6), 2**31 - 1)
    if case == "max_steps_9":
        attr = RefAligner(backend="numpy", text_begin_free=10,
                          text_end_free=10)._attributes()
        return (C.full_config(attr, 128, 128), _hard_pairs(102),
                (0, 0, 10, 10), 9)
    if case == "one_pair":
        attr = RefAligner(backend="numpy", **e2e)._attributes()
        return (C.full_config(attr, 160, 160, W=256, S_cap=96),
                random_pairs(103, 1, 150, 150, 0.02, 0.0, as_bytes=True),
                (0, 0, 0, 0), 2**31 - 1)
    # ragged: 1000 pairs, seven a block, the last block holds six
    attr = RefAligner(backend="numpy", **e2e)._attributes()
    cfg = C.full_config(attr, 96, 96, W=256, S_cap=96)
    assert fused_loop.group_pairs(cfg, 1000) == 7
    return (cfg, random_pairs(104, 1000, 40, 80, 0.05, 0.02, as_bytes=True),
            (0, 0, 0, 0), 2**31 - 1)


WARP_CASES = ([f"metric_{m}_{s}" for m in ("affine",) + METRICS
               for s in ("full", "score")]
              + ["wfadaptive_narrow_band", "xdrop_banded", "zdrop_banded",
                 "overflow_w", "unrelated_wide_band", "seeded_null_steps",
                 "max_steps_9", "one_pair", "ragged"])


@pytest.mark.parametrize("case", WARP_CASES)
def test_warp_kernel_matches_plain_version(dev, case):
    """The group build at one warp a pair (several pairs a block; the
    ragged case seven pairs a block, the last holding six) and at the G
    the routing gives, against the plain version and the general build,
    byte for byte on the whole choices tensor. Two folds of the cascade
    ran over every
    diagonal of [0, W) and now run over the band: wf-adaptive's minimum
    takes max(plen, tlen) once for the diagonals outside it, and x-drop /
    z-drop name diagonal 0 when no cell of the band is valid. A one-shot
    run reaches neither value (a trimmed band ends on valid cells, whose
    distance is at most max(plen, tlen)); the kernel keeps both, and these
    cases drive each fold over bands narrower than M's row."""
    cfg, pairs, frees_row, max_steps = _warp_case(case)
    args = _inputs(cfg, pairs, dev, frees_row)
    before = dict(fused_loop.build_launches)
    got = fused_loop.align_batch_fused_loop(cfg, *args, max_steps,
                                            build="group", group=1)
    routed = fused_loop.align_batch_fused_loop(cfg, *args, max_steps,
                                               build="group")
    general = fused_loop.align_batch_fused_loop(cfg, *args, max_steps,
                                                build="general")
    assert {k: v - before[k] for k, v in fused_loop.build_launches.items()
            } == {"group": 2, "narrow": 0, "general": 1, "cluster": 0}
    want = fused_loop.align_batch_fused_loop_ref(cfg, *args, max_steps)
    torch.cuda.synchronize()
    assert set(got) == set(want) == set(general) == set(routed)
    for k in (KEYS if cfg.record_choices else KEYS[:4]):
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(routed[k], want[k]), k
        assert torch.equal(general[k], want[k]), k
    status = got["status"]
    if case == "overflow_w":
        assert (status == C.ST_OVERFLOW_W).any()
    if case == "max_steps_9":
        assert (status == C.ST_MAX_STEPS).any()
    if case == "seeded_null_steps":
        assert (got["choices"] == C.MSRC_SEED).any()
    if case == "unrelated_wide_band":
        assert (got["final_s"] > 200).all()
    if case in ("one_pair", "ragged", "unrelated_wide_band"):
        assert (status == C.ST_END_REACHED).all()


def test_builds_refuse_launches_they_cannot_take(dev, monkeypatch):
    """The narrow build takes only a one-shot run on the equality words,
    the group build only a ring that fits a pair's share of shared memory,
    in whole groups of G warps, at most GROUP_MAX_THREADS threads a block;
    the cluster build only a band that a cluster of at most CLUSTER_MAX
    CTAs holds, in CTAs of at most CLUSTER_THREADS threads: given more
    they raise, the wrapper or the C side, and nothing falls back."""
    cfg = C.full_config(ATTR, 160, 160, W=256, S_cap=96)
    pairs = random_pairs(105, 8, 100, 150, 0.05, 0.0, as_bytes=True)
    args = _inputs(cfg, pairs, dev)
    before = dict(fused_loop.build_launches)
    with pytest.raises(RuntimeError, match="narrow"):
        fused_loop.align_batch_fused_loop(
            cfg, *args, 2**31 - 1, build="narrow",
            state=fused_loop.new_state(cfg, len(pairs), dev))
    with pytest.raises(RuntimeError, match="narrow"):
        fused_loop.align_batch_fused_loop(
            dataclasses.replace(cfg, W=1152), *_inputs(
                dataclasses.replace(cfg, W=1152), pairs, dev), 2**31 - 1,
            build="narrow")
    # a G no block holds: the wrapper raises
    with pytest.raises(RuntimeError, match="group"):
        fused_loop.align_batch_fused_loop(
            cfg, *args, 2**31 - 1, build="group",
            group=fused_loop.GROUP_MAX_THREADS // 32 + 1)
    with pytest.raises(ValueError, match="group"):
        fused_loop.align_batch_fused_loop(cfg, *args, 2**31 - 1,
                                          build="general", group=2)
    # a G that does not divide the block, and a block past the kernel's
    # launch bound: the C side refuses
    real_shape = fused_loop.launch_shape
    for shape in ((96, 2), (1024, 2)):
        monkeypatch.setattr(fused_loop, "launch_shape",
                            lambda *a, shape=shape, **k: shape)
        with pytest.raises(RuntimeError, match="group"):
            fused_loop.align_batch_fused_loop(cfg, *args, 2**31 - 1,
                                              build="group")
    monkeypatch.setattr(fused_loop, "launch_shape", real_shape)
    # a ring in global memory: no group holds it
    wide = C.full_config(ATTR, 1024, 1088, W=4096, S_cap=96)
    assert fused_loop.ring_in_global(wide)
    with pytest.raises(RuntimeError, match="group"):
        fused_loop.align_batch_fused_loop(wide, *_inputs(wide, pairs, dev),
                                          2**31 - 1, build="group")
    # a scope whose ring no cluster of at most 8 CTAs holds
    attr = RefAligner(backend="numpy", span="end-to-end",
                      gap_opening=400)._attributes()
    big = C.full_config(attr, 1024, 1088, W=2176, S_cap=96)
    assert fused_loop.cluster_size(big) == 0
    with pytest.raises(RuntimeError, match="cluster"):
        fused_loop.align_batch_fused_loop(big, *_inputs(big, pairs, dev),
                                          2**31 - 1, build="cluster")
    # a diagonal a thread: 1024 threads a CTA, past the kernel's launch
    # bound, which the C side refuses
    monkeypatch.setattr(fused_loop, "CLUSTER_DIAGONALS", 1)
    assert fused_loop.launch_shape(wide, len(pairs), "cluster")[0] \
        > fused_loop.CLUSTER_THREADS
    with pytest.raises(RuntimeError, match="cluster"):
        fused_loop.align_batch_fused_loop(wide, *_inputs(wide, pairs, dev),
                                          2**31 - 1, build="cluster")
    assert fused_loop.build_launches == before


def _cluster_case(case):
    """(config, pairs, frees row) of one cluster-build case: a band that
    spans several CTAs' slices (diagonal 0 lies on a slice edge)."""
    e2e = dict(span="end-to-end")
    if case.startswith("metric_"):
        _, metric, scope, W = case.split("_")
        attr = _metric_attr(metric, scope=scope)
        pairs = random_pairs(106, 6, 500, 700, 0.06, 0.04, unrelated=0.34,
                             as_bytes=True)
        return (C.full_config(attr, 768, 768, W=int(W), S_cap=700,
                              record_choices=scope == "full"),
                pairs, (0, 0, 0, 0))
    # begin frees of 300 either side: WF0 alone spans 601 diagonals, more
    # than a slice of 544 at W=2176
    wide_free = dict(pattern_begin_free=300, pattern_end_free=40,
                     text_begin_free=300, text_end_free=40)
    pairs = random_pairs(107, 6, 500, 700, 0.08, 0.04, unrelated=0.34,
                         as_bytes=True)
    frees = (300, 40, 300, 40)
    if case in ("endsfree", "endsfree_bonus"):
        kw = dict(wide_free, **({"match": -1} if case.endswith("bonus")
                                else {}))
        attr = RefAligner(backend="numpy", **kw)._attributes()
    else:
        params = dict(HEURISTICS, banded=HeuristicParams(
            strategy=HS.BANDED_ADAPTIVE, min_k=-300, max_k=300,
            steps_between_cutoffs=1))[case]
        attr = dataclasses.replace(
            RefAligner(backend="numpy", **wide_free)._attributes(),
            heuristic=params)
    return C.full_config(attr, 768, 768, W=2176, S_cap=900), pairs, frees


CLUSTER_CASES = ([f"metric_{m}_{s}_{W}" for m in ("affine",) + METRICS
                  for s in ("full", "score") for W in (2176, 6912)]
                 + ["endsfree", "endsfree_bonus", "wfadaptive", "xdrop",
                    "zdrop", "banded"])


@pytest.mark.parametrize("case", CLUSTER_CASES)
def test_cluster_kernel_matches_plain_version(dev, case):
    """The cluster build (a pair a cluster of CTAs, a slice of the band
    each, cells across a slice edge through distributed shared memory, the
    reductions the cluster's) against the plain version and the general
    build, byte for byte on the whole choices tensor."""
    cfg, pairs, frees_row = _cluster_case(case)
    args = _inputs(cfg, pairs, dev, frees_row)
    # the routing takes the cluster build past 3072 diagonals or where the
    # ring passes one block
    assert fused_loop.kernel_build(cfg, len(pairs)) == (
        "cluster" if cfg.W > 3072 or fused_loop.ring_in_global(cfg)
        else "general")
    before = dict(fused_loop.build_launches)
    got = fused_loop.align_batch_fused_loop(cfg, *args, 2**31 - 1,
                                            build="cluster")
    general = fused_loop.align_batch_fused_loop(cfg, *args, 2**31 - 1,
                                                build="general")
    assert {k: v - before[k] for k, v in fused_loop.build_launches.items()
            } == {"group": 0, "narrow": 0, "general": 1, "cluster": 1}
    want = fused_loop.align_batch_fused_loop_ref(cfg, *args, 2**31 - 1)
    torch.cuda.synchronize()
    assert set(got) == set(want) == set(general)
    for k in (KEYS if cfg.record_choices else KEYS[:4]):
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(general[k], want[k]), k
    assert (got["status"] != C.ST_OVERFLOW_W).any()
    if case.startswith("endsfree"):
        assert (got["status"] == C.ST_END_REACHED).any()


@pytest.mark.parametrize("kw,W,in_global", [
    (dict(span="end-to-end"), 2176, False),
    (dict(span="end-to-end"), 4096, True),
    (dict(heuristic="adaptive"), 4096, True),
    (dict(span="end-to-end", distance="affine2p"), 2176, True),
    (dict(span="end-to-end", heuristic="X-drop", xdrop=50), 2176, False),
    (dict(span="end-to-end", distance="indel"), 5120, False),
])
def test_wide_band_layouts_match_plain_version(dev, kw, W, in_global):
    """Bands past 1024 diagonals on the cluster build and on the general
    build (several diagonals a thread; the ring in global memory where it
    passes shared memory); the routing takes the cluster build past 3072
    diagonals or where the ring passes one block."""
    attr = RefAligner(backend="numpy", **kw)._attributes()
    pairs = random_pairs(73, 6, 700, 1000, 0.04, 0.03, as_bytes=True)
    cfg = C.full_config(attr, 1024, 1088, W=W, S_cap=500)
    assert fused_loop.ring_in_global(cfg) == in_global
    assert fused_loop.kernel_build(cfg, len(pairs)) == (
        "cluster" if W > 3072 or in_global else "general")
    args = _inputs(cfg, pairs, dev)
    got = fused_loop.align_batch_fused_loop(cfg, *args, 2**31 - 1,
                                            build="cluster")
    general = fused_loop.align_batch_fused_loop(cfg, *args, 2**31 - 1,
                                                build="general")
    want = fused_loop.align_batch_fused_loop_ref(cfg, *args, 2**31 - 1)
    torch.cuda.synchronize()
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(general[k], want[k]), k


@pytest.mark.parametrize("kw,W", [
    (dict(span="end-to-end"), 896), (dict(heuristic="adaptive"), 896),
    (dict(span="end-to-end"), 4096),
    (dict(span="end-to-end", distance="affine2p"), 1152),
])
@pytest.mark.parametrize("record", [False, True])
def test_segments_match_plain_version(dev, kw, W, record):
    """Start and resume segment by segment, kernel and plain each from
    its own state: equal results, and equal states for the pairs still
    running (pairs done in an earlier segment return at once); the last
    segment's result is the one-shot run's. At W=896 the segments run on
    the group build with G > 1, on the table or, with match classes, on
    the words."""
    attr = RefAligner(backend="numpy", **kw)._attributes()
    pairs = random_pairs(74, 8, 700, 1000, 0.04, 0.03, as_bytes=True)
    whole = C.full_config(attr, 1024, 1088, W=W, S_cap=1200,
                          record_choices=False)
    cfg = dataclasses.replace(whole, S_cap=150, record_choices=record)
    pat, txt, plen, tlen, frees = _token_rows(cfg, pairs, dev)
    ext = TE.build_extension(cfg, pat, txt)
    assert (ext["table"] is not None) == (not cfg.match_classes)
    if cfg.W <= 1024:
        assert fused_loop.kernel_build(cfg, len(pairs)) == "group"
        assert fused_loop.group_size(cfg, len(pairs)) > 1

    def run(fn, state, fresh, base):
        return fn(cfg, ext["bits"], plen, tlen, frees, 2**31 - 1,
                  table=ext["table"], state=state, fresh=fresh, seg_base=base)

    sk = fused_loop.new_state(cfg, len(pairs), dev)
    sp = fused_loop.new_state(cfg, len(pairs), dev)
    base, n = 0, 0
    while True:
        got = run(fused_loop.align_batch_fused_loop, sk, base == 0, base)
        want = run(fused_loop.align_batch_fused_loop_ref, sp, base == 0, base)
        torch.cuda.synchronize()
        for k in KEYS:
            if k in want:
                assert torch.equal(got[k], want[k]), (n, k)
        running = got["status"] == C.ST_OVERFLOW_S
        for k in ("ring", "lohi", "carry"):
            assert torch.equal(sk[k][running], sp[k][running]), (n, k)
        n += 1
        base += cfg.S_cap - 1
        if not bool(running.any()):
            break
    assert n >= 3
    one = fused_loop.align_batch_fused_loop(whole, ext["bits"], plen, tlen,
                                            frees, 2**31 - 1,
                                            table=ext["table"])
    for k in KEYS[:4]:
        assert torch.equal(got[k], one[k]), k


@pytest.mark.parametrize("W,seq", [
    (896, ("group",)), (896, ("general", "group")),
    (896, ("group", "general")),
    # the group build at G = 1, 4 and the routed G in turns
    (896, ("group:1", "group:4", "group")),
    (2176, ("cluster",)), (2176, ("general", "cluster")),
    (2176, ("cluster", "general")),
])
@pytest.mark.parametrize("use_table", [True, False])
@pytest.mark.parametrize("record", [False, True])
def test_segments_change_build_between_segments(dev, W, seq, use_table,
                                                record):
    """Segment by segment on the table or the equality words, with pairs
    that end in the first segment: each segment on the builds of `seq` in
    turn ("group:G" the group build at G warps a pair) gives the plain
    version's results, and a state byte-equal to a run on the general
    build alone (a done pair's too), so a state passes between builds and
    between G."""
    attr = RefAligner(backend="numpy", span="end-to-end")._attributes()
    pairs = (random_pairs(108, 6, 700, 1000, 0.04, 0.03, as_bytes=True)
             + random_pairs(109, 4, 60, 120, 0.02, 0.0, as_bytes=True))
    cfg = C.full_config(attr, 1024, 1088, W=W, S_cap=150,
                        record_choices=record)
    pat, txt, plen, tlen, frees = _token_rows(cfg, pairs, dev)
    bits = TE.build_eq_bits(cfg, pat, txt)
    table = lcp_table.build_lcp_table_hmajor(W, cfg.kmin, -1, pat, txt) \
        if use_table else None
    ext_bits = None if use_table else bits

    def run(fn, state, base, **kw):
        return fn(cfg, ext_bits, plen, tlen, frees, 2**31 - 1, table=table,
                  state=state, fresh=base == 0, seg_base=base, **kw)

    sx, sg, sp = (fused_loop.new_state(cfg, len(pairs), dev)
                  for _ in range(3))
    base, n = 0, 0
    while True:
        build, _, g = seq[n % len(seq)].partition(":")
        before = fused_loop.build_launches[build]
        got = run(fused_loop.align_batch_fused_loop, sx, base, build=build,
                  group=int(g) if g else None)
        assert fused_loop.build_launches[build] == before + 1
        gen = run(fused_loop.align_batch_fused_loop, sg, base,
                  build="general")
        want = run(fused_loop.align_batch_fused_loop_ref, sp, base)
        torch.cuda.synchronize()
        for k in KEYS:
            if k in want:
                assert torch.equal(got[k], want[k]), (n, build, k)
                assert torch.equal(gen[k], want[k]), (n, k)
        running = want["status"] == C.ST_OVERFLOW_S
        for k in ("ring", "lohi", "carry"):
            assert torch.equal(sx[k], sg[k]), (n, build, k)
            assert torch.equal(sx[k][running], sp[k][running]), (n, k)
        if n == 0:
            assert (want["status"] == C.ST_END_REACHED).any()
            assert running.any()
        n += 1
        base += cfg.S_cap - 1
        if not bool(running.any()):
            break
    assert n >= 3


@pytest.mark.parametrize("mode", ["medium", "low", "biwfa"])
def test_segmented_batch_on_cuda_matches_one_shot(dev, monkeypatch, mode):
    """A batch of 1 kb pairs with the record budget forced down: every
    memory mode runs segmented (K3 and the table variants launch) and
    answers as high does in one shot, and as the oracle."""
    monkeypatch.setattr(PB, "CHOICES_BYTES_CAP", 2**24)
    pairs = random_pairs(75, 24, 800, 1000, 0.04, 0.03, as_bytes=True)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    high = pywfa_tpu_torch.BatchWavefrontAligner(
        span="end-to-end", device=dev).align(pats, txts)
    runs = PB.segmented_runs["runs"]
    tables = lcp_table.launches["lcp_table"]
    PB.oracle_fallbacks.update(dict.fromkeys(PB.oracle_fallbacks, 0))
    aligner = pywfa_tpu_torch.BatchWavefrontAligner(
        span="end-to-end", memory_mode=mode, device=dev)
    got = aligner.align(pats, txts)
    assert PB.segmented_runs["runs"] > runs
    assert lcp_table.launches["lcp_table"] > tables
    assert not any(PB.oracle_fallbacks.values())
    key = lambda r: (r.status, r.score, r.ops, r.end_v, r.end_h)
    assert list(map(key, got)) == list(map(key, high))
    o = PB._oracle_one(aligner._attr, pats[0], txts[0])
    assert key(got[0]) == key(o)


def test_resume_on_cuda_equals_fresh(dev):
    pairs = random_pairs(76, 12, 400, 500, 0.04, 0.03, as_bytes=True)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    attr = RefAligner(backend="numpy", span="end-to-end")._attributes()
    small = dataclasses.replace(attr, system=dataclasses.replace(
        attr.system, max_alignment_steps=40))
    res, paused = PB.align_pairs_resumable(small, pats, txts, device=dev)
    assert paused is not None
    assert sum(r.status == PB.STATUS_MAX_STEPS_REACHED for r in res) >= 8
    res, paused = PB.align_pairs_resume(paused, 10**6)
    assert paused is None
    fresh = PB.align_pairs(attr, pats, txts, device=dev)
    assert [(r.status, r.score, r.ops) for r in res] == [
        (r.status, r.score, r.ops) for r in fresh]



def test_compact_snapshots_on_cuda_match_the_cpu(dev, monkeypatch):
    """16 pairs of 100-600 bp in segments of 64 scores: the boundaries'
    snapshots keep the ring rows of the pairs still running (some fewer
    than all), the results are byte-equal to the same run on the CPU, and
    the peak of device memory is no higher than with every ring row
    copied, nor than with every restore into new buffers."""
    monkeypatch.setattr(PB, "CHOICES_BYTES_CAP", 1)
    monkeypatch.setattr(PB, "REPLAY_CHOICES_BYTES", 1)
    pairs = random_pairs(78, 16, 100, 600, 0.04, 0.03, as_bytes=True)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    attr = RefAligner(backend="numpy", span="end-to-end")._attributes()
    snapshot, restore = PB._snapshot, PB._restore
    snaps = []

    def spy(state, rows=None):
        snaps.append(snapshot(state, rows))
        return snaps[-1]

    def run():
        # the run's own rise over what the earlier tests left allocated
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        res = PB.align_pairs(attr, pats, txts, device=dev)
        torch.cuda.synchronize(dev)
        return res, torch.cuda.max_memory_allocated(dev) - base

    monkeypatch.setattr(PB, "_snapshot", spy)
    run()  # the first run's lazily built tables stay out of the peaks
    del snaps[:]
    got, peak = run()
    assert snaps and any(sn["ring"].shape[0] < sn["carry"].shape[0]
                         for sn in snaps)
    monkeypatch.setattr(PB, "_snapshot",
                        lambda state, rows=None: snapshot(state))
    whole, peak_whole = run()
    monkeypatch.setattr(PB, "_restore",
                        lambda snap, d, into=None: restore(snap, d))
    _, peak_new_buffers = run()
    monkeypatch.setattr(PB, "_snapshot", spy)
    monkeypatch.setattr(PB, "_restore", restore)
    cpu = PB.align_pairs(attr, pats, txts, device="cpu")
    key = lambda r: (r.status, r.score, r.ops, r.end_v, r.end_h)
    assert list(map(key, got)) == list(map(key, cpu))
    assert list(map(key, whole)) == list(map(key, cpu))
    assert peak <= peak_whole and peak <= peak_new_buffers

@pytest.mark.parametrize("n", [1000, 5000])
@pytest.mark.parametrize("scope", ["full", "score"])
def test_wavefront_aligner_long_pairs_on_cuda(dev, n, scope):
    rng = random.Random(77)
    p = "".join(rng.choice("ACGT") for _ in range(n))
    t = mutate(rng, p, 0.04, 0.03)
    a = pywfa_tpu_torch.WavefrontAligner(p, scope=scope, device=dev)
    b = RefAligner(p, scope=scope, backend="numpy")
    ra, rb = a(t), b(t)
    assert (ra.score, ra.status, ra.cigartuples) == (
        rb.score, rb.status, rb.cigartuples)


@pytest.mark.parametrize("shards", ["every card", "eight on one"])
@pytest.mark.parametrize("record", [True, False])
def test_sharded_matches_unsharded_on_every_card(dev, record, shards):
    """The mesh over every card of the host, and eight shards on the
    first card, against engine.align_batch on the first: a shard may take
    another build or G than the whole batch (group_size reads B: 1024
    pairs take one warp a pair, a shard of 128 several), and must give
    the same bytes; the choices stay on their shard's card; the gathered
    meta is the whole batch."""
    from pywfa_tpu_torch.parallel import make_mesh, sharded_align_batch
    from pywfa_tpu_torch.ops.fused_loop import launch_shape
    n = torch.cuda.device_count()
    mesh = make_mesh() if shards == "every card" else make_mesh([dev] * 8)
    assert mesh.size == (n if shards == "every card" else 8)
    assert mesh.group is None
    pairs = random_pairs(78, 1024 * n, 120, 150, 0.02, 0.0, as_bytes=True)
    cfg = C.full_config(ATTR, 160, 160, W=256, S_cap=96,
                        record_choices=record)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    host = (PB.encode_batch(pats, cfg.Lp, cfg.extend_chunk,
                            PB.PATTERN_SENTINEL),
            PB.encode_batch(txts, cfg.Lt, cfg.extend_chunk,
                            PB.TEXT_SENTINEL),
            np.array([len(p) for p in pats], np.int32),
            np.array([len(t) for t in txts], np.int32),
            np.zeros((len(pats), 4), np.int32))
    whole = TE.align_batch(cfg, *(torch.from_numpy(a).to(dev) for a in host),
                           2**31 - 1)
    out = sharded_align_batch(cfg, mesh, gather_results=True)(*host,
                                                              2**31 - 1)
    for key in KEYS[:-1]:
        assert torch.equal(out[key].cpu(), whole[key].cpu()), key
    if record:
        assert [c.device for c in out["choices"]] == list(mesh.devices)
        assert torch.equal(torch.cat([c.cpu() for c in out["choices"]], 1),
                           whole["choices"].cpu())
    assert int(out["steps"]) == int(whole["steps"])
    assert (whole["status"] == C.ST_END_REACHED).all()
    if shards == "eight on one":
        B = len(pairs)
        assert launch_shape(cfg, B // 8, "group", dev)[1] > launch_shape(
            cfg, B, "group", dev)[1]


def test_cli_on_the_card_matches_the_cpu(dev, tmp_path):
    """`python -m pywfa_tpu_torch.cli align --device cuda` writes the
    same files as `--device cpu` (the plain versions), in tsv and paf, on
    mixed lengths over three length buckets with a lowercase read and a
    read with an N."""
    from pywfa_tpu_torch import cli
    from pywfa_tpu_torch.utils import write_fasta
    pairs = random_pairs(79, 40, 30, 220, 0.04, 0.02, as_bytes=True)
    pats = [p.decode() for p, _ in pairs]
    txts = [t.decode() for _, t in pairs]
    txts[0] = txts[0].lower()
    pats[1] = pats[1][:10] + "N" + pats[1][11:]
    pfa, tfa = str(tmp_path / "p.fa"), str(tmp_path / "t.fa")
    write_fasta(pfa, [(f"p{i}", s) for i, s in enumerate(pats)])
    write_fasta(tfa, [(f"t{i}", s) for i, s in enumerate(txts)])
    for fmt in ("tsv", "paf"):
        files = {}
        for device in ("cuda", "cpu"):
            files[device] = str(tmp_path / f"{device}.{fmt}")
            assert cli.main(["align", "--patterns", pfa, "--texts", tfa,
                             "--format", fmt, "--out", files[device],
                             "--device", device]) == 0
        with open(files["cuda"], "rb") as a, open(files["cpu"], "rb") as b:
            got = a.read()
            assert got == b.read()
        assert len(got.splitlines()) == len(pairs)


def _chunk_case(dev, equality, W, S_cap, record, seed=120):
    """(config, token rows, plen, tlen, frees) of an in-place compare
    case: 22 pairs of 250-321 bp at 5% / 3%, with N (the wildcard) or IUPAC
    codes (the classes) on both sides, a pair that fills its rows up to
    their sentinels and a 3 bp pair; rows of 337 and 363 tokens, so that
    most rows start off a 4-byte boundary."""
    attr = RefAligner(backend="numpy", span="end-to-end")._attributes()
    cfg = C.full_config(attr, 321, 347, W=W, S_cap=S_cap,
                        record_choices=record,
                        wildcard=ord("N") if equality == "wildcard" else -1)
    if equality == "classes":
        cfg = dataclasses.replace(cfg, match_classes="iupac")
    rng = random.Random(seed)
    codes = {"bytes": "", "wildcard": "N", "classes": "NRYSWKM"}[equality]
    pairs = []
    for p, t in random_pairs(seed, 22, 250, 321, 0.05, 0.03):
        p, t = list(p), list(t)
        for arr in (p, t):
            for _ in range(len(arr) // 15 if codes else 0):
                arr[rng.randrange(len(arr))] = rng.choice(codes)
        pairs.append(("".join(p).encode(), "".join(t)[:347].encode()))
    full = "".join(rng.choice("ACGT") for _ in range(321))
    pairs += [(full.encode(), (full + full[:26]).encode()),
              (b"ACG", b"ACGT")]
    return (cfg,) + _token_rows(cfg, pairs, dev)


@pytest.mark.parametrize("equality", ["bytes", "wildcard", "classes"])
@pytest.mark.parametrize("record", [True, False])
@pytest.mark.parametrize("build,group,W", [
    ("group", 1, 512), ("group", 4, 512), ("cluster", None, 2176),
    ("general", None, 2176)])
def test_chunk_builds_match_plain_and_bits(dev, build, group, W, record,
                                           equality):
    """Each build that compares the token rows in place (the group build
    at G = 1 and G = 4, the cluster build with four CTAs a pair, the
    general build) gives the plain version's bytes and the words' on the
    same build, choices included, with and without the record, byte for
    byte, with a wildcard and under match classes."""
    cfg, pat, txt, plen, tlen, frees = _chunk_case(dev, equality, W, 400,
                                                   record)
    ext = TE.build_extension(dataclasses.replace(cfg, extend_force="chunk"),
                             pat, txt)
    assert ext["pat"] is not None and ext["bits"] is None
    bits = TE.build_eq_bits(cfg, pat, txt)
    name = fused_loop.variant(cfg, chunk=True)
    before = (fused_loop.variant_launches[name],
              fused_loop.build_launches[build])
    got = fused_loop.align_batch_fused_loop(
        cfg, None, plen, tlen, frees, 2**31 - 1, pat=ext["pat"],
        txt=ext["txt"], build=build, group=group)
    assert (fused_loop.variant_launches[name],
            fused_loop.build_launches[build]) == (before[0] + 1,
                                                  before[1] + 1)
    plain = fused_loop.align_batch_fused_loop_ref(
        cfg, None, plen, tlen, frees, 2**31 - 1, pat=ext["pat"],
        txt=ext["txt"])
    by_bits = fused_loop.align_batch_fused_loop(
        cfg, bits, plen, tlen, frees, 2**31 - 1, build=build, group=group)
    torch.cuda.synchronize()
    for k in KEYS:
        if k in plain:
            assert torch.equal(got[k], plain[k]), k
            assert torch.equal(got[k], by_bits[k]), k
    assert int((got["status"] == C.ST_END_REACHED).sum()) >= 20


@pytest.mark.parametrize("W,seq", [
    (896, ("group", "general")), (896, ("group:1", "group:4", "group")),
    (2176, ("cluster", "general"))])
@pytest.mark.parametrize("equality", ["bytes", "wildcard"])
@pytest.mark.parametrize("record", [False, True])
def test_chunk_segments_match_plain_and_bits(dev, W, seq, equality, record):
    """Segment by segment on the rows, each segment on the builds of `seq`
    in turn, from WF0 and then from the stored state: the plain version's
    results, and a state byte-equal to the same segments on the words
    (a done pair's too)."""
    cfg, pat, txt, plen, tlen, frees = _chunk_case(dev, equality, W, 100,
                                                   record)
    ext = TE.build_extension(dataclasses.replace(cfg, extend_force="chunk"),
                             pat, txt)
    bits = TE.build_eq_bits(cfg, pat, txt)

    def run(fn, state, base, rows=True, **kw):
        src = (dict(pat=ext["pat"], txt=ext["txt"]) if rows else {})
        return fn(cfg, None if rows else bits, plen, tlen, frees, 2**31 - 1,
                  state=state, fresh=base == 0, seg_base=base, **src, **kw)

    sx, sb, sp = (fused_loop.new_state(cfg, len(plen), dev)
                  for _ in range(3))
    base, n = 0, 0
    while True:
        build, _, g = seq[n % len(seq)].partition(":")
        kw = dict(build=build, group=int(g) if g else None)
        got = run(fused_loop.align_batch_fused_loop, sx, base, **kw)
        words = run(fused_loop.align_batch_fused_loop, sb, base, False, **kw)
        want = run(fused_loop.align_batch_fused_loop_ref, sp, base)
        torch.cuda.synchronize()
        for k in KEYS:
            if k in want:
                assert torch.equal(got[k], want[k]), (n, build, k)
                assert torch.equal(got[k], words[k]), (n, build, k)
        running = want["status"] == C.ST_OVERFLOW_S
        for k in ("ring", "lohi", "carry"):
            assert torch.equal(sx[k], sb[k]), (n, build, k)
            assert torch.equal(sx[k][running], sp[k][running]), (n, k)
        n += 1
        base += cfg.S_cap - 1
        if not bool(running.any()):
            break
    assert n >= 2


def test_narrow_build_refuses_the_rows(dev):
    """The narrow build extends by the words alone: a launch on the rows
    forced onto it raises, the C side refusing it, and nothing falls
    back; the routing never sends one there."""
    cfg, pat, txt, plen, tlen, frees = _chunk_case(dev, "bytes", 384, 649,
                                                   True)
    ext = TE.build_extension(dataclasses.replace(cfg, extend_force="chunk"),
                             pat, txt)
    assert fused_loop.kernel_build(cfg, len(plen)) == "narrow"
    assert fused_loop.kernel_build(cfg, len(plen), pat=ext["pat"]) == "group"
    before = dict(fused_loop.build_launches)
    with pytest.raises(RuntimeError, match="narrow"):
        fused_loop.align_batch_fused_loop(
            cfg, None, plen, tlen, frees, 2**31 - 1, pat=ext["pat"],
            txt=ext["txt"], build="narrow")
    assert fused_loop.build_launches == before
