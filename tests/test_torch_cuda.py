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


@pytest.mark.parametrize("L,W,B,wildcard", [
    (160, 256, 64, -1), (160, 64, 3, 78), (233, 192, 16, -1),
    (234, 192, 16, 78), (600, 320, 16, -1), (1024, 1152, 16, -1),
    (2000, 2176, 4, -1),
])
def test_lcp_table_kernel_matches_plain_version(dev, L, W, B, wildcard):
    """K3 at the uint8 shapes, both sides of the uint8 / int16 edge, int16
    shapes and bands past one block of 256 threads, with a wildcard."""
    pairs = random_pairs(71, B, L // 2, L, 0.08, 0.05, as_bytes=True)
    if wildcard >= 0:
        pairs = [(p[:9] + b"N" + p[10:], t[:5] + b"N" + t[6:])
                 for p, t in pairs]
    cfg = C.full_config(ATTR, L, L, W=W, wildcard=wildcard)
    pat, txt, *_ = _token_rows(cfg, pairs, dev)
    before = lcp_table.launches["lcp_table"]
    got = lcp_table.build_lcp_table_hmajor(W, cfg.kmin, wildcard, pat, txt)
    assert lcp_table.launches["lcp_table"] == before + 1
    want = lcp_table.build_lcp_table_hmajor_ref(W, cfg.kmin, wildcard, pat,
                                                txt)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == lcp_table.table_dtype(txt.shape[1])
    assert torch.equal(got, want)


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
    words launches the narrow kernel; the same run with a state to fill
    launches the general one. Both give the plain version's bytes."""
    attr = RefAligner(backend="numpy", **kw)._attributes()
    pairs = _window_pairs(75, 24, 300, 20 if frees_row[2] else 0)
    cfg = C.full_config(attr, 320, 352, W=512, S_cap=400,
                        record_choices=kw.get("scope") != "score")
    args = _inputs(cfg, pairs, dev, frees_row)
    narrow = fused_loop.align_batch_fused_loop(cfg, *args, 2**31 - 1)
    general = fused_loop.align_batch_fused_loop(
        cfg, *args, 2**31 - 1, state=fused_loop.new_state(cfg, len(pairs),
                                                          dev), fresh=True)
    plain = fused_loop.align_batch_fused_loop_ref(cfg, *args, 2**31 - 1)
    torch.cuda.synchronize()
    for k in KEYS:
        if k in plain:
            assert torch.equal(narrow[k], plain[k]), k
            assert torch.equal(general[k], plain[k]), k
    assert int((plain["status"] == C.ST_END_REACHED).sum()) >= 12


@pytest.mark.parametrize("kw,W,in_global", [
    (dict(span="end-to-end"), 2176, False),
    (dict(span="end-to-end"), 4096, True),
    (dict(heuristic="adaptive"), 4096, True),
    (dict(span="end-to-end", distance="affine2p"), 2176, True),
    (dict(span="end-to-end", heuristic="X-drop", xdrop=50), 2176, False),
    (dict(span="end-to-end", distance="indel"), 5120, False),
])
def test_wide_band_layouts_match_plain_version(dev, kw, W, in_global):
    attr = RefAligner(backend="numpy", **kw)._attributes()
    pairs = random_pairs(73, 6, 700, 1000, 0.04, 0.03, as_bytes=True)
    cfg = C.full_config(attr, 1024, 1088, W=W, S_cap=500)
    assert fused_loop.ring_in_global(cfg) == in_global
    args = _inputs(cfg, pairs, dev)
    got = fused_loop.align_batch_fused_loop(cfg, *args, 2**31 - 1)
    want = fused_loop.align_batch_fused_loop_ref(cfg, *args, 2**31 - 1)
    torch.cuda.synchronize()
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kw,W", [
    (dict(span="end-to-end"), 896), (dict(heuristic="adaptive"), 896),
    (dict(span="end-to-end"), 4096),
    (dict(span="end-to-end", distance="affine2p"), 1152),
])
@pytest.mark.parametrize("record", [False, True])
def test_segments_match_plain_version(dev, kw, W, record):
    """Start and resume segment by segment, kernel and plain each from
    its own state: equal results, and equal states for the pairs still
    running; the last segment's result is the one-shot run's."""
    attr = RefAligner(backend="numpy", **kw)._attributes()
    pairs = random_pairs(74, 8, 700, 1000, 0.04, 0.03, as_bytes=True)
    whole = C.full_config(attr, 1024, 1088, W=W, S_cap=1200,
                          record_choices=False)
    cfg = dataclasses.replace(whole, S_cap=150, record_choices=record)
    pat, txt, plen, tlen, frees = _token_rows(cfg, pairs, dev)
    ext = TE.build_extension(cfg, pat, txt)
    assert (ext["table"] is not None) == (not cfg.match_classes)

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
