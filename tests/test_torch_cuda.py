"""The CUDA fused-loop kernel against its plain torch version, on the card.

Every variant (each of the five distance metrics, end-to-end or ends-free
span, full-CIGAR or score-only scope) is held against the plain version,
and the API paths against the scalar oracle.

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
from pywfa_tpu_torch.attributes import AlignerAttributes, AlignmentForm
from pywfa_tpu_torch.constants import AlignmentSpan
from pywfa_tpu_torch.oracle import OracleAligner
from pywfa_tpu_torch.ops import config as C
from pywfa_tpu_torch.ops import engine as TE
from pywfa_tpu_torch.ops import fused_loop
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
