"""The port's stages around the fused loop, its batch path and its pywfa
API under all five distance metrics, against the JAX package.

For affine2p, gap-linear, edit (levenshtein) and indel, on both spans
(ends-free with match 0) and in both scopes:

- the walk against `pywfa_tpu.ops.engine.traceback_walk`;
- the packed pipelines against `align_batch_pallas_packed_full`/`_meta`;
- `align_pairs` against `pywfa_tpu.batch.align_pairs` and the oracle, with
  an escalation case a metric;
- `WavefrontAligner(distance=...)` against the reference's numpy and jax
  backends;
- `supported()` at every rung the ladder derives for 150 bp reads and for
  the API's 256 bp bucket.

Everything is an integer or a string: tolerance zero. The loop itself is
held in `tests/test_torch_metrics.py`, whose inputs these tests share.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pywfa_tpu
import pywfa_tpu_torch
from pywfa_tpu import batch as BT
from pywfa_tpu.batch import pack_tokens
from pywfa_tpu.ops import engine as E
from pywfa_tpu_torch import batch as PB
from pywfa_tpu_torch.ops import config as C
from pywfa_tpu_torch.ops import engine as TE
from pywfa_tpu_torch.ops import fused_loop as TFL
from tests.test_torch_fused_loop import MAXS, _all_three
from tests.test_torch_metrics import (ALL_METRICS, EF_PAIRS, METRICS, PAIRS,
                                      _attr, _inputs)

torch.set_num_threads(1)

FIELDS = ("status", "score", "ops", "end_v", "end_h", "wf_score", "dropped")


@pytest.mark.parametrize("case", ["div25", "gaps"])
@pytest.mark.parametrize("metric", METRICS)
def test_walk_matches_reference(metric, case):
    cfg, *inputs = _inputs(_attr(metric), PAIRS[case], "full")
    port = _all_three(cfg, *inputs)[0]
    tcfg = C.from_reference(cfg)
    ok = TE.walkable(port)
    got = TE.traceback_walk(tcfg, port["choices"], port["final_s"],
                            port["end_k"], ok)
    want = E.traceback_walk(cfg, jnp.asarray(port["choices"].numpy()),
                            jnp.asarray(port["final_s"].numpy()),
                            jnp.asarray(port["end_k"].numpy()),
                            jnp.asarray(ok.numpy()))
    for g, w, name in zip(got, want, ("ops", "n_ops", "k_start", "fb")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert not got[3].any() and ok.any()


@pytest.mark.parametrize("layout", ["compact", "full", "meta"])
@pytest.mark.parametrize("span", ["end-to-end", "ends-free"])
@pytest.mark.parametrize("metric", METRICS)
def test_packed_pipeline_matches_pallas_pipeline(metric, span, layout):
    pairs, row = EF_PAIRS["all"]
    if span == "end-to-end":
        row = (0, 0, 0, 0)
    cfg, pat, txt, plen, tlen, frees = _inputs(
        _attr(metric, span, frees=row), pairs, "rung1",
        record=layout != "meta")
    if layout == "compact":
        cfg = dataclasses.replace(cfg, ops_out=32)
    if layout != "meta":
        assert E.packed_layout(cfg) == layout
    B = len(plen)
    packed = np.concatenate([pack_tokens(pat, plen, width=cfg.Lp),
                             pack_tokens(txt, tlen, width=cfg.Lt)], axis=1)
    run = (E.align_batch_pallas_packed_meta if layout == "meta"
           else E.align_batch_pallas_packed_full)
    ref = run(cfg, B, B, jnp.asarray(packed), jnp.asarray(plen),
              jnp.asarray(tlen), jnp.asarray(frees), jnp.int32(MAXS))
    port = TE.align_batch_packed_full(
        C.from_reference(cfg), torch.from_numpy(packed),
        torch.from_numpy(plen), torch.from_numpy(tlen),
        torch.from_numpy(frees), MAXS)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def _fields(results):
    return [tuple(getattr(r, f) for f in FIELDS) for r in results]


# pairs that escalate past the first rung, some (disjoint alphabets) to
# the terminal one
ESCALATING = PAIRS["div25"] + PAIRS["gaps"] + [
    (b"AC" * 50, b"GT" * 50), (b"CAAC" * 25, b"TTGG" * 24)]


@pytest.mark.parametrize("scope", ["full", "score"])
@pytest.mark.parametrize("span", ["end-to-end", "ends-free"])
@pytest.mark.parametrize("metric", METRICS)
def test_align_pairs_matches_reference_and_oracle(metric, span, scope):
    row = (0, 0, 0, 0) if span == "end-to-end" else (6, 5, 8, 7)
    attr = _attr(metric, span, scope, row)
    pairs = ESCALATING + PAIRS["div5"]
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    PB.oracle_fallbacks.update(dict.fromkeys(PB.oracle_fallbacks, 0))
    port = PB.align_pairs(C.attributes_from_reference(attr), pats, txts,
                          device="cpu")
    fallbacks = dict(PB.oracle_fallbacks)
    assert _fields(port) == _fields(BT.align_pairs(attr, pats, txts))
    assert _fields(port) == _fields(
        [BT._oracle_one(attr, p, t, None) for p, t in pairs])
    assert fallbacks["inconsistent walk"] == 0 and fallbacks["dropped"] == 0
    if metric != "indel":
        assert fallbacks["overflow at full caps"] == 0


@pytest.mark.parametrize("metric", METRICS)
def test_escalation_reaches_the_terminal_rung(metric, monkeypatch):
    attr = C.attributes_from_reference(_attr(metric))
    pats = [p for p, _ in ESCALATING]
    txts = [t for _, t in ESCALATING]
    rungs = []
    dispatch = PB.align_pairs_dispatch

    def record(*args, **kw):
        sub = dispatch(*args, **kw)
        rungs.append((sub.rung.cfg.W, sub.rung.cfg.S_cap, sub.rung.at_full_caps))
        assert TFL.supported(sub.rung.cfg)
        return sub

    monkeypatch.setattr(PB, "align_pairs_dispatch", record)
    port = PB.align_pairs(attr, pats, txts, device="cpu")
    assert len(rungs) >= 2 and not rungs[0][2] and rungs[-1][2]
    assert rungs[0][1] < rungs[-1][1]
    oracle = [pywfa_tpu_torch.oracle.OracleAligner(attr).align(p, t)
              for p, t in ESCALATING]
    assert _fields(port) == _fields(oracle)


def test_indel_overflow_at_full_caps_goes_to_the_oracle_and_is_counted():
    """Unrelated pairs under indel can need more than max(plen, tlen) + 1,
    the terminal rung's score cap: they end ST_OVERFLOW_S at full caps and
    the oracle answers them, in the reference too. The counter shows it."""
    pairs = [(b"AC" * 40, b"GT" * 40), (b"ACGT" * 10, b"ACGT" * 10)]
    attr = _attr("indel")
    PB.oracle_fallbacks.update(dict.fromkeys(PB.oracle_fallbacks, 0))
    port = PB.align_pairs(C.attributes_from_reference(attr),
                          [p for p, _ in pairs], [t for _, t in pairs],
                          device="cpu")
    assert PB.oracle_fallbacks == {"inconsistent walk": 0,
                                   "overflow at full caps": 1, "dropped": 0}
    assert _fields(port) == _fields(BT.align_pairs(
        attr, [p for p, _ in pairs], [t for _, t in pairs]))
    assert port[0].score == 160 and port[1].score == 0


API_PAIRS = [(p.decode(), t.decode()) for p, t in
             PAIRS["div5"][:6] + PAIRS["gaps"][:3] + PAIRS["div25"][:3]]


@pytest.mark.parametrize("scope", ["full", "score"])
@pytest.mark.parametrize("span", ["end-to-end", "ends-free"])
@pytest.mark.parametrize("metric", METRICS)
def test_wavefront_aligner_matches_reference_backends(metric, span, scope):
    kw = dict(distance=metric, span=span, scope=scope)
    if span == "ends-free":
        kw.update(pattern_begin_free=3, pattern_end_free=4,
                  text_begin_free=6, text_end_free=5)
    port = pywfa_tpu_torch.WavefrontAligner(device="cpu", **kw)
    ref_np = pywfa_tpu.WavefrontAligner(backend="numpy", **kw)
    ref_jax = pywfa_tpu.WavefrontAligner(backend="jax", **kw)
    for p, t in API_PAIRS:
        got = port(t, p)
        for ref in (ref_np, ref_jax):
            want = ref(t, p)
            assert (got.status, got.score, got.cigartuples,
                    got.pattern_start, got.pattern_end, got.text_start,
                    got.text_end) == (
                want.status, want.score, want.cigartuples,
                want.pattern_start, want.pattern_end, want.text_start,
                want.text_end), (p, t)
            assert port.cigarstring == ref.cigarstring
            assert port.locations == ref.locations


def _ladder(attr, scope):
    """Every rung `_plan_rung` and `_next_caps` give a batch of 4096
    150 bp reads under `attr` (the port's attributes), then the terminal
    rung of the API's 256 bp bucket."""
    attr = PB.validate_alignment(attr, 150, 150)
    Lp = Lt = PB._bucket_len(150)
    rung = PB._plan_rung(attr, Lp, Lt, 150, 4096, None, None, None, False)
    rungs = [rung.cfg]
    while not rung.at_full_caps:
        W, S_cap = PB._next_caps(rung, attr, 150, 150)
        rung = PB._plan_rung(attr, Lp, Lt, 150, 4096, None, W, S_cap, True)
        assert not rung.segmented
        rungs.append(rung.cfg)
    assert len(rungs) >= 2
    rungs.append(C.full_config(attr, 256, 256,
                               record_choices=scope == "full"))
    return rungs


@pytest.mark.parametrize("span", ["end-to-end", "ends-free"])
@pytest.mark.parametrize("scope", ["full", "score"])
@pytest.mark.parametrize("metric", ALL_METRICS)
def test_supported_at_every_rung_of_the_ladder(metric, scope, span):
    """Every rung `_plan_rung` and `_next_caps` give 150 bp reads, and
    the terminal rung of the API's 256 bp bucket, fits the
    kernel: one thread a diagonal and the ring in shared memory (affine2p's
    terminal rung, W 512 with a scope of 26, only with the ring's
    per-component depth)."""
    rungs = _ladder(C.attributes_from_reference(_attr(metric, span, scope)),
                    scope)
    for c in rungs:
        assert TFL.supported(c), (c.W, c.S_cap, TFL.smem_bytes(c))
        assert TFL.smem_bytes(c) <= TFL.SMEM_LIMIT
    if metric == "affine2p":
        assert rungs[0].W == 384 and rungs[0].scope == 26
        assert rungs[-2].W == 512 and rungs[-2].S_cap == 649
        assert sum(TFL.ring_depths(rungs[0])) == 36
        # a uniform ring of scope rows a component would not fit there
        assert 5 * 26 * 512 * 4 > TFL.SMEM_LIMIT


@pytest.mark.parametrize("scope", ["full", "score"])
@pytest.mark.parametrize("kw", [
    dict(heuristic="adaptive", span="end-to-end"), dict(heuristic="X-drop"),
    dict(match=-1, text_begin_free=50, text_end_free=50),
    dict(match=-1, heuristic="adaptive", pattern_begin_free=20),
], ids=["adaptive", "xdrop", "seeded", "seeded-adaptive"])
@pytest.mark.parametrize("metric", ["affine", "affine2p", "linear"])
def test_new_variants_supported_at_every_rung(metric, kw, scope):
    """The heuristic and seeded variants on the same ladders: the
    cascade's reduction partials and, with a match bonus, the deeper ring
    of the transformed penalties (affine2p at match -1: a scope of 53)
    still fit one block; a heuristic's band cap keeps W at or under the
    exact ladder's."""
    api = pywfa_tpu_torch.WavefrontAligner(backend="numpy", distance=metric,
                                           scope=scope, **kw)
    rungs = _ladder(api._attributes(), scope)
    exact = _ladder(dataclasses.replace(
        api._attributes(), heuristic=type(api._attributes().heuristic)()),
        scope)
    for c, e in zip(rungs, exact):
        assert TFL.supported(c), (c.W, c.S_cap, TFL.smem_bytes(c))
        assert TFL.smem_bytes(c) <= TFL.SMEM_LIMIT
        assert c.W <= e.W
        suffix = "_heur" if "heuristic" in kw else ""
        assert suffix in TFL.variant(c)
        assert ("endsfreeseed" in TFL.variant(c)) == ("match" in kw)


def test_variants_name_every_metric_span_and_scope():
    """5 metrics x 2 spans x 2 scopes, each with and without a heuristic,
    plus the seeded span (ends-free with a match bonus) for the three
    metrics that carry a match weight; the launch counts name each of
    them three times, by the equality words, (`_table`) by the run-length
    table and (`_chunk`) by the token rows compared in place."""
    assert len(TFL.VARIANTS) == 52 == len(set(TFL.VARIANTS))
    assert set(TFL.variant_launches) == set(TFL.VARIANTS) | {
        v + "_table" for v in TFL.VARIANTS} | {
        v + "_chunk" for v in TFL.VARIANTS}
    assert len(TFL.variant_launches) == 156
    seen = set()
    for metric in ALL_METRICS:
        for span in ("end-to-end", "ends-free"):
            for scope in ("full", "score"):
                cfg = C.full_config(C.attributes_from_reference(
                    _attr(metric, span, scope)), 64, 64,
                    record_choices=scope == "full")
                seen.add(TFL.variant(cfg))
                seen.add(TFL.variant(dataclasses.replace(cfg, strategy=8)))
                if span == "ends-free" and TFL.supported(
                        dataclasses.replace(cfg, match=-1)):
                    for strategy in (0, 16):
                        seen.add(TFL.variant(dataclasses.replace(
                            cfg, match=-1, strategy=strategy)))
    assert seen == set(TFL.VARIANTS)
    assert not TFL.supported(dataclasses.replace(
        C.full_config(C.attributes_from_reference(
            _attr("indel", "ends-free", "full")), 64, 64), match=-1))
