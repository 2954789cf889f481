"""Wildcards and match classes in the port against the JAX package.

The equality bits are where both live: `build_eq_bits` with a wildcard
byte, with the IUPAC table and with a custom class table must equal
`engine._build_eq_bits` word for word, and `align_pairs` on the CPU (the
plain loop over those bits, then the host fill under the same equality)
must equal the reference's batch results and the scalar oracle on every
field. Tolerance: zero.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pywfa_tpu
import pywfa_tpu_torch
from pywfa_tpu import attributes as RA
from pywfa_tpu import batch as BT
from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.oracle import OracleAligner
from pywfa_tpu.ops import engine as E
from pywfa_tpu_torch import attributes as PA
from pywfa_tpu_torch import batch as PB
from pywfa_tpu_torch.ops import config as C
from pywfa_tpu_torch.ops import engine as TE

torch.set_num_threads(1)

FIELDS = ("status", "score", "ops", "end_v", "end_h", "wf_score", "dropped")
PURINES = {"A": "R", "G": "R", "C": "Y", "T": "Y", "N": "RY"}
# a class table is registered per package, under one name in both
RA.register_match_classes("purine_pyrimidine", PURINES)
PA.register_match_classes("purine_pyrimidine", PURINES)


def ambiguous_pairs(n, L, seed, codes=b"NRYSWKM"):
    """Pairs at 10% divergence with ambiguity codes on both sides (the
    twin of tests/test_match_classes.py's corpus)."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    amb = np.frombuffer(codes, dtype=np.uint8)
    out = []
    for _ in range(n):
        p = alpha[rng.integers(0, 4, L)]
        t = p.copy()
        idx = rng.choice(L, max(1, L // 10), replace=False)
        t[idx] = alpha[rng.integers(0, 4, len(idx))]
        for arr in (p, t):
            j = rng.choice(L, max(1, L // 12), replace=False)
            arr[j] = amb[rng.integers(0, len(amb), len(j))]
        out.append((p.tobytes(), t[: L - int(rng.integers(0, 6))].tobytes()))
    return out


def _fields(results):
    return [tuple(getattr(r, f) for f in FIELDS) for r in results]


@pytest.mark.parametrize("kw", [
    dict(wildcard=ord("N")), dict(match_classes="iupac"),
    dict(match_classes="purine_pyrimidine"), dict(),
], ids=["wildcard", "iupac", "custom", "exact"])
@pytest.mark.parametrize("W", [128, 384])
def test_eq_bits_match_reference(kw, W):
    pairs = ambiguous_pairs(9, 70, 7) + [(b"ANNT", b"ACGT"), (b"A", b"N")]
    attr = WavefrontAligner(
        backend="numpy", match_classes=kw.get("match_classes"))._attributes()
    cfg = E.full_config(attr, 80, 80, wildcard=kw.get("wildcard", -1), W=W)
    pat = BT.encode_batch([p for p, _ in pairs], cfg.Lp, cfg.extend_chunk,
                          BT.PATTERN_SENTINEL)
    txt = BT.encode_batch([t for _, t in pairs], cfg.Lt, cfg.extend_chunk,
                          BT.TEXT_SENTINEL)
    ref = np.asarray(E.build_eq_bits(cfg, jnp.asarray(pat), jnp.asarray(txt)))
    port = TE.build_eq_bits(C.from_reference(cfg), torch.from_numpy(pat),
                            torch.from_numpy(txt))
    np.testing.assert_array_equal(port.numpy().view(np.uint32), ref)
    if kw:
        exact = TE.build_eq_bits(
            C.from_reference(E.full_config(
                WavefrontAligner(backend="numpy")._attributes(), 80, 80,
                W=W)),
            torch.from_numpy(pat), torch.from_numpy(txt))
        assert not torch.equal(port, exact)


@pytest.mark.parametrize("kw", [
    dict(span="end-to-end", match_classes="iupac"),
    dict(span="end-to-end", distance="affine2p", match_classes="iupac"),
    dict(match_classes="iupac", pattern_begin_free=10, pattern_end_free=10,
         text_begin_free=10, text_end_free=10),
    dict(span="end-to-end", match_classes="purine_pyrimidine"),
    dict(span="end-to-end", wildcard="N"),
    dict(wildcard="N", distance="levenshtein", text_begin_free=8,
         text_end_free=8),
    dict(span="end-to-end", wildcard="N", scope="score"),
], ids=["iupac", "iupac-2p", "iupac-endsfree", "custom", "wildcard",
        "wildcard-edit-endsfree", "wildcard-score"])
def test_align_pairs_matches_reference_and_oracle(kw):
    codes = b"N" if "wildcard" in kw else b"NRYSWKM"
    pairs = ambiguous_pairs(20, 90, 3, codes)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    api = WavefrontAligner(backend="numpy", **kw)
    attr = api._attributes()
    wc = api._bwildcard if api._wildcard else None
    PB.oracle_fallbacks.update(dict.fromkeys(PB.oracle_fallbacks, 0))
    port = PB.align_pairs(C.attributes_from_reference(attr), pats, txts,
                          wildcard=wc, device="cpu")
    assert not any(PB.oracle_fallbacks.values())
    ref = BT.align_pairs(attr, pats, txts, wildcard=wc)
    assert _fields(port) == _fields(ref)
    oracle = [BT._oracle_one(attr, p, t, wc) for p, t in pairs]
    assert _fields(port) == _fields(oracle)
    assert any("X" in r.ops or r.score < 0 for r in port)


def test_python_fill_with_classes_and_wildcard(monkeypatch):
    """Without the native library the Python fill repeats the equality."""
    monkeypatch.setattr(PB.native, "lib", lambda: None)
    pairs = ambiguous_pairs(6, 60, 4, b"N")
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    for kw in (dict(wildcard="N"), dict(match_classes="iupac")):
        api = WavefrontAligner(backend="numpy", span="end-to-end", **kw)
        wc = api._bwildcard if api._wildcard else None
        port = PB.align_pairs(C.attributes_from_reference(api._attributes()),
                              pats, txts, wildcard=wc, device="cpu")
        oracle = [BT._oracle_one(api._attributes(), p, t, wc)
                  for p, t in pairs]
        assert _fields(port) == _fields(oracle)


@pytest.mark.parametrize("kw", [
    dict(wildcard="N"), dict(match_classes="iupac"),
    dict(match_classes=PURINES, span="end-to-end"),
])
def test_wavefront_aligner_matches_reference(kw):
    """pywfa's `wildcard=` and the package's `match_classes=` through the
    single-pair API, against the reference's numpy and jax backends."""
    cases = [("ANGTACGTTT", "ACGTACGTAT"), ("ARGTNNGT", "AAGTCCGT"),
             ("GATTACANNN", "GATCACATTT"), ("AGCTAGCT", "GATCGATC")]
    for pattern, text in cases:
        port = pywfa_tpu_torch.WavefrontAligner(pattern, device="cpu", **kw)
        got = port(text)
        for backend in ("numpy", "jax"):
            ref = pywfa_tpu.WavefrontAligner(pattern, backend=backend, **kw)
            want = ref(text)
            assert (port.status, port.score, port.cigarstring,
                    port.locations) == (ref.status, ref.score,
                                        ref.cigarstring, ref.locations)
            assert (got.pattern_start, got.pattern_end, got.text_start,
                    got.text_end) == (want.pattern_start, want.pattern_end,
                                      want.text_start, want.text_end)


def test_wildcard_and_classes_exclusive():
    with pytest.raises(ValueError):
        pywfa_tpu_torch.WavefrontAligner("ACGT", wildcard="N",
                                         match_classes="iupac", device="cpu")
