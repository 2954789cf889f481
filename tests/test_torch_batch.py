"""The port's batch and stream API against the JAX package and the oracle.

`pywfa_tpu_torch.batch.align_pairs(..., device="cpu")` runs the port's
whole main path (host encode, the torch device pipeline with the fused
loop's plain version, host finish, escalation) and must equal
`pywfa_tpu.batch.align_pairs` and the scalar oracle on every BatchResult
field, on both spans and in both scopes. Tolerance: zero.
"""
import dataclasses

import pytest
import torch

from pywfa_tpu import batch as BT
from pywfa_tpu import native
from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.oracle import OracleAligner
from pywfa_tpu.utils.encode import pack2bits
from pywfa_tpu_torch import BatchWavefrontAligner
from pywfa_tpu_torch import batch as PB
from pywfa_tpu_torch import native as port_native
from pywfa_tpu_torch.ops import config as C
from tests.corpus import random_pairs
from tests.test_torch_engine import README_PAIRS, window_pairs

torch.set_num_threads(1)

FIELDS = ("status", "score", "ops", "end_v", "end_h", "wf_score", "dropped")


def _attr(**kw):
    return WavefrontAligner(backend="numpy", span="end-to-end",
                            **kw)._attributes()


def _fields(results):
    return [tuple(getattr(r, f) for f in FIELDS) for r in results]


CASES = {
    "readme": README_PAIRS,
    "div2": random_pairs(31, 16, 100, 120, 0.02, 0.0, as_bytes=True),
    # escalate past the first rung; the pairs over disjoint alphabets
    # (every base a mismatch) score past the second rung's cap and reach
    # the terminal rung
    "div25": random_pairs(32, 12, 60, 120, 0.2, 0.05, unrelated=0.3,
                          as_bytes=True)
    + [(b"AC" * 55, b"GT" * 55), (b"CAAC" * 30, b"TTGG" * 29)],
    "mixed": random_pairs(33, 14, 5, 120, 0.05, 0.05, as_bytes=True),
    # a non-ACGT byte: the token-row push instead of the 2-bit one
    "with_n": [(b"ACGTNACGTACGTTTGCA", b"ACGTAACGTACCTTTGCA")]
    + random_pairs(34, 5, 20, 60, 0.05, 0.05, as_bytes=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_align_pairs_matches_reference_and_oracle(case):
    pairs = CASES[case]
    attr = _attr()
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    port = PB.align_pairs(attr, pats, txts, device="cpu")
    ref = BT.align_pairs(attr, pats, txts)
    assert _fields(port) == _fields(ref)
    oracle = [OracleAligner(attr).align(p, t) for p, t in pairs]
    assert _fields(port) == _fields(oracle)
    assert [r.cigarstring for r in port] == [r.cigarstring for r in ref]


def test_escalation_reaches_wider_rungs(monkeypatch):
    """div25 holds pairs past the first rung: the port escalates them (a
    batch at rung-1 caps alone reports overflow for them) through the
    second rung to the terminal one."""
    pairs = CASES["div25"]
    attr = _attr()
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    h = PB.align_pairs_dispatch(attr, pats, txts, device="cpu")
    assert h.cfg.ops_out > 0 and not h.at_full_caps
    packed = PB.align_pairs_pull(h).packed_np
    status = packed[:h.B]
    assert ((status == 4) | (status == 5)).any()
    rungs = []
    dispatch = PB.align_pairs_dispatch

    def record(*args, **kw):
        sub = dispatch(*args, **kw)
        rungs.append((sub.cfg.W, sub.cfg.S_cap, sub.at_full_caps))
        return sub

    monkeypatch.setattr(PB, "align_pairs_dispatch", record)
    assert _fields(PB.align_pairs_finish(h)) == _fields(
        BT.align_pairs(attr, pats, txts))
    assert len(rungs) == 2 and not rungs[0][2] and rungs[1][2]
    assert h.cfg.S_cap < rungs[0][1] < rungs[1][1]


def test_match_bonus_penalties_match_reference():
    pairs = CASES["mixed"][:8]
    attr = _attr(match=-1, mismatch=5, gap_opening=7, gap_extension=3)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    assert _fields(PB.align_pairs(attr, pats, txts, device="cpu")) == \
        _fields(BT.align_pairs(attr, pats, txts))


def test_stream_matches_align_pairs():
    attr = _attr()
    batches = [([p for p, _ in CASES[c]], [t for _, t in CASES[c]])
               for c in ("readme", "with_n", "div2")]
    seq = [BT.align_pairs(attr, p, t) for p, t in batches]
    out = list(PB.align_pairs_stream(attr, iter(batches), depth=2,
                                     device="cpu"))
    assert [_fields(r) for r in out] == [_fields(r) for r in seq]


def test_batch_aligner_stream_and_empty_batches():
    a = BatchWavefrontAligner(span="end-to-end", device="cpu")
    pats = [p.decode() for p, _ in README_PAIRS]
    txts = [t.decode() for _, t in README_PAIRS]
    out = list(a.align_stream(iter([(pats, txts), ([], []),
                                    (pats, txts, dict(Lp=128, Lt=128))]),
                              depth=1))
    assert out[1] == []
    assert _fields(out[0]) == _fields(out[2]) == _fields(a.align(pats, txts))
    assert out[0][0].cigarstring == "3M1X4M1D7M1I9M1X6M"
    assert out[0][0].score == -24


@pytest.mark.parametrize("kw", [
    dict(memory_mode="medium"), dict(memory_mode="low"),
    dict(memory_mode="biwfa"),
    dict(memory_mode="low", distance="affine2p", heuristic="X-drop"),
    dict(memory_mode="medium", span="ends-free", match=-1),
    dict(memory_mode="biwfa", distance="linear", wildcard="N"),
])
def test_off_slice_config_raises(kw):
    """Memory modes other than high are what the batch path still refuses
    by configuration, whatever else the configuration asks for."""
    pats = [p for p, _ in README_PAIRS]
    txts = [t for _, t in README_PAIRS]
    kw = dict(dict(span="end-to-end"), **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6"):
        BatchWavefrontAligner(device="cpu", **kw).align(pats, txts)


@pytest.mark.parametrize("kw", [
    dict(distance="affine2p", heuristic="X-drop"),
    dict(span="ends-free", match=-1, text_begin_free=5, text_end_free=5),
    dict(distance="linear", wildcard="N"),
    dict(heuristic="adaptive"), dict(wildcard="N"),
    dict(match_classes="iupac"),
    dict(span="ends-free", extension=True),
])
def test_configurations_of_this_slice_run(kw):
    """What used to raise runs: heuristics, a match bonus on the ends-free
    span, wildcards, match classes and WF-extension, through the stream,
    equal to the reference's batch path."""
    pairs = README_PAIRS + random_pairs(35, 10, 30, 110, 0.1, 0.05,
                                        unrelated=0.2, as_bytes=True)
    pats = [p.decode() for p, _ in pairs]
    txts = [t.decode() for _, t in pairs]
    kw = dict(dict(span="end-to-end"), **kw)
    from pywfa_tpu.batch import BatchWavefrontAligner as RefBatch
    port = BatchWavefrontAligner(device="cpu", **kw)
    PB.oracle_fallbacks.update(dict.fromkeys(PB.oracle_fallbacks, 0))
    got = list(port.align_stream([(pats[:9], txts[:9]),
                                  (pats[9:], txts[9:])]))
    assert not any(PB.oracle_fallbacks.values())
    want = RefBatch(**kw).align(pats, txts)
    assert _fields(got[0] + got[1]) == _fields(want)


@pytest.mark.parametrize("W,S_cap", [(1024, 300000), (1152, 2000)])
def test_long_read_shapes_raise(W, S_cap):
    """A choices record over the device budget needs the segmented
    traceback; a band over 1024 diagonals needs more than one thread per
    diagonal. Neither is ported yet."""
    pats = [p for p, _ in README_PAIRS]
    txts = [t for _, t in README_PAIRS]
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6"):
        PB.align_pairs(_attr(), pats, txts, device="cpu", W=W, S_cap=S_cap)


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PB.align_pairs(_attr(), [b"ACGT"], [b"ACGT"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchWavefrontAligner(span="end-to-end")


def test_attributes_match_reference_aligner():
    kw = dict(match=-2, mismatch=6, gap_opening=5, gap_extension=1,
              span="end-to-end", max_steps=77)
    port = BatchWavefrontAligner(device="cpu", **kw)._attr
    ref = WavefrontAligner(backend="numpy", **kw)._attributes()
    # the port keeps its own attribute classes: carried across field by
    # field, the reference's attributes are the port's
    assert port == C.attributes_from_reference(ref)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


# name: (pairs, aligner kwargs); every span but the last is pywfa's
# default, ends-free
EF_CASES = {
    "defaults": (README_PAIRS + CASES["mixed"], dict()),
    "window": (window_pairs(35, 12, 40, 100, 15), dict(
        text_begin_free=15, text_end_free=15)),
    # frees past the shortest pairs (clamped per pair) and pairs that
    # escalate past the first rung
    "escalate": (CASES["div25"] + CASES["mixed"][:6], dict(
        pattern_begin_free=8, pattern_end_free=8, text_begin_free=8,
        text_end_free=8)),
    "e2e": (CASES["div25"], dict(span="end-to-end")),
}


def _ref_oracle(attr, pairs):
    """The reference's per-pair oracle, ends-free slack clamped per pair."""
    return [BT._oracle_one(attr, p, t, None) for p, t in pairs]


@pytest.mark.parametrize("scope", ["full", "score"])
@pytest.mark.parametrize("case", sorted(EF_CASES))
def test_spans_and_scopes_match_reference_and_oracle(case, scope):
    pairs, kw = EF_CASES[case]
    attr = WavefrontAligner(backend="numpy", scope=scope,
                            **kw)._attributes()
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    port = PB.align_pairs(attr, pats, txts, device="cpu")
    assert _fields(port) == _fields(BT.align_pairs(attr, pats, txts))
    assert _fields(port) == _fields(_ref_oracle(attr, pairs))
    if scope == "score":
        assert all(r.ops == "" for r in port)


def test_ends_free_escalation_reaches_wider_rungs(monkeypatch):
    pairs, kw = EF_CASES["escalate"]
    attr = WavefrontAligner(backend="numpy", **kw)._attributes()
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    rungs = []
    dispatch = PB.align_pairs_dispatch

    def record(*args, **kw):
        sub = dispatch(*args, **kw)
        rungs.append((sub.cfg.W, sub.cfg.S_cap))
        return sub

    monkeypatch.setattr(PB, "align_pairs_dispatch", record)
    port = PB.align_pairs(attr, pats, txts, device="cpu")
    assert len(rungs) >= 2 and rungs[0][1] < rungs[-1][1]
    assert _fields(port) == _fields(_ref_oracle(attr, pairs))


def test_frees_past_the_shortest_pair_are_clamped_per_pair():
    """Frees larger than every pair of a mixed-length batch: the batch
    aligns (the reference would refuse one such pair alone) and each pair
    equals the oracle run with its own clamped frees; an inconsistent
    walk's oracle fallback clamps the same way."""
    pairs = [(b"ACGTTGCA", b"TTACGTTGCAGG"), (b"AC", b"GGGACT")] + \
        window_pairs(36, 5, 30, 60, 20)
    attr = WavefrontAligner(backend="numpy", pattern_begin_free=100,
                            pattern_end_free=100, text_begin_free=150,
                            text_end_free=150)._attributes()
    port = PB.align_pairs(attr, [p for p, _ in pairs],
                          [t for _, t in pairs], device="cpu")
    assert _fields(port) == _fields(_ref_oracle(attr, pairs))
    assert _fields([PB._oracle_one(attr, p, t) for p, t in pairs]) == \
        _fields(port)


@pytest.mark.parametrize("case", ["window", "escalate"])
def test_python_fill_appends_trailing_free_ops(monkeypatch, case):
    """Without the native library the Python match-fill assembles the
    CIGARs, trailing free I and D blocks included."""
    pairs, kw = EF_CASES[case]
    attr = WavefrontAligner(backend="numpy", **kw)._attributes()
    want = _ref_oracle(attr, pairs)
    monkeypatch.setattr(native, "lib", lambda: None)
    monkeypatch.setattr(port_native, "lib", lambda: None)
    port = PB.align_pairs(attr, [p for p, _ in pairs],
                          [t for _, t in pairs], device="cpu")
    assert _fields(port) == _fields(want)
    assert any(r.ops.endswith("I") for r in port)


def test_default_batch_aligner_matches_reference():
    pats = [p.decode() for p, _ in README_PAIRS]
    txts = [t.decode() for _, t in README_PAIRS]
    port = BatchWavefrontAligner(device="cpu")
    ref = BT.BatchWavefrontAligner()
    assert port._attr == C.attributes_from_reference(ref._api._attributes())
    assert _fields(port.align(pats, txts)) == _fields(ref.align(pats, txts))
    packed = ([pack2bits(p.encode()) for p in pats], [len(p) for p in pats],
              [pack2bits(t.encode()) for t in txts], [len(t) for t in txts])
    assert _fields(port.align_packed2bits(*packed)) == _fields(
        ref.align_packed2bits(*packed))


def test_oracle_fallbacks_count_a_loop_that_writes_wrong_choices(monkeypatch):
    """A fused loop whose choice record is wrong (here: blanked) still
    yields right results, because inconsistent walks go to the oracle; the
    counter is what shows that the host did the work."""
    from pywfa_tpu_torch.ops import fused_loop as TFL
    pairs = CASES["div2"]
    attr = C.attributes_from_reference(_attr())
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    zero = dict.fromkeys(PB.oracle_fallbacks, 0)
    PB.oracle_fallbacks.update(zero)
    want = PB.align_pairs(attr, pats, txts, device="cpu")
    assert PB.oracle_fallbacks == zero
    loop = TFL.align_batch_fused_loop

    def blank(*args, **kw):
        out = loop(*args, **kw)
        out["choices"].zero_()
        return out

    monkeypatch.setattr(TFL, "align_batch_fused_loop", blank)
    got = PB.align_pairs(attr, pats, txts, device="cpu")
    assert _fields(got) == _fields(want)
    n_moved = sum(r.wf_score > 0 for r in want)
    assert n_moved > 0
    assert PB.oracle_fallbacks == dict(zero, **{"inconsistent walk": n_moved})
