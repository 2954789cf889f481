"""The fused score loop's plain torch version against the JAX package.

`align_batch_fused_loop_ref` (the CPU side of the port's fused-loop
wrapper; the CUDA kernel is held against it on the card) is compared with
the Pallas kernel `align_batch_pallas`, run in interpret mode on the CPU
as tests/test_pallas_kernel.py runs it, and with the XLA engine
`E.align_batch`: status, final_s, end_k, end_off and the whole choices
tensor, byte for byte (tolerance zero). The whole packed device pipeline
is compared with `E.align_batch_pallas_packed_full` in both layouts. The
ends-free span (its WF0 seeds and lowest-k termination) and the
score-only scope are compared the same way.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.constants import AlignmentSpan
from pywfa_tpu.batch import (PATTERN_SENTINEL, TEXT_SENTINEL, encode_batch,
                             pack_tokens)
from pywfa_tpu.ops import engine as E
from pywfa_tpu.ops.pallas import fused_loop as PFL
from pywfa_tpu_torch import batch as TB
from pywfa_tpu_torch.ops import config as C
from pywfa_tpu_torch.ops import engine as TE
from pywfa_tpu_torch.ops import fused_loop as TFL
from tests.corpus import random_pairs
from tests.test_torch_engine import README_PAIRS, window_pairs

torch.set_num_threads(1)

KEYS = ("status", "final_s", "end_k", "end_off", "choices")
MAXS = 2**31 - 1

CASES = {
    "readme": README_PAIRS,
    "div2": random_pairs(21, 12, 80, 120, 0.02, 0.0, as_bytes=True),
    "div25": random_pairs(22, 10, 40, 110, 0.15, 0.1, unrelated=0.2,
                          as_bytes=True),
}


def _attr():
    return WavefrontAligner(backend="numpy", span="end-to-end")._attributes()


def _cfg(pairs, caps):
    attr = _attr()
    maxLp = max(len(p) for p, _ in pairs)
    maxLt = max(len(t) for _, t in pairs)
    if caps == "full":
        return E.full_config(attr, maxLp, maxLt)
    # the first rung the batch path picks for these lengths
    S0 = 96
    W = E._round_up(TB._band_for_score(attr, S0, maxLp, maxLt), 128)
    return E.full_config(attr, maxLp, maxLt, W=W, S_cap=S0)


def _encode(cfg, pairs):
    C_ = cfg.extend_chunk
    pat = encode_batch([p for p, _ in pairs], cfg.Lp, C_, PATTERN_SENTINEL)
    txt = encode_batch([t for _, t in pairs], cfg.Lt, C_, TEXT_SENTINEL)
    plen = np.array([len(p) for p, _ in pairs], dtype=np.int32)
    tlen = np.array([len(t) for _, t in pairs], dtype=np.int32)
    return pat, txt, plen, tlen


def _port(cfg, pat, txt, plen, tlen, max_steps, frees=None):
    tcfg = C.from_reference(cfg)
    bits = TE.build_eq_bits(tcfg, torch.from_numpy(pat),
                            torch.from_numpy(txt))
    if frees is None:
        frees = np.zeros((len(plen), 4), dtype=np.int32)
    return TFL.align_batch_fused_loop_ref(
        tcfg, bits, torch.from_numpy(plen), torch.from_numpy(tlen),
        torch.from_numpy(frees), max_steps)


def _assert_equal(port, ref):
    for k in KEYS:
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("caps", ["full", "rung1"])
@pytest.mark.parametrize("max_steps", [MAXS, 6])
def test_plain_loop_matches_pallas_and_xla(case, caps, max_steps):
    pairs = CASES[case]
    cfg = _cfg(pairs, caps)
    pat, txt, plen, tlen = _encode(cfg, pairs)
    B = len(plen)
    frees = jnp.zeros((B, 4), jnp.int32)
    ms = jnp.int32(max_steps)
    port = _port(cfg, pat, txt, plen, tlen, max_steps)
    xla = E.align_batch(cfg, jnp.asarray(pat), jnp.asarray(txt),
                        jnp.asarray(plen), jnp.asarray(tlen), frees, ms)
    _assert_equal(port, xla)
    bits = E.build_eq_bits(cfg, jnp.asarray(pat), jnp.asarray(txt))
    pallas = PFL.align_batch_pallas(cfg, B, bits, jnp.asarray(plen),
                                    jnp.asarray(tlen), frees, ms)
    _assert_equal(port, pallas)
    status = port["status"].numpy()
    if max_steps == 6:
        assert (status == C.ST_MAX_STEPS).any()
    elif caps == "full":
        assert (status == C.ST_END_REACHED).all()


def test_undersized_band_reports_overflow_w():
    """W = 128 cannot hold these drifts: the port flags ST_OVERFLOW_W as
    the XLA engine does (the Pallas kernel clamps instead, so it is not
    the reference here)."""
    pairs = random_pairs(23, 8, 20, 120, 0.1, 0.1, unrelated=1.0,
                         as_bytes=True)
    full = _cfg(pairs, "full")
    cfg = dataclasses.replace(full, W=128)
    pat, txt, plen, tlen = _encode(cfg, pairs)
    port = _port(cfg, pat, txt, plen, tlen, MAXS)
    xla = E.align_batch(cfg, jnp.asarray(pat), jnp.asarray(txt),
                        jnp.asarray(plen), jnp.asarray(tlen),
                        jnp.zeros((len(plen), 4), jnp.int32), jnp.int32(MAXS))
    _assert_equal(port, xla)
    status = port["status"].numpy()
    assert (status == C.ST_OVERFLOW_W).any()
    assert (status == C.ST_END_REACHED).any()


@pytest.mark.parametrize("layout", ["compact", "full"])
@pytest.mark.parametrize("case", ["readme", "div25"])
def test_packed_pipeline_matches_pallas_pipeline(layout, case):
    pairs = CASES[case]
    cfg = _cfg(pairs, "rung1")
    if layout == "compact":
        cfg = dataclasses.replace(cfg, ops_out=32)
    assert E.packed_layout(cfg) == layout
    pat, txt, plen, tlen = _encode(cfg, pairs)
    B = len(plen)
    packed = np.concatenate([pack_tokens(pat, plen, width=cfg.Lp),
                             pack_tokens(txt, tlen, width=cfg.Lt)], axis=1)
    ref = E.align_batch_pallas_packed_full(
        cfg, B, B, jnp.asarray(packed), jnp.asarray(plen), jnp.asarray(tlen),
        jnp.zeros((B, 4), jnp.int32), jnp.int32(MAXS))
    port = TE.align_batch_packed_full(
        C.from_reference(cfg), torch.from_numpy(packed),
        torch.from_numpy(plen), torch.from_numpy(tlen),
        torch.zeros((B, 4), dtype=torch.int32), MAXS)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    # the token-row push of the same batch packs to the same bytes
    fused = np.concatenate([pat, txt], axis=1)
    port_fused = TE.align_batch_fused_full(
        C.from_reference(cfg), torch.from_numpy(fused),
        torch.from_numpy(plen), torch.from_numpy(tlen),
        torch.zeros((B, 4), dtype=torch.int32), MAXS)
    np.testing.assert_array_equal(port_fused.numpy(), np.asarray(ref))


def test_wrapper_routes_cpu_to_plain_version_and_rejects_others():
    pairs = CASES["readme"]
    cfg = C.from_reference(_cfg(pairs, "full"))
    pat, txt, plen, tlen = _encode(cfg, pairs)
    bits = TE.build_eq_bits(cfg, torch.from_numpy(pat),
                            torch.from_numpy(txt))
    args = (bits, torch.from_numpy(plen), torch.from_numpy(tlen),
            torch.zeros((len(plen), 4), dtype=torch.int32))
    before = dict(TFL.variant_launches)
    out = TFL.align_batch_fused_loop(cfg, *args, MAXS)
    ref = TFL.align_batch_fused_loop_ref(cfg, *args, MAXS)
    for k in KEYS:
        assert torch.equal(out[k], ref[k])
    assert TFL.variant_launches == before  # the plain version is not a launch
    with pytest.raises(ValueError):
        TFL.align_batch_fused_loop(cfg, *(a.to("meta") for a in args), MAXS)
    with pytest.raises(TypeError):
        TFL.align_batch_fused_loop(cfg, bits, args[1].long(), *args[2:], MAXS)
    # a band past one thread block is taken (the bits must fit it); a band
    # that is not whole warps is refused
    with pytest.raises(ValueError, match="1152"):
        TFL.align_batch_fused_loop(dataclasses.replace(cfg, W=1152),
                                   *args, MAXS)
    with pytest.raises(NotImplementedError, match="whole warps"):
        TFL.align_batch_fused_loop(dataclasses.replace(cfg, W=100),
                                   *args, MAXS)
    # a strategy bit the cascade does not know
    with pytest.raises(NotImplementedError):
        TFL.align_batch_fused_loop(dataclasses.replace(cfg, strategy=64),
                                   *args, MAXS)


# name: (pairs, frees row (pattern begin, pattern end, text begin, text
# end) before the per-pair clamp)
EF_CASES = {
    "zero": (CASES["div25"], (0, 0, 0, 0)),
    "text": (window_pairs(24, 10, 40, 80, 12), (0, 0, 12, 12)),
    "pattern": ([(t, p) for p, t in window_pairs(25, 10, 40, 80, 12)],
                (12, 12, 0, 0)),
    "all": (window_pairs(26, 6, 30, 70, 8) + README_PAIRS, (6, 6, 6, 6)),
}


def _ef_inputs(case, caps, record=True, span="ends-free"):
    """(cfg, pat, txt, plen, tlen, frees) with frees clamped per pair, as
    the batch path builds them."""
    pairs, row = EF_CASES[case]
    attr = WavefrontAligner(
        backend="numpy", span=span, pattern_begin_free=row[0],
        pattern_end_free=row[1], text_begin_free=row[2],
        text_end_free=row[3])._attributes()
    maxLp = max(len(p) for p, _ in pairs)
    maxLt = max(len(t) for _, t in pairs)
    if caps == "full":
        cfg = E.full_config(attr, maxLp, maxLt, record_choices=record)
    else:
        W = E._round_up(TB._band_for_score(attr, 96, maxLp, maxLt), 128)
        cfg = E.full_config(attr, maxLp, maxLt, W=W, S_cap=96,
                            record_choices=record)
    pat, txt, plen, tlen = _encode(cfg, pairs)
    frees = np.zeros((len(plen), 4), dtype=np.int32)
    if span == "ends-free":
        lens = np.stack([plen, plen, tlen, tlen], axis=1)
        frees = np.minimum(np.array([row], dtype=np.int32), lens)
    return cfg, pat, txt, plen, tlen, frees


def _all_three(cfg, pat, txt, plen, tlen, frees, max_steps=MAXS):
    """(port, xla, pallas) outputs of one batch."""
    B = len(plen)
    args = (jnp.asarray(plen), jnp.asarray(tlen), jnp.asarray(frees),
            jnp.int32(max_steps))
    port = _port(cfg, pat, txt, plen, tlen, max_steps, frees)
    xla = E.align_batch(cfg, jnp.asarray(pat), jnp.asarray(txt), *args)
    rbits = E.build_eq_bits(cfg, jnp.asarray(pat), jnp.asarray(txt))
    pallas = PFL.align_batch_pallas(cfg, B, rbits, *args)
    return port, xla, pallas


def _assert_equal_keys(port, ref, record):
    keys = KEYS if record else KEYS[:4]
    assert ("choices" in port) == record
    for k in keys:
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


@pytest.mark.parametrize("case", sorted(EF_CASES))
@pytest.mark.parametrize("caps", ["full", "rung1"])
def test_ends_free_plain_loop_matches_pallas_and_xla(case, caps):
    cfg, *inputs = _ef_inputs(case, caps)
    port, xla, pallas = _all_three(cfg, *inputs)
    _assert_equal_keys(port, xla, True)
    _assert_equal_keys(port, pallas, True)
    status = port["status"].numpy()
    if caps == "full":
        assert (status == C.ST_END_REACHED).all()
    if case in ("text", "pattern"):
        # the reads end inside their windows: some alignments start or end
        # off the corner diagonals
        done = status == C.ST_END_REACHED
        ak = inputs[3] - inputs[2]
        assert (port["end_k"].numpy()[done] != ak[done]).any()


@pytest.mark.parametrize("span,case", [
    ("end-to-end", "zero"), ("end-to-end", "all"),
    ("ends-free", "text"), ("ends-free", "all"),
])
def test_score_only_plain_loop_matches_pallas_and_xla(span, case):
    """The score-only scope (the Pallas kernel's second pallas_call)
    records no choices; status, final_s, end_k and end_off are those of
    the recording scope."""
    cfg, *inputs = _ef_inputs(case, "rung1", record=False, span=span)
    port, xla, pallas = _all_three(cfg, *inputs)
    _assert_equal_keys(port, xla, False)
    _assert_equal_keys(port, pallas, False)
    full = _all_three(dataclasses.replace(cfg, record_choices=True),
                      *inputs)[0]
    _assert_equal_keys(port, {k: full[k].numpy() for k in KEYS[:4]}, False)


def test_seed_past_band_reports_overflow_w():
    """Text-begin-free seeds past a 128-diagonal band: the port flags
    ST_OVERFLOW_W before the first step, as engine._init_state does (the
    Pallas kernel would clamp them; the batch path never routes such a
    batch to it)."""
    pairs = window_pairs(27, 8, 20, 100, 10)
    attr = WavefrontAligner(backend="numpy")._attributes()
    cfg = E.full_config(attr, 110, 110, W=128)
    pat, txt, plen, tlen = _encode(cfg, pairs)
    frees = np.zeros((len(plen), 4), dtype=np.int32)
    frees[:, 2] = np.minimum(70, tlen)
    port = _port(cfg, pat, txt, plen, tlen, MAXS, frees)
    xla = E.align_batch(cfg, jnp.asarray(pat), jnp.asarray(txt),
                        jnp.asarray(plen), jnp.asarray(tlen),
                        jnp.asarray(frees), jnp.int32(MAXS))
    _assert_equal(port, xla)
    status = port["status"].numpy()
    over = frees[:, 2] > -cfg.kmin - 3
    assert over.any() and not over.all()
    assert (status[over] == C.ST_OVERFLOW_W).all()
    assert (port["final_s"].numpy()[over] == 0).all()
    assert (status[~over] == C.ST_END_REACHED).any()


def test_supported_covers_the_slice():
    attr = WavefrontAligner(backend="numpy")._attributes()
    cfg = C.full_config(attr, 150, 150)
    assert TFL.supported(cfg) and TFL.variant(cfg) == "endsfree"
    score = dataclasses.replace(cfg, record_choices=False)
    assert TFL.supported(score) and TFL.variant(score) == "endsfree_score"
    e2e = dataclasses.replace(score, span=AlignmentSpan.END_TO_END)
    assert TFL.variant(e2e) == "e2e_score"
    # a match bonus: the seeded span on ends-free, nothing new end to end
    seeded = dataclasses.replace(cfg, match=-1)
    assert TFL.supported(seeded) and TFL.variant(seeded) == "endsfreeseed"
    assert TFL.supported(dataclasses.replace(e2e, match=-1))
    assert TFL.variant(dataclasses.replace(e2e, match=-1)) == "e2e_score"
    heur = dataclasses.replace(seeded, strategy=4, record_choices=False)
    assert TFL.supported(heur)
    assert TFL.variant(heur) == "endsfreeseed_heur_score"
    assert TFL.smem_bytes(heur) == TFL.smem_bytes(
        dataclasses.replace(heur, strategy=0)) + 7 * 32 * 4
    # wildcards and classes live in the eq bits
    assert TFL.supported(dataclasses.replace(cfg, wildcard=78))
    assert TFL.supported(dataclasses.replace(cfg, match_classes="iupac"))
    # more diagonals than one thread block: several a thread, and past a
    # block's shared memory the ring in global memory
    wide = dataclasses.replace(cfg, W=1152)
    assert TFL.supported(wide) and not TFL.ring_in_global(wide)
    assert TFL.block_threads(1152) == 576 and TFL.block_threads(256) == 256
    assert not TFL.ring_in_global(dataclasses.replace(cfg, W=3840))
    assert TFL.ring_in_global(dataclasses.replace(cfg, W=3968))
    assert TFL.supported(dataclasses.replace(cfg, W=20096))
    assert TFL.variant(cfg, table=True) == "endsfree_table"
    assert not TFL.supported(dataclasses.replace(cfg, W=100))
