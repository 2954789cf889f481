"""The fused score loop's plain torch version against the JAX package.

`align_batch_fused_loop_ref` (the CPU side of the port's fused-loop
wrapper; the CUDA kernel is held against it on the card) is compared with
the Pallas kernel `align_batch_pallas`, run in interpret mode on the CPU
as tests/test_pallas_kernel.py runs it, and with the XLA engine
`E.align_batch`: status, final_s, end_k, end_off and the whole choices
tensor, byte for byte (tolerance zero). The whole packed device pipeline
is compared with `E.align_batch_pallas_packed_full` in both layouts.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.batch import (PATTERN_SENTINEL, TEXT_SENTINEL, encode_batch,
                             pack_tokens)
from pywfa_tpu.ops import engine as E
from pywfa_tpu.ops.pallas import fused_loop as PFL
from pywfa_tpu_torch import batch as TB
from pywfa_tpu_torch.ops import config as C
from pywfa_tpu_torch.ops import engine as TE
from pywfa_tpu_torch.ops import fused_loop as TFL
from tests.corpus import random_pairs
from tests.test_torch_engine import README_PAIRS

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


def _port(cfg, pat, txt, plen, tlen, max_steps):
    tcfg = C.from_reference(cfg)
    bits = TE.build_eq_bits(tcfg, torch.from_numpy(pat),
                            torch.from_numpy(txt))
    frees = torch.zeros((len(plen), 4), dtype=torch.int32)
    return TFL.align_batch_fused_loop_ref(
        tcfg, bits, torch.from_numpy(plen), torch.from_numpy(tlen), frees,
        max_steps)


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
    before = TFL.launches
    out = TFL.align_batch_fused_loop(cfg, *args, MAXS)
    ref = TFL.align_batch_fused_loop_ref(cfg, *args, MAXS)
    for k in KEYS:
        assert torch.equal(out[k], ref[k])
    assert TFL.launches == before  # the plain version is not a launch
    with pytest.raises(ValueError):
        TFL.align_batch_fused_loop(cfg, *(a.to("meta") for a in args), MAXS)
    with pytest.raises(TypeError):
        TFL.align_batch_fused_loop(cfg, bits, args[1].long(), *args[2:], MAXS)
    with pytest.raises(NotImplementedError):
        TFL.align_batch_fused_loop(dataclasses.replace(cfg, strategy=8),
                                   *args, MAXS)
