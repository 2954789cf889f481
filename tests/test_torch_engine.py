"""The port's torch device stages are byte-equal to the JAX engine's.

Covers pywfa_tpu_torch.ops.engine: the 2-bit decode, the packed equality
bits (compared as uint32 words), the traceback walk and the output
packing in both layouts. The walk and packing run on choices recorded by
the reference engine `E.align_batch`. Tolerance: zero (integers).
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
from pywfa_tpu_torch.ops import config as C
from pywfa_tpu_torch.ops import engine as TE
from tests.corpus import random_pairs

torch.set_num_threads(1)

README_PAIRS = [
    (b"TCTTTACTCGCGCGTTGGAGAAATACAATAGT", b"TCTATACTGCGCGTTTGGAGAAATAAAATAGT"),
    (b"AATTAATTTAAGTCTAGGCTACTTTCGGTACTTTGTTCTT",
     b"AATTTAAGTCTAGGCTACTTTCGGTACTTTCTT"),
    (b"AAAAACCTTTTTAAAAAA", b"GGCCAAAAACCAAAAAA"),
    (b"AAAAAAAAAAAACCTTTTAAAAAAGAAAAAAA", b"ACCCCCCCCCCCAAAAACCAAAAAAAAAAAAA"),
]

CASES = {
    "readme": README_PAIRS,
    "div2": random_pairs(11, 12, 60, 120, 0.02, 0.0, as_bytes=True),
    "div25": random_pairs(12, 10, 40, 110, 0.15, 0.1, unrelated=0.2,
                          as_bytes=True),
}


def _inputs(pairs, **cfg_kw):
    attr = WavefrontAligner(backend="numpy",
                            span="end-to-end")._attributes()
    maxLp = max(len(p) for p, _ in pairs)
    maxLt = max(len(t) for _, t in pairs)
    cfg = E.full_config(attr, maxLp, maxLt, **cfg_kw)
    C_ = cfg.extend_chunk
    pat = encode_batch([p for p, _ in pairs], cfg.Lp, C_, PATTERN_SENTINEL)
    txt = encode_batch([t for _, t in pairs], cfg.Lt, C_, TEXT_SENTINEL)
    plen = np.array([len(p) for p, _ in pairs], dtype=np.int32)
    tlen = np.array([len(t) for _, t in pairs], dtype=np.int32)
    return cfg, pat, txt, plen, tlen


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_packed_matches_reference(case):
    cfg, pat, txt, plen, tlen = _inputs(CASES[case])
    packed = np.concatenate([pack_tokens(pat, plen, width=cfg.Lp),
                             pack_tokens(txt, tlen, width=cfg.Lt)], axis=1)
    rp, rt = E._decode_packed(cfg, jnp.asarray(packed), jnp.asarray(plen),
                              jnp.asarray(tlen))
    tp, tt = TE.decode_packed(C.from_reference(cfg), torch.from_numpy(packed),
                              torch.from_numpy(plen), torch.from_numpy(tlen))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(rt))
    # and both equal the host encoder's rows
    np.testing.assert_array_equal(tp.numpy(), pat)
    np.testing.assert_array_equal(tt.numpy(), txt)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("W", [None, 128])
def test_build_eq_bits_matches_reference(case, W):
    cfg, pat, txt, _, _ = _inputs(CASES[case], W=W)
    ref = np.asarray(E.build_eq_bits(cfg, jnp.asarray(pat),
                                     jnp.asarray(txt)))
    port = TE.build_eq_bits(C.from_reference(cfg), torch.from_numpy(pat),
                            torch.from_numpy(txt))
    assert port.dtype == torch.int32 and ref.dtype == np.uint32
    np.testing.assert_array_equal(port.numpy().view(np.uint32), ref)


def _ref_out(cfg, pat, txt, plen, tlen):
    B = len(plen)
    return E.align_batch(cfg, jnp.asarray(pat), jnp.asarray(txt),
                         jnp.asarray(plen), jnp.asarray(tlen),
                         jnp.zeros((B, 4), jnp.int32), jnp.int32(2**31 - 1))


def _torch_out(out):
    return {k: torch.from_numpy(np.array(out[k]))
            for k in ("status", "final_s", "end_k", "end_off", "choices")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_traceback_walk_matches_reference(case):
    cfg, pat, txt, plen, tlen = _inputs(CASES[case])
    out = _ref_out(cfg, pat, txt, plen, tlen)
    ok = np.asarray(out["status"]) == E.ST_END_REACHED
    ref = E.traceback_walk(cfg, out["choices"], out["final_s"], out["end_k"],
                           jnp.asarray(ok))
    tout = _torch_out(out)
    port = TE.traceback_walk(C.from_reference(cfg), tout["choices"],
                             tout["final_s"], tout["end_k"],
                             torch.from_numpy(ok))
    assert ok.all()
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("ops_out", [0, 8, 32])
def test_pack_full_matches_reference(case, ops_out):
    """Both wire layouts; ops_out=8 drops tokens past the compacted width
    and flags those pairs ST_OVERFLOW_S."""
    cfg, pat, txt, plen, tlen = _inputs(CASES[case])
    cfg = dataclasses.replace(cfg, ops_out=ops_out)
    out = _ref_out(cfg, pat, txt, plen, tlen)
    ref = np.asarray(E.pack_full_output(cfg, out))
    port = TE.pack_full(C.from_reference(cfg), _torch_out(out))
    assert port.dtype == torch.uint8
    np.testing.assert_array_equal(port.numpy(), ref)


def test_walk_fallback_on_inconsistent_choices():
    """A corrupted choice byte (no M source at a positive score) stops the
    walk with the fallback flag, as in the reference."""
    cfg, pat, txt, plen, tlen = _inputs(README_PAIRS)
    out = _ref_out(cfg, pat, txt, plen, tlen)
    ch = np.array(out["choices"])
    fs = np.array(out["final_s"])
    ek = np.array(out["end_k"])
    ch[fs[0], 0, ek[0] - cfg.kmin] = 0
    ok = np.ones(len(plen), dtype=bool)
    ref = E.traceback_walk(cfg, jnp.asarray(ch), out["final_s"],
                           out["end_k"], jnp.asarray(ok))
    port = TE.traceback_walk(C.from_reference(cfg), torch.from_numpy(ch),
                             torch.from_numpy(fs), torch.from_numpy(ek),
                             torch.from_numpy(ok))
    assert bool(port[3][0])
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
