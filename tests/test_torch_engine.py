"""The port's torch device stages are byte-equal to the JAX engine's.

Covers pywfa_tpu_torch.ops.engine: the 2-bit decode, the packed equality
bits (compared as uint32 words), the traceback walk and the output
packing in both layouts, and the score-only pipelines. The walk and
packing run on choices recorded by the reference engine `E.align_batch`,
on both spans. Tolerance: zero (integers).
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

def window_pairs(seed, n, lo, hi, flank, sub=0.03):
    """n (read, window) pairs: each read, with substitutions at rate `sub`,
    sits in a window between random flanks of 0..flank bases."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = []
    for _ in range(n):
        read = acgt[rng.integers(0, 4, rng.integers(lo, hi + 1))]
        copy = read.copy()
        flip = rng.random(len(copy)) < sub
        copy[flip] = acgt[rng.integers(0, 4, int(flip.sum()))]
        left, right = (acgt[rng.integers(0, 4, rng.integers(0, flank + 1))]
                       for _ in range(2))
        out.append((read.tobytes(),
                    np.concatenate([left, copy, right]).tobytes()))
    return out


CASES = {
    "readme": README_PAIRS,
    "div2": random_pairs(11, 12, 60, 120, 0.02, 0.0, as_bytes=True),
    "div25": random_pairs(12, 10, 40, 110, 0.15, 0.1, unrelated=0.2,
                          as_bytes=True),
}


def _inputs(pairs, span="end-to-end", **cfg_kw):
    attr = WavefrontAligner(backend="numpy", span=span)._attributes()
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


def _ref_out(cfg, pat, txt, plen, tlen, frees=None):
    if frees is None:
        frees = np.zeros((len(plen), 4), dtype=np.int32)
    return E.align_batch(cfg, jnp.asarray(pat), jnp.asarray(txt),
                         jnp.asarray(plen), jnp.asarray(tlen),
                         jnp.asarray(frees), jnp.int32(2**31 - 1))


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


def _window_inputs(span, **cfg_kw):
    """Reads in windows, with text begin/end frees of 10 (clamped per pair)
    on the ends-free span and none end to end."""
    cfg, pat, txt, plen, tlen = _inputs(window_pairs(13, 10, 30, 90, 10),
                                        span=span, **cfg_kw)
    frees = np.zeros((len(plen), 4), dtype=np.int32)
    if span == "ends-free":
        frees[:, 2] = frees[:, 3] = np.minimum(10, tlen)
    return cfg, pat, txt, plen, tlen, frees


def _packed(cfg, pat, txt, plen, tlen):
    return np.concatenate([pack_tokens(pat, plen, width=cfg.Lp),
                           pack_tokens(txt, tlen, width=cfg.Lt)], axis=1)


def test_walk_stops_on_wf0_seed():
    """Ends-free alignments that start on a text-begin-free seed: the walk
    stops at score 0 on the seed's diagonal k != 0 and returns it as
    k_start, as the reference's walk does."""
    cfg, pat, txt, plen, tlen, frees = _window_inputs("ends-free")
    out = _ref_out(cfg, pat, txt, plen, tlen, frees)
    ok = np.asarray(out["status"]) == E.ST_END_REACHED
    assert ok.all()
    ref = E.traceback_walk(cfg, out["choices"], out["final_s"], out["end_k"],
                           jnp.asarray(ok))
    tout = _torch_out(out)
    port = TE.traceback_walk(C.from_reference(cfg), tout["choices"],
                             tout["final_s"], tout["end_k"],
                             torch.from_numpy(ok))
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    k_start = port[2].numpy()
    assert (k_start > 0).any() and not port[3].any()
    assert (k_start <= frees[:, 2]).all()


@pytest.mark.parametrize("span", ["end-to-end", "ends-free"])
def test_meta_pipelines_match_reference(span):
    """Score-only scope: the [4, B] meta block from the 2-bit push and from
    the token-row push."""
    cfg, pat, txt, plen, tlen, frees = _window_inputs(
        span, record_choices=False)
    args = (jnp.asarray(plen), jnp.asarray(tlen), jnp.asarray(frees),
            jnp.int32(2**31 - 1))
    targs = (torch.from_numpy(plen), torch.from_numpy(tlen),
             torch.from_numpy(frees), 2**31 - 1)
    tcfg = C.from_reference(cfg)
    packed = _packed(cfg, pat, txt, plen, tlen)
    ref = np.asarray(E.align_batch_packed_meta(cfg, jnp.asarray(packed),
                                               *args))
    port = TE.align_batch_packed_meta(tcfg, torch.from_numpy(packed), *targs)
    assert port.dtype == torch.int32 and port.shape == (4, len(plen))
    np.testing.assert_array_equal(port.numpy(), ref)
    fused = np.concatenate([pat, txt], axis=1)
    np.testing.assert_array_equal(
        TE.align_batch_fused_meta(tcfg, torch.from_numpy(fused),
                                  *targs).numpy(),
        np.asarray(E.align_batch_fused_meta(cfg, jnp.asarray(fused), *args)))
    assert (ref[0] == E.ST_END_REACHED).all()


@pytest.mark.parametrize("ops_out", [0, 32])
def test_ends_free_packed_pipeline_matches_pallas_pipeline(ops_out):
    """The whole ends-free device pipeline against the reference's Pallas
    pipeline, in the full (ops_out 0) and the compact layout."""
    cfg, pat, txt, plen, tlen, frees = _window_inputs("ends-free", W=256,
                                                      S_cap=96)
    cfg = dataclasses.replace(cfg, ops_out=ops_out)
    B = len(plen)
    packed = _packed(cfg, pat, txt, plen, tlen)
    ref = E.align_batch_pallas_packed_full(
        cfg, B, B, jnp.asarray(packed), jnp.asarray(plen), jnp.asarray(tlen),
        jnp.asarray(frees), jnp.int32(2**31 - 1))
    port = TE.align_batch_packed_full(
        C.from_reference(cfg), torch.from_numpy(packed),
        torch.from_numpy(plen), torch.from_numpy(tlen),
        torch.from_numpy(frees), 2**31 - 1)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
