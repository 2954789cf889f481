"""The port's run-length table against the JAX package's two versions.

`pywfa_tpu_torch.ops.lcp_table.build_lcp_table_hmajor` on CPU tensors (the
plain torch version of the CUDA kernel) must equal, byte for byte, the
Pallas kernel `pywfa_tpu.ops.pallas.lcp_table.build_lcp_table_hmajor` run
in interpret mode, and the XLA version `engine._build_lcp_table` transposed
into the same [Ltp, B, W] layout: at the uint8 shape of short reads, on
both sides of the uint8 / int16 edge (Ltp 249 and 250), at an int16 shape,
at band widths that are and are not multiples of 128, with and without a
wildcard, on batches whose sequences are shorter than the rows. Inputs
come from a numpy seed. Tolerance: zero (integers).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.batch import PATTERN_SENTINEL, TEXT_SENTINEL, encode_batch
from pywfa_tpu.ops import engine as E
from pywfa_tpu.ops.pallas import lcp_table as LT
from pywfa_tpu_torch.ops import lcp_table as TLT

torch.set_num_threads(1)

WILDCARD = ord("N")


def _rows(seed, B, Lt, wildcard):
    """(cfg, pat, txt): B pairs of mixed lengths up to Lt, texts mutated
    from the patterns, an N here and there when a wildcard is set."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    pats, txts = [], []
    for b in range(B):
        n = Lt if b == 0 else int(rng.integers(Lt // 3, Lt + 1))
        p = acgt[rng.integers(0, 4, n)]
        t = p.copy()
        flip = rng.random(n) < 0.1
        t[flip] = acgt[rng.integers(0, 4, int(flip.sum()))]
        t = t[: max(1, n - int(rng.integers(0, 8)))]
        if wildcard >= 0:
            p[rng.random(n) < 0.03] = wildcard
            t[rng.random(len(t)) < 0.03] = wildcard
        pats.append(p.tobytes())
        txts.append(t.tobytes())
    attr = WavefrontAligner(backend="numpy", span="end-to-end")._attributes()
    cfg = E.full_config(attr, Lt, Lt, wildcard=wildcard)
    pat = encode_batch(pats, cfg.Lp, cfg.extend_chunk, PATTERN_SENTINEL)
    txt = encode_batch(txts, cfg.Lt, cfg.extend_chunk, TEXT_SENTINEL)
    return cfg, pat, txt


# (Lt, W, B): Ltp = Lt + 16
SHAPES = [(160, 64, 3), (160, 320, 16), (233, 192, 3), (234, 192, 3),
          (234, 64, 16), (584, 320, 3), (584, 192, 16)]


@pytest.mark.parametrize("wildcard", [-1, WILDCARD])
@pytest.mark.parametrize("Lt,W,B", SHAPES)
def test_plain_table_matches_pallas_and_xla(Lt, W, B, wildcard):
    cfg, pat, txt = _rows(Lt * 7 + W + B, B, Lt, wildcard)
    cfg = dataclasses.replace(cfg, W=W)
    Ltp = txt.shape[1]
    assert Ltp == Lt + 16
    got = TLT.build_lcp_table_hmajor(W, cfg.kmin, wildcard,
                                     torch.from_numpy(pat),
                                     torch.from_numpy(txt))
    assert got.dtype == (torch.uint8 if Ltp < 250 else torch.int16)
    assert tuple(got.shape) == (Ltp, B, W)
    pallas = np.asarray(LT.build_lcp_table_hmajor(
        W, cfg.kmin, wildcard, True, jnp.asarray(pat), jnp.asarray(txt)))
    assert pallas.dtype == got.numpy().dtype
    np.testing.assert_array_equal(got.numpy(), pallas)
    xla = np.asarray(E._build_lcp_table(cfg, jnp.asarray(pat),
                                        jnp.asarray(txt)))
    np.testing.assert_array_equal(got.numpy(), xla.transpose(2, 0, 1))


def test_table_wrapper_checks_its_inputs():
    _, pat, txt = _rows(1, 3, 64, -1)
    p, t = torch.from_numpy(pat), torch.from_numpy(txt)
    before = dict(TLT.launches)
    TLT.build_lcp_table_hmajor(64, -32, -1, p, t)
    assert TLT.launches == before  # the plain version is not a launch
    with pytest.raises(TypeError):
        TLT.build_lcp_table_hmajor(64, -32, -1, p.int(), t)
    with pytest.raises(ValueError):
        TLT.build_lcp_table_hmajor(64, -32, -1, p[:2], t)
    with pytest.raises(ValueError):
        TLT.build_lcp_table_hmajor(64, -32, -1, p.to("meta"), t.to("meta"))
    long = torch.zeros((3, TLT.MAX_LTP + 1), dtype=torch.int8)
    with pytest.raises(NotImplementedError):
        TLT.build_lcp_table_hmajor(64, -32, -1, p, long)
    assert TLT.supported(2048) and not TLT.supported(2049)
