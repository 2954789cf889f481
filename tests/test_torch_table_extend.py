"""The fused loop's table extension against its bits extension and the
JAX engine's one-hot table extension.

The plain torch version of the fused loop, extending by the run-length
table (`off += R[off]`), must give the same result dict, choice bytes
included, as the same loop extending by the packed equality words, for
the five distance metrics, both spans and one heuristic; and the same
status, score, end cell and choices as `pywfa_tpu.ops.engine.align_batch`
forced to its h-major table extension (`extend_force="onehot"`).
Tolerance: zero (integers).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.batch import PATTERN_SENTINEL, TEXT_SENTINEL, encode_batch
from pywfa_tpu.ops import engine as E
from pywfa_tpu_torch.ops import config as C
from pywfa_tpu_torch.ops import engine as TE
from pywfa_tpu_torch.ops import fused_loop as TFL
from pywfa_tpu_torch.ops import lcp_table as TLT
from tests.corpus import random_pairs
from tests.test_torch_engine import README_PAIRS, window_pairs

torch.set_num_threads(1)

MAXS = 2**31 - 1
KEYS = ("status", "final_s", "end_k", "end_off", "choices")
PAIRS = README_PAIRS + random_pairs(51, 10, 40, 110, 0.08, 0.05,
                                    unrelated=0.1, as_bytes=True)
WINDOWS = window_pairs(52, 8, 40, 80, 12)

# name: (aligner kwargs, pairs, frees row)
CONFIGS = {
    "affine_e2e": (dict(span="end-to-end"), PAIRS, (0, 0, 0, 0)),
    "affine_endsfree": (dict(text_begin_free=12, text_end_free=12), WINDOWS,
                        (0, 0, 12, 12)),
    "affine2p_e2e": (dict(distance="affine2p", span="end-to-end"), PAIRS,
                     (0, 0, 0, 0)),
    "linear_endsfree": (dict(distance="linear", text_begin_free=12,
                             text_end_free=12), WINDOWS, (0, 0, 12, 12)),
    "edit_e2e": (dict(distance="levenshtein", span="end-to-end"), PAIRS,
                 (0, 0, 0, 0)),
    "indel_endsfree": (dict(distance="indel", text_begin_free=12,
                            text_end_free=12), WINDOWS, (0, 0, 12, 12)),
    "affine_adaptive": (dict(span="end-to-end", heuristic="adaptive"), PAIRS,
                        (0, 0, 0, 0)),
    "affine_seeded": (dict(match=-1, text_begin_free=12, text_end_free=12),
                      WINDOWS, (0, 0, 12, 12)),
}


def _inputs(name):
    kw, pairs, row = CONFIGS[name]
    attr = WavefrontAligner(backend="numpy", **kw)._attributes()
    maxLp = max(len(p) for p, _ in pairs)
    maxLt = max(len(t) for _, t in pairs)
    cfg = E.full_config(attr, maxLp, maxLt)
    pat = encode_batch([p for p, _ in pairs], cfg.Lp, cfg.extend_chunk,
                       PATTERN_SENTINEL)
    txt = encode_batch([t for _, t in pairs], cfg.Lt, cfg.extend_chunk,
                       TEXT_SENTINEL)
    plen = np.array([len(p) for p, _ in pairs], dtype=np.int32)
    tlen = np.array([len(t) for _, t in pairs], dtype=np.int32)
    frees = np.minimum(np.array([row], dtype=np.int32),
                       np.stack([plen, plen, tlen, tlen], axis=1))
    return cfg, pat, txt, plen, tlen, frees


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_table_extension_equals_bits_and_reference(name):
    ref_cfg, pat, txt, plen, tlen, frees = _inputs(name)
    cfg = C.from_reference(ref_cfg)
    tp, tt = torch.from_numpy(pat), torch.from_numpy(txt)
    args = (torch.from_numpy(plen), torch.from_numpy(tlen),
            torch.from_numpy(frees))
    bits = TE.build_eq_bits(cfg, tp, tt)
    table = TLT.build_lcp_table_hmajor(cfg.W, cfg.kmin, cfg.wildcard, tp, tt)
    by_bits = TFL.align_batch_fused_loop(cfg, bits, *args, MAXS)
    by_table = TFL.align_batch_fused_loop(cfg, None, *args, MAXS,
                                          table=table)
    assert set(by_bits) == set(by_table)
    for k in by_bits:
        assert torch.equal(by_bits[k], by_table[k]), k
    assert int(by_table["status"].min()) >= 1
    forced = dataclasses.replace(ref_cfg, extend_force="onehot")
    assert E._extend_mode(forced, txt.shape[1]) == "onehot"
    want = E.align_batch(forced, jnp.asarray(pat), jnp.asarray(txt),
                         jnp.asarray(plen), jnp.asarray(tlen),
                         jnp.asarray(frees), jnp.int32(MAXS))
    for k in KEYS:
        np.testing.assert_array_equal(by_table[k].numpy(),
                                      np.asarray(want[k]), err_msg=k)


def test_extend_mode_routes_tables_and_bits():
    ref_cfg, pat, txt, *_ = _inputs("affine_e2e")
    cfg = C.from_reference(ref_cfg)
    B, Ltp = txt.shape
    assert TE.extend_mode(cfg, B, Ltp) == "table"
    assert TE.extend_mode(cfg, B, 2049) == "bits"
    for off in (dict(use_lcp_table=False), dict(match_classes="iupac"),
                dict(extend_force="bits")):
        assert TE.extend_mode(dataclasses.replace(cfg, **off), B,
                              Ltp) == "bits"
    tp, tt = torch.from_numpy(pat), torch.from_numpy(txt)
    ext = TE.build_extension(cfg, tp, tt)
    assert ext["bits"] is None and ext["table"].shape[0] == Ltp
    ext = TE.build_extension(dataclasses.replace(cfg, use_lcp_table=False),
                             tp, tt)
    assert ext["table"] is None and ext["bits"].dtype == torch.int32
    with pytest.raises(ValueError):
        TFL.align_batch_fused_loop(cfg, None, tp, tt, tt, MAXS)
    assert TFL.variant(cfg, table=True) == "e2e_table"
    assert "e2e_table" in TFL.variant_launches
