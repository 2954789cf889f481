"""The CUDA fused-loop kernel against its plain torch version, on the card.

Runs only where a CUDA device is present (marker `cuda`; skipped
elsewhere). The file imports no jax, so on a GPU host without jax run it
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Every comparison is of integers and byte-exact (tolerance zero).
"""
import dataclasses

import numpy as np
import pytest
import torch

from pywfa_tpu.attributes import AlignerAttributes, AlignmentForm
from pywfa_tpu.constants import AlignmentSpan
from pywfa_tpu.oracle import OracleAligner
from pywfa_tpu_torch import batch as PB
from pywfa_tpu_torch.ops import config as C
from pywfa_tpu_torch.ops import engine as TE
from pywfa_tpu_torch.ops import fused_loop
from tests.corpus import random_pairs

pytestmark = pytest.mark.cuda

KEYS = ("status", "final_s", "end_k", "end_off", "choices")
ATTR = AlignerAttributes(form=AlignmentForm(span=AlignmentSpan.END_TO_END))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(cfg, pairs, dev):
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
    return (bits, torch.from_numpy(plens).to(dev),
            torch.from_numpy(tlens).to(dev),
            torch.zeros((len(pairs), 4), dtype=torch.int32, device=dev))


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
    before = fused_loop.launches
    got = fused_loop.align_batch_fused_loop(cfg, *args, max_steps)
    assert fused_loop.launches == before + 1
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
