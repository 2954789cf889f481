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


def _grid_ok(B, W, Ltp, cells=None, segments=None):
    """The launch of launch_shape(B, W, Ltp, cells, segments) within CUDA's
    limits and covering B * ceil(W / cells) * segments threads with no
    block to spare; returns (cells, segments, threads, blocks, groups a
    pair)."""
    cells, segments, threads, blocks = TLT.launch_shape(B, W, Ltp, cells,
                                                        segments)
    assert cells in TLT.CELLS[TLT.table_dtype(Ltp)]
    assert segments in TLT.SEGMENTS and 32 % segments == 0
    assert 32 <= threads <= 256 and threads % 32 == 0
    assert 1 <= blocks <= 2**31 - 1
    groups = -(-W // cells)
    # every group of diagonals inside W, the last one reaching it
    assert (groups - 1) * cells < W <= groups * cells
    items = B * groups * segments
    assert blocks * threads >= items
    assert B == 0 or (blocks - 1) * threads < items
    return cells, segments, threads, blocks, groups


@pytest.mark.parametrize("Ltp", [176, 1040])
@pytest.mark.parametrize("W", [1, 61, 256, 257, 896, 6912])
def test_launch_shape_covers_every_cell_once(W, Ltp):
    """The kernel's geometry: for batches up to 2^20 pairs every grid
    dimension stays within CUDA's limits; on small batches, replaying the
    kernel's own index arithmetic (thread -> pair, first diagonal, segment
    of text positions; cells up to W; the segments of a group in one warp)
    covers every (pair, diagonal) and every text position exactly once and
    stores nothing past W."""
    dt = TLT.table_dtype(Ltp)
    for B in (1, 2, 17, 4096, 65535, 65537, 2**20):
        for cells in (None,) + TLT.CELLS[dt]:
            for segments in (None,) + TLT.SEGMENTS:
                _grid_ok(B, W, Ltp, cells, segments)
    for B in (1, 2, 17):
        for cells in (None,) + TLT.CELLS[dt]:
            for segments in (None,) + TLT.SEGMENTS:
                cells, S, threads, blocks, groups = _grid_ok(
                    B, W, Ltp, cells, segments)
                tid = np.arange(blocks * threads)
                item, seg = tid // S, tid % S
                live = item < B * groups
                item, seg, tid = item[live], seg[live], tid[live]
                # the S threads of a group: neighbours in one warp
                assert ((item * S) // 32 == (item * S + S - 1) // 32).all()
                b, w0 = item // groups, (item % groups) * cells
                hits = np.zeros((B, W, S), dtype=np.int64)
                for i in range(cells):
                    inside = w0 + i < W
                    np.add.at(hits, (b[inside], (w0 + i)[inside],
                                     seg[inside]), 1)
                assert (hits == 1).all()
                # the segments' rows, as the kernel cuts them
                seglen = -(-Ltp // S)
                rows = np.zeros(Ltp, dtype=np.int64)
                for k in range(S):
                    hi = Ltp - 1 - k * seglen
                    if hi >= 0:
                        rows[max(0, hi - seglen + 1):hi + 1] += 1
                assert (rows == 1).all()
    # the most diagonals a thread while the batch gives MIN_THREADS
    # threads, else the fewest, and then segments of text positions
    assert TLT.launch_shape(4096, 256, Ltp)[:2] == (TLT.CELLS[dt][0], 1)
    cells, segments = TLT.launch_shape(1, W, Ltp)[:2]
    assert cells == TLT.CELLS[dt][-1]
    assert segments > 1 and -(-Ltp // segments) >= TLT.MIN_SEGMENT
    with pytest.raises(ValueError):
        TLT.launch_shape(4, W, Ltp, cells=2)
    with pytest.raises(ValueError):
        TLT.launch_shape(4, W, Ltp, segments=3)


def _fault_rows(case):
    """(cfg, pat, txt) at one shape of each limit of the first CUDA
    kernel: more pairs than a grid dimension of 65535 holds, and a
    pattern row past 48 KiB (49168 bytes against a text row of 1040)."""
    rng = np.random.default_rng(1059)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    attr = WavefrontAligner(backend="numpy", span="end-to-end")._attributes()
    if case == "many_pairs":
        B, Lt = 65537, 16
        seqs = acgt[rng.integers(0, 4, (B, Lt))]
        lens = rng.integers(8, Lt + 1, B)
        txts = np.where(rng.random((B, Lt)) < 0.1,
                        acgt[rng.integers(0, 4, (B, Lt))], seqs)
        pats = [s[:n].tobytes() for s, n in zip(seqs, lens)]
        txts = [t[:n].tobytes() for t, n in zip(txts, rng.permutation(lens))]
        cfg = dataclasses.replace(E.full_config(attr, Lt, Lt), W=8)
    else:
        Lp, Lt = 49152, 1024
        p = acgt[rng.integers(0, 4, Lp)]
        t = p[:Lt].copy()
        flip = rng.random(Lt) < 0.05
        t[flip] = acgt[rng.integers(0, 4, int(flip.sum()))]
        pats, txts = [p.tobytes()], [t.tobytes()]
        cfg = dataclasses.replace(E.full_config(attr, Lp, Lt), W=64)
    pat = encode_batch(pats, cfg.Lp, cfg.extend_chunk, PATTERN_SENTINEL)
    txt = encode_batch(txts, cfg.Lt, cfg.extend_chunk, TEXT_SENTINEL)
    return cfg, pat, txt


@pytest.mark.parametrize("case", ["many_pairs", "long_pattern_row"])
def test_plain_table_matches_xla_at_the_fault_shapes(case):
    """The plain version (the CPU path and the card's twin) against the
    reference's XLA builder, transposed, at B = 65537 and at a pattern row
    of 49168 bytes, the two shapes the first CUDA kernel refused."""
    cfg, pat, txt = _fault_rows(case)
    if case == "many_pairs":
        assert pat.shape[0] > 65535
    else:
        assert pat.shape[1] > 48 * 1024 and txt.shape[1] == 1040
    got = TLT.build_lcp_table_hmajor(cfg.W, cfg.kmin, -1,
                                     torch.from_numpy(pat),
                                     torch.from_numpy(txt))
    assert tuple(got.shape) == (txt.shape[1], pat.shape[0], cfg.W)
    assert got.dtype == TLT.table_dtype(txt.shape[1])
    xla = np.asarray(E._build_lcp_table(cfg, jnp.asarray(pat),
                                        jnp.asarray(txt)))
    np.testing.assert_array_equal(got.numpy(), xla.transpose(2, 0, 1))
