"""Which build of the fused-loop kernel a launch takes, and the invariant
the warp build rests on, checked on the CPU.

`fused_loop.kernel_build` sends every short-read shape of the batch and
API paths to the warp build (one warp a pair over the live band), the
terminal rungs (a score cap past the band's width) to the narrow build
(a block a pair), the segments and the run-length table of bands up to
1024 diagonals to the warp build too, bands past 3072 diagonals or with a
ring past one block to the cluster build (a pair a cluster of CTAs, a
slice of the band each), and the rest to the general build: bands of
1025 to 3072 diagonals whose ring fits one block, and a ring that no
cluster holds. The warp build touches
only each row's band, so it needs every ring cell outside its row's band
to be NULL: that is checked on the plain version's state, which every
build's state equals byte for byte on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from pywfa_tpu_torch import batch as PB
from pywfa_tpu_torch.align import WavefrontAligner
from pywfa_tpu_torch.attributes import HeuristicParams, validate_alignment
from pywfa_tpu_torch.constants import HeuristicStrategy as HS
from pywfa_tpu_torch.ops import config as C
from pywfa_tpu_torch.ops import engine as TE
from pywfa_tpu_torch.ops import fused_loop as TFL
from tests.corpus import random_pairs

torch.set_num_threads(1)

METRICS = ("affine", "affine2p", "linear", "levenshtein", "indel")
MAXS = 2**31 - 1


def _attr(metric="affine", **kw):
    return WavefrontAligner(backend="numpy", distance=metric,
                            **kw)._attributes()


def _rung1(attr, maxLp, maxLt):
    """The first rung the batch path derives for these lengths."""
    attr0 = validate_alignment(attr, maxLp, maxLt)
    return PB._derive_config(attr0, PB._bucket_len(maxLp),
                             PB._bucket_len(maxLt), min(maxLp, maxLt), None,
                             None, False)[1]


def _short_read_shapes():
    """(name, cfg, B) of the short-read main-path launches."""
    shapes = []
    for metric in METRICS:
        for scope in ("full", "score"):
            shapes.append((f"{metric}_rung1_{scope}",
                           _rung1(_attr(metric, span="end-to-end",
                                        scope=scope), 150, 150), 4096))
            # one WavefrontAligner call: a 150 bp pair padded to 16 pairs
            # at the API's power-of-two buckets
            shapes.append((f"{metric}_api_{scope}",
                           _rung1(_attr(metric, scope=scope), 256, 256), 16))
    free = dict(text_begin_free=50, text_end_free=50)
    shapes.append(("windows", _rung1(_attr(**free), 150, 200), 4096))
    shapes.append(("seeded_windows", _rung1(_attr(match=-1, **free), 150,
                                            200), 4096))
    shapes.append(("affine2p_windows",
                   _rung1(_attr("affine2p", **free), 150, 200), 4096))
    for name, params in (
            ("wfadaptive", HeuristicParams(strategy=HS.WFADAPTIVE)),
            ("xdrop", HeuristicParams(strategy=HS.XDROP, xdrop=20)),
            ("zdrop", HeuristicParams(strategy=HS.ZDROP, zdrop=100))):
        attr = dataclasses.replace(_attr(span="end-to-end"), heuristic=params)
        shapes.append((f"heur_{name}_rung1", _rung1(attr, 150, 150), 4096))
    shapes.append(("affine2p_heur_rung1",
                   _rung1(_attr("affine2p", span="end-to-end",
                                heuristic="adaptive"), 150, 150), 4096))
    shapes.append(("heur_seed_windows",
                   _rung1(_attr(match=-1, heuristic="adaptive", **free), 150,
                          200), 4096))
    return shapes


@pytest.mark.parametrize("name,cfg,B", _short_read_shapes(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_short_read_shapes_take_the_warp_build(name, cfg, B):
    assert cfg.W <= TFL.MAX_THREADS and cfg.S_cap <= 96, name
    assert TFL.kernel_build(cfg, B) == "warp"
    P = TFL.warp_pairs(cfg, B)
    assert 1 <= P <= TFL.WARP_MAX_PAIRS
    assert P * TFL.warp_pair_bytes(cfg) <= TFL.SMEM_LIMIT
    # a small batch spreads over the SMs, a pair a block
    assert TFL.warp_pairs(cfg, 16) == 1


def test_long_read_shapes_take_the_general_build():
    """Segments, the table and bands past 1024 diagonals: the warp build
    up to 1024 diagonals; past them the cluster build where a block a
    pair would give a thread more than three diagonals or keep the ring in
    global memory, else the general build, which was as fast at W=1792
    and W=2176, and the general build where no cluster holds the ring."""
    attr = _attr(span="end-to-end")
    cfg = C.full_config(attr, 160, 160, W=256, S_cap=96)
    assert TFL.kernel_build(cfg, 4096) == "warp"
    state = TFL.new_state(cfg, 4, "cpu")
    assert TFL.kernel_build(cfg, 4, state=state) == "warp"
    table = torch.zeros((200, 4, cfg.W), dtype=torch.uint8)
    assert TFL.kernel_build(cfg, 4, table=table) == "warp"
    wide = C.full_config(attr, 1024, 1088, W=1152, S_cap=500)
    assert not TFL.ring_in_global(wide)
    assert TFL.kernel_build(wide, 16) == "general"
    # three diagonals a thread: 576 / 3 = 192
    assert TFL.launch_shape(wide, 16, "cluster") == (192, 2)
    in_global = C.full_config(attr, 1024, 1088, W=4096, S_cap=500)
    assert TFL.ring_in_global(in_global)
    assert TFL.kernel_build(in_global, 16) == "cluster"
    assert TFL.launch_shape(in_global, 16, "cluster") == (352, 4)
    assert TFL.launch_shape(in_global, 16, "general") == (1024, 1)
    # the widest band a warp build takes
    assert TFL.kernel_build(dataclasses.replace(cfg, W=1024), 16) == "warp"
    # stream E's second rung, one shot: 1 kb pairs, W=896, S_cap=768
    assert TFL.kernel_build(
        C.full_config(attr, 1024, 1024, W=896, S_cap=768), 256) == "warp"
    # a scope whose ring fits no cluster of at most CLUSTER_MAX CTAs
    big = C.full_config(_attr(span="end-to-end", gap_opening=400), 1024,
                        1088, W=2176, S_cap=500)
    assert TFL.ring_in_global(big)
    assert TFL.cluster_size(big) == 0
    assert TFL.kernel_build(big, 16) == "general"
    with pytest.raises(RuntimeError, match="cluster"):
        TFL.launch_shape(big, 16, "cluster")


def _long_read_shapes():
    """(name, cfg, B, table, state, build, (threads, cluster)) of the
    long-read launches: stream F's segments (W=896, the table), resume,
    batch G's rung 2 (W=6912, the ring past one block) and rung 1
    (W=1792), the W=2176 shape and the 5 kb API pair's second rung
    (W=3584, four diagonals a thread on a block)."""
    attr = _attr(span="end-to-end")
    f = C.full_config(attr, 1024, 1040, W=896, S_cap=292,
                      record_choices=False)
    g = C.full_config(attr, 10240, 10240, W=6912, S_cap=96,
                      record_choices=False)
    w2176 = C.full_config(attr, 1024, 1088, W=2176, S_cap=700)
    api5k = C.full_config(_attr(), 8192, 8192, W=3584, S_cap=3456)
    g1 = C.full_config(attr, 10240, 10240, W=1792, S_cap=1696)
    a2p = C.full_config(_attr("affine2p", span="end-to-end"), 10240, 10240,
                        W=6912, S_cap=96, record_choices=False)
    table = torch.zeros((f.Lt + 1, 256, f.W), dtype=torch.int16)
    state = TFL.new_state(dataclasses.replace(f, W=32), 256, "cpu")
    return [
        ("F_forward", f, 256, table, state, "warp", (64, 1)),
        ("F_replay", dataclasses.replace(f, record_choices=True), 256, table,
         state, "warp", (64, 1)),
        ("resume", f, 256, table, None, "warp", (64, 1)),
        ("G_forward", g, 16, None, state, "cluster", (288, 8)),
        ("G_replay", dataclasses.replace(g, record_choices=True), 16, None,
         state, "cluster", (288, 8)),
        ("G_high_one_shot", dataclasses.replace(g, S_cap=2000), 16, None,
         None, "cluster", (288, 8)),
        ("affine2p_6912", a2p, 16, None, state, "cluster", (288, 8)),
        ("G_rung1", g1, 16, None, None, "general", (896, 1)),
        ("w2176", w2176, 8, None, None, "general", (736, 1)),
        ("api_5kb", api5k, 16, None, None, "cluster", (320, 4)),
    ]


@pytest.mark.parametrize("name,cfg,B,table,state,build,shape",
                         _long_read_shapes(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_long_read_shapes_take_the_new_builds(name, cfg, B, table, state,
                                              build, shape):
    assert TFL.kernel_build(cfg, B, table=table, state=state) == build, name
    assert TFL.launch_shape(cfg, B, build) == shape
    if build == "cluster":
        assert TFL.ring_in_global(cfg) or cfg.W > 3 * TFL.MAX_THREADS
        assert TFL.cluster_smem_bytes(cfg, shape[1]) <= TFL.SMEM_LIMIT


@pytest.mark.parametrize("W,P,resident", [(896, 4, 4), (1024, 3, 3)])
def test_warp_build_holds_a_segment_at_wide_bands(W, P, resident):
    """A segment's state at W=896 (stream F) and W=1024: a pair's ring and
    bands, 15 rows at pywfa's penalties, fit a warp's share of one block;
    P pairs a block keep `resident` pairs an SM, and a 256-pair batch is cut
    to ceil(256 / SMs) = 2 pairs a block."""
    cfg = C.full_config(_attr(span="end-to-end"), 1024, 1040, W=W,
                        S_cap=292, record_choices=False)
    per = TFL.warp_pair_bytes(cfg)
    assert per == -(-15 * (W + 2) // 4) * 16
    assert TFL.warp_pairs(cfg, 4096) == P
    assert P * per <= TFL.SMEM_LIMIT
    assert P * (TFL.SM_SMEM // (P * per + TFL.BLOCK_SMEM_RESERVED)) \
        == resident
    assert TFL.warp_pairs(cfg, 256) == 2
    assert TFL.kernel_build(cfg, 256,
                            state=TFL.new_state(cfg, 2, "cpu")) == "warp"


@pytest.mark.parametrize("W", [1152, 2176, 4096, 5120, 6912, 8192])
@pytest.mark.parametrize("metric", METRICS)
def test_cluster_slices_cover_the_band(metric, W):
    """The cluster build's C slices of W / C diagonals cover [0, W) in
    whole warps, each at most 1024 diagonals, and each CTA's columns of
    the ring, its bands and its reductions' rows fit one CTA's shared
    memory, for every metric at pywfa's penalties, with and without the
    cascade; C is the smallest such cluster; a CTA's threads, three
    diagonals each, cover its slice within the kernel's launch bound; the routing takes the cluster build
    where the general build's threads would own four diagonals or more
    (W > 3072) or its ring would live in global memory."""
    for heur in (None, "adaptive"):
        kw = dict(span="end-to-end")
        if heur:
            kw["heuristic"] = heur
        cfg = C.full_config(_attr(metric, **kw), W, W, W=W, S_cap=96)
        Cn = TFL.cluster_size(cfg)
        assert 2 <= Cn <= TFL.CLUSTER_MAX, (metric, W)
        T = W // Cn
        assert T * Cn == W and T % 32 == 0 and T <= TFL.MAX_THREADS
        slices = [range(r * T, (r + 1) * T) for r in range(Cn)]
        assert [w for sl in slices for w in sl] == list(range(W))
        rows = sum(TFL.ring_depths(cfg))
        smem = TFL.cluster_smem_bytes(cfg, Cn)
        assert smem >= rows * T * 4 and smem <= TFL.SMEM_LIMIT
        assert all((W // 32) % c or W // c > TFL.MAX_THREADS
                   or TFL.cluster_smem_bytes(cfg, c) > TFL.SMEM_LIMIT
                   for c in range(1, Cn))
        threads, ctas = TFL.launch_shape(cfg, 16, "cluster")
        assert ctas == Cn and threads % 32 == 0
        assert threads <= TFL.CLUSTER_THREADS
        assert threads * TFL.CLUSTER_DIAGONALS >= T > (threads - 32) \
            * TFL.CLUSTER_DIAGONALS
        assert TFL.kernel_build(cfg, 16) == (
            "cluster" if W > 3072 or TFL.ring_in_global(cfg) else "general")


@pytest.mark.parametrize("metric", METRICS)
def test_terminal_rungs_take_the_narrow_build(metric):
    """A rung whose score cap passes its width expects live bands that
    fill W: the narrow build, a block a pair. At 150 bp that is every
    terminal rung but edit's and indel's, whose cap is about the length."""
    cfg = C.full_config(_attr(metric, span="end-to-end"), 160, 160)
    want = "warp" if metric in ("levenshtein", "indel") else "narrow"
    assert (cfg.S_cap > cfg.W) == (want == "narrow")
    assert TFL.kernel_build(cfg, 256) == want
    # a segment at the same band: the warp build
    assert TFL.kernel_build(cfg, 4, state=TFL.new_state(cfg, 4, "cpu")) \
        == "warp"


@pytest.mark.parametrize("metric", METRICS)
def test_warp_blocks_fit_shared_memory_at_the_terminal_rung(metric):
    """Every metric's terminal rung at 150 bp: P pairs' rings and bands in
    one block's shared memory; P keeps the most pairs an SM can hold."""
    cfg = C.full_config(_attr(metric, span="end-to-end"), 160, 160)
    per = TFL.warp_pair_bytes(cfg)
    rows = sum(TFL.ring_depths(cfg))
    assert per >= rows * cfg.W * 4 + rows * 2 * 4 and per % 16 == 0
    P = TFL.warp_pairs(cfg, 4096)
    assert 1 <= P <= TFL.WARP_MAX_PAIRS
    assert P * per <= TFL.SMEM_LIMIT

    def resident(q):
        return q * (TFL.SM_SMEM // (q * per + TFL.BLOCK_SMEM_RESERVED))

    assert all(resident(P) >= resident(q)
               for q in range(1, TFL.WARP_MAX_PAIRS + 1)
               if q * per <= TFL.SMEM_LIMIT)


def test_warp_pairs_at_pywfa_defaults():
    """Gap-affine 4/6/2 at W=256: 15 rows, 15,488 bytes a pair; seven
    pairs a block keep two blocks, 14 pairs, on an SM (eight would keep
    one). Affine2p at W=384: 36 rows, 55,584 bytes, four pairs an SM."""
    cfg = C.full_config(_attr(span="end-to-end"), 160, 160, W=256, S_cap=96)
    assert TFL.warp_pair_bytes(cfg) == 15488
    assert TFL.warp_pairs(cfg, 4096) == 7
    assert TFL.warp_pairs(cfg, 256) == 2
    a2p = C.full_config(_attr("affine2p", span="end-to-end"), 160, 160,
                        W=384, S_cap=96)
    assert TFL.warp_pair_bytes(a2p) == 55584
    P = TFL.warp_pairs(a2p, 4096)
    assert P * (TFL.SM_SMEM // (P * 55584 + TFL.BLOCK_SMEM_RESERVED)) == 4


HEURISTICS = {
    "wfadaptive": HeuristicParams(strategy=HS.WFADAPTIVE,
                                  min_wavefront_length=5,
                                  max_distance_threshold=15,
                                  steps_between_cutoffs=1),
    "xdrop": HeuristicParams(strategy=HS.XDROP, xdrop=10,
                             steps_between_cutoffs=1),
    "zdrop": HeuristicParams(strategy=HS.ZDROP, zdrop=12,
                             steps_between_cutoffs=2),
}


def _invariant_cases():
    cases = []
    for metric in METRICS:
        cases.append((metric, "end-to-end", None, None))
        cases.append((metric, "ends-free", None, None))
    for metric in ("affine", "affine2p", "linear"):
        cases.append((metric, "ends-free", -1, None))
    for name in sorted(HEURISTICS):
        cases.append(("affine", "end-to-end", None, name))
    cases.append(("affine2p", "ends-free", None, "wfadaptive"))
    cases.append(("affine", "ends-free", -1, "xdrop"))
    return cases


@pytest.mark.parametrize("metric,span,match,heur", _invariant_cases())
def test_ring_is_null_outside_each_rows_band(metric, span, match, heur):
    """After a segment of the plain version, every cell of the stored ring
    whose diagonal lies outside its row's band is NULL, for the pairs still
    running and for those done (the warp build's invariant)."""
    kw = {} if match is None else dict(match=match)
    if span == "ends-free":
        kw.update(pattern_begin_free=3, pattern_end_free=3,
                  text_begin_free=8, text_end_free=8)
    attr = _attr(metric, span=span, **kw)
    if heur is not None:
        attr = dataclasses.replace(attr, heuristic=HEURISTICS[heur])
    pairs = random_pairs(80 + len(metric), 12, 4, 60, 0.15, 0.08,
                         unrelated=0.25, as_bytes=True)
    # edit and indel count an edit 1; a match bonus doubles every penalty
    S_cap = 12 if metric in ("levenshtein", "indel") else 24
    cfg = C.full_config(attr, 64, 64, W=128,
                        S_cap=S_cap if match is None else 2 * S_cap)
    W = cfg.W
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    plens = np.array([len(p) for p in pats], dtype=np.int32)
    tlens = np.array([len(t) for t in txts], dtype=np.int32)
    pat = PB.encode_batch(pats, cfg.Lp, cfg.extend_chunk,
                          PB.PATTERN_SENTINEL, plens)
    txt = PB.encode_batch(txts, cfg.Lt, cfg.extend_chunk, PB.TEXT_SENTINEL,
                          tlens)
    bits = TE.build_eq_bits(cfg, torch.from_numpy(pat),
                            torch.from_numpy(txt))
    lens = np.stack([plens, plens, tlens, tlens], axis=1)
    frees = np.minimum(np.array([[3, 3, 8, 8]], dtype=np.int32), lens)
    state = TFL.new_state(cfg, len(pairs), "cpu")
    out = TFL.align_batch_fused_loop(
        cfg, bits, torch.from_numpy(plens), torch.from_numpy(tlens),
        torch.from_numpy(frees), MAXS, state=state, fresh=True)
    # some pairs still run at the segment's end, some are done
    status = out["status"]
    assert (status == C.ST_OVERFLOW_S).any()
    assert (status != C.ST_OVERFLOW_S).any()
    k = torch.arange(W) + cfg.kmin
    lo = state["lohi"][:, :, 0:1]
    hi = state["lohi"][:, :, 1:2]
    outside = (k < lo) | (k > hi)
    assert (state["ring"][outside] == C.NULL).all()
    # and rows that hold a band hold it inside [kmin + 2, kmin + W - 3]
    held = lo[..., 0] <= hi[..., 0]
    assert held.any()
    assert (lo[..., 0][held] >= cfg.kmin + 2).all()
    assert (hi[..., 0][held] <= cfg.kmin + W - 3).all()
