"""Which build of the fused-loop kernel a launch takes, with how many
warps a pair, and the invariant the group build rests on, checked on the
CPU.

`fused_loop.kernel_build` sends every band of at most 1024 diagonals to
the group build (G warps a pair over the live band): the short-read
rungs of the batch and API paths, the segments and the run-length table;
`fused_loop.group_size` gives G from the band the rung's score cap
allows and the pairs an SM holds (one warp a pair at the first rung of
4096 pairs, several at a second rung or a segment of few pairs). The
one-shot terminal rungs (a score cap past the band's width) go to the
narrow build (a block a pair), which the group build did not beat on
the card. Bands past
3072 diagonals or with a ring past one block go to the cluster build (a
pair a cluster of CTAs, a slice of the band each), the rest to the
general build: bands of 1025 to 3072 diagonals whose ring fits one
block, and a ring that no cluster holds. The group build touches only
each row's band, so it needs every ring cell outside its row's band to be
NULL: that is checked on the plain version's state, which every build's
state equals byte for byte on the card.
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


def _rung1(attr, maxLp, maxLt, B=4096):
    """The first rung the batch path plans for B pairs of these lengths."""
    attr0 = validate_alignment(attr, maxLp, maxLt)
    return PB._plan_rung(attr0, PB._bucket_len(maxLp), PB._bucket_len(maxLt),
                         min(maxLp, maxLt), B, None, None, None, False).cfg


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
                           _rung1(_attr(metric, scope=scope), 256, 256, 16),
                           16))
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
    """The short-read rungs take the group build: one warp a pair at 4096
    pairs (a pair a warp of the SM's issue slots), G from the rule at one
    API call's 16 pairs."""
    assert cfg.W <= TFL.MAX_THREADS and cfg.S_cap <= 96, name
    assert TFL.kernel_build(cfg, B) == "group"
    G = TFL.group_size(cfg, B)
    assert G == (1 if B == 4096 else
                 min(-(-TFL.live_band(cfg) // 32), TFL.GROUP_WARPS_A_SM))
    P = TFL.group_pairs(cfg, B, G)
    assert 1 <= P <= TFL.GROUP_MAX_PAIRS
    assert P * TFL.group_pair_bytes(cfg, G) <= TFL.SMEM_LIMIT
    assert TFL.launch_shape(cfg, B, "group") == (32 * G * P, G)
    # a small batch spreads over the SMs, a pair a block
    assert TFL.group_pairs(cfg, 16, G) == 1


def test_long_read_shapes_take_the_general_build():
    """Segments, the table and bands past 1024 diagonals: the group build
    up to 1024 diagonals; past them the cluster build where a block a
    pair would give a thread more than three diagonals or keep the ring in
    global memory, else the general build, which was as fast at W=1792
    and W=2176, and the general build where no cluster holds the ring."""
    attr = _attr(span="end-to-end")
    cfg = C.full_config(attr, 160, 160, W=256, S_cap=96)
    assert TFL.kernel_build(cfg, 4096) == "group"
    state = TFL.new_state(cfg, 4, "cpu")
    assert TFL.kernel_build(cfg, 4, state=state) == "group"
    table = torch.zeros((200, 4, cfg.W), dtype=torch.uint8)
    assert TFL.kernel_build(cfg, 4, table=table) == "group"
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
    # the widest band a group build takes
    assert TFL.kernel_build(dataclasses.replace(cfg, W=1024), 16) == "group"
    # stream E's second rung, one shot: 1 kb pairs, W=896, S_cap=768
    assert TFL.kernel_build(
        C.full_config(attr, 1024, 1024, W=896, S_cap=768), 256) == "group"
    # a scope whose ring fits no cluster of at most CLUSTER_MAX CTAs
    big = C.full_config(_attr(span="end-to-end", gap_opening=400), 1024,
                        1088, W=2176, S_cap=500)
    assert TFL.ring_in_global(big)
    assert TFL.cluster_size(big) == 0
    assert TFL.kernel_build(big, 16) == "general"
    with pytest.raises(RuntimeError, match="cluster"):
        TFL.launch_shape(big, 16, "cluster")


def _long_read_shapes():
    """(name, cfg, B, table, state, build, (threads, units a pair)) of the
    long-read launches: stream F's segments (W=896, the table, 4 warps a
    pair: a live band of 360 diagonals, two pairs an SM), resume,
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
        ("F_forward", f, 256, table, state, "group", (128, 4)),
        ("F_replay", dataclasses.replace(f, record_choices=True), 256, table,
         state, "group", (128, 4)),
        ("resume", f, 256, table, None, "group", (128, 4)),
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
    per = TFL.group_pair_bytes(cfg)
    assert per == -(-15 * (W + 2) // 4) * 16
    assert TFL.group_pairs(cfg, 4096) == P
    assert P * per <= TFL.SMEM_LIMIT
    assert P * (TFL.SM_SMEM // (P * per + TFL.BLOCK_SMEM_RESERVED)) \
        == resident
    assert TFL.group_pairs(cfg, 256) == 2
    assert TFL.kernel_build(cfg, 256,
                            state=TFL.new_state(cfg, 2, "cpu")) == "group"


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
    """A one-shot rung whose score cap passes its width expects live bands
    that fill W: there a block a pair, a thread a diagonal (the narrow
    build), beat the group build at every G on the card, so it stays. At
    150 bp that is every terminal rung but edit's and indel's, whose cap
    is about the length: they take the group build, as a segment or the
    run-length table at the same band does, with the G the rule gives: a
    live band of 346-508 diagonals, more than 8 strides of 32, cut to
    GROUP_WARPS_A_SM warps an SM: 256 pairs, two an SM, 4 warps each; 512
    pairs 2 warps; 16 pairs 8 warps; a pair a block."""
    cfg = C.full_config(_attr(metric, span="end-to-end"), 160, 160)
    want = "group" if metric in ("levenshtein", "indel") else "narrow"
    assert (cfg.S_cap > cfg.W) == (want == "narrow")
    assert TFL.kernel_build(cfg, 256) == want
    assert TFL.launch_shape(cfg, 256, "narrow") == (cfg.W, 1)
    band = TFL.live_band(cfg)
    assert 300 < band <= cfg.W - 4
    assert TFL.group_size(cfg, 256) == 4
    assert TFL.group_size(cfg, 512) == 2
    assert TFL.group_size(cfg, 16) == TFL.GROUP_WARPS_A_SM == 8
    assert TFL.launch_shape(cfg, 256, "group") == (128, 4)
    assert TFL.launch_shape(cfg, 16, "group") == (256, 8)
    # a segment or the table at the same band: the group build
    assert TFL.kernel_build(cfg, 4, state=TFL.new_state(cfg, 4, "cpu")) \
        == "group"
    table = torch.zeros((cfg.Lt + 1, 4, cfg.W), dtype=torch.uint8)
    assert TFL.kernel_build(cfg, 4, table=table) == "group"


@pytest.mark.parametrize("metric", METRICS)
def test_warp_blocks_fit_shared_memory_at_the_terminal_rung(metric):
    """Every metric's terminal rung at 150 bp: P pairs' rings and bands in
    one block's shared memory; P keeps the most pairs an SM can hold."""
    cfg = C.full_config(_attr(metric, span="end-to-end"), 160, 160)
    per = TFL.group_pair_bytes(cfg)
    rows = sum(TFL.ring_depths(cfg))
    assert per >= rows * cfg.W * 4 + rows * 2 * 4 and per % 16 == 0
    P = TFL.group_pairs(cfg, 4096)
    assert 1 <= P <= TFL.GROUP_MAX_PAIRS
    assert P * per <= TFL.SMEM_LIMIT

    def resident(q):
        return q * (TFL.SM_SMEM // (q * per + TFL.BLOCK_SMEM_RESERVED))

    assert all(resident(P) >= resident(q)
               for q in range(1, TFL.GROUP_MAX_PAIRS + 1)
               if q * per <= TFL.SMEM_LIMIT)


def test_warp_pairs_at_pywfa_defaults():
    """Gap-affine 4/6/2 at W=256: 15 rows, 15,488 bytes a pair; seven
    pairs a block keep two blocks, 14 pairs, on an SM (eight would keep
    one). Affine2p at W=384: 36 rows, 55,584 bytes, four pairs an SM."""
    cfg = C.full_config(_attr(span="end-to-end"), 160, 160, W=256, S_cap=96)
    assert TFL.group_pair_bytes(cfg) == 15488
    assert TFL.group_pairs(cfg, 4096) == 7
    assert TFL.group_pairs(cfg, 256) == 2
    a2p = C.full_config(_attr("affine2p", span="end-to-end"), 160, 160,
                        W=384, S_cap=96)
    assert TFL.group_pair_bytes(a2p) == 55584
    P = TFL.group_pairs(a2p, 4096)
    assert P * (TFL.SM_SMEM // (P * 55584 + TFL.BLOCK_SMEM_RESERVED)) == 4


def test_rung1_takes_one_warp_a_pair():
    """The first rung of 4096 pairs (W=256, S_cap=96): one warp a pair,
    seven pairs a block, exactly the block of one warp a pair before G
    (15,488 bytes a pair, no fold partials)."""
    cfg = C.full_config(_attr(span="end-to-end"), 160, 160, W=256, S_cap=96)
    assert TFL.kernel_build(cfg, 4096) == "group"
    assert TFL.group_size(cfg, 4096) == 1
    assert TFL.launch_shape(cfg, 4096, "group") == (224, 1)
    assert TFL.group_pair_bytes(cfg, 1) == 15488


def test_e_rung2_takes_the_rules_group():
    """Stream E's second rung, one shot (256 pairs of 1 kb, W=896,
    S_cap=768): the score cap lets a band reach 804 diagonals, two pairs
    share an SM, so GROUP_WARPS_A_SM / 2 = 4 warps a pair, a pair a
    block."""
    cfg = C.full_config(_attr(span="end-to-end"), 1024, 1024, W=896,
                        S_cap=768)
    assert TFL.live_band(cfg) == 2 * (768 // 2 + 1) + 2 * (9 + 4) + 8 == 804
    assert TFL.kernel_build(cfg, 256) == "group"
    G = TFL.group_size(cfg, 256)
    assert G == min(-(-TFL.live_band(cfg) // 32),
                    TFL.GROUP_WARPS_A_SM // -(-256 // TFL.SMS)) == 4
    assert TFL.launch_shape(cfg, 256, "group") == (128, 4)


@pytest.mark.parametrize("metric", METRICS)
def test_group_blocks_fit_at_every_g(metric):
    """At pywfa's penalties, every metric, with and without the cascade,
    at the first and the terminal rung: for every G a block holds, P
    pairs of G warps keep P * G <= 32 warps and GROUP_MAX_THREADS
    threads, P rings and their fold partials fit SMEM_LIMIT, and with
    G > 1 there are at most NAMED_BARRIERS pairs (one named barrier each,
    id 0 left to __syncthreads) and at most GROUP_MAX_PAIRS always."""
    for heur in (None, "adaptive"):
        kw = dict(span="end-to-end")
        if heur:
            kw["heuristic"] = heur
        attr = _attr(metric, **kw)
        for cfg in (C.full_config(attr, 160, 160, W=256, S_cap=96),
                    C.full_config(attr, 160, 160),
                    C.full_config(attr, 1024, 1024, W=1024, S_cap=768)):
            rows = sum(TFL.ring_depths(cfg))
            for G in range(1, TFL.GROUP_MAX_THREADS // 32 + 1):
                per = TFL.group_pair_bytes(cfg, G)
                partials = (0 if G == 1 else (TFL.GROUP_PARTIALS + (
                    TFL.HEUR_REDUCTIONS if heur else 0)) * G + 2)
                assert per == -(-(rows * (cfg.W + 2) + partials) // 4) * 16
                for B in (16, 256, 4096):
                    P = TFL.group_pairs(cfg, B, G)
                    if P == 0:
                        # only a ring past a block's shared memory
                        assert per > TFL.SMEM_LIMIT, (metric, cfg.W, G)
                        continue
                    assert P * G <= 32
                    assert 32 * G * P <= TFL.GROUP_MAX_THREADS
                    assert P * per <= TFL.SMEM_LIMIT
                    assert P <= TFL.GROUP_MAX_PAIRS
                    assert G == 1 or P <= TFL.NAMED_BARRIERS
            for B in (16, 256, 4096):
                threads, G = TFL.launch_shape(cfg, B, "group")
                assert threads % (32 * G) == 0
                assert threads <= TFL.GROUP_MAX_THREADS


@pytest.mark.parametrize("W", [128, 384, 512, 1024])
def test_group_lanes_cover_every_band(W):
    """Thread t of a group of G warps owns k = k0 + t of every stride,
    k0 from the band's low end in steps of 32 * G (the extension loads
    four strides at a time): every band [lo, hi] inside [kmin + 2,
    kmin + W - 3] is covered, each diagonal by one thread once, at every
    G up to W / 32 that a block holds."""
    kmin = -(W // 2)
    klo, khi = kmin + 2, kmin + W - 3
    rng = np.random.default_rng(W)
    bands = [(klo, khi), (0, 0), (klo, klo), (khi, khi)]
    for _ in range(12):
        lo, hi = sorted(int(x) for x in rng.integers(klo, khi + 1, 2))
        bands.append((lo, hi))
    for G in range(1, min(W // 32, TFL.GROUP_MAX_THREADS // 32) + 1):
        GT = 32 * G
        for lo, hi in bands:
            seen = []
            for k0 in range(lo, hi + 1, GT):
                seen += [k0 + t for t in range(GT) if k0 + t <= hi]
            assert seen == list(range(lo, hi + 1))
            ext = []
            for k0 in range(lo, hi + 1, 4 * GT):
                ext += [k0 + GT * j + t for j in range(4) for t in range(GT)
                        if k0 + GT * j + t <= hi]
            assert sorted(ext) == list(range(lo, hi + 1))
            assert all(0 <= k - kmin < W for k in seen)


@pytest.mark.parametrize("metric", METRICS)
def test_score_band_is_the_batch_paths_band(metric):
    """config.score_band, which group_size reads, is the band the batch
    path sizes a rung's W by (batch._band_for_score) wherever no
    heuristic and no begin-free seed bounds the latter."""
    attr = validate_alignment(_attr(metric, span="end-to-end"), 150, 160)
    pen = attr.penalties
    for S in (8, 96, 384, 649, 768, 2000):
        for Lp, Lt in ((150, 160), (1024, 1040), (160, 160)):
            assert C.score_band(pen.distance_metric, pen.gap_opening1,
                                pen.gap_extension1, pen.gap_extension2,
                                pen.max_score_scope, S, abs(Lp - Lt)) \
                == PB._band_for_score(attr, S, Lp, Lt)
    cfg = C.full_config(attr, 160, 160, W=256, S_cap=96)
    assert TFL.live_band(cfg) == min(cfg.W - 4, PB._band_for_score(
        attr, 96, 160, 160))


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
    running and for those done (the group build's invariant)."""
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
