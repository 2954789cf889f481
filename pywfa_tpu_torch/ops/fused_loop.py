"""The fused whole-alignment score loop: all five distance metrics
(gap-affine, gap-affine 2-piece, gap-linear, edit, indel), end-to-end or
ends-free span (with a match bonus too: the boundary is then seeded at
every score divisible by -match), full-CIGAR or score-only scope, and the
heuristic cascade (wf-adaptive, wfmash, x-drop, z-drop, banded static and
adaptive, and their combinations); one shot from score 0 or one segment of
a segmented run (state in, state out); bands of any width; extension by
the packed equality words, by the run-length table (`ops/lcp_table.py`),
or by comparing the token rows in place from each cell's offset to the
first mismatch (the reference's chunked `engine._extend_band`, for batches
whose words would not fit: `engine.extend_mode`).

The twin of `pywfa_tpu/ops/pallas/fused_loop.py`. For every pair it runs
the whole WFA score loop -- extend, terminate, prune the wavefront by the
heuristics, compute s+1, seed, trim, record one choice byte per cell
unless the scope is score-only -- and returns the same dict as the
reference's `align_batch_pallas`.

`align_batch_fused_loop` is the entry point. On CUDA tensors it launches
the hand-written kernel in `csrc/fused_loop.cu`, in the build that
`kernel_build` picks: for a band of at most 1024 diagonals, the group
build (G warps a pair over the live band, G from `group_size`; one shot
or a segment, on any extension source), or the narrow build (one block a
pair, a thread a diagonal, the words only) for a one-shot terminal rung,
whose score cap passes its width, where the group build lost to it on the
card; for a band past 3072 diagonals or a ring past one
block's shared memory the cluster build (one pair on a thread-block
cluster of up to 8 CTAs, a slice of the band and of the ring each); else
the general build (one block a pair); on CPU
tensors it runs `align_batch_fused_loop_ref`, the plain torch version,
which is the Pallas kernel's own array program over [B, W] with a Python
loop over scores.

A segmented run (the long-read path) keeps each pair's state in three
int32 tensors that the kernel and the plain version share: `ring`
[B, rows, W] (the wavefront ring, `ring_depths` rows a component, the row
of score s at s % depth), `lohi` [B, rows, 2] (each row's band) and
`carry` [B, len(CARRY)] (see CARRY). A segment covers the scores
[seg_base, seg_base + S_cap - 1], records choice level s - seg_base, and
updates the state in place; a pair still running at its end reports
ST_OVERFLOW_S in the result and stays ST_RUNNING in the state; a pair that
is done is left as it is. `state_from_reference` builds the same state
from the JAX package's resume pytree.

One deliberate difference from the Pallas kernel: a band that outgrows W
reports ST_OVERFLOW_W, as the XLA engine does, instead of being clamped
silently; so do ends-free seeds past the band, at WF0 or at a later
score. The escalation ladder re-runs such pairs at a wider band.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..constants import AlignmentSpan, DistanceMetric, HeuristicStrategy
from .config import (
    D1, D2, I1, I2, M, MSRC_D1, MSRC_D2, MSRC_I1, MSRC_I2, MSRC_NONE,
    MSRC_SEED, MSRC_X,
    NULL, NULL_THRESHOLD, PATTERN_PAD, ST_END_REACHED, ST_END_UNREACHABLE,
    ST_MAX_STEPS, ST_OVERFLOW_S, ST_OVERFLOW_W, ST_RUNNING, TEXT_PAD,
    EngineConfig, score_band,
)

# the kernel's metric codes (csrc/fused_loop.cu) and the variant-name
# prefix of each metric; gap-affine, pywfa's default, carries none
METRIC_CODE = {DistanceMetric.GAP_AFFINE: 0, DistanceMetric.GAP_AFFINE_2P: 1,
               DistanceMetric.GAP_LINEAR: 2, DistanceMetric.EDIT: 3,
               DistanceMetric.INDEL: 4}
METRIC_PREFIX = {DistanceMetric.GAP_AFFINE: "",
                 DistanceMetric.GAP_AFFINE_2P: "affine2p_",
                 DistanceMetric.GAP_LINEAR: "linear_",
                 DistanceMetric.EDIT: "edit_", DistanceMetric.INDEL: "indel_"}
# the kernel's span codes: end to end; ends-free with the begin-free seeds
# in WF0 (match == 0); ends-free with WF0 the single cell k = 0 and the
# boundary seeded at every score divisible by -match (match != 0, only
# for the three metrics that carry a match weight)
SPANS = ("e2e", "endsfree", "endsfreeseed")
SEEDED_METRICS = (DistanceMetric.GAP_AFFINE, DistanceMetric.GAP_AFFINE_2P,
                  DistanceMetric.GAP_LINEAR)
VARIANTS = tuple(METRIC_PREFIX[metric] + span + heur + scope
                 for metric in METRIC_PREFIX
                 for span in SPANS
                 if span != "endsfreeseed" or metric in SEEDED_METRICS
                 for heur in ("", "_heur") for scope in ("", "_score"))

# the heuristic strategies of the cascade
STRATEGIES = int(HeuristicStrategy.WFADAPTIVE | HeuristicStrategy.WFMASH
                 | HeuristicStrategy.XDROP | HeuristicStrategy.ZDROP
                 | HeuristicStrategy.BANDED_STATIC
                 | HeuristicStrategy.BANDED_ADAPTIVE)

# kernel launches made by align_batch_fused_loop (plain version excluded),
# by variant (see `variant`); a launch that extends by the run-length table
# counts under the variant's name plus "_table", one that compares the
# token rows in place under its name plus "_chunk" (the same
# instantiation: the extension is a run-time branch, uniform over the
# launch)
TABLE_VARIANTS = tuple(v + "_table" for v in VARIANTS)
CHUNK_VARIANTS = tuple(v + "_chunk" for v in VARIANTS)
variant_launches = dict.fromkeys(VARIANTS + TABLE_VARIANTS + CHUNK_VARIANTS,
                                 0)

# the in-place compare's modes in the kernel (csrc/fused_loop.cu,
# kChunkBytes ...): raw bytes, bytes with a wildcard, int32 class masks
CHUNK_MODES = ("bytes", "wildcard", "classes")

# the kernel builds of csrc/fused_loop.cu, in the order of their codes,
# and the launches align_batch_fused_loop made of each; of the group
# build's, by its G (warps a pair), in group_launches
BUILDS = ("general", "narrow", "group", "cluster")
build_launches = dict.fromkeys(BUILDS, 0)
group_launches = {}

# shared memory one block may use on sm_90, shared memory of one SM, and
# what the card sets aside of it for each resident block (bytes)
SMEM_LIMIT = 232448
SM_SMEM = 233472
BLOCK_SMEM_RESERVED = 1024
MAX_THREADS = 1024
# the group build (csrc/fused_loop.cu, kGroupMaxPairs, kGroupMaxThreads,
# kNamedBarriers): at most this many pairs a block, threads a block (its
# launch bound), and pairs a block with G > 1 (a named barrier each); the
# SMs of an H100 SXM, over which a small batch is spread
GROUP_MAX_PAIRS = 8
GROUP_MAX_THREADS = 256
NAMED_BARRIERS = 15
SMS = 132
# the warps of the group build an SM keeps issuing before its issue
# slots, not a step's dependent chain, set the step: every warp of a pair
# runs the step's uniform chain, and at the terminal rung 4 warps a pair
# took 1.56 us a step at one pair an SM and 1.72 at two, 8 warps 1.55 and
# 1.88, 12 warps 1.66 at one; at four pairs an SM 1 or 2 warps were best
# (PERF.md, the step sweep); G is cut to GROUP_WARPS_A_SM / (pairs an SM)
GROUP_WARPS_A_SM = 8
# the cluster build: at most this many CTAs a pair (the portable cluster
# size of sm_90)
CLUSTER_MAX = 8
# diagonals a thread of the cluster build (its CTAs run whole warps, the
# last threads owning fewer): three was the fastest of one to four at
# batch G's W=6912 and at W=2176, within 5% of two at W=3584 (PERF.md,
# kernel table); so a CTA runs at most CLUSTER_THREADS threads, the
# kernel's launch bound (csrc/fused_loop.cu, kClusterThreads)
CLUSTER_DIAGONALS = 3
CLUSTER_THREADS = 384
# the most diagonals a thread of the general build owns (ceil(W / 1024))
# where it stays the build of a band past 1024 diagonals whose ring fits
# one block: at two and three (W=1792, 2176) it was as fast as the
# cluster build or faster, at four (W=3584) 1.2x slower (time_builds.py)
GENERAL_MAX_DIAGONALS = 3

# one pair's carry in the state of a segmented run, in the kernel's order:
# its score, status, result (final_s, end_k, end_off), null-step count, the
# cascade's wait and historic maximum, and whether it is done
CARRY = ("s", "status", "final_s", "end_k", "end_off", "nnull", "h_wait",
         "hm_sw", "hm_k", "hm_off", "hm_valid", "done")


def _edit_like(cfg: EngineConfig) -> bool:
    return cfg.metric in (DistanceMetric.EDIT, DistanceMetric.INDEL)


def ring_depths(cfg: EngineConfig) -> tuple:
    """Rows of the kernel's wavefront ring, per component. M is read as
    far back as the scope; a gap component only at its own extension
    distance, so it keeps gap_extension + 1 rows. At pywfa's affine2p
    penalties that is 26 + 2 * 3 + 2 * 2 = 36 rows instead of 5 * 26."""
    if cfg.metric == DistanceMetric.GAP_AFFINE:
        return (cfg.scope,) + (cfg.gap_extension1 + 1,) * 2
    if cfg.metric == DistanceMetric.GAP_AFFINE_2P:
        return ((cfg.scope,) + (cfg.gap_extension1 + 1,) * 2
                + (cfg.gap_extension2 + 1,) * 2)
    return (cfg.scope,)


# per-warp partials of the heuristic cascade's block reductions (32 each)
HEUR_REDUCTIONS = 7


def smem_bytes(cfg: EngineConfig, ring: bool = True) -> int:
    """Dynamic shared memory of one block: the offsets ring (unless it
    lives in global memory), its lo/hi pairs and the per-warp partials of
    the two trim reductions a component, of the ends-free termination and,
    with a heuristic, of the cascade's reductions."""
    depths = ring_depths(cfg)
    rows = sum(depths)
    partials = 2 * len(depths) + 1 + (HEUR_REDUCTIONS if cfg.strategy else 0)
    return ((rows * cfg.W if ring else 0) + rows * 2 + partials * 32) * 4


def ring_in_global(cfg: EngineConfig) -> bool:
    """Whether the ring's rows pass one block's shared memory (gap-affine
    at pywfa's penalties: W > 3840; the 2-piece metric: W > 1600) and live
    in a global [B, rows, W] array instead."""
    return smem_bytes(cfg) > SMEM_LIMIT


# rows of the group build's fold partials a pair with G > 1: the trim's
# 2 * 5 (every metric's, the 2-piece metric's five components), the
# ends-free first hit, the cascade's (csrc/fused_loop.cu, kRowTerm)
GROUP_PARTIALS = 2 * 5 + 1


def group_pair_bytes(cfg: EngineConfig, G: int = 1) -> int:
    """Shared memory one pair of the group build takes with G warps: its
    ring [rows, W] and its bands [rows, 2], int32, and with G > 1 the
    rows of G fold partials and two slots of the next pair's index;
    rounded up to 16 bytes."""
    rows = sum(ring_depths(cfg))
    ints = rows * (cfg.W + 2)
    if G > 1:
        partials = GROUP_PARTIALS + (HEUR_REDUCTIONS if cfg.strategy else 0)
        ints += partials * G + 2
    return -(-ints // 4) * 16


def group_pairs(cfg: EngineConfig, B: int, G: int = 1,
                sms: int = SMS) -> int:
    """Pairs a block of the group build at G warps a pair; 0 when one
    pair's ring passes a block's shared memory or one group a block's
    GROUP_MAX_THREADS threads. With G > 1, one pair a block, so that the
    few long pairs of a rung, which set its time, land on SMs of their
    own instead of sharing one with their neighbours in the batch (two a
    block put the e2e terminal rung's 64 unrelated pairs of 256 on 32 SMs,
    two by two). With one warp a pair, shared memory bounds the pairs an SM
    holds, so P is the one up to GROUP_MAX_PAIRS whose blocks keep the
    most pairs resident on an SM (the largest such), cut to ceil(B / sms)
    so that a small batch spreads over the SMs."""
    per = group_pair_bytes(cfg, G)
    if per > SMEM_LIMIT or 32 * G > GROUP_MAX_THREADS:
        return 0
    if G > 1:
        return 1
    best = max((P * (SM_SMEM // (P * per + BLOCK_SMEM_RESERVED)), P)
               for P in range(1, GROUP_MAX_PAIRS + 1)
               if P * per <= SMEM_LIMIT)
    return min(best[1], -(-B // sms))


def live_band(cfg: EngineConfig) -> int:
    """Diagonals a pair's band can hold at this rung: what the score cap
    allows (config.score_band, the reach the batch path sizes W by), at
    most the W - 4 the kernel keeps inside [kmin + 2, kmin + W - 3]."""
    return min(cfg.W - 4, score_band(cfg.metric, cfg.gap_opening1,
                                     cfg.gap_extension1, cfg.gap_extension2,
                                     cfg.scope, cfg.S_cap,
                                     abs(cfg.Lp - cfg.Lt)))


def group_size(cfg: EngineConfig, B: int, sms: int = SMS) -> int:
    """G, the warps a pair of the group build: enough that one stride of
    32 * G diagonals covers the live band (live_band), cut so that the
    pairs an SM holds, ceil(B / sms), keep at most GROUP_WARPS_A_SM warps
    issuing, and to a block's GROUP_MAX_THREADS; at least one. A rung of
    many pairs (the first rung, 4096 pairs) gets one warp a pair; a rung
    of a few hundred pairs over a band of hundreds of diagonals (stream
    E's second rung, stream F's segments: 4) or of a few pairs (a probe
    batch's rungs, one WavefrontAligner call: 3-8) several."""
    per_sm = -(-B // sms)
    return max(1, min(-(-live_band(cfg) // 32), GROUP_WARPS_A_SM // per_sm,
                      GROUP_MAX_THREADS // 32))


def cluster_smem_bytes(cfg: EngineConfig, C: int) -> int:
    """Dynamic shared memory of one CTA of the cluster build with C CTAs a
    pair: its columns of the ring [rows, W / C], the bands [rows, 2] and
    the reductions' rows of C * (W / C / 32) partials each (see
    smem_bytes)."""
    rows = sum(ring_depths(cfg))
    partials = (2 * cfg.n_comp + 1
                + (HEUR_REDUCTIONS if cfg.strategy else 0))
    T = cfg.W // C
    return (rows * T + rows * 2 + partials * C * (T // 32)) * 4


def cluster_size(cfg: EngineConfig) -> int:
    """CTAs a pair of the cluster build: the smallest C up to CLUSTER_MAX
    that cuts W into slices of whole warps, each of at most MAX_THREADS
    diagonals (so that a CTA may run a thread a diagonal), whose columns of
    the ring fit one CTA's shared memory; 0 when none does. Batch G's
    W=6912: 8 slices of 864; W=2176: 4 of 544."""
    warps = cfg.W // 32
    for C in range(1, CLUSTER_MAX + 1):
        if (cfg.W % 32 == 0 and warps % C == 0 and cfg.W // C <= MAX_THREADS
                and cluster_smem_bytes(cfg, C) <= SMEM_LIMIT):
            return C
    return 0


def kernel_build(cfg: EngineConfig, B: int, table=None, state=None,
                 pat=None) -> str:
    """The build of csrc/fused_loop.cu that a launch of B pairs takes (one
    of BUILDS). A band of at most MAX_THREADS diagonals whose ring fits a
    pair's share of a block takes the group build (G warps a pair over
    the live band, G from group_size), one shot or a segment's state, on
    the words, the run-length table or the token rows (`pat`): the first
    rungs at one warp a pair,
    a batch's second rung, a segment and a few pairs over a wide band at
    several; unless a one-shot run's score cap passes its width, as at the
    terminal rungs, which are sized for pairs as far apart as unrelated
    ones: their live bands fill W, and there a block a pair, a thread a
    diagonal (the narrow build), took 0.448 ms alone at the gap-affine
    terminal rung where the group build took 0.561 (PERF.md, kernel
    table); the narrow build extends by the words alone, so such a rung
    on the table or the rows stays on the group build. A wider band takes
    the
    cluster build (a pair a cluster of cluster_size CTAs, the ring in
    their shared memory) where a block a pair would give a thread more
    than GENERAL_MAX_DIAGONALS diagonals or keep the ring in global memory
    (the 5 kb pairs' W=3584, batch G's W=6912); else the general build (a
    block a pair), which was as fast at W=1792 and W=2176, and so does a
    ring that no cluster holds."""
    if cfg.W <= MAX_THREADS and group_pairs(cfg, B) > 0:
        if (state is None and table is None and pat is None
                and cfg.S_cap > cfg.W):
            return "narrow"
        return "group"
    wide = (-(-cfg.W // MAX_THREADS) > GENERAL_MAX_DIAGONALS
            or ring_in_global(cfg))
    return "cluster" if wide and cluster_size(cfg) else "general"


def launch_shape(cfg: EngineConfig, B: int, build: str, dev=None,
                 group=None) -> tuple:
    """(threads a block, units a pair) of a launch of B pairs on `build`:
    the group build G = group_size warps a pair (or `group`), as many
    pairs a block as group_pairs gives for the device's SMs, 32 * G
    threads each (a G no block holds raises); the cluster build
    CLUSTER_DIAGONALS diagonals a thread of a CTA's slice, in whole warps,
    on each of cluster_size CTAs (a band no cluster holds raises); the
    narrow build a thread a diagonal; the general build block_threads, one
    block a pair."""
    if build == "group":
        sms = (torch.cuda.get_device_properties(dev).multi_processor_count
               if dev is not None and torch.device(dev).type == "cuda"
               else SMS)
        G = group_size(cfg, B, sms) if group is None else int(group)
        P = group_pairs(cfg, B, G, sms) if G >= 1 else 0
        if P == 0:
            raise RuntimeError(f"fused loop kernel launch failed (group "
                               f"build): no block holds a pair of G={G} "
                               f"warps at W={cfg.W} (rows "
                               f"{sum(ring_depths(cfg))})")
        return 32 * G * P, G
    if build == "cluster":
        C = cluster_size(cfg)
        if C == 0:
            raise RuntimeError(f"fused loop kernel launch failed (cluster "
                               f"build): no cluster of at most {CLUSTER_MAX} "
                               f"CTAs holds W={cfg.W} (rows "
                               f"{sum(ring_depths(cfg))})")
        return -(-cfg.W // (C * 32 * CLUSTER_DIAGONALS)) * 32, C
    return (cfg.W if build == "narrow" else block_threads(cfg.W)), 1


def block_threads(W: int) -> int:
    """Threads of a block: one a diagonal up to MAX_THREADS; past it every
    thread owns ceil(W / MAX_THREADS) diagonals, W / that many threads,
    rounded up to whole warps."""
    per = -(-W // MAX_THREADS)
    return -(-(-(-W // per)) // 32) * 32


def _ends_free(cfg: EngineConfig) -> bool:
    return cfg.span == AlignmentSpan.ENDS_FREE


def span_code(cfg: EngineConfig) -> int:
    """Index into SPANS of the config's span (see SPANS)."""
    if not _ends_free(cfg):
        return 0
    return 1 if cfg.match == 0 else 2


def variant(cfg: EngineConfig, table: bool = False,
            chunk: bool = False) -> str:
    """The kernel variant a config launches: the metric's prefix (none for
    gap-affine), the span, "_heur" with any heuristic, "_score" for the
    score-only scope, then "_table" when the extension reads the
    run-length table, "_chunk" when it compares the token rows."""
    return (METRIC_PREFIX[cfg.metric] + SPANS[span_code(cfg)]
            + ("_heur" if cfg.strategy else "")
            + ("" if cfg.record_choices else "_score")
            + ("_table" if table else "") + ("_chunk" if chunk else ""))


def chunk_mode(cfg: EngineConfig) -> int:
    """The in-place compare's mode (an index into CHUNK_MODES): int32
    class-mask rows under match classes, else int8 token rows compared
    byte for byte, with the wildcard where the config has one."""
    if cfg.match_classes:
        return CHUNK_MODES.index("classes")
    return CHUNK_MODES.index("wildcard" if cfg.wildcard >= 0 else "bytes")


def supported(cfg: EngineConfig) -> bool:
    """The slice this module covers: every distance metric, end-to-end or
    ends-free span, with or without a match bonus, every heuristic of the
    cascade, full-CIGAR or score-only scope, any band of whole warps (the
    ring moves to global memory where it passes a block's shared memory).
    Wildcards and match classes live in the equality bits or the table,
    and in the in-place compare's mode (chunk_mode)."""
    return (cfg.metric in METRIC_CODE
            and (span_code(cfg) != 2 or cfg.metric in SEEDED_METRICS)
            and (cfg.strategy & ~STRATEGIES) == 0
            and cfg.W % 32 == 0
            and smem_bytes(cfg, ring=False) <= SMEM_LIMIT)


def new_state(cfg: EngineConfig, B: int, device) -> dict:
    """An empty state of a segmented run for B pairs (see the module
    docstring); the first segment (fresh=True) fills it. `s` is the score
    the next segment starts at, kept on the host."""
    rows = sum(ring_depths(cfg))
    i32 = torch.int32
    lohi = torch.ones((B, rows, 2), dtype=i32, device=device)
    lohi[:, :, 1] = -1
    return dict(ring=torch.full((B, rows, cfg.W), NULL, dtype=i32,
                                device=device),
                lohi=lohi,
                carry=torch.zeros((B, len(CARRY)), dtype=i32, device=device),
                s=0)


def unpause_max_steps(state: dict) -> dict:
    """Un-pause, in place, the pairs stopped at ST_MAX_STEPS, so that a
    later segment with a raised step cap goes on from their retained ring
    with the extension of the score they stopped at; the next segment
    starts at that score."""
    carry = state["carry"]
    paused = carry[:, CARRY.index("status")] == ST_MAX_STEPS
    if bool(paused.any()):
        state["s"] = int(carry[paused, CARRY.index("s")].max())
    carry[:, CARRY.index("status")] = torch.where(
        paused, ST_RUNNING, carry[:, CARRY.index("status")])
    carry[:, CARRY.index("done")] = torch.where(
        paused, 0, carry[:, CARRY.index("done")])
    return state


def state_from_reference(cfg: EngineConfig, ref_state: dict,
                         device="cpu") -> dict:
    """The port's state from the JAX package's resume pytree, given as a
    dict of numpy arrays (offsets [n_comp, scope, B, W], lo / hi
    [n_comp, scope, B], m_exists [scope, B], s, done, status, final_s,
    end_k, end_off, num_null_steps and the h_* heuristic fields): a pause
    taken there finishes here. The reference's ring keeps `scope` rows a
    component at s % scope; the port's keeps ring_depths rows at
    s % depth, so the newest `depth` scores of each component carry
    over."""
    import numpy as np
    offsets = np.asarray(ref_state["offsets"])
    _, scope, B, W = offsets.shape
    s = int(np.asarray(ref_state["s"]))
    lo = np.asarray(ref_state["lo"]).copy()
    hi = np.asarray(ref_state["hi"]).copy()
    # a wavefront that does not exist is null whatever its band says
    absent = ~np.asarray(ref_state["m_exists"])
    lo[M][absent] = 1
    hi[M][absent] = -1
    depths = ring_depths(cfg)
    rows = sum(depths)
    ring = np.full((B, rows, W), NULL, dtype=np.int32)
    lohi = np.tile(np.array([1, -1], dtype=np.int32), (B, rows, 1))
    base = 0
    for c, depth in enumerate(depths):
        for back in range(depth):
            score = s - back
            if score < 0:
                break
            row = base + score % depth
            ring[:, row] = offsets[c, score % scope]
            lohi[:, row, 0] = lo[c, score % scope]
            lohi[:, row, 1] = hi[c, score % scope]
        base += depth
    fields = dict(s=np.full(B, s), status=ref_state["status"],
                  final_s=ref_state["final_s"], end_k=ref_state["end_k"],
                  end_off=ref_state["end_off"],
                  nnull=ref_state["num_null_steps"],
                  h_wait=ref_state["h_steps_wait"],
                  hm_sw=ref_state["h_max_sw"], hm_k=ref_state["h_max_sw_k"],
                  hm_off=ref_state["h_max_sw_off"],
                  hm_valid=ref_state["h_max_sw_valid"],
                  done=ref_state["done"])
    carry = np.stack([np.asarray(fields[name]).astype(np.int32)
                      for name in CARRY], axis=1)
    dev = torch.device(device)
    return dict(ring=torch.from_numpy(ring).to(dev),
                lohi=torch.from_numpy(lohi).to(dev),
                carry=torch.from_numpy(np.ascontiguousarray(carry)).to(dev),
                s=s)


def _check(cfg: EngineConfig, bits, plen, tlen, frees, table, state, fresh,
           pat=None, txt=None):
    """Check a launch's arguments; returns the extension's input tensor
    (the words, the table or the pattern rows), whose device the launch
    runs on."""
    if not supported(cfg):
        raise NotImplementedError(
            f"the fused loop takes bands of whole warps (got {cfg})")
    if (pat is None) != (txt is None):
        raise ValueError("the in-place compare needs both token rows")
    given = [name for name, t in (("bits", bits), ("table", table),
                                  ("pat / txt", pat)) if t is not None]
    if len(given) != 1:
        raise ValueError("the extension needs one of the equality bits, the "
                         "run-length table or the token rows, got "
                         + (", ".join(given) or "none"))
    if pat is not None:
        ext = pat
        B = pat.shape[0] if pat.dim() == 2 else -1
        rows_type = torch.int32 if cfg.match_classes else torch.int8
        for name, t, width in (("pat", pat, cfg.Lp), ("txt", txt, cfg.Lt)):
            if t.dim() != 2 or t.shape[0] != B:
                raise ValueError(f"pat / txt must be [B, *] rows of one B, "
                                 f"got {tuple(pat.shape)}, "
                                 f"{tuple(txt.shape)}")
            if t.shape[1] <= width:
                raise ValueError(f"{name} rows hold {t.shape[1]} tokens, "
                                 f"need more than {width} for the sentinel "
                                 "mismatch")
            if t.dtype != rows_type:
                raise TypeError(f"{name} must be {rows_type} "
                                + ("(class masks)" if cfg.match_classes
                                   else "(tokens)") + f", got {t.dtype}")
            if t.device != pat.device:
                raise ValueError(f"txt is on {txt.device}, pat on "
                                 f"{pat.device}")
    else:
        ext = table if table is not None else bits
        if ext.dim() != 3 or ext.shape[2] != cfg.W:
            raise ValueError(f"bits / table must be [*, B, {cfg.W}], got "
                             f"{tuple(ext.shape)}")
        B = ext.shape[1]
    if table is not None:
        if table.dtype not in (torch.uint8, torch.int16):
            raise TypeError(f"table must be uint8 or int16, got "
                            f"{table.dtype}")
        if table.shape[0] <= cfg.Lt:
            raise ValueError(f"the table holds {table.shape[0]} text "
                             f"positions, need more than Lt={cfg.Lt}")
    elif bits is not None and ext.shape[0] * 32 <= cfg.Lt:
        raise ValueError(f"bits hold {ext.shape[0] * 32} text positions, "
                         f"need more than Lt={cfg.Lt} for the sentinel "
                         "mismatch")
    shapes = [("plen", plen, (B,)), ("tlen", tlen, (B,)),
              ("frees", frees, (B, 4))]
    if state is not None:
        rows = sum(ring_depths(cfg))
        shapes += [("state ring", state["ring"], (B, rows, cfg.W)),
                   ("state lohi", state["lohi"], (B, rows, 2)),
                   ("state carry", state["carry"], (B, len(CARRY)))]
    elif not fresh:
        raise ValueError("a later segment needs the state of the one before")
    for name, t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != ext.device:
            raise ValueError(f"{name} is on {t.device}, the extension's "
                             f"input on {ext.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if bits is not None and bits.dtype != torch.int32:
        raise TypeError(f"bits must be int32, got {bits.dtype}")
    return ext


def align_batch_fused_loop(cfg: EngineConfig, bits, plen, tlen, frees,
                           max_steps: int, table=None, state=None,
                           fresh: bool = True, seg_base: int = 0,
                           build=None, group=None, pat=None,
                           txt=None) -> dict:
    """Run the fused score loop over B pairs.

    bits: [NQ, B, W] int32 bit patterns (engine.build_eq_bits), or None
    when `table`, the [Ltp, B, W] run-length table
    (lcp_table.build_lcp_table_hmajor), extends instead, or `pat` / `txt`,
    the sentinel-padded token rows [B, Lp + C] / [B, Lt + C] (int8; int32
    class masks under match classes: engine.build_extension), compared in
    place from each cell's offset to the first mismatch; plen/tlen:
    [B] int32; frees: [B, 4] int32 (pattern begin, pattern end, text
    begin, text end free; read on the ends-free span only); max_steps: the
    user step cap. `state` (new_state) makes the call one segment of a
    segmented run over the scores [seg_base, seg_base + S_cap - 1]: the
    first (fresh=True) starts from score 0 and fills the state, a later
    one goes on from it; the state is updated in place. Returns
    dict(status, final_s, end_k, end_off, steps), plus choices
    [S_cap, B, W] uint8 when cfg.record_choices (levels a pair never
    reaches read 0; the level of score s is s - seg_base). `build` (one
    of BUILDS) overrides kernel_build's choice on CUDA tensors, and
    `group` the group build's G (group_size); a build or a G the launch
    cannot take raises.
    """
    ext = _check(cfg, bits, plen, tlen, frees, table, state, fresh, pat, txt)
    if build is not None and build not in BUILDS:
        raise ValueError(f"build must be one of {BUILDS}, got {build!r}")
    if group is not None and build not in (None, "group"):
        raise ValueError(f"G is the group build's, not the {build} build's")
    max_steps = min(int(max_steps), 2**31 - 1)
    if ext.device.type == "cpu":
        return align_batch_fused_loop_ref(cfg, bits, plen, tlen, frees,
                                          max_steps, table, state, fresh,
                                          seg_base, pat, txt)
    if ext.device.type != "cuda":
        raise ValueError(f"no fused loop for device {ext.device}")
    tensors = [("bits / table / pat", ext), ("plen", plen), ("tlen", tlen),
               ("frees", frees)]
    if txt is not None:
        tensors.append(("txt", txt))
    if state is not None:
        tensors += [("state " + k, state[k]) for k in ("ring", "lohi",
                                                       "carry")]
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from . import cuda_build
    lib = cuda_build.load()
    B, W = plen.shape[0], cfg.W
    NQ = bits.shape[0] if bits is not None else 0
    dev = ext.device
    record = cfg.record_choices
    # score-only scope: no [S_cap, B, W] record, so no memset of it either
    choices = (torch.zeros((cfg.S_cap, B, W), dtype=torch.uint8, device=dev)
               if record else None)
    # status, final_s, end_k, end_off; then the group build's pair counter
    res = torch.empty(4 * B + 1, dtype=torch.int32, device=dev)
    x, o1, e1, o2, e2 = score_distances(cfg)
    depths = ring_depths(cfg)
    heur = heuristic_params(cfg)
    in_global = ring_in_global(cfg)
    if build is None:
        build = kernel_build(cfg, B, table, state, pat)
    # units a pair: the group build's warps, the cluster build's CTAs
    threads, units = launch_shape(cfg, B, build, dev,
                                  group if build == "group" else None)
    # only the general build keeps the ring in global memory
    in_global = in_global and build == "general"
    if state is not None:
        ring = state["ring"]
    else:
        # a one-shot run's ring, where it does not fit shared memory
        ring = (torch.empty((B, sum(depths), W), dtype=torch.int32,
                            device=dev) if in_global else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wfa_fused_loop(
            bits.data_ptr() if bits is not None else None,
            table.data_ptr() if table is not None else None,
            int(table is not None and table.dtype == torch.uint8),
            table.shape[0] if table is not None else 0,
            pat.data_ptr() if pat is not None else None,
            txt.data_ptr() if txt is not None else None,
            pat.shape[1] if pat is not None else 0,
            txt.shape[1] if txt is not None else 0,
            chunk_mode(cfg), cfg.wildcard & 0xFF,
            plen.data_ptr(), tlen.data_ptr(),
            frees.data_ptr(), choices.data_ptr() if record else None,
            res.data_ptr(), ring.data_ptr() if ring is not None else None,
            state["lohi"].data_ptr() if state is not None else None,
            state["carry"].data_ptr() if state is not None else None,
            int(fresh), int(in_global), seg_base, BUILDS.index(build),
            threads, units,
            (ctypes.c_int * len(depths))(*depths), B, W, NQ,
            cfg.S_cap, cfg.scope, x, o1, e1, o2, e2, max_steps,
            METRIC_CODE[cfg.metric], span_code(cfg), int(record),
            (ctypes.c_int * len(heur))(*heur), -cfg.match, stream)
    if rc != 0:
        raise RuntimeError(f"fused loop kernel launch failed ({build} "
                           "build): " + cuda_build.error_string(rc))
    variant_launches[variant(cfg, table is not None, pat is not None)] += 1
    build_launches[build] += 1
    if build == "group":
        group_launches[units] = group_launches.get(units, 0) + 1
    res = res[:4 * B].view(4, B)
    out = dict(status=res[0], final_s=res[1], end_k=res[2], end_off=res[3],
               steps=res[1].max())
    if record:
        out["choices"] = choices
    return out


def active_clusters() -> int:
    """cudaOccupancyMaxActiveClusters of the last launch of the cluster
    build in this process (-1 before the first): how many of its clusters
    the card holds at once."""
    from . import cuda_build
    return int(cuda_build.load().wfa_fused_loop_active_clusters())


def score_distances(cfg: EngineConfig) -> tuple:
    """Score distances (x, o1, e1, o2, e2) from s + 1 back to the source
    wavefronts: M for a mismatch; M opening and I1/D1 extending a gap of
    piece 1; the same for piece 2. Gap-linear opens at its indel penalty
    and extends nothing; edit and indel read only s; an unused distance
    is 0."""
    m = cfg.metric
    if _edit_like(cfg):
        return (1, 1, 0, 0, 0)
    if m == DistanceMetric.GAP_LINEAR:
        return (cfg.mismatch, cfg.gap_opening1, 0, 0, 0)
    o1e1 = cfg.gap_opening1 + cfg.gap_extension1
    if m == DistanceMetric.GAP_AFFINE:
        return (cfg.mismatch, o1e1, cfg.gap_extension1, 0, 0)
    return (cfg.mismatch, o1e1, cfg.gap_extension1,
            cfg.gap_opening2 + cfg.gap_extension2, cfg.gap_extension2)


def heuristic_params(cfg: EngineConfig) -> tuple:
    """The cascade's parameters as the kernel takes them: the strategy
    bits (HeuristicStrategy), min_wavefront_length, max_distance_threshold,
    steps_between_cutoffs, xdrop, zdrop, band_min_k, band_max_k, and the
    match weight of the drop heuristics' Smith-Waterman score."""
    return (cfg.strategy, cfg.min_wavefront_length,
            cfg.max_distance_threshold, cfg.steps_between_cutoffs, cfg.xdrop,
            cfg.zdrop, cfg.band_min_k, cfg.band_max_k,
            -cfg.match if cfg.match != 0 else 1)


def _f2i(x):
    """float32 -> int32 as the kernel's cast does it: truncation toward
    zero, saturation at the int32 range, NaN to 0."""
    big = x >= 2147483648.0
    y = torch.nan_to_num(x, nan=0.0).clamp(-2147483648.0, 2147483520.0)
    return torch.where(big, 2**31 - 1, y.to(torch.int32))


def _ctz32(m):
    """Count trailing zeros of int32 bit patterns (garbage where m == 0):
    isolate the lowest set bit, convert to float32 (exact for one bit) and
    read the exponent -- bit 31 included, whose sign the mask drops."""
    lsb = m & -m
    e = (lsb.float().view(torch.int32) >> 23) & 0xFF
    return e - 127


def _plain_rows(cfg: EngineConfig, s: int):
    """(state row, plain row) of every wavefront a state holds at score s:
    the newest `depth` scores of each component, at s % depth in the state
    and at comp * scope + s % scope in the plain version's ring."""
    base = 0
    for comp, depth in enumerate(ring_depths(cfg)):
        for back in range(depth):
            score = s - back
            if score >= 0:
                yield (base + score % depth,
                       comp * cfg.scope + score % cfg.scope)
        base += depth


def _extend_chunk(cfg: EngineConfig, pat, txt, plen, tlen, karr, off, valid):
    """The in-place compare of the plain version, the reference's
    `engine._extend_band` over [B, W]: every cell of `valid` gathers
    extend_chunk tokens of both rows at v = off - k and h = off and adds
    the run of the running product of their equalities, while any cell
    ran a whole chunk; a cell runs only while v and h lie inside the
    pair's lengths. Equality as the words define it: equal bytes; with a
    wildcard that byte matches any real byte on either side, and a
    sentinel nothing; with class masks (int32 rows) intersecting masks.
    Positions past a row read as sentinels (mask 0 under classes)."""
    C = cfg.extend_chunk
    B, W = off.shape
    classes = bool(cfg.match_classes)
    # the rows padded by one chunk of sentinels, so that no gather leaves
    # them (the reference's gather clamps to the row's last sentinel)
    patp = torch.nn.functional.pad(pat, (0, C),
                                   value=0 if classes else PATTERN_PAD)
    txtp = torch.nn.functional.pad(txt, (0, C),
                                   value=0 if classes else TEXT_PAD)
    cr = torch.arange(C, dtype=torch.int64, device=off.device)
    active = valid
    while bool(active.any()):
        v = off - karr
        h = off
        vi = v.clamp(0, pat.shape[1] - 1).long()
        hi = h.clamp(0, txt.shape[1] - 1).long()
        pch = patp.gather(1, (vi[:, :, None] + cr).reshape(B, -1)).view(
            B, W, C)
        tch = txtp.gather(1, (hi[:, :, None] + cr).reshape(B, -1)).view(
            B, W, C)
        if classes:
            eq = (pch & tch) != 0
        else:
            eq = pch == tch
            if cfg.wildcard >= 0:
                wc = cfg.wildcard - 256 if cfg.wildcard > 127 else \
                    cfg.wildcard
                eq = ((eq | (pch == wc) | (tch == wc))
                      & (pch != PATTERN_PAD) & (tch != TEXT_PAD))
        run = eq.to(torch.int32).cumprod(-1).sum(-1, dtype=torch.int32)
        ok = active & (v >= 0) & (h >= 0) & (v < plen) & (h < tlen)
        run = torch.where(ok, run, 0)
        off = off + run
        active = ok & (run == C)
    return off


def align_batch_fused_loop_ref(cfg: EngineConfig, bits, plen, tlen, frees,
                               max_steps: int, table=None, state=None,
                               fresh: bool = True, seg_base: int = 0,
                               pat=None, txt=None) -> dict:
    """The plain torch version: the Pallas kernel's array program (every
    metric's branch, both spans, the match seeding, the heuristic cascade,
    both scopes) over [B, W], all pairs as one tile, with the
    band-overflow flag of the XLA engine, the extension by the equality
    words, by the run-length table or by the token rows compared in place
    (the reference's `engine._extend_band`), and the state of a segmented
    run in and out (see align_batch_fused_loop). Its own ring has `scope`
    rows for every component; the pairs still running step together, so a
    later segment starts all of them at the one score their carries hold.
    Runs on any device."""
    B, W = plen.shape[0], cfg.W
    NQ = bits.shape[0] if bits is not None else 0
    dev = plen.device
    i32 = torch.int32
    scope, S_cap, kmin = cfg.scope, cfg.S_cap, cfg.kmin
    x, o1e1, e1, o2e2, e2 = score_distances(cfg)
    metric = cfg.metric
    edit_like = _edit_like(cfg)
    linear = metric == DistanceMetric.GAP_LINEAR
    affine2p = metric == DistanceMetric.GAP_AFFINE_2P
    NC = cfg.n_comp
    NQ32 = NQ * 32
    iota = torch.arange(W, dtype=i32, device=dev)[None, :]
    karr = iota + kmin
    plen = plen.to(i32)[:, None]
    tlen = tlen.to(i32)[:, None]
    ends_free = _ends_free(cfg)
    record = cfg.record_choices
    # ends-free with a match bonus: WF0 is the single cell k = 0 and the
    # boundary is seeded at every score divisible by -match
    seeding = span_code(cfg) == 2
    ST = HeuristicStrategy
    use_heur = cfg.strategy != 0
    wfadaptive = bool(cfg.strategy & (ST.WFADAPTIVE | ST.WFMASH))
    wfmash = bool(cfg.strategy & ST.WFMASH)
    xdrop = bool(cfg.strategy & ST.XDROP)
    zdrop = not xdrop and bool(cfg.strategy & ST.ZDROP)  # x-drop wins
    banded_static = bool(cfg.strategy & ST.BANDED_STATIC)
    banded_adaptive = (not banded_static
                       and bool(cfg.strategy & ST.BANDED_ADAPTIVE))
    swg_match = heuristic_params(cfg)[-1]
    steps_between = cfg.steps_between_cutoffs

    # --- WF0 (the Pallas kernel's `:270-290`) ---
    if ends_free:
        frees = frees.to(i32)
        pbf, pef = frees[:, 0:1], frees[:, 1:2]
        tbf, tef = frees[:, 2:3], frees[:, 3:4]
    if ends_free and not seeding:
        wf0_lo, wf0_hi = -pbf, tbf
        off0 = torch.where((karr >= 0) & (karr <= wf0_hi), karr.clamp(min=0),
                           torch.where((karr < 0) & (karr >= wf0_lo), 0,
                                       NULL))
        # seeds past the band (engine._init_state): escalate at once
        overflow0 = (wf0_lo < kmin + 2) | (wf0_hi > kmin + W - 3)
    else:
        wf0_lo = wf0_hi = 0
        off0 = torch.where(karr == 0, 0, NULL)
        overflow0 = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    off = torch.full((NC * scope, B, W), NULL, dtype=i32, device=dev)
    lo = torch.ones((NC * scope, B, 1), dtype=i32, device=dev)
    hi = -torch.ones((NC * scope, B, 1), dtype=i32, device=dev)
    off[M * scope] = off0
    lo[M * scope] = wf0_lo
    hi[M * scope] = wf0_hi
    choices = (torch.zeros((S_cap, B, W), dtype=torch.uint8, device=dev)
               if record else None)
    null_row = torch.full((B, W), NULL, dtype=i32, device=dev)
    one = torch.ones((B, 1), dtype=i32, device=dev)
    true = torch.ones((B, 1), dtype=torch.bool, device=dev)

    def read_wf(comp, score):
        """(off [B,W], lo [B,1], hi [B,1], null [B,1]) for a score."""
        if score < 0:
            return null_row, one, -one, true
        i = comp * scope + score % scope
        return off[i], lo[i], hi[i], lo[i] > hi[i]

    def band_mask(lo_, hi_):
        return (karr >= lo_) & (karr <= hi_)

    def shift(a, dk):
        # a[:, i+dk] at i, NULL-padded; dk in {-1, +1}
        pad = null_row[:, :1]
        if dk > 0:
            return torch.cat([a[:, 1:], pad], dim=1)
        return torch.cat([pad, a[:, :-1]], dim=1)

    def pack(value, prio):
        return torch.where(value >= 0, (value << 3) | prio, -2**30)

    def gap(open_off, ext_off, dk):
        """One gap component: open from M vs extend (extend wins ties).
        An all-invalid cell keeps the raw shifted value, which only M's
        bounds check nulls. Returns (values, extended)."""
        add = 1 if dk < 0 else 0  # an insertion advances the offset
        gp = torch.maximum(pack(shift(open_off, dk) + add, 0),
                           pack(shift(ext_off, dk) + add, 1))
        value = torch.where(gp < 0,
                            shift(torch.maximum(open_off, ext_off), dk) + add,
                            gp >> 3)
        return value, (gp >= 0) & ((gp & 7) == 1)

    def one_comp_source(pm):
        pr = pm & 7
        return torch.where(pr == 5, MSRC_X,
                           torch.where(pr == 3, MSRC_D1,
                                       torch.where(pr == 1, MSRC_I1,
                                                   MSRC_NONE)))

    def lim(lo_, hi_, nul, widen):
        return (torch.where(nul, 2**30, lo_ - widen),
                torch.where(nul, -2**30, hi_ + widen))

    def col():
        return torch.zeros((B, 1), dtype=i32, device=dev)

    s = 0
    done = overflow0.clone()
    status = torch.where(overflow0, ST_OVERFLOW_W, col())
    final_s, end_k, nnull = col(), col(), col()
    end_off = col() + NULL
    # the cascade's carry: steps to the next cutoff, and the historic
    # maximum of the drop heuristics (its score, diagonal, offset)
    h_wait = col() + steps_between
    hm_sw, hm_k, hm_valid = col(), col(), col().bool()
    hm_off = col() + NULL
    if not fresh:
        # a later segment: the carry, and the ring's rows of the score the
        # running pairs share (a done pair's rows are never read)
        c = {name: state["carry"][:, i:i + 1].clone()
             for i, name in enumerate(CARRY)}
        done = c["done"] != 0
        status, final_s, end_k, end_off = (c["status"], c["final_s"],
                                           c["end_k"], c["end_off"])
        nnull, h_wait = c["nnull"], c["h_wait"]
        hm_sw, hm_k, hm_off = c["hm_sw"], c["hm_k"], c["hm_off"]
        hm_valid = c["hm_valid"] != 0
        running0 = ~done[:, 0]
        if bool(running0.any()):
            s = int(c["s"][running0].max())
            if int(c["s"][running0].min()) != s:
                raise ValueError("the running pairs of a state must share "
                                 "one score")
        off[:] = NULL
        lo[:] = 1
        hi[:] = -1
        for srow, prow in _plain_rows(cfg, s):
            off[prow] = state["ring"][:, srow]
            lo[prow] = state["lohi"][:, srow, 0:1]
            hi[prow] = state["lohi"][:, srow, 1:2]
    entered = ~done
    seg_end = seg_base + S_cap - 1
    while bool((~done).any()) and s < seg_end:
        active = ~done
        slot = s % scope
        m_off, m_lo, m_hi, m_null = read_wf(M, s)
        # feasibility probe: a run of null steps longer than the scope
        dead = active & m_null & (nnull > scope)
        status = torch.where(dead, ST_END_UNREACHABLE, status)
        final_s = torch.where(dead, s, final_s)
        done = done | dead
        active = active & ~dead

        # --- extension: the run from the table, or find-first-mismatch
        # over the equality words ---
        band = band_mask(m_lo, m_hi) & active & ~m_null
        valid = band & (m_off >= 0) & (m_off <= tlen)
        if table is not None:
            idx = m_off.clamp(0, table.shape[0] - 1)
            run = table.gather(0, idx[None].long())[0].to(i32)
            m_off = torch.where(valid, m_off + run, m_off)
        elif pat is not None:
            m_off = _extend_chunk(cfg, pat, txt, plen, tlen, karr, m_off,
                                  valid)
        else:
            idx = m_off.clamp(0, NQ32 - 1)
            q0 = idx >> 5
            ones = torch.full_like(idx, -1)
            head = ones << (idx & 31)
            fm = torch.full_like(idx, NQ32)
            for q in range(NQ):
                sel = torch.where(q0 == q, head,
                                  torch.where(q0 < q, ones, 0))
                mq = ~bits[q] & sel
                cand = q * 32 + _ctz32(mq)
                fm = torch.minimum(fm, torch.where(mq != 0, cand, NQ32))
            m_off = torch.where(valid, m_off + (fm - idx), m_off)
        off[M * scope + slot] = m_off

        # --- termination ---
        if ends_free:
            # the lowest diagonal on an end-free boundary wins
            v = m_off - karr
            cellv = band_mask(m_lo, m_hi) & (m_off > NULL_THRESHOLD)
            done_h = cellv & (m_off >= tlen) & ((plen - v) <= pef)
            done_v = cellv & (v >= plen) & ((tlen - m_off) <= tef)
            dmask = done_h | done_v
            firsti = torch.where(dmask, iota, W).amin(1, keepdim=True)
            hit = active & ~m_null & dmask.any(1, keepdim=True)
            t_k = firsti + kmin
            t_off = torch.where(iota == firsti, m_off, 0).sum(
                1, keepdim=True, dtype=i32)
        else:
            # the end cell k = tlen - plen reached offset tlen
            ak = tlen - plen
            cell = torch.where(karr == ak, m_off, 0).sum(1, keepdim=True,
                                                          dtype=i32)
            on_band = (m_lo <= ak) & (ak <= m_hi)
            hit = active & ~m_null & on_band & (cell >= tlen)
            t_k, t_off = ak, tlen
        status = torch.where(hit, ST_END_REACHED, status)
        final_s = torch.where(hit, s, final_s)
        end_k = torch.where(hit, t_k, end_k)
        end_off = torch.where(hit, t_off, end_off)
        done = done | hit
        active = active & ~hit

        # --- heuristic cascade: prune the band of M[s] before the compute
        # reads it (the Pallas kernel's `:397-557`) ---
        if use_heur:
            eligible = active & ~m_null
            h_wait = torch.where(eligible, h_wait - 1, h_wait)
            cur_lo, cur_hi = m_lo, m_hi
        if wfadaptive:
            do_h = (eligible & (h_wait <= 0)
                    & ((cur_hi - cur_lo + 1) >= cfg.min_wavefront_length))
            hband = band_mask(cur_lo, cur_hi)
            v_h = m_off - karr
            if wfmash:
                # length-normalised distance, in float32 in this order
                mfactor = (plen + tlen).float() / 2
                lv = _f2i((plen - v_h).float() / plen.float() * mfactor)
                lh = _f2i((tlen - m_off).float() / tlen.float() * mfactor)
                dist = torch.maximum(lv, lh)
            else:
                dist = torch.maximum(plen - v_h, tlen - m_off)
            dist = torch.where(m_off >= 0, dist, -NULL)
            mind = torch.where(hband, dist, torch.maximum(plen, tlen)).amin(
                1, keepdim=True)
            keep = (dist - mind) <= cfg.max_distance_threshold
            ak_h = tlen - plen
            # from below over [lo, min(ak, hi)), then from above over
            # (max(ak, new lo), hi]
            top_limit = torch.minimum(ak_h, cur_hi)
            stop_bot = hband & (karr < top_limit) & keep
            first_keep = torch.where(stop_bot, iota, W).amin(
                1, keepdim=True) + kmin
            lo_red = torch.where(stop_bot.any(1, keepdim=True), first_keep,
                                 torch.maximum(top_limit, cur_lo))
            new_lo = torch.where(do_h, torch.maximum(lo_red, cur_lo), cur_lo)
            bot_limit = torch.maximum(ak_h, new_lo)
            stop_top = hband & (karr > bot_limit) & keep
            last_keep = torch.where(stop_top, iota, -1).amax(
                1, keepdim=True) + kmin
            hi_red = torch.where(stop_top.any(1, keepdim=True), last_keep,
                                 torch.minimum(bot_limit, cur_hi))
            new_hi = torch.where(do_h, torch.minimum(hi_red, cur_hi), cur_hi)
            h_wait = torch.where(do_h, steps_between, h_wait)
            cur_lo, cur_hi = new_lo, new_hi
        if xdrop or zdrop:
            # the wait is read again: a cutoff above skips this stage
            do_d = eligible & (h_wait <= 0)
            num = swg_match * (m_off - karr + m_off) - s
            sw = torch.div(num, 2, rounding_mode="trunc")
            validc = band_mask(cur_lo, cur_hi) & (m_off >= 0)
            swm = torch.where(validc, sw, -2**30)
            cmax = swm.amax(1, keepdim=True)
            # the first diagonal that attains the maximum
            cidx = torch.where(swm == cmax, iota, W).amin(1, keepdim=True)
            cmax_off = m_off.gather(1, cidx.long())
            if xdrop:
                prune = do_d & hm_valid
                keepx = validc & ((hm_sw - sw) < cfg.xdrop)
                any_keep = keepx.any(1, keepdim=True)
                firstx = torch.where(keepx, iota, W).amin(
                    1, keepdim=True) + kmin
                lastx = torch.where(keepx, iota, -1).amax(
                    1, keepdim=True) + kmin
                # in sequence: the new hi reads the new lo
                cur_lo = torch.where(
                    prune, torch.where(any_keep, firstx, cur_hi + 1), cur_lo)
                cur_hi = torch.where(
                    prune, torch.where(any_keep, lastx, cur_lo - 1), cur_hi)
                upd = do_d & (~hm_valid | (cmax > hm_sw))
                hm_sw = torch.where(upd, cmax, hm_sw)
                hm_k = torch.where(upd, cidx + kmin, hm_k)
                hm_valid = hm_valid | do_d
                h_wait = torch.where(do_d, steps_between, h_wait)
            else:
                improved = cmax > hm_sw
                zdropped = (do_d & hm_valid & ~improved
                            & ((hm_sw - cmax) > cfg.zdrop))
                upd = do_d & (~hm_valid | improved)
                hm_sw = torch.where(upd, cmax, hm_sw)
                hm_k = torch.where(upd, cidx + kmin, hm_k)
                hm_off = torch.where(upd, cmax_off, hm_off)
                hm_valid = hm_valid | do_d
                h_wait = torch.where(do_d & ~zdropped, steps_between, h_wait)
                # the pair ends at the historic maximum's cell
                status = torch.where(zdropped, ST_END_UNREACHABLE, status)
                final_s = torch.where(zdropped, s, final_s)
                end_k = torch.where(zdropped, hm_k, end_k)
                end_off = torch.where(zdropped, hm_off, end_off)
                done = done | zdropped
                active = active & ~zdropped
        if banded_static:
            # no wait gate
            cur_lo = torch.where(eligible, cur_lo.clamp(min=cfg.band_min_k),
                                 cur_lo)
            cur_hi = torch.where(eligible, cur_hi.clamp(max=cfg.band_max_k),
                                 cur_hi)
        elif banded_adaptive:
            wf_len = cur_hi - cur_lo + 1
            max_len = cfg.band_max_k - cfg.band_min_k + 1
            # the wait resets whenever the wavefront has 4 diagonals, even
            # with nothing to cut
            ticked = eligible & (h_wait <= 0) & (wf_len >= 4)
            do_b = ticked & (wf_len > max_len)

            def dist_at(kq):
                o = m_off.gather(1, (kq - kmin).clamp(0, W - 1).long())
                d = torch.maximum(plen - (o - kq), tlen - o)
                return torch.where(o >= 0, d, -NULL)

            leeway = (wf_len - max_len) // 2
            quarter = wf_len // 4
            d0 = dist_at(cur_lo)
            d1 = dist_at(cur_lo + quarter)
            d2 = dist_at(cur_lo + 2 * quarter)
            d3 = dist_at(cur_hi)
            new_lo0 = (cur_lo + torch.where(d0 > d3, leeway, 0)
                       + torch.where(d1 > d2, leeway, 0))
            nlo = torch.maximum(new_lo0, cur_lo)
            nhi = torch.minimum(new_lo0 + max_len - 1, cur_hi)
            cur_lo = torch.where(do_b, nlo, cur_lo)
            cur_hi = torch.where(do_b, nhi, cur_hi)
            h_wait = torch.where(ticked, steps_between, h_wait)
        if use_heur:
            # install M's pruned band and cut every gap component of
            # score s to it
            changed = eligible & ((cur_lo != m_lo) | (cur_hi != m_hi))
            off[M * scope + slot] = torch.where(
                changed & ~band_mask(cur_lo, cur_hi), NULL, m_off)
            lo[M * scope + slot] = torch.where(changed, cur_lo, m_lo)
            hi[M * scope + slot] = torch.where(changed, cur_hi, m_hi)
            for comp in range(1, NC):
                i = comp * scope + slot
                nlo = torch.where(changed, torch.maximum(lo[i], cur_lo),
                                  lo[i])
                nhi = torch.where(changed, torch.minimum(hi[i], cur_hi),
                                  hi[i])
                off[i] = torch.where(changed & ~band_mask(nlo, nhi), NULL,
                                     off[i])
                lo[i] = nlo
                hi[i] = nhi

        # --- compute s+1 ---
        s1 = s + 1
        slot1 = s1 % scope
        if edit_like:
            # one component; every candidate comes from the wavefront of s
            p_off, p_lo, p_hi, p_null = read_wf(M, s1 - 1)
            lo_n = p_lo - 1
            hi_n = p_hi + 1
            all_null = p_null
            pm = torch.maximum(pack(shift(p_off, +1), 3),
                               pack(shift(p_off, -1) + 1, 1))
            if metric == DistanceMetric.EDIT:  # indel has no mismatch
                pm = torch.maximum(pack(p_off + 1, 5), pm)
            # an all-invalid cell stays negative; the bounds check nulls it
            mvals = pm >> 3
            choice = one_comp_source(pm)
            gaps = gap_prods = ()
        elif linear:
            # one component; mismatch from s1 - x, both gaps from s1 - o
            mm_off, mm_lo, mm_hi, mm_null = read_wf(M, s1 - x)
            op_off, op_lo, op_hi, op_null = read_wf(M, s1 - o1e1)
            l1, h1 = lim(mm_lo, mm_hi, mm_null, 0)
            l2, h2 = lim(op_lo, op_hi, op_null, 1)
            lo_n = torch.minimum(l1, l2)
            hi_n = torch.maximum(h1, h2)
            all_null = mm_null & op_null
            pm = torch.maximum(
                pack(mm_off + 1, 5),
                torch.maximum(pack(shift(op_off, +1), 3),
                              pack(shift(op_off, -1) + 1, 1)))
            mvals = torch.where(pm < 0, NULL, pm >> 3)
            choice = one_comp_source(pm)
            gaps = gap_prods = ()
        else:
            mm_off, mm_lo, mm_hi, mm_null = read_wf(M, s1 - x)
            op_off, op_lo, op_hi, op_null = read_wf(M, s1 - o1e1)
            i1_off, i1_lo, i1_hi, i1_null = read_wf(I1, s1 - e1)
            d1_off, d1_lo, d1_hi, d1_null = read_wf(D1, s1 - e1)
            lims = [lim(mm_lo, mm_hi, mm_null, 0),
                    lim(op_lo, op_hi, op_null, 1),
                    lim(i1_lo, i1_hi, i1_null, 1),
                    lim(d1_lo, d1_hi, d1_null, 1)]
            all_null = mm_null & op_null & i1_null & d1_null
            ins1, i1_ext = gap(op_off, i1_off, -1)
            del1, d1_ext = gap(op_off, d1_off, +1)
            mis = mm_off + 1
            gaps = (ins1, del1)
            gap_prods = (~(op_null & i1_null), ~(op_null & d1_null))
            if affine2p:
                op2_off, op2_lo, op2_hi, op2_null = read_wf(M, s1 - o2e2)
                i2_off, i2_lo, i2_hi, i2_null = read_wf(I2, s1 - e2)
                d2_off, d2_lo, d2_hi, d2_null = read_wf(D2, s1 - e2)
                lims += [lim(op2_lo, op2_hi, op2_null, 1),
                         lim(i2_lo, i2_hi, i2_null, 1),
                         lim(d2_lo, d2_hi, d2_null, 1)]
                all_null = all_null & op2_null & i2_null & d2_null
                ins2, i2_ext = gap(op2_off, i2_off, -1)
                del2, d2_ext = gap(op2_off, d2_off, +1)
                gaps += (ins2, del2)
                gap_prods += (~(op2_null & i2_null), ~(op2_null & d2_null))
                # M by the packed (value << 3) | prio max:
                # X(5) > D2(4) > D1(3) > I2(2) > I1(1)
                cands = ((mis, 5, MSRC_X), (del2, 4, MSRC_D2),
                         (del1, 3, MSRC_D1), (ins2, 2, MSRC_I2),
                         (ins1, 1, MSRC_I1))
                ext_bits = ((i1_ext.to(i32) << 3) | (d1_ext.to(i32) << 4)
                            | (i2_ext.to(i32) << 5) | (d2_ext.to(i32) << 6))
            else:
                # X(5) > D1(3) > I1(1)
                cands = ((mis, 5, MSRC_X), (del1, 3, MSRC_D1),
                         (ins1, 1, MSRC_I1))
                ext_bits = (i1_ext.to(i32) << 3) | (d1_ext.to(i32) << 4)
            lo_n = functools.reduce(torch.minimum, [l for l, _ in lims])
            hi_n = functools.reduce(torch.maximum, [h for _, h in lims])
            pm = functools.reduce(torch.maximum,
                                  [pack(v, p) for v, p, _ in cands])
            raw = functools.reduce(torch.maximum, [v for v, _, _ in cands])
            pr = pm & 7
            msrc = torch.full_like(pm, MSRC_NONE)
            for _, p, src in cands:
                msrc = torch.where((pm >= 0) & (pr == p), src, msrc)
            choice = msrc | ext_bits
            # an all-invalid cell keeps the largest raw candidate, which
            # the bounds check nulls
            mvals = torch.where(pm < 0, raw, pm >> 3)
        if not edit_like:
            nnull = torch.where(active & all_null, nnull + 1,
                                torch.where(active, 0, nnull))
        v_ = mvals - karr
        bad = (mvals < 0) | (mvals > tlen) | (v_ < 0) | (v_ > plen)
        mvals = torch.where(bad, NULL, mvals)

        null_step = all_null
        seeded_null = None
        if seeding:
            # boundary seeds at the scores divisible by -match (the Pallas
            # kernel's `:720-745`): a pair with any begin-free slack gets
            # a wavefront at every such score, seeded at k = ek and k = -ek
            # while the frees reach that far; on a null step it is a
            # wavefront of the seeds alone, which keeps the heuristics'
            # cadence ticking
            ek = s1 // -cfg.match
            need = (((pbf > 0) | (tbf > 0)) if s1 % -cfg.match == 0
                    else ~true)
            seed_t = need & (tbf >= ek)
            seed_p = need & (pbf >= ek)
            do_t = seed_t & (karr == ek) & (mvals <= ek)
            do_p = seed_p & (karr == -ek) & (mvals <= 0)
            mvals = torch.where(do_t, ek, mvals)
            mvals = torch.where(do_p, 0, mvals)
            choice = torch.where(do_t | do_p, MSRC_SEED, choice)
            ns_lo = torch.where(seed_p, -ek, torch.where(seed_t, ek, 0))
            ns_hi = torch.where(seed_t, ek, torch.where(seed_p, -ek, 0))
            lo_n = torch.where(seed_p, lo_n.clamp(max=-ek), lo_n)
            hi_n = torch.where(seed_t, hi_n.clamp(min=ek), hi_n)
            seeded_null = null_step & need
            lo_n = torch.where(seeded_null, ns_lo, lo_n)
            hi_n = torch.where(seeded_null, ns_hi, hi_n)
            null_step = null_step & ~need
        overflow = active & ~null_step & (
            (lo_n < kmin + 2) | (hi_n > kmin + W - 3))
        lo_n = lo_n.clamp(kmin + 2, kmin + W - 3)
        hi_n = hi_n.clamp(kmin + 2, kmin + W - 3)
        write = active & ~null_step
        bandn = band_mask(lo_n, hi_n)
        band_n = bandn & write

        # M is written on every non-null step; a gap component only when
        # one of its sources exists
        vals = (mvals,) + gaps
        prods = (write,) + tuple(write & p for p in gap_prods)
        for c in range(NC):
            arr = torch.where(band_n & prods[c], vals[c], NULL)
            v3 = arr - karr
            inb = bandn & (arr >= 0) & (arr <= tlen) & (v3 >= 0) & (v3 <= plen)
            first = torch.where(inb, iota, W).amin(1, keepdim=True) + kmin
            last = torch.where(inb, iota, -1).amax(1, keepdim=True) + kmin
            keep = prods[c] & inb.any(1, keepdim=True)
            tlo = torch.where(keep, first, 1)
            thi = torch.where(keep, last, -1)
            if c == M and seeding:
                # a wavefront of the seeds alone is not trimmed
                tlo = torch.where(seeded_null, lo_n, tlo)
                thi = torch.where(seeded_null, hi_n, thi)
            off[c * scope + slot1] = torch.where(
                (karr >= tlo) & (karr <= thi), arr, NULL)
            lo[c * scope + slot1] = tlo
            hi[c * scope + slot1] = thi
            if c == M and edit_like:
                # an empty wavefront ends the pair at the next probe:
                # edit and indel count no null steps
                nnull = torch.where(active & (tlo > thi), 2**30, nnull)
        if record:
            choices[s1 - seg_base] = torch.where(band_n, choice, 0).to(
                torch.uint8)

        # band overflow: the pair escalates to a wider band
        status = torch.where(overflow, ST_OVERFLOW_W, status)
        done = done | overflow
        active = active & ~overflow

        hit_max = active & (s1 >= max_steps)
        status = torch.where(hit_max, ST_MAX_STEPS, status)
        final_s = torch.where(hit_max, s1, final_s)
        done = done | hit_max
        s = s1

    running = ~done
    if state is not None:
        # the state of a later segment, for the pairs that entered this
        # one: a pair still running stays running there, and a pair paused
        # at the step cap keeps the ring it stopped with (all such pairs
        # stop at one score, which ends the loop)
        keep = entered[:, 0]
        for srow, prow in _plain_rows(cfg, s):
            state["ring"][keep, srow] = off[prow][keep]
            state["lohi"][keep, srow, 0] = lo[prow][keep, 0]
            state["lohi"][keep, srow, 1] = hi[prow][keep, 0]
        fields = dict(s=torch.where(running | (status == ST_MAX_STEPS), s,
                                    final_s),
                      status=status, final_s=final_s, end_k=end_k,
                      end_off=end_off, nnull=nnull, h_wait=h_wait,
                      hm_sw=hm_sw, hm_k=hm_k, hm_off=hm_off,
                      hm_valid=hm_valid, done=done)
        new = torch.cat([fields[name].to(i32) for name in CARRY], dim=1)
        state["carry"][keep] = new[keep]
    status = torch.where(running, ST_OVERFLOW_S, status)
    final_s = torch.where(running, s, final_s)
    out = dict(status=status[:, 0], final_s=final_s[:, 0],
               end_k=end_k[:, 0], end_off=end_off[:, 0], steps=final_s.max())
    if record:
        out["choices"] = choices
    return out
