"""The fused whole-alignment score loop: all five distance metrics
(gap-affine, gap-affine 2-piece, gap-linear, edit, indel), end-to-end or
ends-free span (with a match bonus too: the boundary is then seeded at
every score divisible by -match), full-CIGAR or score-only scope, and the
heuristic cascade (wf-adaptive, wfmash, x-drop, z-drop, banded static and
adaptive, and their combinations).

The twin of `pywfa_tpu/ops/pallas/fused_loop.py`. For every pair it runs
the whole WFA score loop -- extend, terminate, prune the wavefront by the
heuristics, compute s+1, seed, trim, record one choice byte per cell
unless the scope is score-only -- and returns the same dict as the
reference's `align_batch_pallas`.

`align_batch_fused_loop` is the entry point. On CUDA tensors it launches
the hand-written kernel in `csrc/fused_loop.cu`; on CPU tensors it runs
`align_batch_fused_loop_ref`, the plain torch version, which is the Pallas
kernel's own array program over [B, W] with a Python loop over scores.

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
    NULL, NULL_THRESHOLD, ST_END_REACHED, ST_END_UNREACHABLE, ST_MAX_STEPS,
    ST_OVERFLOW_S, ST_OVERFLOW_W, EngineConfig,
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
# by variant (see `variant`)
variant_launches = dict.fromkeys(VARIANTS, 0)

# shared memory one block may use on sm_90 (bytes)
SMEM_LIMIT = 232448
MAX_THREADS = 1024


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


def smem_bytes(cfg: EngineConfig) -> int:
    """Dynamic shared memory of one block: the offsets ring, its lo/hi
    pairs and the per-warp partials of the two trim reductions a component,
    of the ends-free termination and, with a heuristic, of the cascade's
    reductions."""
    depths = ring_depths(cfg)
    rows = sum(depths)
    partials = 2 * len(depths) + 1 + (HEUR_REDUCTIONS if cfg.strategy else 0)
    return (rows * cfg.W + rows * 2 + partials * 32) * 4


def _ends_free(cfg: EngineConfig) -> bool:
    return cfg.span == AlignmentSpan.ENDS_FREE


def span_code(cfg: EngineConfig) -> int:
    """Index into SPANS of the config's span (see SPANS)."""
    if not _ends_free(cfg):
        return 0
    return 1 if cfg.match == 0 else 2


def variant(cfg: EngineConfig) -> str:
    """The kernel variant a config launches: the metric's prefix (none for
    gap-affine), the span, "_heur" with any heuristic, then "_score" for
    the score-only scope."""
    return (METRIC_PREFIX[cfg.metric] + SPANS[span_code(cfg)]
            + ("_heur" if cfg.strategy else "")
            + ("" if cfg.record_choices else "_score"))


def supported(cfg: EngineConfig) -> bool:
    """The slice this module covers: every distance metric, end-to-end or
    ends-free span, with or without a match bonus, every heuristic of the
    cascade, full-CIGAR or score-only scope, one thread per diagonal.
    Wildcards and match classes live in the equality bits and need nothing
    here."""
    return (cfg.metric in METRIC_CODE
            and (span_code(cfg) != 2 or cfg.metric in SEEDED_METRICS)
            and (cfg.strategy & ~STRATEGIES) == 0
            and cfg.W % 32 == 0 and cfg.W <= MAX_THREADS
            and smem_bytes(cfg) <= SMEM_LIMIT)


def _check(cfg: EngineConfig, bits, plen, tlen, frees):
    if not supported(cfg):
        raise NotImplementedError(
            "the fused loop runs one thread per diagonal with its ring in "
            f"shared memory: W a multiple of 32, W <= {MAX_THREADS} and "
            f"at most {SMEM_LIMIT} bytes (got {cfg}); wider bands wait for "
            "the long-read path (ROADMAP queue 1 item 6)")
    if bits.dim() != 3 or bits.shape[2] != cfg.W:
        raise ValueError(f"bits must be [NQ, B, {cfg.W}], got "
                         f"{tuple(bits.shape)}")
    NQ, B, _ = bits.shape
    if NQ * 32 <= cfg.Lt:
        raise ValueError(f"bits hold {NQ * 32} text positions, need more "
                         f"than Lt={cfg.Lt} for the sentinel mismatch")
    for name, t, shape in (("plen", plen, (B,)), ("tlen", tlen, (B,)),
                           ("frees", frees, (B, 4))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != bits.device:
            raise ValueError(f"{name} is on {t.device}, bits on "
                             f"{bits.device}")
    for name, t in (("bits", bits), ("plen", plen), ("tlen", tlen),
                    ("frees", frees)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")


def align_batch_fused_loop(cfg: EngineConfig, bits, plen, tlen, frees,
                           max_steps: int) -> dict:
    """Run the fused score loop over B pairs.

    bits: [NQ, B, W] int32 bit patterns (engine.build_eq_bits); plen/tlen:
    [B] int32; frees: [B, 4] int32 (pattern begin, pattern end, text
    begin, text end free; read on the ends-free span only); max_steps: the
    user step cap. Returns dict(status, final_s, end_k, end_off, steps),
    plus choices [S_cap, B, W] uint8 when cfg.record_choices (levels a
    pair never reaches read 0).
    """
    _check(cfg, bits, plen, tlen, frees)
    max_steps = min(int(max_steps), 2**31 - 1)
    if bits.device.type == "cpu":
        return align_batch_fused_loop_ref(cfg, bits, plen, tlen, frees,
                                          max_steps)
    if bits.device.type != "cuda":
        raise ValueError(f"no fused loop for device {bits.device}")
    for name, t in (("bits", bits), ("plen", plen), ("tlen", tlen),
                    ("frees", frees)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from . import cuda_build
    lib = cuda_build.load()
    NQ, B, W = bits.shape
    dev = bits.device
    record = cfg.record_choices
    # score-only scope: no [S_cap, B, W] record, so no memset of it either
    choices = (torch.zeros((cfg.S_cap, B, W), dtype=torch.uint8, device=dev)
               if record else None)
    res = torch.empty((4, B), dtype=torch.int32, device=dev)
    x, o1, e1, o2, e2 = score_distances(cfg)
    depths = ring_depths(cfg)
    heur = heuristic_params(cfg)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wfa_fused_loop(
            bits.data_ptr(), plen.data_ptr(), tlen.data_ptr(),
            frees.data_ptr(), choices.data_ptr() if record else None,
            res.data_ptr(), (ctypes.c_int * len(depths))(*depths), B, W, NQ,
            cfg.S_cap, cfg.scope, x, o1, e1, o2, e2, max_steps,
            METRIC_CODE[cfg.metric], span_code(cfg), int(record),
            (ctypes.c_int * len(heur))(*heur), -cfg.match, stream)
    if rc != 0:
        raise RuntimeError("fused loop kernel launch failed: "
                           + cuda_build.error_string(rc))
    variant_launches[variant(cfg)] += 1
    out = dict(status=res[0], final_s=res[1], end_k=res[2], end_off=res[3],
               steps=res[1].max())
    if record:
        out["choices"] = choices
    return out


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


def align_batch_fused_loop_ref(cfg: EngineConfig, bits, plen, tlen, frees,
                               max_steps: int) -> dict:
    """The plain torch version: the Pallas kernel's array program (every
    metric's branch, both spans, the match seeding, the heuristic cascade,
    both scopes) over [B, W], all pairs as one tile, with the
    band-overflow flag of the XLA engine. Its ring has `scope` rows for
    every component. Runs on any device."""
    NQ, B, W = bits.shape
    dev = bits.device
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
    while bool((~done).any()) and s < S_cap - 1:
        active = ~done
        slot = s % scope
        m_off, m_lo, m_hi, m_null = read_wf(M, s)
        # feasibility probe: a run of null steps longer than the scope
        dead = active & m_null & (nnull > scope)
        status = torch.where(dead, ST_END_UNREACHABLE, status)
        final_s = torch.where(dead, s, final_s)
        done = done | dead
        active = active & ~dead

        # --- extension: find-first-mismatch over the equality words ---
        band = band_mask(m_lo, m_hi) & active & ~m_null
        valid = band & (m_off >= 0) & (m_off <= tlen)
        idx = m_off.clamp(0, NQ32 - 1)
        q0 = idx >> 5
        ones = torch.full_like(idx, -1)
        head = ones << (idx & 31)
        fm = torch.full_like(idx, NQ32)
        for q in range(NQ):
            sel = torch.where(q0 == q, head, torch.where(q0 < q, ones, 0))
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
            choices[s1] = torch.where(band_n, choice, 0).to(torch.uint8)

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
    status = torch.where(running, ST_OVERFLOW_S, status)
    final_s = torch.where(running, s, final_s)
    out = dict(status=status[:, 0], final_s=final_s[:, 0],
               end_k=end_k[:, 0], end_off=end_off[:, 0], steps=final_s.max())
    if record:
        out["choices"] = choices
    return out
