"""Device stages of the batch path around the fused score loop, in torch.

The twin of the XLA-op stages of `pywfa_tpu.ops.engine` that the main path
runs: the 2-bit decode, the packed equality bits, the traceback walk and
the output packing, plus the pipelines that chain them with the fused
loop: `align_batch_packed_full` and `align_batch_fused_full`, which end in
`pack_full` in the full-CIGAR scope and in `pack_meta` in the score-only
one (`align_batch_packed_meta` and `align_batch_fused_meta` are their
names under the reference's score-only spelling). Every function
is device-agnostic: it runs where its input tensors live, CPU or CUDA.
Only the walk synchronises with the device, to end early.

The segmented (rematerialized) run of the long-read path is here too, the
twin of the reference's `align_batch_start` / `align_batch_resume` /
`align_batch_start_walk` / `align_batch_replay_walk`: a forward segment
records nothing and updates the state in place; a replay runs one segment
again from its boundary state with the record and walks its levels at
once, so the record never leaves the device. The extension's input (the
equality bits, or the run-length table where `extend_mode` picks it) is
built once a batch by `build_extension` and handed to every segment.

Where the reference's formulation existed only because the TPU lacks an
indexed load (one-hot selects, a one-hot matmul compaction), this module
uses the direct gather or scatter instead; the outputs are byte-identical.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..attributes import match_class_table
from ..constants import DistanceMetric
from . import fused_loop, lcp_table
from .config import (
    D1, D2, I1, I2, M, MSRC_D1, MSRC_D2, MSRC_I1, MSRC_I2, MSRC_NONE,
    MSRC_SEED, MSRC_X,
    NULL_THRESHOLD, PATTERN_PAD, ST_END_REACHED, ST_END_UNREACHABLE,
    ST_OVERFLOW_S, TEXT_PAD, WOP_D, WOP_I, WOP_MFLAG, WOP_X,
    EngineConfig, fused_widths, packed_layout, packed_widths,
)


@functools.lru_cache(maxsize=None)
def _acgt(device: torch.device) -> torch.Tensor:
    return torch.tensor(list(b"ACGT"), dtype=torch.int8, device=device)


@functools.lru_cache(maxsize=None)
def _byte_weights(device: torch.device) -> torch.Tensor:
    return torch.tensor([1 << i for i in range(8)], dtype=torch.uint8,
                        device=device)


def decode_fused(cfg: EngineConfig, fused: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split one [B, Wp+Wt] fused token array into (pat, txt) rows."""
    wp, _ = fused_widths(cfg)
    return fused[:, :wp], fused[:, wp:]


def decode_packed(cfg: EngineConfig, packed: torch.Tensor,
                  plen: torch.Tensor, tlen: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, Pp+Pt] uint8 2-bit DNA -> the int8 token rows the host encoder
    would produce (ACGT bytes up to each length, sentinel past it)."""
    pp, _ = packed_widths(cfg)
    wp, wt = fused_widths(cfg)
    lut = _acgt(packed.device)
    shifts = 2 * torch.arange(4, dtype=torch.int32, device=packed.device)

    def dec(block, width, length, pad):
        B = block.shape[0]
        codes = (block.to(torch.int32)[:, :, None] >> shifts) & 3
        codes = codes.reshape(B, -1)
        if codes.shape[1] < width:
            # only the base region is sent; the tail is past every length
            # and gets the sentinel below
            codes = torch.nn.functional.pad(codes,
                                            (0, width - codes.shape[1]))
        else:
            codes = codes[:, :width]
        tok = lut[codes.long()]
        iota = torch.arange(width, dtype=torch.int32, device=packed.device)
        return torch.where(iota[None, :] < length[:, None], tok, pad)

    pat = dec(packed[:, :pp], wp, plen, PATTERN_PAD)
    txt = dec(packed[:, pp:], wt, tlen, TEXT_PAD)
    return pat, txt


def build_eq_bits(cfg: EngineConfig, pat: torch.Tensor, txt: torch.Tensor
                  ) -> torch.Tensor:
    """Packed per-diagonal equality bits Q[q, b, w] as int32 bit patterns.

    Bit (h & 31) of Q[h >> 5, b, w] is pattern[h - k_w] == text[h] for
    k_w = kmin + w, with the pattern sentinel wherever h - k_w leaves the
    pattern row; bits at h >= Ltp are 0. Gather-free: the pattern row of
    diagonal W-1-w is a sliding window (`unfold`, a view) of the padded
    pattern, so one compare builds the equality bytes of all diagonals in
    reversed order. They are packed 8 to a byte, 4 bytes are read as one
    little-endian int32 word, and the diagonal order is flipped back.
    Words are built in groups that bound the temporaries to about 2^28
    elements.

    With cfg.wildcard >= 0 that byte matches any real character on either
    side, and never a sentinel (the extension would run past a sequence's
    end). With cfg.match_classes both rows are mapped through the
    registered class-mask table first and two cells match when their masks
    intersect; the sentinels, and any byte absent from the table, map to
    0 and match nothing.
    """
    dev = pat.device
    classes = bool(cfg.match_classes)
    pad = PATTERN_PAD
    if classes:
        tbl = torch.from_numpy(match_class_table(cfg.match_classes)
                               .astype(np.int32)).to(dev)
        pat = tbl[pat.view(torch.uint8).long()]
        txt = tbl[txt.view(torch.uint8).long()]
        pad = 0
    B, Lpp = pat.shape
    Ltp = txt.shape[1]
    W, kmin = cfg.W, cfg.kmin
    NQ = -(-Ltp // 32)
    H = NQ * 32
    # window w' = W-1-w starts at pattern index -k_w = -(kmin + W-1) + w'
    lead = max(0, kmin + W - 1)
    first = lead - (kmin + W - 1)
    tail = max(0, first + W - 1 + H - lead - Lpp)
    patpad = torch.nn.functional.pad(pat, (lead, tail), value=pad)
    wins = patpad.unfold(1, H, 1)[:, first:first + W]          # [B, W, H]
    txtp = torch.nn.functional.pad(txt, (0, H - Ltp))
    in_text = torch.arange(H, device=dev) < Ltp
    weights = _byte_weights(dev)
    G = max(1, (1 << 28) // max(1, B * W * 32))
    words = torch.empty((NQ, B, W), dtype=torch.int32, device=dev)
    for q0 in range(0, NQ, G):
        hs = slice(q0 * 32, min(NQ, q0 + G) * 32)
        pk, tk = wins[:, :, hs], txtp[:, None, hs]
        if classes:
            eq = (pk & tk) != 0
        else:
            eq = pk == tk
            if cfg.wildcard >= 0:
                eq = ((eq | (pk == cfg.wildcard) | (tk == cfg.wildcard))
                      & (pk != PATTERN_PAD) & (tk != TEXT_PAD))
        eq = eq & in_text[hs]
        byte = (eq.view(torch.uint8).reshape(B, W, -1, 8) * weights
                ).sum(-1, dtype=torch.uint8)                    # [B, W, 4g]
        words[q0:q0 + G] = byte.view(torch.int32).flip(1).permute(2, 0, 1)
    return words


@functools.lru_cache(maxsize=64)
def _walk_tables(cfg: EngineConfig, device: torch.device) -> dict:
    """Per-(component, choice byte) transition tables of the walk step.

    Entry comp * 256 + ch holds what the reference's walk step derives
    from (comp, ch): the emitted token, the score and diagonal deltas, the
    next component, and the kind of the step at M (0 move, 1 stop at a
    seed, 2 inconsistent chain). The table has one block of 256 rows a
    component: M alone for gap-linear, edit and indel, which never leave
    M and step back by the mismatch or the indel penalty (1 and 1 for edit
    and indel); M, I1, D1 for gap-affine; I2 and D2 besides for the
    2-piece metric, whose M block follows the I2/D2 sources and whose
    bytes carry their extend bits 5-6. Sources a metric never writes take
    the last branch of the reference's where-chain.
    """
    ch = np.arange(256, dtype=np.int64)
    msrc = ch & 7
    is_x = msrc == MSRC_X
    m_kind = np.where(msrc == MSRC_SEED, 1, np.where(msrc == MSRC_NONE, 2, 0))
    if cfg.n_comp == 1:
        edit_like = cfg.metric in (DistanceMetric.EDIT, DistanceMetric.INDEL)
        lin_x = 1 if edit_like else cfg.mismatch
        lin_open = 1 if edit_like else cfg.gap_opening1
        is_i = msrc == MSRC_I1
        rows = [(np.where(is_x, WOP_X, np.where(is_i, WOP_I, WOP_D))
                 | WOP_MFLAG,
                 np.where(is_x, lin_x, lin_open),
                 np.where(is_i, -1, np.where(msrc == MSRC_D1, 1, 0)),
                 np.full(256, M), m_kind)]
    else:
        x = cfg.mismatch
        # per gap component: (source code, extend bit, open and extend
        # distances, op, diagonal delta)
        e1, e2 = cfg.gap_extension1, cfg.gap_extension2
        o1e1 = cfg.gap_opening1 + e1
        o2e2 = cfg.gap_opening2 + e2
        gaps = {I1: (MSRC_I1, 3, o1e1, e1, WOP_I, -1),
                D1: (MSRC_D1, 4, o1e1, e1, WOP_D, 1),
                I2: (MSRC_I2, 5, o2e2, e2, WOP_I, -1),
                D2: (MSRC_D2, 6, o2e2, e2, WOP_D, 1)}
        # at M the chain is X, I1, D1, I2, else D2
        m_comp = np.where(msrc == MSRC_I1, I1, np.where(
            msrc == MSRC_D1, D1, np.where(msrc == MSRC_I2, I2, D2)))
        m_op = np.where(is_x, WOP_X, np.where(
            (msrc == MSRC_I1) | (msrc == MSRC_I2), WOP_I, WOP_D))
        m_dk = np.where((msrc == MSRC_I1) | (msrc == MSRC_I2), -1, np.where(
            (msrc == MSRC_D1) | (msrc == MSRC_D2), 1, 0))
        m_ds = np.full(256, x)
        m_next = np.full(256, M)
        for comp, (_, bit, oe, e, _, _) in gaps.items():
            ext = (ch >> bit) & 1
            pick = ~is_x & (m_comp == comp)
            m_ds = np.where(pick, np.where(ext == 1, e, oe), m_ds)
            m_next = np.where(pick & (ext == 1), comp, m_next)
        rows = [(m_op | WOP_MFLAG, m_ds, m_dk, m_next, m_kind)]
        # at a gap component: extend continues the chain, open returns to M
        for comp in range(1, cfg.n_comp):
            _, bit, oe, e, op, dk = gaps[comp]
            ext = ((ch >> bit) & 1) == 1
            rows.append((np.full(256, op), np.where(ext, e, oe),
                         np.full(256, dk), np.where(ext, comp, M),
                         np.zeros(256, np.int64)))
    cols = list(zip(*rows))

    def t(i, dtype):
        return torch.tensor(np.concatenate(cols[i]), dtype=dtype,
                            device=device)

    return dict(emit=t(0, torch.uint8), ds=t(1, torch.int32),
                dk=t(2, torch.int32), next=t(3, torch.int32),
                kind=t(4, torch.int32))


def walk_carry_init(final_s: torch.Tensor, end_k: torch.Tensor,
                    ok: torch.Tensor) -> tuple:
    """The walk's carry (s, k, comp, active, fallback) at each pair's end
    cell; `ok` marks the pairs that are walked."""
    B = final_s.shape[0]
    dev = final_s.device
    return (final_s.to(torch.int32).clone(), end_k.to(torch.int32).clone(),
            torch.zeros(B, dtype=torch.int32, device=dev), ok.clone(),
            torch.zeros(B, dtype=torch.bool, device=dev))


def walk_segment(cfg: EngineConfig, choices: torch.Tensor, seg_base: int,
                 carry: tuple):
    """Walk one segment's choice block backwards, from where the segment
    above left each pair.

    choices [K, B, W] holds the levels of the scores
    [seg_base, seg_base + K); level 0 of a segment that is not the bottom
    one aliases the top level of the segment below, which walks it. Each
    iteration every pair whose score lies in the segment reads its own
    cell choices[s - seg_base, b, k] with one gather and takes one step;
    the op it emits lands at its level, so the stream is zero-sparse over
    levels in FORWARD cigar order, as the reference's level scan writes
    it. Every step lowers s by at least the metric's smallest score
    distance, which bounds the iteration count; every 4 steps one host
    sync ends the walk early once no pair is left in the segment. A pair
    stops at score 0 on the diagonal it reached, which is a WF0 seed
    (k != 0 on the ends-free span) and becomes its k_start, or at a seed
    of a later score. Returns (ops_fwd [B, K] uint8, carry); after the
    bottom segment a pair still active has an inconsistent chain.
    """
    K, B, W = choices.shape
    dev = choices.device
    tb = _walk_tables(cfg, dev)
    # the least score a step goes back: the metric's smallest distance
    min_step = min(d for d in fused_loop.score_distances(cfg) if d > 0)
    n_iter = (K - 1) // min_step + 2
    lowest = seg_base + 1 if seg_base > 0 else 0
    flat = choices.reshape(-1)
    row = torch.arange(B, dtype=torch.int64, device=dev)
    s, k, comp, act, fallback = carry
    ops = torch.zeros((B, K + 1), dtype=torch.uint8, device=dev)
    for it in range(n_iter):
        here = act & (s >= lowest) & (s < seg_base + K)
        # every 4 steps, stop once no pair walks here (one host sync); the
        # remaining steps would change nothing
        if it and it % 4 == 0 and not bool(here.any()):
            break
        kk = (k - cfg.kmin).long()
        lvl = (s.long() - seg_base).clamp(0, K - 1)
        cell = flat[(lvl * B + row) * W + kk.clamp(0, W - 1)]
        ch = torch.where((kk >= 0) & (kk < W), cell, 0).long()
        t = comp.long() * 256 + ch
        at_m = comp == M
        kind = tb["kind"][t]
        stop = here & at_m & ((s <= 0) | (kind == 1))
        bad = here & at_m & (s > 0) & (kind == 2)
        move = here & ~stop & ~bad
        pos = torch.where(move, lvl, K)
        ops.scatter_(1, pos[:, None], torch.where(move, tb["emit"][t], 0)
                     .to(torch.uint8)[:, None])
        s = torch.where(move, s - tb["ds"][t], s)
        k = torch.where(move, k + tb["dk"][t], k)
        comp = torch.where(move, tb["next"][t], comp)
        # a chain pointing before score 0 is inconsistent
        bad2 = move & (s < 0)
        fallback = fallback | bad | bad2
        act = act & ~stop & ~bad & ~bad2
    return ops[:, :K], (s, k, comp, act, fallback)


def traceback_walk(cfg: EngineConfig, choices: torch.Tensor,
                   final_s: torch.Tensor, end_k: torch.Tensor,
                   ok: torch.Tensor):
    """Walk the whole choice tensor of a one-shot run backwards from each
    pair's end cell: the bottom segment and the only one (see
    walk_segment).
    Returns (ops_fwd [B, S_cap] uint8, n_ops [B], k_start [B], fallback [B]).
    """
    ops_fwd, (_, k, _, act, fallback) = walk_segment(
        cfg, choices, 0, walk_carry_init(final_s, end_k, ok))
    n_ops = (ops_fwd != 0).sum(1, dtype=torch.int32)
    return ops_fwd, n_ops, k, fallback | act


def walkable(out: dict) -> torch.Tensor:
    """The pairs whose traceback is walked: those that reached the end, and
    dropped pairs that recorded an end cell."""
    status = out["status"]
    return (status == ST_END_REACHED) | (
        (status == ST_END_UNREACHABLE) & (out["end_off"] > NULL_THRESHOLD))


def pack_full(cfg: EngineConfig, out: dict) -> torch.Tensor:
    """Walk + pack all full-scope outputs into ONE uint8 vector (the wire
    format of config.packed_layout, decoded by batch.align_pairs_finish)."""
    ok = walkable(out)
    walk = traceback_walk(cfg, out["choices"], out["final_s"], out["end_k"],
                          ok)
    return pack_walked(cfg, out, ok, walk)


def pack_walked(cfg: EngineConfig, out: dict, ok: torch.Tensor,
                walk: tuple) -> torch.Tensor:
    """Pack the loop's outputs and their walk (traceback_walk's tuple) into
    the wire format.

    The compact layout compacts each pair's zero-sparse op stream with a
    cumsum plus a scatter: token i goes to position cumsum(nonzero)-1, and
    tokens past ops_out fall into a spill column that is dropped.
    """
    ops_fwd, n_ops, k_start, fb = walk
    status = out["status"].to(torch.int32)
    end_off = out["end_off"].to(torch.int32).contiguous()
    B = status.shape[0]
    if packed_layout(cfg) == "compact":
        OC = cfg.ops_out
        assert OC % 2 == 0
        nz = ops_fwd != 0
        pos = torch.where(nz, nz.long().cumsum(1) - 1, OC).clamp(max=OC)
        comp = torch.zeros((B, OC + 1), dtype=torch.uint8,
                           device=ops_fwd.device)
        comp.scatter_(1, pos, ops_fwd)
        comp = comp[:, :OC]
        ops_stream = comp[:, 0::2] | (comp[:, 1::2] << 4)
        # overflowing walks re-run at the next rung
        status = torch.where(ok & (n_ops > OC), ST_OVERFLOW_S, status)
        m16 = torch.stack([out["final_s"].to(torch.int32),
                           out["end_k"].to(torch.int32), n_ops,
                           k_start]).to(torch.int16)
        return torch.cat([
            status.to(torch.uint8), fb.to(torch.uint8),
            m16.view(torch.uint8).reshape(-1),
            end_off.view(torch.uint8).reshape(-1),
            ops_stream.reshape(-1)])
    meta = torch.stack([status, out["final_s"].to(torch.int32),
                        out["end_k"].to(torch.int32), end_off, n_ops,
                        k_start, fb.to(torch.int32)])
    return torch.cat([meta.view(torch.uint8).reshape(-1),
                      ops_fwd.reshape(-1)])


def _pack(cfg: EngineConfig, out: dict) -> torch.Tensor:
    """The scope's packed output: pack_full with the choice record,
    pack_meta without it."""
    return pack_full(cfg, out) if cfg.record_choices else pack_meta(out)


def align_batch_packed_full(cfg: EngineConfig, packed, plen, tlen, frees,
                            max_steps: int) -> torch.Tensor:
    """2-bit input -> packed output: decode, eq-bits, the fused loop, and
    in the full scope the walk and the packing, all on `packed`'s
    device."""
    plen = plen.to(torch.int32)
    tlen = tlen.to(torch.int32)
    pat, txt = decode_packed(cfg, packed, plen, tlen)
    bits = build_eq_bits(cfg, pat, txt)
    return _pack(cfg, fused_loop.align_batch_fused_loop(
        cfg, bits, plen, tlen, frees, max_steps))


def align_batch_fused_full(cfg: EngineConfig, fused, plen, tlen, frees,
                           max_steps: int) -> torch.Tensor:
    """As align_batch_packed_full, from fused int8 token rows (the push
    format of batches that hold a non-ACGT byte)."""
    plen = plen.to(torch.int32)
    tlen = tlen.to(torch.int32)
    pat, txt = decode_fused(cfg, fused)
    bits = build_eq_bits(cfg, pat, txt)
    return _pack(cfg, fused_loop.align_batch_fused_loop(
        cfg, bits, plen, tlen, frees, max_steps))


def pack_meta(out: dict) -> torch.Tensor:
    """Score-only scope: the [4, B] int32 meta block (status, final_s,
    end_k, end_off), decoded by batch.align_pairs_finish."""
    return torch.stack([out["status"], out["final_s"], out["end_k"],
                        out["end_off"]]).to(torch.int32)


# the score-only pipelines under the reference's names (cfg.record_choices
# is False there, so the pipelines end in pack_meta)
align_batch_packed_meta = align_batch_packed_full
align_batch_fused_meta = align_batch_fused_full


def extend_mode(cfg: EngineConfig, Ltp: int) -> str:
    """The extension of a segmented run: "table", the h-major run-length
    table and one load a cell, where the config allows a table, the text
    rows are short enough for it (lcp_table.supported) and matching is not
    by classes (the table's kernel compares raw tokens); else "bits", the
    packed equality words. PYWFA_EXTEND=bits (cfg.extend_force) forces the
    words."""
    if (cfg.use_lcp_table and not cfg.match_classes
            and cfg.extend_force not in ("bits", "chunk")
            and lcp_table.supported(Ltp)):
        return "table"
    return "bits"


def build_extension(cfg: EngineConfig, pat: torch.Tensor,
                    txt: torch.Tensor) -> dict:
    """The extension's input for a batch, by extend_mode: dict(bits=...,
    table=...) with one of the two None."""
    if extend_mode(cfg, txt.shape[1]) == "table":
        return dict(bits=None, table=lcp_table.build_lcp_table_hmajor(
            cfg.W, cfg.kmin, cfg.wildcard, pat.contiguous(),
            txt.contiguous()))
    return dict(bits=build_eq_bits(cfg, pat, txt), table=None)


def _segment(cfg, ext, plen, tlen, frees, max_steps, state, fresh):
    seg_base = 0 if fresh else state["s"]
    out = fused_loop.align_batch_fused_loop(
        cfg, ext["bits"], plen, tlen, frees, max_steps, table=ext["table"],
        state=state, fresh=fresh, seg_base=seg_base)
    # where any pair is still running, the next segment starts here
    state["s"] = seg_base + cfg.S_cap - 1
    return out


def align_batch_start(cfg: EngineConfig, ext: dict, plen, tlen, frees,
                      max_steps: int):
    """Segmented execution, the first segment: scores [0, S_cap - 1] from
    WF0. Returns (out, state); pairs still running report ST_OVERFLOW_S in
    `out` and go on in align_batch_resume."""
    state = fused_loop.new_state(cfg, plen.shape[0], plen.device)
    return _segment(cfg, ext, plen, tlen, frees, max_steps, state,
                    True), state


def align_batch_resume(cfg: EngineConfig, ext: dict, plen, tlen, frees,
                       max_steps: int, state: dict):
    """Continue a segmented run from `state` for another S_cap - 1 scores;
    the state is updated in place. Returns (out, state)."""
    return _segment(cfg, ext, plen, tlen, frees, max_steps, state,
                    False), state


def align_batch_start_walk(cfg: EngineConfig, ext: dict, plen, tlen, frees,
                           max_steps: int, carry: tuple):
    """Run the first segment again with the choice record and walk its
    levels; the record never leaves the device. `cfg` records choices.
    Returns (ops_fwd [B, S_cap], carry)."""
    state = fused_loop.new_state(cfg, plen.shape[0], plen.device)
    out = _segment(cfg, ext, plen, tlen, frees, max_steps, state, True)
    return walk_segment(cfg, out["choices"], 0, carry)


def align_batch_replay_walk(cfg: EngineConfig, ext: dict, plen, tlen, frees,
                            max_steps: int, state: dict, carry: tuple):
    """Run one segment again from its boundary `state` (as the forward
    pass saved it; consumed: it is updated in place) with the choice
    record, and walk its levels. Returns (ops_fwd [B, S_cap], carry)."""
    seg_base = state["s"]
    out = _segment(cfg, ext, plen, tlen, frees, max_steps, state, False)
    return walk_segment(cfg, out["choices"], seg_base, carry)
