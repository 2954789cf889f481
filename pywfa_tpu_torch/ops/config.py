"""Static engine configuration, statuses and wire-format constants.

The twin of the configuration half of `pywfa_tpu.ops.engine` (its
`EngineConfig`, `full_config` and the ST_*/MSRC_*/WOP_*/*_PAD constants),
kept field for field identical so that one config drives both packages.
No torch here: this module is pure Python and imports nothing heavy.
"""
from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional, Tuple

from .. import attributes, constants
from ..constants import AlignmentSpan, DistanceMetric, OFFSET_NULL

NULL = OFFSET_NULL
NULL_THRESHOLD = OFFSET_NULL // 2

# per-pair engine statuses
ST_RUNNING = 0
ST_END_REACHED = 1       # alignment end reached (clean completion)
ST_END_UNREACHABLE = 2   # heuristic dead-end / z-drop
ST_MAX_STEPS = 3         # user max_alignment_steps hit
ST_OVERFLOW_W = 4        # band exceeded W -> escalate bucket
ST_OVERFLOW_S = 5        # S_cap exceeded -> escalate bucket

# component indices
M, I1, D1, I2, D2 = 0, 1, 2, 3, 4

# choice byte layout: bits 0-2 = M source, bit 3 = I1 ext, bit 4 = D1 ext,
# bit 5 = I2 ext, bit 6 = D2 ext
MSRC_NONE, MSRC_X, MSRC_I1, MSRC_D1, MSRC_I2, MSRC_D2, MSRC_SEED = (
    0, 1, 2, 3, 4, 5, 7)

# walk op codes (the op stream emitted by the traceback walk)
WOP_END, WOP_X, WOP_I, WOP_D = 0, 1, 2, 3
WOP_MFLAG = 4  # bit: op preceded by a (greedy) match run

# sequence padding sentinels: distinct values so padded tails never match
PATTERN_PAD = 1
TEXT_PAD = 2


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration (same fields as the JAX package's)."""

    metric: DistanceMetric
    # internal (post-Eizenga) penalties
    match: int
    mismatch: int
    gap_opening1: int
    gap_extension1: int
    gap_opening2: int
    gap_extension2: int
    span: AlignmentSpan
    # heuristics
    strategy: int = 0  # HeuristicStrategy bitmask
    min_wavefront_length: int = 10
    max_distance_threshold: int = 50
    steps_between_cutoffs: int = 1
    xdrop: int = 20
    zdrop: int = 20
    band_min_k: int = -10
    band_max_k: int = 10
    internal_gap_e: int = 2
    # shapes
    W: int = 256          # band width (diagonals)
    S_cap: int = 128      # max score steps this bucket supports
    Lp: int = 160         # padded pattern length
    Lt: int = 160         # padded text length
    # behavior
    record_choices: bool = True
    extend_chunk: int = 16
    wildcard: int = -1    # >= 0: wildcard byte code
    match_classes: str = ""
    use_lcp_table: bool = True
    extend_force: str = ""
    # compacted walk-op output width (even; 0 = off): see packed_layout
    ops_out: int = 0

    @property
    def n_comp(self) -> int:
        if self.metric == DistanceMetric.GAP_AFFINE:
            return 3
        if self.metric == DistanceMetric.GAP_AFFINE_2P:
            return 5
        return 1

    @property
    def scope(self) -> int:
        m = self.metric
        if m in (DistanceMetric.INDEL, DistanceMetric.EDIT):
            return 2
        if m == DistanceMetric.GAP_LINEAR:
            return max(self.mismatch, self.gap_opening1) + 1
        if m == DistanceMetric.GAP_AFFINE:
            return max(self.gap_opening1 + self.gap_extension1,
                       self.mismatch) + 1
        return max(max(self.gap_opening1 + self.gap_extension1,
                       self.gap_opening2 + self.gap_extension2),
                   self.mismatch) + 1

    @property
    def kmin(self) -> int:
        return -(self.W // 2)


def _carry(value):
    """A JAX-package value as the port's own type: dataclasses and enums
    become the port's classes of the same name, field by field and by
    value; plain values pass through."""
    if dataclasses.is_dataclass(value):
        cls = getattr(attributes, type(value).__name__)
        return cls(**{f.name: _carry(getattr(value, f.name))
                      for f in dataclasses.fields(cls)})
    if isinstance(value, enum.Enum):
        return getattr(constants, type(value).__name__)(value.value)
    return value


def from_reference(ref) -> EngineConfig:
    """The port's config built field by field from a JAX-package config."""
    return EngineConfig(**{f.name: _carry(getattr(ref, f.name))
                           for f in dataclasses.fields(EngineConfig)})


def attributes_from_reference(ref) -> attributes.AlignerAttributes:
    """The port's AlignerAttributes built field by field from a
    JAX-package AlignerAttributes (its penalties, form, heuristic and
    system blocks included). A named match-class table is registered per
    package and does not come across with its name."""
    return _carry(ref)


def full_config(attr, plen: int, tlen: int, wildcard: int = -1,
                W: Optional[int] = None, S_cap: Optional[int] = None,
                Lp: Optional[int] = None, Lt: Optional[int] = None,
                record_choices: bool = True) -> EngineConfig:
    """Build a no-overflow config for sequences up to (plen, tlen)."""
    pen = attr.penalties
    scope_pad = pen.max_score_scope + 4
    if W is None:
        W = 2 * max(plen, tlen) + 2 * scope_pad + 8
    W = _round_up(max(W, 32), 128)
    if S_cap is None:
        S_cap = _worst_case_score(pen, plen, tlen) + 2
        S_cap = min(S_cap, attr.system.max_alignment_steps + 2)
    S_cap = max(S_cap, 8)
    h = attr.heuristic
    return EngineConfig(
        metric=pen.distance_metric,
        match=pen.match,
        mismatch=pen.mismatch,
        gap_opening1=pen.gap_opening1,
        gap_extension1=pen.gap_extension1,
        gap_opening2=pen.gap_opening2,
        gap_extension2=pen.gap_extension2,
        span=attr.form.span,
        strategy=int(h.strategy),
        min_wavefront_length=h.min_wavefront_length,
        max_distance_threshold=h.max_distance_threshold,
        steps_between_cutoffs=h.steps_between_cutoffs,
        xdrop=h.xdrop,
        zdrop=h.zdrop,
        band_min_k=h.min_k,
        band_max_k=h.max_k,
        internal_gap_e=pen.internal_gap_e,
        W=W,
        S_cap=S_cap,
        Lp=Lp if Lp is not None else plen,
        Lt=Lt if Lt is not None else tlen,
        record_choices=record_choices,
        wildcard=wildcard,
        match_classes=getattr(attr, "match_classes", ""),
        extend_force=extend_force_env(),
    )


def extend_force_env() -> str:
    """PYWFA_EXTEND as a config captures it: "", "table", "bits" or
    "chunk" (ops/engine.extend_mode)."""
    return os.environ.get("PYWFA_EXTEND", "").strip().lower()


def score_band(metric, gap_opening1: int, gap_extension1: int,
               gap_extension2: int, scope: int, S: int, diff: int) -> int:
    """Band width sufficient for any alignment of score <= S between
    sequences whose lengths differ by `diff`: a wavefront grows at most
    one diagonal a side every gap-extension step (every gap-opening one
    under gap-linear, every step under edit and indel), plus the target
    diagonal's offset, padded by the scope as full_config pads W. The
    batch path sizes a rung's W by it (batch._band_for_score), the fused
    loop the group build's warps a pair
    (ops/fused_loop.py::group_size)."""
    if metric == DistanceMetric.GAP_AFFINE:
        den = max(1, gap_extension1)
    elif metric == DistanceMetric.GAP_AFFINE_2P:
        den = max(1, min(gap_extension1, gap_extension2))
    elif metric == DistanceMetric.GAP_LINEAR:
        den = max(1, gap_opening1)
    else:
        den = 1
    reach = min(S, S // den + 1)
    return 2 * (reach + diff) + 2 * (scope + 4) + 8


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _worst_case_score(pen, plen: int, tlen: int) -> int:
    """Upper bound on the WF score of a complete alignment."""
    m = pen.distance_metric
    diff = abs(plen - tlen)
    mn = min(plen, tlen)
    if m in (DistanceMetric.INDEL, DistanceMetric.EDIT):
        return max(plen, tlen) + 1
    if m == DistanceMetric.GAP_LINEAR:
        return mn * pen.mismatch + pen.gap_opening1 * diff + 1
    if m == DistanceMetric.GAP_AFFINE:
        return (mn * pen.mismatch + pen.gap_opening1
                + diff * pen.gap_extension1 + 1)
    i1 = pen.gap_opening1 + diff * pen.gap_extension1
    i2 = pen.gap_opening2 + diff * pen.gap_extension2
    return mn * pen.mismatch + min(i1, i2) + 1


def fused_widths(cfg) -> Tuple[int, int]:
    """Token-row widths (pattern, text) of the fused input layout."""
    return cfg.Lp + cfg.extend_chunk, cfg.Lt + cfg.extend_chunk


def packed_widths(cfg) -> Tuple[int, int]:
    """Byte-row widths (pattern, text) of the 2-bit-packed input layout:
    only the [0, Lp)/[0, Lt) base region is sent, since every position
    past a pair's length decodes to the sentinel anyway."""
    return -(-cfg.Lp // 4), -(-cfg.Lt // 4)


def packed_layout(cfg: EngineConfig) -> str:
    """Static layout of the packed full-scope output vector:

    - "full":    7*B int32 meta [status, final_s, end_k, end_off, n_ops,
                 k_start, fallback] + ops_fwd [B, S_cap] sparse stream.
    - "compact": per-pair 14-byte meta -- [B] status u8, [B] fallback u8,
                 [4, B] int16 (final_s, end_k, n_ops, k_start), [B] int32
                 end_off -- + the 4-bit-packed [B, ops_out//2] compacted
                 op stream. Chosen when ops_out is active and every field
                 fits.
    All multi-byte fields are little-endian.
    """
    if not (0 < cfg.ops_out < cfg.S_cap):
        return "full"
    fits = (cfg.S_cap <= 32767 and cfg.W <= 65534
            and (cfg.Lt + cfg.extend_chunk) <= 2**31 - 1)
    return "compact" if fits else "full"
