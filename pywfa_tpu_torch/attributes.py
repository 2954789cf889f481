"""Aligner attributes: penalties, heuristics, spans, system limits.

Mirrors the semantics of WFA2-lib's attribute/penalty system
(reference: wavefront_attributes.{h,c}, wavefront_penalties.c) re-expressed as
plain dataclasses that the engines treat as *static* configuration.

The port's own copy of `pywfa_tpu/attributes.py`; `from_reference` carries a
JAX-package `AlignerAttributes` across field by field.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .constants import (
    AlignmentScope,
    AlignmentSpan,
    DistanceMetric,
    HeuristicStrategy,
    MemoryMode,
)

INT_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# Match-equivalence classes: the tensor-friendly generalization of the
# reference's lambda match-function mode (reference: wavefront_align.c:
# 150-178 wavefront_align_lambda + wavefront_sequences.c:228-252
# wavefront_sequences_cmp). An arbitrary per-character callback cannot run
# inside a device kernel; instead each byte maps to a 32-bit class mask and
# two characters match iff their masks intersect -- which covers the
# practical lambda uses (IUPAC ambiguity codes, wildcard families,
# case-folding). Tables are registered by NAME so the static engine config
# stays hashable and compile-cache keyed.
# ---------------------------------------------------------------------------

def _build_class_table(classes) -> "np.ndarray":
    import numpy as np
    tbl = np.zeros(256, dtype=np.uint32)
    bit = {}
    for ch, members in classes.items():
        for m in members:
            if m not in bit:
                if len(bit) >= 32:
                    raise ValueError("at most 32 base classes supported")
                bit[m] = 1 << len(bit)
            tbl[ord(ch)] |= bit[m]
    return tbl


# IUPAC nucleotide ambiguity codes (T==U)
_IUPAC = {
    "A": "A", "C": "C", "G": "G", "T": "T", "U": "T",
    "R": "AG", "Y": "CT", "S": "GC", "W": "AT", "K": "GT", "M": "AC",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT",
}

_MATCH_CLASS_TABLES = {"iupac": _build_class_table(_IUPAC)}


def register_match_classes(name: str, classes) -> str:
    """Register a match-equivalence table under `name` and return it.

    `classes` maps each character to an iterable of base symbols; two
    characters match iff they share a base symbol (at most 32 distinct
    base symbols). Alternatively pass a ready [256] uint32 mask array.
    Bytes absent from the table never match anything (including
    themselves). Use via WavefrontAligner(match_classes=name) or
    AlignerAttributes(match_classes=name).
    """
    import numpy as np
    if isinstance(classes, np.ndarray):
        if classes.shape != (256,):
            raise ValueError("mask table must have shape (256,)")
        tbl = classes.astype(np.uint32)
    else:
        tbl = _build_class_table(dict(classes))
    _MATCH_CLASS_TABLES[name] = tbl
    return name


def match_class_table(name: str):
    """The registered [256] uint32 class-mask table for `name`."""
    return _MATCH_CLASS_TABLES[name]


@dataclasses.dataclass(frozen=True)
class Penalties:
    """Internal (post-validation, post-Eizenga) penalty set.

    WFA operates on a model where match == 0; a negative match score is folded
    in via Eizenga's transform: X' = 2X - 2M, O' = 2O, E' = 2E - M
    (reference: wavefront_penalties.c:77-172). `match` preserves the original
    (<=0) match score for translating WF-score back to SW-score.
    """

    distance_metric: DistanceMetric
    match: int = 0
    mismatch: int = 4
    gap_opening1: int = 6
    gap_extension1: int = 2
    gap_opening2: int = -1
    gap_extension2: int = -1
    # gap-extension penalty of the *original* model, used by z-drop
    # (reference: wavefront_penalties.h:67 internal_gap_e)
    internal_gap_e: int = 2
    # original user penalties (pre-Eizenga), kept for CIGAR re-scoring and
    # maxtrim (reference: penalties.linear/affine/affine2p_penalties members)
    orig_match: int = 0
    orig_mismatch: int = 4
    orig_gap_opening1: int = 6
    orig_gap_extension1: int = 2
    orig_gap_opening2: int = -1
    orig_gap_extension2: int = -1

    @property
    def max_score_scope(self) -> int:
        """Score window needed to compute a new wavefront.

        (reference: wavefront_components.c:47-124)
        """
        m = self.distance_metric
        if m in (DistanceMetric.INDEL, DistanceMetric.EDIT):
            return 2
        if m == DistanceMetric.GAP_LINEAR:
            return max(self.mismatch, self.gap_opening1) + 1
        if m == DistanceMetric.GAP_AFFINE:
            return max(self.gap_opening1 + self.gap_extension1, self.mismatch) + 1
        # affine-2p
        indel = max(
            self.gap_opening1 + self.gap_extension1,
            self.gap_opening2 + self.gap_extension2,
        )
        return max(indel, self.mismatch) + 1


def penalties_indel() -> Penalties:
    """(reference: wavefront_penalties.c:39-50)"""
    return Penalties(
        distance_metric=DistanceMetric.INDEL,
        match=0, mismatch=-1,
        gap_opening1=1, gap_extension1=-1,
        gap_opening2=-1, gap_extension2=-1,
        internal_gap_e=1,
    )


def penalties_edit() -> Penalties:
    """(reference: wavefront_penalties.c:51-62)"""
    return Penalties(
        distance_metric=DistanceMetric.EDIT,
        match=0, mismatch=1,
        gap_opening1=1, gap_extension1=-1,
        gap_opening2=-1, gap_extension2=-1,
        internal_gap_e=1,
    )


def penalties_linear(match: int, mismatch: int, indel: int) -> Penalties:
    """Validate + adjust gap-linear penalties (reference: wavefront_penalties.c:63-95)."""
    if match > 0:
        raise ValueError(f"[WFA::Penalties] Match score must be negative or zero (M={match})")
    if mismatch <= 0 or indel <= 0:
        raise ValueError(
            f"[WFA::Penalties] Penalties (X={mismatch},D={indel},I={indel}) must be (X>0,D>0,I>0)"
        )
    if match < 0:
        return Penalties(
            distance_metric=DistanceMetric.GAP_LINEAR,
            match=match,
            mismatch=2 * mismatch - 2 * match,
            gap_opening1=2 * indel - match,
            gap_extension1=-1, gap_opening2=-1, gap_extension2=-1,
            internal_gap_e=indel,
            orig_match=match, orig_mismatch=mismatch,
            orig_gap_opening1=indel, orig_gap_extension1=indel,
        )
    return Penalties(
        distance_metric=DistanceMetric.GAP_LINEAR,
        match=0, mismatch=mismatch,
        gap_opening1=indel,
        gap_extension1=-1, gap_opening2=-1, gap_extension2=-1,
        internal_gap_e=indel,
        orig_match=match, orig_mismatch=mismatch,
        orig_gap_opening1=indel, orig_gap_extension1=indel,
    )


def penalties_affine(match: int, mismatch: int, gap_opening: int, gap_extension: int) -> Penalties:
    """Validate + adjust gap-affine penalties (reference: wavefront_penalties.c:96-133)."""
    if match > 0:
        raise ValueError(f"[WFA::Penalties] Match score must be negative or zero (M={match})")
    if mismatch <= 0 or gap_opening < 0 or gap_extension <= 0:
        raise ValueError(
            f"[WFA::Penalties] Penalties (X={mismatch},O={gap_opening},E={gap_extension}) "
            "must be (X>0,O>=0,E>0)"
        )
    if match < 0:
        return Penalties(
            distance_metric=DistanceMetric.GAP_AFFINE,
            match=match,
            mismatch=2 * mismatch - 2 * match,
            gap_opening1=2 * gap_opening,
            gap_extension1=2 * gap_extension - match,
            gap_opening2=-1, gap_extension2=-1,
            internal_gap_e=gap_extension,
            orig_match=match, orig_mismatch=mismatch,
            orig_gap_opening1=gap_opening, orig_gap_extension1=gap_extension,
        )
    return Penalties(
        distance_metric=DistanceMetric.GAP_AFFINE,
        match=0, mismatch=mismatch,
        gap_opening1=gap_opening, gap_extension1=gap_extension,
        gap_opening2=-1, gap_extension2=-1,
        internal_gap_e=gap_extension,
        orig_match=match, orig_mismatch=mismatch,
        orig_gap_opening1=gap_opening, orig_gap_extension1=gap_extension,
    )


def penalties_affine2p(
    match: int,
    mismatch: int,
    gap_opening1: int,
    gap_extension1: int,
    gap_opening2: int,
    gap_extension2: int,
) -> Penalties:
    """Validate + adjust dual-affine penalties (reference: wavefront_penalties.c:134-180)."""
    if match > 0:
        raise ValueError(f"[WFA::Penalties] Match score must be negative or zero (M={match})")
    if (mismatch <= 0 or gap_opening1 < 0 or gap_extension1 <= 0
            or gap_opening2 < 0 or gap_extension2 <= 0):
        raise ValueError(
            f"[WFA::Penalties] Penalties (X={mismatch},O1={gap_opening1},E1={gap_extension1},"
            f"O2={gap_opening2},E2={gap_extension2}) must be (X>0,O1>=0,E1>0,O2>=0,E2>0)"
        )
    if match < 0:
        return Penalties(
            distance_metric=DistanceMetric.GAP_AFFINE_2P,
            match=match,
            mismatch=2 * mismatch - 2 * match,
            gap_opening1=2 * gap_opening1,
            gap_extension1=2 * gap_extension1 - match,
            gap_opening2=2 * gap_opening2,
            gap_extension2=2 * gap_extension2 - match,
            internal_gap_e=gap_extension1,
            orig_match=match, orig_mismatch=mismatch,
            orig_gap_opening1=gap_opening1, orig_gap_extension1=gap_extension1,
            orig_gap_opening2=gap_opening2, orig_gap_extension2=gap_extension2,
        )
    return Penalties(
        distance_metric=DistanceMetric.GAP_AFFINE_2P,
        match=0, mismatch=mismatch,
        gap_opening1=gap_opening1, gap_extension1=gap_extension1,
        gap_opening2=gap_opening2, gap_extension2=gap_extension2,
        internal_gap_e=gap_extension1,
        orig_match=match, orig_mismatch=mismatch,
        orig_gap_opening1=gap_opening1, orig_gap_extension1=gap_extension1,
        orig_gap_opening2=gap_opening2, orig_gap_extension2=gap_extension2,
    )


def wf_score_to_sw_score(swg_match: int, plen: int, tlen: int, wf_score: int) -> int:
    """Eizenga's score translation (reference: wavefront_penalties.h:73)."""
    return (swg_match * (plen + tlen) - wf_score) // 2


def classic_score(penalties: Penalties, plen: int, tlen: int, wf_score: int) -> int:
    """Translate an internal WF-score to the user-facing score.

    (reference: wavefront_compute.c:108-120 wavefront_compute_classic_score)
    """
    if penalties.distance_metric in (DistanceMetric.INDEL, DistanceMetric.EDIT):
        return wf_score
    swg_match = -penalties.match
    if swg_match == 0:
        return -wf_score
    return wf_score_to_sw_score(swg_match, plen, tlen, wf_score)


def classic_score_batch(penalties: Penalties, plens, tlens, wf_scores):
    """Vectorized classic_score over numpy arrays (identical arithmetic)."""
    import numpy as _np
    wf = _np.asarray(wf_scores, dtype=_np.int64)
    if penalties.distance_metric in (DistanceMetric.INDEL, DistanceMetric.EDIT):
        return wf
    swg_match = -penalties.match
    if swg_match == 0:
        return -wf
    return (swg_match * (_np.asarray(plens, dtype=_np.int64)
                         + _np.asarray(tlens, dtype=_np.int64)) - wf) // 2


@dataclasses.dataclass(frozen=True)
class HeuristicParams:
    """(reference: wavefront_heuristic.h wavefront_heuristic_t)"""

    strategy: HeuristicStrategy = HeuristicStrategy.NONE
    min_wavefront_length: int = 10
    max_distance_threshold: int = 50
    steps_between_cutoffs: int = 1
    xdrop: int = 20
    zdrop: int = 20
    min_k: int = -10
    max_k: int = 10


@dataclasses.dataclass(frozen=True)
class AlignmentForm:
    """Span + ends-free slack (reference: wavefront_attributes.h alignment_form_t)."""

    span: AlignmentSpan = AlignmentSpan.END_TO_END
    extension: bool = False
    pattern_begin_free: int = 0
    pattern_end_free: int = 0
    text_begin_free: int = 0
    text_end_free: int = 0


@dataclasses.dataclass(frozen=True)
class SystemParams:
    """(reference: wavefront_attributes.h alignment_system_t)"""

    max_alignment_steps: int = INT_MAX
    probe_interval_global: int = 3000
    probe_interval_compact: int = 6000
    verbose: int = 0
    check_alignment_correct: bool = False
    max_num_threads: int = 1
    min_offsets_per_thread: int = 500


@dataclasses.dataclass(frozen=True)
class AlignerAttributes:
    """Full aligner configuration (reference: wavefront_attributes.h:114-133).

    Defaults follow WFA2-lib's `wavefront_aligner_attr_default`
    (reference: wavefront_attributes.c:38-100) -- note pywfa overrides
    heuristic to NONE and span to ends-free at its API layer (align.pyx:394-413).
    """

    penalties: Penalties = dataclasses.field(
        default_factory=lambda: penalties_affine(0, 4, 6, 2)
    )
    scope: AlignmentScope = AlignmentScope.COMPUTE_ALIGNMENT
    form: AlignmentForm = dataclasses.field(default_factory=AlignmentForm)
    heuristic: HeuristicParams = dataclasses.field(default_factory=HeuristicParams)
    memory_mode: MemoryMode = MemoryMode.HIGH
    system: SystemParams = dataclasses.field(default_factory=SystemParams)
    # name of a registered match-equivalence table ("" = exact matching);
    # see register_match_classes -- the generalized lambda mode
    match_classes: str = ""


def validate_alignment(attr: AlignerAttributes, plen: int, tlen: int) -> AlignerAttributes:
    """Pre-alignment preset/validation pass.

    (reference: wavefront_align.c:48-103 wavefront_align_presets__checks)
    Returns possibly-updated attributes (extension-mode ends-free autoconfig).
    """
    form = attr.form
    if form.span == AlignmentSpan.ENDS_FREE and form.extension:
        form = dataclasses.replace(
            form,
            pattern_begin_free=0, pattern_end_free=plen,
            text_begin_free=0, text_end_free=tlen,
        )
        attr = dataclasses.replace(attr, form=form)
    is_drop = bool(attr.heuristic.strategy & (HeuristicStrategy.XDROP | HeuristicStrategy.ZDROP))
    if is_drop and attr.penalties.distance_metric in (DistanceMetric.EDIT, DistanceMetric.INDEL):
        raise ValueError(
            "[WFA] Heuristics drops are not compatible with 'edit'/'indel' distance metrics"
        )
    if form.span == AlignmentSpan.ENDS_FREE:
        if (form.pattern_begin_free > plen or form.pattern_end_free > plen
                or form.text_begin_free > tlen or form.text_end_free > tlen):
            raise ValueError(
                "[WFA] Ends-free parameters must be not larger than the sequences "
                f"(P0={form.pattern_begin_free},Pf={form.pattern_end_free},"
                f"T0={form.text_begin_free},Tf={form.text_end_free}) "
                f"where (|P|,|T|)=({plen},{tlen})"
            )
    return attr
