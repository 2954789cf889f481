"""Scalar/NumPy reference WFA engine ("the oracle").

A from-scratch, single-pair implementation of the exact wavefront-alignment
algorithm with the full WFA2-lib feature surface: all five distance models,
end-to-end / ends-free spans, score-only / full-CIGAR scopes, and the complete
heuristic cascade. It exists to (a) back the Python API with a complete,
always-available engine and (b) serve as the ground-truth for property tests
of the batched device engine.

The port's own copy of `pywfa_tpu/oracle.py`, kept identical in behaviour
(tests/test_torch_copies.py holds the two against each other).

Semantics follow WFA2-lib (citations inline, reference paths relative to
WFA2-lib's wavefront/ directory) but the code is an independent
NumPy formulation over dense diagonal bands, not a translation of the C.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .attributes import (
    AlignerAttributes,
    HeuristicParams,
    Penalties,
    classic_score,
    validate_alignment,
)
from .cigar import Cigar, cigar_maxtrim
from .constants import (
    AlignmentScope,
    AlignmentSpan,
    Component,
    DIAGONAL_NULL,
    DistanceMetric,
    HeuristicStrategy,
    OFFSET_NULL,
    STATUS_ALG_COMPLETED,
    STATUS_ALG_PARTIAL,
    STATUS_END_REACHED,
    STATUS_END_UNREACHABLE,
    STATUS_MAX_STEPS_REACHED,
    STATUS_OK,
    BT_M,
    BT_I1_OPEN,
    BT_I1_EXT,
    BT_I2_OPEN,
    BT_I2_EXT,
    BT_D1_OPEN,
    BT_D1_EXT,
    BT_D2_OPEN,
    BT_D2_EXT,
)

INT_MAX = 2**31 - 1
# offsets below this are "unreachable" sentinels (NULL plus bounded creep)
_NULL_THRESHOLD = OFFSET_NULL // 2


def _trunc_div2(x: int) -> int:
    """C-style integer division by 2 (rounds toward zero)."""
    return -((-x) // 2) if x < 0 else x // 2


class _WF:
    """One wavefront: offsets over diagonals, with a band [lo, hi].

    Invariant (replacing WFA2-lib's lazy end-initialization,
    wavefront_compute.c:490-567): every cell outside [lo, hi] holds
    OFFSET_NULL, so shifted reads need no bounds logic.
    """

    __slots__ = ("off", "lo", "hi", "null")

    def __init__(self, off: np.ndarray, lo: int, hi: int, null: bool = False):
        self.off = off
        self.lo = lo
        self.hi = hi
        self.null = null or lo > hi

    def clamp_outside_to_null(self, koff: int) -> None:
        """Re-establish the NULL-outside-band invariant after lo/hi shrink."""
        self.off[: self.lo + koff] = OFFSET_NULL
        self.off[self.hi + koff + 1:] = OFFSET_NULL


@dataclasses.dataclass
class OracleResult:
    status: int
    score: int          # user-facing score (cigar score)
    ops: str            # per-base op chars, '' when score-only/failed
    end_v: int
    end_h: int
    wf_score: int       # internal WF score reached
    dropped: bool


class OracleAligner:
    """Single-pair exact WFA with the reference's full behavior surface."""

    def __init__(self, attr: AlignerAttributes, wildcard: Optional[int] = None,
                 keep_wavefronts: bool = False):
        self.attr = attr
        self.wildcard = wildcard
        # optional utils.plot.WavefrontPlot recording band evolution
        # (analog of wavefront_plot.c)
        self.plot = None
        # retain the run (all wavefront contents) for debug display
        # (reference: wavefront_display.c via utils.display.print_wavefronts)
        self.keep_wavefronts = keep_wavefronts
        self.last_run = None

    # ------------------------------------------------------------------
    def align(self, pattern: bytes, text: bytes) -> OracleResult:
        attr = validate_alignment(self.attr, len(pattern), len(text))
        run = _Run(attr, pattern, text, self.wildcard)
        run.plot = self.plot
        result = run.run()
        if (self.keep_wavefronts
                or result.status == STATUS_MAX_STEPS_REACHED):
            # retain a MAX_STEPS-paused run so align_resume can continue
            # it (reference: wavefront_align.c:245-266)
            self.last_run = run
        return result

    def align_resume(self, max_steps: int) -> OracleResult:
        """Continue the last MAX_STEPS-paused alignment with a raised cap
        (reference: wavefront_align.c:245-266 wavefront_align_resume)."""
        if (self.last_run is None
                or self.last_run.status != STATUS_MAX_STEPS_REACHED):
            raise ValueError("no MAX_STEPS-paused alignment to resume")
        return self.last_run.resume(max_steps)


class _Run:
    def __init__(self, attr: AlignerAttributes, pattern: bytes, text: bytes,
                 wildcard: Optional[int] = None):
        self.wildcard = wildcard
        self.plot = None
        self.attr = attr
        self.pen: Penalties = attr.penalties
        self.metric = self.pen.distance_metric
        self.plen = len(pattern)
        self.tlen = len(text)
        self.pat = np.frombuffer(pattern, dtype=np.uint8).astype(np.int16)
        self.txt = np.frombuffer(text, dtype=np.uint8).astype(np.int16)
        # match-equivalence classes (generalized lambda mode; reference:
        # wavefront_sequences.c:228-252): chars match iff masks intersect
        self.cls_pat = self.cls_txt = None
        if getattr(attr, "match_classes", ""):
            from .attributes import match_class_table
            tbl = match_class_table(attr.match_classes).astype(np.int64)
            self.cls_pat = tbl[self.pat]
            self.cls_txt = tbl[self.txt]
        self.scope = attr.scope
        self.form = attr.form
        self.heur = attr.heuristic
        self.max_score_scope = self.pen.max_score_scope
        # diagonal band array layout: index(k) = k + koff
        self.koff = self.plen + 4
        self.span_len = self.plen + self.tlen + 9
        self.karr = np.arange(self.span_len, dtype=np.int64) - self.koff
        # wavefront storage: comp -> {score: _WF or None}
        self.wfs: Dict[Component, Dict[int, Optional[_WF]]] = {
            c: {} for c in Component
        }
        # status
        self.status = STATUS_OK
        self.status_score = 0
        self.num_null_steps = 0
        self.end_pos: Tuple[int, int, int] = (-1, DIAGONAL_NULL, OFFSET_NULL)
        self.dropped = False
        self.cigar = Cigar()
        # heuristic internals (reference: wavefront_heuristic.c:114-121)
        self.h_steps_wait = self.heur.steps_between_cutoffs
        self.h_max_sw_score = 0
        self.h_max_sw_score_k = DIAGONAL_NULL
        self.h_max_sw_score_offset = OFFSET_NULL
        self.h_max_wf_score = 0

    # -- wavefront helpers ---------------------------------------------
    def _new_off(self) -> np.ndarray:
        return np.full(self.span_len, OFFSET_NULL, dtype=np.int64)

    def _get(self, comp: Component, score: int) -> Optional[_WF]:
        if score < 0:
            return None
        return self.wfs[comp].get(score)

    def _get_off(self, comp: Component, score: int) -> np.ndarray:
        """Offsets for compute input; None/null wavefronts read as all-NULL.

        (reference: wavefront_compute.c:258-297 victim/null substitution)
        """
        wf = self._get(comp, score)
        if wf is None or wf.null:
            return self._null_off
        return wf.off

    # ------------------------------------------------------------------
    def run(self) -> OracleResult:
        self._null_off = self._new_off()
        self._init_wf0()
        self._plot_record(0)
        self.s = 0
        return self._loop()

    def resume(self, max_steps: int) -> OracleResult:
        """Continue a MAX_STEPS-paused run with a raised cap.

        All wavefront state is retained by this object, so continuation
        picks up exactly where the loop paused (extension of the paused
        score) -- the scalar analog of the reference's experimental
        resume (reference: wavefront_align.c:245-266).
        """
        if self.status != STATUS_MAX_STEPS_REACHED:
            raise ValueError("resume requires a MAX_STEPS_REACHED run "
                             f"(status is {self.status})")
        self.attr = dataclasses.replace(
            self.attr, system=dataclasses.replace(
                self.attr.system, max_alignment_steps=max_steps))
        self.status = STATUS_OK
        self.cigar.score = 0
        return self._loop()

    def _loop(self) -> OracleResult:
        end2end = self.form.span == AlignmentSpan.END_TO_END
        max_steps = self.attr.system.max_alignment_steps
        s = self.s
        while True:
            finished = self._extend(s, end2end)
            if finished:
                if self.status in (STATUS_END_REACHED, STATUS_END_UNREACHABLE):
                    self._terminate(s)
                break
            s += 1
            self._compute(s)
            self._plot_record(s)
            # max-steps probe (reference: wavefront_unialign.c:100-107)
            if s >= max_steps:
                self.cigar.score = -max_steps
                self.status = STATUS_MAX_STEPS_REACHED
                self.status_score = s
                break
        self.s = s
        return OracleResult(
            status=self.status,
            score=self.cigar.score,
            ops=self.cigar.ops,
            end_v=self.cigar.end_v,
            end_h=self.cigar.end_h,
            wf_score=self.status_score,
            dropped=self.dropped,
        )

    def _plot_record(self, s: int) -> None:
        """Record all live wavefront components for plotting (reference:
        wavefront_plot.c:186-238 plots M plus I1/D1[/I2/D2] per metric,
        hooked at wavefront_unialign.c:269-270 and aligner init)."""
        if self.plot is None:
            return
        comp_names = {Component.I1: "I1", Component.D1: "D1",
                      Component.I2: "I2", Component.D2: "D2"}
        for comp in Component:
            wf = self._get(comp, s)
            if wf is None or wf.null:
                continue
            sl = slice(wf.lo + self.koff, wf.hi + self.koff + 1)
            offs = np.asarray(wf.off[sl])
            if comp == Component.M:
                self.plot.record(s, wf.lo, wf.hi, offs)
            elif hasattr(self.plot, "record_component"):
                self.plot.record_component(comp_names[comp], s, wf.lo,
                                           wf.hi, offs)

    # -- WF0 seeding (reference: wavefront_aligner.c:251-310) -----------
    def _init_wf0(self) -> None:
        endsfree = self.form.span == AlignmentSpan.ENDS_FREE
        seeded = endsfree and self.pen.match == 0
        hi = self.form.text_begin_free if seeded else 0
        lo = -self.form.pattern_begin_free if seeded else 0
        off = self._new_off()
        off[self.koff] = 0
        if seeded:
            for h in range(1, self.form.text_begin_free + 1):
                off[h + self.koff] = h
            for v in range(1, self.form.pattern_begin_free + 1):
                off[-v + self.koff] = 0
        self.wfs[Component.M][0] = _WF(off, lo, hi)

    # -- extension (reference: wavefront_extend*.c) ---------------------
    def _extend(self, s: int, end2end: bool) -> bool:
        wf = self._get(Component.M, s)
        if wf is None:
            # feasibility probe for heuristic dead-ends
            # (reference: wavefront_extend.c:100-106)
            if self.num_null_steps > self.max_score_scope:
                self.status = STATUS_END_UNREACHABLE
                self.status_score = s
                return True
            return False
        if not wf.null:
            self._extend_matches(wf)
        if end2end:
            if self._termination_end2end(wf, s):
                self.status = STATUS_END_REACHED
                self.status_score = s
                return True
        else:
            if not wf.null and self._termination_endsfree(wf, s):
                self.status = STATUS_END_REACHED
                self.status_score = s
                return True
        if self.heur.strategy != HeuristicStrategy.NONE:
            if self._heuristic_cutoff(s):
                self.status = STATUS_END_UNREACHABLE
                self.status_score = s
                return True
        return False

    def _extend_matches(self, wf: _WF) -> None:
        """Greedy LCP extension of every diagonal, vectorized over the band.

        (reference: wavefront_extend_kernels.c:96-163; our formulation is a
        lockstep advance-until-fixed-point rather than per-diagonal scalar LCP)
        """
        sl = slice(wf.lo + self.koff, wf.hi + self.koff + 1)
        o = wf.off[sl]
        k = self.karr[sl]
        active = o > _NULL_THRESHOLD
        while active.any():
            v = o - k
            h = o
            inb = active & (v >= 0) & (v < self.plen) & (h >= 0) & (h < self.tlen)
            if not inb.any():
                break
            vi = np.where(inb, v, 0)
            hi_ = np.where(inb, h, 0)
            if self.cls_pat is not None:
                eq = (self.cls_pat[vi] & self.cls_txt[hi_]) != 0
            else:
                eq = self.pat[vi] == self.txt[hi_]
                if self.wildcard is not None:
                    # single-wildcard matching (reference: align.pyx:297-304)
                    eq = eq | (self.pat[vi] == self.wildcard) \
                            | (self.txt[hi_] == self.wildcard)
            m = inb & eq
            if not m.any():
                break
            o = np.where(m, o + 1, o)
            active = m
        wf.off[sl] = o

    # -- termination (reference: wavefront_termination.c) ---------------
    def _termination_end2end(self, wf: _WF, s: int) -> bool:
        ak = self.tlen - self.plen
        if wf.lo > ak or ak > wf.hi:
            return False
        if wf.off[ak + self.koff] < self.tlen:
            return False
        self.end_pos = (s, ak, self.tlen)
        return True

    def _termination_endsfree(self, wf: _WF, s: int) -> bool:
        sl = slice(wf.lo + self.koff, wf.hi + self.koff + 1)
        o = wf.off[sl]
        k = self.karr[sl]
        valid = o > _NULL_THRESHOLD
        v = o - k
        h = o
        done_h = valid & (h >= self.tlen) & (
            self.plen - v <= self.form.pattern_end_free)
        done_v = valid & (v >= self.plen) & (
            self.tlen - h <= self.form.text_end_free)
        done = done_h | done_v
        if not done.any():
            return False
        i = int(np.argmax(done))  # lowest-k hit wins (C scans lo..hi)
        kk = wf.lo + i
        self.end_pos = (s, kk, int(wf.off[kk + self.koff]))
        return True

    # -- compute dispatch (reference: wavefront_unialign.c:63-81) -------
    def _compute(self, s: int) -> None:
        m = self.metric
        if m in (DistanceMetric.INDEL, DistanceMetric.EDIT):
            self._compute_edit(s)
        elif m == DistanceMetric.GAP_LINEAR:
            self._compute_linear(s)
        elif m == DistanceMetric.GAP_AFFINE:
            self._compute_affine(s)
        else:
            self._compute_affine2p(s)

    def _bounds_null(self, vals: np.ndarray, k: np.ndarray) -> np.ndarray:
        """NULL-out offsets whose (v,h) exits the DP matrix.

        (reference: wavefront_compute_affine.c:79-84 unsigned-compare trick)
        """
        h = vals
        v = vals - k
        bad = (h < 0) | (h > self.tlen) | (v < 0) | (v > self.plen)
        return np.where(bad, OFFSET_NULL, vals)

    def _shift(self, off: np.ndarray, dk: int) -> np.ndarray:
        """off[k+dk] viewed at k, NULL-padded."""
        out = np.full_like(off, OFFSET_NULL)
        if dk == 0:
            return off.copy()
        if dk > 0:
            out[:-dk] = off[dk:]
        else:
            out[-dk:] = off[:dk]
        return out

    def _store_outputs(self, s: int, lo: int, hi: int,
                       outs: Dict[Component, Optional[np.ndarray]]) -> None:
        """Clamp each produced band, install, trim, and run ends-processing.

        (reference: wavefront_compute.c allocate/trim/process_ends)
        """
        for comp, arr in outs.items():
            if arr is None:
                self.wfs[comp][s] = None
                continue
            full = self._new_off()
            full[lo + self.koff: hi + self.koff + 1] = \
                arr[lo + self.koff: hi + self.koff + 1]
            self.wfs[comp][s] = _WF(full, lo, hi)
        # ends-free per-score boundary seeding when match != 0
        # (reference: wavefront_compute.c:124-254, process_ends :607-624)
        if self._endsfree_required(s):
            mwf = self.wfs[Component.M][s]
            if mwf is not None:
                self._endsfree_init(mwf, s)
        for comp, arr in outs.items():
            wf = self.wfs[comp].get(s)
            if wf is not None:
                self._trim_ends(wf)

    def _trim_ends(self, wf: _WF) -> None:
        """(reference: wavefront_compute.c:571-624)"""
        k = wf.hi
        while k >= wf.lo:
            o = wf.off[k + self.koff]
            h = o
            v = o - k
            if 0 <= h <= self.tlen and 0 <= v <= self.plen:
                break
            k -= 1
        wf.hi = k
        k = wf.lo
        while k <= wf.hi:
            o = wf.off[k + self.koff]
            h = o
            v = o - k
            if 0 <= h <= self.tlen and 0 <= v <= self.plen:
                break
            k += 1
        wf.lo = k
        wf.null = wf.lo > wf.hi
        wf.clamp_outside_to_null(self.koff)

    # -- ends-free (match != 0) boundary seeding ------------------------
    def _endsfree_required(self, s: int) -> bool:
        if self.pen.match == 0:
            return False
        if self.form.span != AlignmentSpan.ENDS_FREE:
            return False
        if self.form.text_begin_free == 0 and self.form.pattern_begin_free == 0:
            return False
        return s % (-self.pen.match) == 0

    def _endsfree_init(self, wf: _WF, s: int) -> None:
        """(reference: wavefront_compute.c:163-211 wavefront_compute_endsfree_init)"""
        ek = s // (-self.pen.match)
        if self.form.text_begin_free >= ek:
            kk = ek + self.koff
            if wf.hi >= ek:
                if wf.off[kk] <= ek:
                    wf.off[kk] = ek
            else:
                wf.off[wf.hi + self.koff + 1: kk] = OFFSET_NULL
                wf.off[kk] = ek
                wf.hi = ek
        if self.form.pattern_begin_free >= ek:
            kk = -ek + self.koff
            if wf.lo <= -ek:
                if wf.off[kk] <= 0:
                    wf.off[kk] = 0
            else:
                wf.off[kk] = 0
                wf.off[kk + 1: wf.lo + self.koff] = OFFSET_NULL
                wf.lo = -ek
        wf.null = wf.lo > wf.hi

    def _allocate_null(self, s: int, comps: List[Component]) -> None:
        """Null score-step (reference: wavefront_compute.c:377-402)."""
        if self._endsfree_required(s):
            # endsfree seeds alone form the M wavefront
            # (reference: wavefront_compute.c:212-254)
            ek = s // (-self.pen.match)
            tbf = self.form.text_begin_free >= ek
            pbf = self.form.pattern_begin_free >= ek
            if tbf and pbf:
                lo, hi = -ek, ek
            elif tbf:
                lo, hi = ek, ek
            elif pbf:
                lo, hi = -ek, -ek
            else:
                lo, hi = 0, 0
            off = self._new_off()
            if tbf:
                off[ek + self.koff] = ek
            if pbf:
                off[-ek + self.koff] = 0
            self.wfs[Component.M][s] = _WF(off, lo, hi)
        else:
            self.wfs[Component.M][s] = None
        for c in comps:
            if c != Component.M:
                self.wfs[c][s] = None

    # -- per-metric compute ---------------------------------------------
    def _compute_edit(self, s: int) -> None:
        """(reference: wavefront_compute_edit.c:330-374)"""
        prev = self._get(Component.M, s - 1)
        assert prev is not None
        lo = prev.lo - 1
        hi = prev.hi + 1
        p = prev.off
        ins = self._shift(p, -1) + 1
        dele = self._shift(p, +1)
        if self.metric == DistanceMetric.INDEL:
            vals = np.maximum(dele, ins)
        else:
            vals = np.maximum(dele, np.maximum(ins - 1, p) + 1)
        vals = self._bounds_null(vals, self.karr)
        self._store_outputs(s, lo, hi, {Component.M: vals})
        wf = self.wfs[Component.M][s]
        if wf is not None and wf.null:
            self.num_null_steps = INT_MAX
        if (self.form.span == AlignmentSpan.END_TO_END
                and self.metric == DistanceMetric.EDIT and wf is not None):
            self._edit_exact_prune(wf)

    def _edit_exact_prune(self, wf: _WF) -> None:
        """Heng Li's exact pruning for edit distance
        (reference: wavefront_compute_edit.c:219-275)."""
        lo, hi = wf.lo, wf.hi
        if hi - lo + 1 < 1000:
            return
        sample_k = lo + (hi - lo) // 2
        sample_off = wf.off[sample_k + self.koff]
        if sample_off < 0:
            return

        def worst(k: int, o: int) -> int:
            return max(self.plen - (o - k), self.tlen - o)

        def best(k: int, o: int) -> int:
            lv = self.plen - (o - k)
            lh = self.tlen - o
            return lv - lh if lv >= lh else lh - lv

        smax_sample = worst(sample_k, int(sample_off))
        if (best(lo, int(wf.off[lo + self.koff])) <= smax_sample
                and best(hi, int(wf.off[hi + self.koff])) <= smax_sample):
            return
        sl = slice(lo + self.koff, hi + self.koff + 1)
        o = wf.off[sl]
        k = self.karr[sl]
        lv = self.plen - (o - k)
        lh = self.tlen - o
        worst_all = np.maximum(lv, lh)
        valid = o >= 0
        if not valid.any():
            return
        score_min_worst = int(worst_all[valid].min())
        best_all = np.abs(lv - lh)
        keep = best_all <= score_min_worst
        lo_r = lo
        for i in range(hi - lo + 1):
            if keep[i]:
                break
            lo_r += 1
        wf.lo = lo_r
        hi_r = hi
        for i in range(hi - lo, -1, -1):
            if lo + i <= lo_r:
                break
            if keep[i]:
                break
            hi_r -= 1
        wf.hi = hi_r
        wf.null = wf.lo > wf.hi
        wf.clamp_outside_to_null(self.koff)

    def _compute_linear(self, s: int) -> None:
        """(reference: wavefront_compute_linear.c:44-76,150-197)"""
        pen = self.pen
        misms_wf = self._get(Component.M, s - pen.mismatch)
        open1_wf = self._get(Component.M, s - pen.gap_opening1)

        def null(wf):
            return wf is None or wf.null

        if null(misms_wf) and null(open1_wf):
            self.num_null_steps += 1
            self._allocate_null(s, [Component.M])
            return
        self.num_null_steps = 0
        m_misms = self._get_off(Component.M, s - pen.mismatch)
        m_open1 = self._get_off(Component.M, s - pen.gap_opening1)
        lo, hi = self._limits_union([
            (misms_wf, 0), (open1_wf, 1),
        ])
        ins1 = self._shift(m_open1, -1)
        del1 = self._shift(m_open1, +1)
        vals = np.maximum(del1, np.maximum(m_misms, ins1) + 1)
        vals = self._bounds_null(vals, self.karr)
        self._store_outputs(s, lo, hi, {Component.M: vals})

    def _limits_union(self, parts) -> Tuple[int, int]:
        """Union of input bands, each widened per its role.

        parts: list of (wf_or_None, widen) where widen is the +-pad applied
        to that input's band (reference: wavefront_compute.c:40-86).
        Null inputs contribute the null-wavefront band, which WFA2-lib sizes
        at least [-1024,1024]; since min/max-union with a huge band would be
        wrong, the C code relies on null inputs having lo=1,hi=-1 via
        wavefront_null (lo>hi so it never widens) -- we skip them entirely.
        """
        lo = None
        hi = None
        for wf, widen in parts:
            if wf is None or wf.null:
                continue
            l = wf.lo - widen
            h = wf.hi + widen
            lo = l if lo is None else min(lo, l)
            hi = h if hi is None else max(hi, h)
        assert lo is not None
        return lo, hi

    def _compute_affine(self, s: int) -> None:
        """(reference: wavefront_compute_affine.c:44-86,229-260)"""
        pen = self.pen
        s_x = s - pen.mismatch
        s_o1 = s - pen.gap_opening1 - pen.gap_extension1
        s_e1 = s - pen.gap_extension1
        misms_wf = self._get(Component.M, s_x)
        open1_wf = self._get(Component.M, s_o1)
        i1_wf = self._get(Component.I1, s_e1)
        d1_wf = self._get(Component.D1, s_e1)

        def null(wf):
            return wf is None or wf.null

        if null(misms_wf) and null(open1_wf) and null(i1_wf) and null(d1_wf):
            self.num_null_steps += 1
            self._allocate_null(s, [Component.M, Component.I1, Component.D1])
            return
        self.num_null_steps = 0
        m_misms = self._get_off(Component.M, s_x)
        m_open1 = self._get_off(Component.M, s_o1)
        i1_ext = self._get_off(Component.I1, s_e1)
        d1_ext = self._get_off(Component.D1, s_e1)
        # input limits (reference: wavefront_compute.c:40-72)
        lo, hi = self._limits_union([
            (misms_wf, 0), (open1_wf, 1), (i1_wf, 1), (d1_wf, 1),
        ])
        ins1 = np.maximum(self._shift(m_open1, -1), self._shift(i1_ext, -1)) + 1
        del1 = np.maximum(self._shift(m_open1, +1), self._shift(d1_ext, +1))
        mis = m_misms + 1
        mvals = np.maximum(del1, np.maximum(mis, ins1))
        mvals = self._bounds_null(mvals, self.karr)
        # I/D outputs are only materialized when any of their inputs exist
        # (reference: wavefront_compute.c:438-459 victim substitution)
        i1_out = ins1 if (not null(open1_wf) or not null(i1_wf)) else None
        d1_out = del1 if (not null(open1_wf) or not null(d1_wf)) else None
        self._store_outputs(s, lo, hi, {
            Component.M: mvals, Component.I1: i1_out, Component.D1: d1_out,
        })

    def _compute_affine2p(self, s: int) -> None:
        """(reference: wavefront_compute_affine2p.c:45-106,335-369)"""
        pen = self.pen
        s_x = s - pen.mismatch
        s_o1 = s - pen.gap_opening1 - pen.gap_extension1
        s_e1 = s - pen.gap_extension1
        s_o2 = s - pen.gap_opening2 - pen.gap_extension2
        s_e2 = s - pen.gap_extension2
        misms_wf = self._get(Component.M, s_x)
        open1_wf = self._get(Component.M, s_o1)
        i1_wf = self._get(Component.I1, s_e1)
        d1_wf = self._get(Component.D1, s_e1)
        open2_wf = self._get(Component.M, s_o2)
        i2_wf = self._get(Component.I2, s_e2)
        d2_wf = self._get(Component.D2, s_e2)

        def null(wf):
            return wf is None or wf.null

        if (null(misms_wf) and null(open1_wf) and null(open2_wf)
                and null(i1_wf) and null(d1_wf) and null(i2_wf) and null(d2_wf)):
            self.num_null_steps += 1
            self._allocate_null(
                s, [Component.M, Component.I1, Component.D1,
                    Component.I2, Component.D2])
            return
        self.num_null_steps = 0
        m_misms = self._get_off(Component.M, s_x)
        m_open1 = self._get_off(Component.M, s_o1)
        i1_ext = self._get_off(Component.I1, s_e1)
        d1_ext = self._get_off(Component.D1, s_e1)
        m_open2 = self._get_off(Component.M, s_o2)
        i2_ext = self._get_off(Component.I2, s_e2)
        d2_ext = self._get_off(Component.D2, s_e2)
        lo, hi = self._limits_union([
            (misms_wf, 0), (open1_wf, 1), (i1_wf, 1), (d1_wf, 1),
            (open2_wf, 1), (i2_wf, 1), (d2_wf, 1),
        ])
        ins1 = np.maximum(self._shift(m_open1, -1), self._shift(i1_ext, -1)) + 1
        ins2 = np.maximum(self._shift(m_open2, -1), self._shift(i2_ext, -1)) + 1
        del1 = np.maximum(self._shift(m_open1, +1), self._shift(d1_ext, +1))
        del2 = np.maximum(self._shift(m_open2, +1), self._shift(d2_ext, +1))
        mis = m_misms + 1
        mvals = np.maximum(np.maximum(del1, del2),
                           np.maximum(mis, np.maximum(ins1, ins2)))
        mvals = self._bounds_null(mvals, self.karr)
        i1_out = ins1 if (not null(open1_wf) or not null(i1_wf)) else None
        d1_out = del1 if (not null(open1_wf) or not null(d1_wf)) else None
        i2_out = ins2 if (not null(open2_wf) or not null(i2_wf)) else None
        d2_out = del2 if (not null(open2_wf) or not null(d2_wf)) else None
        self._store_outputs(s, lo, hi, {
            Component.M: mvals, Component.I1: i1_out, Component.D1: d1_out,
            Component.I2: i2_out, Component.D2: d2_out,
        })

    # -- heuristics (reference: wavefront_heuristic.c) -------------------
    def _heuristic_cutoff(self, s: int) -> bool:
        """Cascade dispatcher (reference: wavefront_heuristic.c:509-567).
        Returns True if the whole alignment is dropped (z-drop)."""
        mwf = self._get(Component.M, s)
        if mwf is None or mwf.lo > mwf.hi:
            return False
        self.h_steps_wait -= 1
        hi_base, lo_base = mwf.hi, mwf.lo
        strat = self.heur.strategy
        if strat & HeuristicStrategy.WFADAPTIVE:
            self._h_wfadaptive(mwf, wfmash_mode=False)
        elif strat & HeuristicStrategy.WFMASH:
            self._h_wfadaptive(mwf, wfmash_mode=True)
        if strat & HeuristicStrategy.XDROP:
            self._h_xdrop(mwf, s)
        elif strat & HeuristicStrategy.ZDROP:
            if self._h_zdrop(mwf, s):
                return True
        if strat & HeuristicStrategy.BANDED_STATIC:
            if mwf.lo < self.heur.min_k:
                mwf.lo = self.heur.min_k
            if mwf.hi > self.heur.max_k:
                mwf.hi = self.heur.max_k
        elif strat & HeuristicStrategy.BANDED_ADAPTIVE:
            self._h_banded_adaptive(mwf)
        if lo_base == mwf.lo and hi_base == mwf.hi:
            return False
        if mwf.lo > mwf.hi:
            mwf.null = True
        mwf.clamp_outside_to_null(self.koff)
        # equate I/D bands to M's (reference: wavefront_heuristic.c:161-172)
        if self.metric in (DistanceMetric.GAP_AFFINE, DistanceMetric.GAP_AFFINE_2P):
            for comp in (Component.I1, Component.D1):
                self._h_equate(self.wfs[comp].get(s), mwf)
            if self.metric == DistanceMetric.GAP_AFFINE_2P:
                for comp in (Component.I2, Component.D2):
                    self._h_equate(self.wfs[comp].get(s), mwf)
        return False

    def _h_equate(self, dst: Optional[_WF], src: _WF) -> None:
        if dst is None:
            return
        if src.lo > dst.lo:
            dst.lo = src.lo
        if src.hi < dst.hi:
            dst.hi = src.hi
        if dst.lo > dst.hi:
            dst.null = True
        dst.clamp_outside_to_null(self.koff)

    def _wf_distances(self, mwf: _WF, weighted: bool) -> Tuple[np.ndarray, int]:
        sl = slice(mwf.lo + self.koff, mwf.hi + self.koff + 1)
        o = mwf.off[sl]
        k = self.karr[sl]
        left_v = self.plen - (o - k)
        left_h = self.tlen - o
        if weighted:
            # wfmash length-weighted distance (reference: :134-145)
            mfactor = int((self.plen + self.tlen) / 2)
            lv = ((self.plen - (o - k)).astype(np.float32)
                  / self.plen * mfactor).astype(np.int64)
            lh = ((self.tlen - o).astype(np.float32)
                  / self.tlen * mfactor).astype(np.int64)
            dist = np.maximum(lv, lh)
        else:
            dist = np.maximum(left_v, left_h)
        dist = np.where(o >= 0, dist, -OFFSET_NULL)
        min_distance = int(min(max(self.plen, self.tlen), dist.min()))
        return dist, min_distance

    def _h_wfadaptive(self, mwf: _WF, wfmash_mode: bool) -> None:
        """(reference: wavefront_heuristic.c:176-293)"""
        if self.h_steps_wait > 0:
            return
        if (mwf.hi - mwf.lo + 1) < self.heur.min_wavefront_length:
            return
        dist, min_distance = self._wf_distances(mwf, wfmash_mode)
        thr = self.heur.max_distance_threshold
        ak = self.tlen - self.plen  # preserve target diagonal
        # reduce from bottom: k in [lo, min(ak, hi))
        top_limit = min(ak, mwf.hi)
        lo_r = mwf.lo
        for k in range(mwf.lo, top_limit):
            if dist[k - mwf.lo] - min_distance <= thr:
                break
            lo_r += 1
        new_lo = lo_r
        # reduce from top: k in (max(ak, new_lo), hi]
        bottom_limit = max(ak, new_lo)
        hi_r = mwf.hi
        for k in range(mwf.hi, bottom_limit, -1):
            if dist[k - mwf.lo] - min_distance <= thr:
                break
            hi_r -= 1
        mwf.lo = new_lo
        mwf.hi = hi_r
        self.h_steps_wait = self.heur.steps_between_cutoffs

    def _sw_scores(self, mwf: _WF, wf_score: int):
        """(reference: wavefront_heuristic.c:303-337)"""
        swg_match = -self.pen.match if self.pen.match != 0 else 1
        sl = slice(mwf.lo + self.koff, mwf.hi + self.koff + 1)
        o = mwf.off[sl]
        k = self.karr[sl]
        v = o - k
        h = o
        sw = np.array([
            _trunc_div2(int(swg_match) * (int(vv) + int(hh)) - wf_score)
            for vv, hh in zip(v, h)
        ], dtype=np.int64)
        valid = o >= 0
        if valid.any():
            idx = int(np.argmax(np.where(valid, sw, np.iinfo(np.int64).min)))
            cmax = int(sw[idx])
            cmax_k = mwf.lo + idx
            cmax_off = int(o[idx])
        else:
            cmax, cmax_k, cmax_off = -(2**62), 0, 0
        return sw, valid, cmax, cmax_k, cmax_off

    def _h_xdrop(self, mwf: _WF, s: int) -> None:
        """(reference: wavefront_heuristic.c:338-383)"""
        if self.h_steps_wait > 0:
            return
        sw, valid, cmax, cmax_k, _ = self._sw_scores(mwf, s)
        xdrop = self.heur.xdrop
        max_sw = self.h_max_sw_score
        if self.h_max_sw_score_k != DIAGONAL_NULL:
            lo, hi = mwf.lo, mwf.hi
            k = lo
            while k <= hi:
                i = k - lo
                if not valid[i]:
                    k += 1
                    continue
                if max_sw - int(sw[i]) < xdrop:
                    break
                k += 1
            mwf.lo = k
            k = hi
            while k >= mwf.lo:
                i = k - lo
                if not valid[i]:
                    k -= 1
                    continue
                if max_sw - int(sw[i]) < xdrop:
                    break
                k -= 1
            mwf.hi = k
            if cmax > self.h_max_sw_score:
                self.h_max_sw_score = cmax
                self.h_max_sw_score_k = cmax_k
        else:
            self.h_max_sw_score = cmax
            self.h_max_sw_score_k = cmax_k
        self.h_steps_wait = self.heur.steps_between_cutoffs

    def _h_zdrop(self, mwf: _WF, s: int) -> bool:
        """(reference: wavefront_heuristic.c:384-450). True => drop alignment."""
        if self.h_steps_wait > 0:
            return False
        sw, valid, cmax, cmax_k, cmax_off = self._sw_scores(mwf, s)
        zdrop = self.heur.zdrop
        if self.h_max_sw_score_k != DIAGONAL_NULL:
            if cmax > self.h_max_sw_score:
                self.h_max_sw_score = cmax
                self.h_max_wf_score = s
                self.h_max_sw_score_k = cmax_k
                self.h_max_sw_score_offset = cmax_off
            else:
                if self.h_max_sw_score - cmax > zdrop:
                    self.end_pos = (
                        self.h_max_wf_score,
                        self.h_max_sw_score_k,
                        self.h_max_sw_score_offset,
                    )
                    return True
        else:
            self.h_max_sw_score = cmax
            self.h_max_wf_score = s
            self.h_max_sw_score_k = cmax_k
            self.h_max_sw_score_offset = cmax_off
        self.h_steps_wait = self.heur.steps_between_cutoffs
        return False

    def _h_banded_adaptive(self, mwf: _WF) -> None:
        """(reference: wavefront_heuristic.c:463-506)"""
        if self.h_steps_wait > 0:
            return
        lo, hi = mwf.lo, mwf.hi
        wf_length = hi - lo + 1
        if wf_length < 4:
            return
        max_wf_length = self.heur.max_k - self.heur.min_k + 1
        if wf_length > max_wf_length:
            def dist(k: int) -> int:
                o = int(mwf.off[k + self.koff])
                if o < 0:
                    return -OFFSET_NULL
                return max(self.plen - (o - k), self.tlen - o)

            leeway = (wf_length - max_wf_length) // 2
            quarter = wf_length // 4
            d0 = dist(lo)
            d1 = dist(lo + quarter)
            d2 = dist(lo + 2 * quarter)
            d3 = dist(hi)
            new_lo = lo
            if d0 > d3:
                new_lo += leeway
            if d1 > d2:
                new_lo += leeway
            mwf.lo = max(new_lo, lo)
            mwf.hi = min(new_lo + max_wf_length - 1, hi)
        self.h_steps_wait = self.heur.steps_between_cutoffs

    # -- backtrace (reference: wavefront_backtrace.c) --------------------
    def _bt_cand(self, comp: Component, score: int, k: int, delta: int,
                 bt_type: int) -> int:
        """Packed (offset<<4)|type candidate; OFFSET_NULL when unreachable.
        (reference: wavefront_backtrace.c:64-220 trace-patch helpers)"""
        if score < 0:
            return OFFSET_NULL
        wf = self.wfs[comp].get(score)
        if wf is None or wf.null or k < wf.lo or k > wf.hi:
            return OFFSET_NULL
        off = int(wf.off[k + self.koff])
        return ((off + delta) << 4) | bt_type

    def _backtrace(self, score: int, k: int, offset: int) -> None:
        if self.metric in (DistanceMetric.INDEL, DistanceMetric.EDIT,
                           DistanceMetric.GAP_LINEAR):
            self._backtrace_linear(score, k, offset)
        else:
            self._backtrace_affine(score, k, offset)

    def _backtrace_affine(self, alignment_score: int, alignment_k: int,
                          alignment_offset: int) -> None:
        """(reference: wavefront_backtrace.c:320-531)"""
        pen = self.pen
        affine2p = self.metric == DistanceMetric.GAP_AFFINE_2P
        rev_ops: List[str] = []  # collected right-to-left
        matrix = Component.M
        score = alignment_score
        k = alignment_k
        offset = alignment_offset
        h = offset
        v = offset - k
        # ending indels (ends-free)
        if matrix == Component.M:
            if v < self.plen:
                rev_ops.append("D" * (self.plen - v))
            if h < self.tlen:
                rev_ops.append("I" * (self.tlen - h))
        M, I1, D1, I2, D2 = (Component.M, Component.I1, Component.D1,
                             Component.I2, Component.D2)
        while v > 0 and h > 0 and score > 0:
            mismatch = score - pen.mismatch
            gap_open1 = score - pen.gap_opening1 - pen.gap_extension1
            gap_open2 = score - pen.gap_opening2 - pen.gap_extension2
            gap_extend1 = score - pen.gap_extension1
            gap_extend2 = score - pen.gap_extension2
            if matrix == M:
                cands = [
                    self._bt_cand(M, mismatch, k, 1, BT_M),
                    self._bt_cand(M, gap_open1, k - 1, 1, BT_I1_OPEN),
                    self._bt_cand(I1, gap_extend1, k - 1, 1, BT_I1_EXT),
                    self._bt_cand(M, gap_open1, k + 1, 0, BT_D1_OPEN),
                    self._bt_cand(D1, gap_extend1, k + 1, 0, BT_D1_EXT),
                ]
                if affine2p:
                    cands += [
                        self._bt_cand(M, gap_open2, k - 1, 1, BT_I2_OPEN),
                        self._bt_cand(I2, gap_extend2, k - 1, 1, BT_I2_EXT),
                        self._bt_cand(M, gap_open2, k + 1, 0, BT_D2_OPEN),
                        self._bt_cand(D2, gap_extend2, k + 1, 0, BT_D2_EXT),
                    ]
            elif matrix == I1:
                cands = [
                    self._bt_cand(M, gap_open1, k - 1, 1, BT_I1_OPEN),
                    self._bt_cand(I1, gap_extend1, k - 1, 1, BT_I1_EXT),
                ]
            elif matrix == I2:
                cands = [
                    self._bt_cand(M, gap_open2, k - 1, 1, BT_I2_OPEN),
                    self._bt_cand(I2, gap_extend2, k - 1, 1, BT_I2_EXT),
                ]
            elif matrix == D1:
                cands = [
                    self._bt_cand(M, gap_open1, k + 1, 0, BT_D1_OPEN),
                    self._bt_cand(D1, gap_extend1, k + 1, 0, BT_D1_EXT),
                ]
            else:  # D2
                cands = [
                    self._bt_cand(M, gap_open2, k + 1, 0, BT_D2_OPEN),
                    self._bt_cand(D2, gap_extend2, k + 1, 0, BT_D2_EXT),
                ]
            max_all = max(cands)
            if max_all < 0:
                break
            if matrix == M:
                max_offset = max_all >> 4
                num_matches = offset - max_offset
                if num_matches > 0:
                    rev_ops.append("M" * num_matches)
                offset = max_offset
                v = offset - k
                h = offset
                if v <= 0 or h <= 0:
                    break
            bt_type = max_all & 0xF
            if bt_type == BT_M:
                score = mismatch
                matrix = M
                rev_ops.append("X")
                offset -= 1
            elif bt_type in (BT_I1_OPEN, BT_I1_EXT, BT_I2_OPEN, BT_I2_EXT):
                if bt_type == BT_I1_OPEN:
                    score, matrix = gap_open1, M
                elif bt_type == BT_I1_EXT:
                    score, matrix = gap_extend1, I1
                elif bt_type == BT_I2_OPEN:
                    score, matrix = gap_open2, M
                else:
                    score, matrix = gap_extend2, I2
                rev_ops.append("I")
                k -= 1
                offset -= 1
            else:
                if bt_type == BT_D1_OPEN:
                    score, matrix = gap_open1, M
                elif bt_type == BT_D1_EXT:
                    score, matrix = gap_extend1, D1
                elif bt_type == BT_D2_OPEN:
                    score, matrix = gap_open2, M
                else:
                    score, matrix = gap_extend2, D2
                rev_ops.append("D")
                k += 1
            v = offset - k
            h = offset
        # beginning matches / indels
        if matrix == Component.M:
            if v > 0 and h > 0:
                nm = min(v, h)
                rev_ops.append("M" * nm)
                v -= nm
                h -= nm
            if v > 0:
                rev_ops.append("D" * v)
            if h > 0:
                rev_ops.append("I" * h)
        self.cigar.ops = "".join(reversed(rev_ops))
        self.cigar.score = alignment_score

    def _backtrace_linear(self, alignment_score: int, alignment_k: int,
                          alignment_offset: int) -> None:
        """(reference: wavefront_backtrace.c:223-319)"""
        pen = self.pen
        rev_ops: List[str] = []
        score = alignment_score
        k = alignment_k
        offset = alignment_offset
        h = offset
        v = offset - k
        if v < self.plen:
            rev_ops.append("D" * (self.plen - v))
        if h < self.tlen:
            rev_ops.append("I" * (self.tlen - h))
        M = Component.M
        is_indel = self.metric == DistanceMetric.INDEL
        while v > 0 and h > 0 and score > 0:
            mismatch = score - pen.mismatch
            gap_open1 = score - pen.gap_opening1
            misms = (OFFSET_NULL if is_indel
                     else self._bt_cand(M, mismatch, k, 1, BT_M))
            ins = self._bt_cand(M, gap_open1, k - 1, 1, BT_I1_OPEN)
            dele = self._bt_cand(M, gap_open1, k + 1, 0, BT_D1_OPEN)
            max_all = max(misms, ins, dele)
            if max_all < 0:
                break
            max_offset = max_all >> 4
            num_matches = offset - max_offset
            if num_matches > 0:
                rev_ops.append("M" * num_matches)
            offset = max_offset
            v = offset - k
            h = offset
            if v <= 0 or h <= 0:
                break
            bt_type = max_all & 0xF
            if bt_type == BT_M:
                score = mismatch
                rev_ops.append("X")
                offset -= 1
            elif bt_type == BT_I1_OPEN:
                score = gap_open1
                rev_ops.append("I")
                k -= 1
                offset -= 1
            else:
                score = gap_open1
                rev_ops.append("D")
                k += 1
            v = offset - k
            h = offset
        if v > 0 and h > 0:
            nm = min(v, h)
            rev_ops.append("M" * nm)
            v -= nm
            h -= nm
        if v > 0:
            rev_ops.append("D" * v)
        if h > 0:
            rev_ops.append("I" * h)
        self.cigar.ops = "".join(reversed(rev_ops))
        self.cigar.score = alignment_score

    # -- terminate (reference: wavefront_unialign.c:147-237) ------------
    def _terminate(self, score: int) -> None:
        self.status_score = score
        pen = self.pen
        if self.scope == AlignmentScope.COMPUTE_SCORE:
            if self.status == STATUS_END_REACHED:
                self.cigar.end_v = self.plen
                self.cigar.end_h = self.tlen
                self.cigar.score = classic_score(pen, self.plen, self.tlen, score)
                self.status = STATUS_ALG_COMPLETED
            else:
                _, k, offset = self.end_pos
                self.cigar.end_v = offset - k
                self.cigar.end_h = offset
                self.cigar.score = classic_score(
                    pen, self.cigar.end_v, self.cigar.end_h, score)
                self.dropped = True
                self.status = STATUS_ALG_PARTIAL
            return
        _, end_k, end_offset = self.end_pos
        if end_offset != OFFSET_NULL:
            self._backtrace(score, end_k, end_offset)
        unreachable = self.status == STATUS_END_UNREACHABLE
        self.dropped = unreachable
        if self.form.extension or unreachable:
            trimmed = cigar_maxtrim(self.cigar, pen)
            if trimmed:
                self.status = STATUS_ALG_PARTIAL
            else:
                self.status = (STATUS_ALG_PARTIAL if unreachable
                               else STATUS_ALG_COMPLETED)
        else:
            _, k, offset = self.end_pos
            self.cigar.end_v = offset - k
            self.cigar.end_h = offset
            self.cigar.score = classic_score(
                pen, self.cigar.end_v, self.cigar.end_h, score)
            self.status = (STATUS_ALG_PARTIAL if unreachable
                           else STATUS_ALG_COMPLETED)
