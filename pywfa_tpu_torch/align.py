"""pywfa-compatible single-pair API on the port.

Drop-in surface for `pywfa.align` (reference: pywfa's align.pyx):
`WavefrontAligner`, `AlignmentResult`, `clip_cigartuples`,
`elide_mismatches_from_cigar`, `cigartuples_to_str`. The port's own copy of
`pywfa_tpu/align.py`: every property, `AlignmentResult`, the clip and elide
helpers, `check_alignment` and `verbose` are carried over unchanged. Only
where an alignment runs differs:

- backend "auto" or "torch": `engine_adapter.align_single` on `device`
  (the hand-written CUDA kernels on "cuda", their plain torch versions on
  "cpu");
- backend "numpy": the scalar oracle, chosen explicitly;
- backend "jax" is refused: that engine belongs to `pywfa_tpu`.

`batch.BatchWavefrontAligner` is the high-throughput entry point.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List, Optional, Tuple

from . import spans
from .attributes import (
    AlignerAttributes,
    AlignmentForm,
    HeuristicParams,
    INT_MAX,
    Penalties,
    SystemParams,
    penalties_affine,
    penalties_affine2p,
    penalties_edit,
    penalties_indel,
    penalties_linear,
)
from .cigar import (
    Cigar,
    cigar_print_pretty_c,
    cigartuples_to_str as _cigartuples_to_str,
    ops_to_cigarstring,
    ops_to_cigartuples,
)
from .constants import (
    STATUS_MAX_STEPS_REACHED,
    AlignmentScope,
    AlignmentSpan,
    DistanceMetric,
    HeuristicStrategy,
    MemoryMode,
)

BACKENDS = ("auto", "torch", "numpy")

__all__ = [
    "WavefrontAligner",
    "AlignmentResult",
    "clip_cigartuples",
    "cigartuples_to_str",
    "elide_mismatches_from_cigar",
]


@dataclass
class AlignmentResult:
    """Holds the result of an alignment.

    Field set, derived properties and every output format are byte-pinned
    to the reference's result class (reference: align.pyx:17-180),
    including its quirks -- see the notes on `pretty` and
    `_gap_expand`. The implementation below is this project's own; only
    observable behavior is mirrored.
    """

    pattern_length: int
    text_length: int
    pattern_start: int
    pattern_end: int
    text_start: int
    text_end: int
    cigartuples: object
    score: int
    pattern: str
    text: str
    status: int

    _REPR_FIELDS = ("score", "pattern_start", "pattern_end", "text_start",
                    "text_end", "cigartuples", "pattern", "text")

    def __repr__(self):
        return "".join(f"    {k}: {getattr(self, k)}\n"
                       for k in self._REPR_FIELDS)

    def __str__(self):
        # 5-line summary, sequences/cigar truncated at 30 chars
        # (reference: align.pyx:57-73 format, byte-pinned)
        score = "Score: %d" % self.score
        if not (self.pattern and self.cigartuples):
            return score
        p, t = self.aligned_pattern, self.aligned_text
        if len(t) > 30:
            p, t = p[:30] + "...", t[:30] + "..."
        return "\n".join([p, t, self.cigarstring[:30], score,
                          "Length: %d" % len(t)])

    @property
    def aligned_pattern(self):
        """Pattern sequence aligned by the cigar; None if suppressed."""
        if self.pattern:
            return self._gap_expand(self.pattern, self.pattern_start,
                                    self.pattern_end)

    @property
    def aligned_text(self):
        """Text sequence aligned by the cigar; None if suppressed."""
        if self.text:
            return self._gap_expand(self.text, self.text_start,
                                    self.text_end)

    @property
    def cigarstring(self):
        return cigartuples_to_str(self.cigartuples)

    @property
    def pretty(self):
        """Pretty format (reference: align.pyx:122-165, byte-pinned).

        Quirk kept for parity: the reference's ALIGNMENT.COMPACT filter
        compares `i[0] != [8]` (an int against a list -- always true), so
        the compact line elides only op 0, never op 8.
        """
        compact = [op for op in self.cigartuples if op[0] != 0]
        out = [f"{self.cigarstring}      ALIGNMENT\n"
               f"{cigartuples_to_str(compact)}      ALIGNMENT.COMPACT\n"]
        # per-op rendering: (pattern advances, text advances, gap char)
        render = {0: (True, True, "|"), 7: (True, True, "|"),
                  8: (True, True, "*"), 2: (True, False, " "),
                  1: (False, True, " "), 4: (False, True, " "),
                  5: (False, True, " ")}
        prow, grow, trow = ["      PATTERN    "], ["                 "], \
            ["      TEXT       "]
        pi = ti = 0
        for opp, ln in self.cigartuples:
            if opp not in render:
                raise ValueError(
                    f"Cigar operation not available for pretty print - {opp}")
            adv_p, adv_t, gap = render[opp]
            prow.append(self.pattern[pi: pi + ln] if adv_p else "-" * ln)
            trow.append(self.text[ti: ti + ln] if adv_t else "-" * ln)
            grow.append(gap * ln)
            pi += ln if adv_p else 0
            ti += ln if adv_t else 0
        out.append("".join(prow) + "\n" + "".join(grow) + "\n"
                   + "".join(trow) + "\n")
        return "".join(out)

    def _gap_expand(self, sequence, begin, end):
        """Gap-expanded sequence for aligned_pattern/aligned_text.

        Parity quirk (reference: align.pyx:168-180): the reference
        iterates cigartuples as (length, mid) -- swapped -- and compares
        the int op code against a gap CHAR, which never matches; every op
        therefore consumes from the [begin:end) slice and the leftover
        tail is appended. Net observable effect: the slice expanded by
        total tuple length, no gap dashes. Reproduced directly.
        """
        seq = sequence[begin:end]
        idx = 0
        parts = []
        for length, _ in self.cigartuples:
            parts.append(seq[idx: idx + length])
            idx += length
        parts.append(seq[idx:])
        return "".join(parts)


# per-op (pattern, text) consumption used by clip_cigartuples' flank
# scans; ops absent here (soft/hard clips etc.) consume nothing, like the
# reference's if/elif chain falling through
_CLIP_CONSUMES = {0: (1, 1), 8: (1, 1), 2: (1, 0), 1: (0, 1)}


def clip_cigartuples(align_result, min_aligned_bases_left=5,
                     min_aligned_bases_right=5):
    """Soft-clip sub-threshold flank blocks.

    Scans each flank inward, accumulating consumed pattern/text bases,
    until an M block meeting the side's threshold is found (that block is
    kept); the consumed flanks become soft-clips (4, n) and the
    start/end coordinates are updated. Behavior byte-pinned to the
    reference incl. its coordinate quirks: a sub-threshold M block on a
    flank advances BOTH coordinates, the left soft-clip length is the
    consumed TEXT bases, and if no block meets a threshold the scan
    stops at the last op (reference: align.pyx:183-250 semantics).
    """
    ct = align_result.cigartuples
    if not ct:
        return align_result
    res = align_result

    def scan(indices, threshold):
        """-> (stop index, pattern bases consumed, text bases consumed)"""
        dp = dt = 0
        idx = indices[-1] if indices else 0
        for idx in indices:
            op, n = ct[idx]
            if op == 0 and n >= threshold:
                break
            p, t = _CLIP_CONSUMES.get(op, (0, 0))
            dp += p * n
            dt += t * n
        return idx, dp, dt

    i, p_left, t_left = scan(range(len(ct)), min_aligned_bases_left)
    j, p_right, t_right = scan(range(len(ct) - 1, -1, -1),
                               min_aligned_bases_right)

    kept = list(ct[i: j + 1])
    left_clip = [(4, t_left)] if res.text_start + t_left > 0 else []
    right_clip = [(4, t_right)] if t_right > 0 else []
    res.cigartuples = left_clip + kept + right_clip
    res.pattern_start = p_left
    res.pattern_end = res.pattern_length - p_right
    res.text_start = t_left
    res.text_end = res.text_length - t_right
    return res


def elide_mismatches_from_cigar(cigartuples):
    """Merge 'X'(8) runs into 'M'(0) blocks (reference: align.pyx:253-277
    semantics: adjacent M/X ops coalesce, other ops flush the block)."""
    out: List[Tuple[int, int]] = []
    block = 0
    for op, n in cigartuples or []:
        if op in (0, 8):
            block += n
            continue
        if block:
            out.append((0, block))
            block = 0
        out.append((op, n))
    if block:
        out.append((0, block))
    return out


def cigartuples_to_str(cigartuples):
    """String format of cigartuples (reference: align.pyx:280-295)."""
    return _cigartuples_to_str(cigartuples)


class WavefrontAligner:
    """Wavefront aligner with pywfa's exact interface, on one device.

    If a pattern is supplied, it will be cached for re-use.
    (reference: align.pyx:306-883)

    Extra (non-pywfa) kwargs: `backend` ("auto", "torch" or "numpy", the
    scalar oracle) and `device` ("cuda" by default, which raises when CUDA
    is absent; "cpu" runs the kernels' plain torch versions).
    Every `memory_mode` and reads of any length run on the device: past
    the mode's budget for the choice record a rung runs segmented.
    """

    def __init__(self,
                 pattern=None,
                 distance="affine",
                 memory_mode="high",
                 match=0,
                 mismatch=4,
                 gap_opening=6,
                 gap_extension=2,
                 gap_opening2=24,
                 gap_extension2=1,
                 scope="full",
                 span="ends-free",
                 pattern_begin_free=0,
                 pattern_end_free=0,
                 text_begin_free=0,
                 text_end_free=0,
                 heuristic=None,
                 min_wavefront_length=10,
                 max_distance_threshold=50,
                 steps_between_cutoffs=1,
                 xdrop=20,
                 wildcard=None,
                 match_classes=None,
                 max_steps=0,
                 backend="auto",
                 verbose=0,
                 check_alignment=False,
                 extension=False,
                 device="cuda",
                 ):
        if backend not in BACKENDS:
            raise ValueError(
                f"backend {backend!r} is not one of {BACKENDS}; the jax "
                "engine is pywfa_tpu.WavefrontAligner's")
        self.pattern_len = 0
        self.text_len = 0
        self._pattern = None
        self._text = None
        self._bpattern = b""
        self._backend = backend
        self._oracle = None
        self._device = None
        if backend != "numpy":
            from .batch import _resolve_device
            self._device = _resolve_device(device)
        # observability (reference: alignment_system_t.verbose /
        # check_alignment_correct, wavefront_attributes.h:86-93)
        self._verbose = verbose
        self._check_alignment = check_alignment
        from .utils.profiler import Timer
        self.timer = Timer()
        if pattern:
            self._pattern = pattern.upper()
            self._bpattern = self._pattern.encode("ascii")
            self.pattern_len = len(self._bpattern)

        self.wildcard = wildcard
        # generalized lambda mode (reference: wavefront_align.c:150-178):
        # a registered table name ("iupac") or a {char: bases} dict
        if match_classes is not None and wildcard is not None:
            raise ValueError("wildcard and match_classes are exclusive")
        if isinstance(match_classes, dict):
            import hashlib
            from .attributes import register_match_classes
            items = repr(sorted((k, "".join(sorted(v)))
                                for k, v in match_classes.items()))
            name = "user-" + hashlib.md5(items.encode()).hexdigest()[:12]
            register_match_classes(name, match_classes)
            match_classes = name
        self._match_classes = match_classes or ""

        if distance not in ("indel", "levenshtein", "linear", "affine", "affine2p"):
            raise NotImplementedError(f'{distance} distance not implemented')
        self._distance = distance
        self._match = match
        self._mismatch = mismatch
        self._gap_opening = gap_opening
        self._gap_extension = gap_extension
        self._gap_opening2 = gap_opening2
        self._gap_extension2 = gap_extension2
        # pywfa maps the linear-model indel penalty from gap_extension at
        # construction (align.pyx:355) but from gap_opening/gap_extension
        # property setters afterwards (align.pyx:675,684)
        self._linear_indel = gap_extension
        # validate penalties now (C validates inside wavefront_aligner_new)
        self._build_penalties()

        if scope == "full":
            self._scope = AlignmentScope.COMPUTE_ALIGNMENT
        elif scope == "score":
            self._scope = AlignmentScope.COMPUTE_SCORE
        else:
            raise ValueError(f'{scope} scope not understood')

        if memory_mode == 'high':
            self._memory_mode = MemoryMode.HIGH
        elif memory_mode == 'medium':
            self._memory_mode = MemoryMode.MED
        elif memory_mode == 'low':
            self._memory_mode = MemoryMode.LOW
        elif memory_mode == 'biwfa':
            self._memory_mode = MemoryMode.ULTRALOW
        else:
            raise ValueError(
                "memory_mode must be one of 'high', 'medium', 'low', 'biwfa'")

        # WF-extension mode (reference: alignment_form_t.extension,
        # wavefront_align.c:57-63 autoconfig + maxtrim on terminate)
        self._extension = bool(extension)
        self._pattern_begin_free = pattern_begin_free
        self._pattern_end_free = pattern_end_free
        self._text_begin_free = text_begin_free
        self._text_end_free = text_end_free
        if span == "ends-free":
            self._span = AlignmentSpan.ENDS_FREE
        elif span == "end-to-end":
            self._span = AlignmentSpan.END_TO_END
        else:
            raise NotImplementedError(f'{span} span not implemented')

        self._min_wavefront_length = min_wavefront_length
        self._max_distance_threshold = max_distance_threshold
        self._steps_between_cutoffs = steps_between_cutoffs
        self._xdrop = xdrop
        if heuristic is None:
            self._heuristic_strategy = HeuristicStrategy.NONE
        elif heuristic == "adaptive":
            self._heuristic_strategy = HeuristicStrategy.WFADAPTIVE
        elif heuristic == "X-drop":
            self._heuristic_strategy = HeuristicStrategy.XDROP
        else:
            raise NotImplementedError(f'{heuristic} heuristic not implemented')

        if max_steps <= 0:
            max_steps = INT_MAX
        self._max_steps = max_steps

        # last-alignment state
        self._status = 0
        self._cigar_ops = ""
        self._score = 0
        self._dropped = False

    # -- config assembly ------------------------------------------------
    def _build_penalties(self) -> Penalties:
        d = self._distance
        if d == "indel":
            self._penalties = penalties_indel()
        elif d == "levenshtein":
            self._penalties = penalties_edit()
        elif d == "linear":
            self._penalties = penalties_linear(
                self._match, self._mismatch, self._linear_indel)
        elif d == "affine":
            self._penalties = penalties_affine(
                self._match, self._mismatch,
                self._gap_opening, self._gap_extension)
        else:
            self._penalties = penalties_affine2p(
                self._match, self._mismatch,
                self._gap_opening, self._gap_extension,
                self._gap_opening2, self._gap_extension2)
        return self._penalties

    def _attributes(self) -> AlignerAttributes:
        return AlignerAttributes(
            penalties=self._penalties,
            scope=self._scope,
            form=AlignmentForm(
                span=self._span,
                extension=self._extension,
                pattern_begin_free=self._pattern_begin_free,
                pattern_end_free=self._pattern_end_free,
                text_begin_free=self._text_begin_free,
                text_end_free=self._text_end_free,
            ),
            heuristic=HeuristicParams(
                strategy=self._heuristic_strategy,
                min_wavefront_length=self._min_wavefront_length,
                max_distance_threshold=self._max_distance_threshold,
                steps_between_cutoffs=self._steps_between_cutoffs,
                xdrop=self._xdrop,
            ),
            memory_mode=self._memory_mode,
            system=SystemParams(max_alignment_steps=self._max_steps,
                                verbose=self._verbose),
            match_classes=self._match_classes,
        )

    # -- alignment ------------------------------------------------------
    def wavefront_align(self, text, pattern=None):
        """Perform wavefront alignment; returns the alignment score.

        (reference: align.pyx:421-443)
        """
        if pattern is not None:
            self._pattern = pattern.upper()
            self._bpattern = self._pattern.encode("ascii")
            self.pattern_len = len(self._bpattern)
        t = text.upper().encode("ascii")
        self._text = text
        self.text_len = len(t)
        wc = None
        if self._wildcard:
            wc = self._bwildcard
        self.timer.start()
        result = self._run_engine(self._bpattern, t, wc)
        elapsed = self.timer.stop()
        self._status = result.status
        self._cigar_ops = result.ops
        self._score = result.score
        self._dropped = result.dropped
        if self._check_alignment and result.ops and result.status == 0:
            # analog of system.check_alignment_correct
            # (reference: wavefront_debug.c:230-241)
            from .utils.check import check_alignment
            matches = None
            if self._match_classes:
                from .attributes import match_class_table
                tbl = match_class_table(self._match_classes)
                matches = lambda a, b: bool(tbl[ord(a)] & tbl[ord(b)])
            elif self._wildcard:
                w = self._wildcard
                matches = lambda a, b: a == b or a == w or b == w
            # a completed full-scope CIGAR consumes BOTH sequences fully
            # (ends-free leading/trailing free runs are explicit I/D ops;
            # result.end_v/end_h mark the alignment end BEFORE the
            # trailing free block, so they are not the consumption bound)
            check_alignment(result.ops, self._pattern, text.upper(),
                            self._penalties,
                            end_v=self.pattern_len, end_h=self.text_len,
                            matches=matches)
        if self._verbose >= 1:
            from .utils.profiler import report_alignment
            report_alignment(
                None, score=self._score, status=self._status,
                plen=self.pattern_len, tlen=self.text_len,
                cigar=self.cigarstring, seconds=elapsed,
                pattern=(self._pattern if self._verbose >= 2 else ""),
                text=(text if self._verbose >= 2 else ""),
                config=f"({self._distance},{self.span},{self.scope})")
        return self._score

    def _run_engine(self, bpattern: bytes, btext: bytes, wildcard):
        if self._backend != "numpy":
            self._oracle = None
            from .engine_adapter import align_single
            return align_single(self._attributes(), bpattern, btext, wildcard,
                                device=self._device)
        from .oracle import OracleAligner
        # retained so wavefront_align_resume can continue a MAX_STEPS pause
        self._oracle = OracleAligner(self._attributes(), wildcard)
        return self._oracle.align(bpattern, btext)

    def wavefront_align_resume(self):
        """Continue a MAX_STEPS-paused alignment after `max_steps` was
        raised; returns the score (reference: wavefront_align.c:245-266
        wavefront_align_resume, experimental).

        The numpy backend continues from the oracle's retained wavefronts;
        the device backend aligns again at the raised cap (the same result
        by the engine/oracle contract).
        """
        if self._status != STATUS_MAX_STEPS_REACHED:
            raise ValueError(
                "wavefront_align_resume requires a MAX_STEPS_REACHED "
                f"alignment (status is {self._status})")
        self.timer.start()
        if self._oracle is not None:
            result = self._oracle.align_resume(self._max_steps)
        else:
            wc = self._bwildcard if self._wildcard else None
            t = self._text.upper().encode("ascii")
            from .engine_adapter import align_single
            result = align_single(self._attributes(), self._bpattern, t, wc,
                                  device=self._device)
        self.timer.stop()
        self._status = result.status
        self._cigar_ops = result.ops
        self._score = result.score
        self._dropped = result.dropped
        return self._score

    def cigar_print_pretty(self, file_name=None):
        """(reference: align.pyx:445-459 -> cigar.c:778-863)"""
        pattern = self._bpattern.decode("ascii")
        text = self._text if self._text is not None else ""
        cig = Cigar(ops=self._cigar_ops, score=self._score)
        if file_name:
            with open(file_name, "w") as fh:
                cigar_print_pretty_c(cig, pattern, text, file=fh)
        else:
            cigar_print_pretty_c(cig, pattern, text, file=sys.stdout)

    # -- properties (reference: align.pyx:461-833) ----------------------
    @property
    def status(self):
        return self._status

    @property
    def score(self):
        return self._score

    @property
    def pattern_begin_free(self):
        return self._pattern_begin_free

    @pattern_begin_free.setter
    def pattern_begin_free(self, pattern_begin_free):
        # plain assignment (reference: align.pyx:473-475)
        self._pattern_begin_free = pattern_begin_free

    @property
    def pattern_end_free(self):
        return self._pattern_end_free

    @pattern_end_free.setter
    def pattern_end_free(self, pattern_end_free):
        self._pattern_end_free = pattern_end_free

    @property
    def text_begin_free(self):
        return self._text_begin_free

    @text_begin_free.setter
    def text_begin_free(self, text_begin_free):
        self._text_begin_free = text_begin_free

    @property
    def text_end_free(self):
        return self._text_end_free

    @text_end_free.setter
    def text_end_free(self, text_end_free):
        self._text_end_free = text_end_free

    @property
    def scope(self):
        if self._scope == AlignmentScope.COMPUTE_ALIGNMENT:
            return "full"
        else:
            return "score"

    @scope.setter
    def scope(self, scope):
        if scope == "full":
            self._scope = AlignmentScope.COMPUTE_ALIGNMENT
        elif scope == "score":
            self._scope = AlignmentScope.COMPUTE_SCORE
        else:
            raise ValueError(f'{scope} scope not understood')

    @property
    def span(self):
        if self._span == AlignmentSpan.ENDS_FREE:
            return "ends-free"
        elif self._span == AlignmentSpan.END_TO_END:
            return "end-to-end"

    @span.setter
    def span(self, span):
        if span == "ends-free":
            self._span = AlignmentSpan.ENDS_FREE
        elif span == "end-to-end":
            self._span = AlignmentSpan.END_TO_END
        else:
            raise NotImplementedError(f'{span} span not implemented')

    @property
    def memory_mode(self):
        return {
            MemoryMode.HIGH: "high",
            MemoryMode.MED: "medium",
            MemoryMode.LOW: "low",
            MemoryMode.ULTRALOW: "biwfa",
        }[self._memory_mode]

    @memory_mode.setter
    def memory_mode(self, memory_mode):
        # NOTE: mirrors align.pyx:545-556, which accepts "med" (not "medium")
        # in the setter
        if memory_mode == "high":
            self._memory_mode = MemoryMode.HIGH
        elif memory_mode == "med":
            self._memory_mode = MemoryMode.MED
        elif memory_mode == "low":
            self._memory_mode = MemoryMode.LOW
        elif memory_mode == "biwfa":
            self._memory_mode = MemoryMode.ULTRALOW
        else:
            raise NotImplementedError(f'{memory_mode} memory_mode not implemented')

    @property
    def heuristic(self):
        if self._heuristic_strategy == HeuristicStrategy.NONE:
            return None
        elif self._heuristic_strategy == HeuristicStrategy.WFADAPTIVE:
            return "adaptive"
        elif self._heuristic_strategy == HeuristicStrategy.XDROP:
            return "X-drop"

    @heuristic.setter
    def heuristic(self, heuristic):
        if heuristic is None:
            self._heuristic_strategy = HeuristicStrategy.NONE
        elif heuristic == "adaptive":
            self._heuristic_strategy = HeuristicStrategy.WFADAPTIVE
        elif heuristic == "X-drop":
            self._heuristic_strategy = HeuristicStrategy.XDROP
        else:
            raise NotImplementedError(f'{heuristic} heuristic not implemented')

    @property
    def min_wavefront_length(self):
        return self._min_wavefront_length

    @min_wavefront_length.setter
    def min_wavefront_length(self, length):
        self._min_wavefront_length = length

    @property
    def max_distance_threshold(self):
        return self._max_distance_threshold

    @max_distance_threshold.setter
    def max_distance_threshold(self, thresh):
        self._max_distance_threshold = thresh

    @property
    def steps_between_cutoffs(self):
        return self._steps_between_cutoffs

    @steps_between_cutoffs.setter
    def steps_between_cutoffs(self, steps):
        self._steps_between_cutoffs = steps

    @property
    def xdrop(self):
        return self._xdrop

    @xdrop.setter
    def xdrop(self, xdrop):
        self._xdrop = xdrop

    @property
    def distance(self):
        return {"indel": "indel", "levenshtein": "levenshtein",
                "linear": "linear", "affine": "affine",
                "affine2p": "affine2p"}[self._distance]

    @distance.setter
    def distance(self, distance):
        if distance not in ("indel", "levenshtein", "linear", "affine", "affine2p"):
            raise NotImplementedError(f'{distance} distance not implemented')
        self._distance = distance
        self._build_penalties()

    @property
    def match_score(self):
        return self._penalties.match

    @match_score.setter
    def match_score(self, match):
        self._match = match
        self._build_penalties()

    @property
    def mismatch_penalty(self):
        return self._penalties.mismatch

    @mismatch_penalty.setter
    def mismatch_penalty(self, mismatch):
        self._mismatch = mismatch
        self._build_penalties()

    @property
    def gap_opening_penalty(self):
        return self._penalties.gap_opening1

    @gap_opening_penalty.setter
    def gap_opening_penalty(self, penalty):
        # also writes the linear-model indel (reference: align.pyx:675)
        self._gap_opening = penalty
        self._linear_indel = penalty
        self._build_penalties()

    @property
    def gap_extension_penalty(self):
        return self._penalties.gap_extension1

    @gap_extension_penalty.setter
    def gap_extension_penalty(self, penalty):
        self._gap_extension = penalty
        self._linear_indel = penalty
        self._build_penalties()

    @property
    def gap_opening2_penalty(self):
        return self._penalties.gap_opening2

    @gap_opening2_penalty.setter
    def gap_opening2_penalty(self, penalty):
        self._gap_opening2 = penalty
        self._build_penalties()

    @property
    def gap_extension2_penalty(self):
        return self._penalties.gap_extension2

    @gap_extension2_penalty.setter
    def gap_extension2_penalty(self, penalty):
        self._gap_extension2 = penalty
        self._build_penalties()

    @property
    def wildcard(self):
        return self._wildcard

    @wildcard.setter
    def wildcard(self, wildcard):
        if wildcard is not None:
            if not isinstance(wildcard, str):
                raise TypeError(
                    f"expected wildcard to be a string, but it is {type(wildcard)}")
            if len(wildcard) > 1:
                raise ValueError(
                    f"wildcard must have length 1, but has length {len(wildcard)}")
            self._wildcard = wildcard
            self._bwildcard = wildcard.upper().encode("ascii")[0]
        else:
            self._wildcard = None

    @property
    def max_steps(self):
        return self._max_steps

    @max_steps.setter
    def max_steps(self, steps):
        if steps <= 0:
            steps = INT_MAX
        self._max_steps = steps

    @property
    def cigarstring(self):
        return ops_to_cigarstring(self._cigar_ops)

    @property
    def cigartuples(self):
        return ops_to_cigartuples(self._cigar_ops)

    @property
    def locations(self):
        """(pattern_start, pattern_end, text_start, text_end).

        (reference: align.pyx:788-833)
        """
        if self.scope == "score":
            return [0, 0, 0, 0]
        cigartuples = self.cigartuples
        if not cigartuples or self.text_len == 0 or self.pattern_len == 0:
            return [0, 0, 0, 0]

        ct = cigartuples
        text_start = 0
        pattern_start = 0
        i = 0
        for i in range(len(cigartuples)):
            if ct[i][0] == 0:
                if ct[i][1] >= 1:
                    break
                else:
                    text_start += ct[i][1]
                    pattern_start += ct[i][1]
            elif ct[i][0] == 2:  # deletion
                pattern_start += ct[i][1]
            elif ct[i][0] == 8:  # mismatch
                text_start += ct[i][1]
                pattern_start += ct[i][1]
            elif ct[i][0] == 1:  # insertion
                text_start += ct[i][1]

        text_end = self.text_len
        pattern_end = self.pattern_len
        j = len(ct) - 1
        for j in range(len(ct) - 1, -1, -1):
            if ct[j][0] == 0:
                if ct[j][1] >= 1:
                    break
                else:
                    text_end -= ct[j][1]
                    pattern_end -= ct[j][1]
            elif ct[j][0] == 2:
                pattern_end -= ct[j][1]
            elif ct[j][0] == 8:
                pattern_end -= ct[j][1]
                text_end -= ct[j][1]
            elif ct[j][0] == 1:
                text_end -= ct[j][1]

        return pattern_start, pattern_end, text_start, text_end

    @spans.traced("call")
    def __call__(self, text, pattern=None, clip_cigar=False,
                 min_aligned_bases_left=1, min_aligned_bases_right=1,
                 elide_mismatches=False, supress_sequences=False):
        """Align `text` to `pattern`; returns AlignmentResult.

        (reference: align.pyx:835-879)
        """
        if pattern is None:
            p = self._pattern
            if not p:
                raise ValueError("pattern is None")
            lp = len(self._pattern)
            score = self.wavefront_align(text)
        else:
            lp = len(pattern)
            p = pattern
            score = self.wavefront_align(text, pattern)

        ct = self.cigartuples
        locs = self.locations
        status = self.status
        if supress_sequences:
            res = AlignmentResult(lp, len(text), locs[0], locs[1], locs[2],
                                  locs[3], ct, score, "", "", status)
        else:
            res = AlignmentResult(lp, len(text), locs[0], locs[1], locs[2],
                                  locs[3], ct, score, p, text, status)
        # NOTE: the reference snapshot reads `if not self.scope == "full"`
        # (align.pyx:874), but that gate contradicts the reference's own
        # README examples (README.rst:219-243, clip with default scope) and
        # makes tests/test.py:231-232's golden unreachable; the working pywfa
        # behavior applies post-processing when scope IS "full", so we do too.
        if self.scope == "full":
            if clip_cigar:
                res = clip_cigartuples(res, min_aligned_bases_left,
                                       min_aligned_bases_right)
            if elide_mismatches:
                res.cigartuples = elide_mismatches_from_cigar(res.cigartuples)
        return res

