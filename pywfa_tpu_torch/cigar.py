"""CIGAR representation and post-processing.

The engine produces a CIGAR as a plain string of per-base operation chars
('M','X','I','D'), like WFA2-lib's `cigar_t.operations` buffer
(reference: alignment/cigar.h:44-58). This module provides run-length
encoding, scoring, maxtrim and the pretty-printers.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional, Tuple

from .attributes import Penalties
from .constants import CIGAR_CHAR_TO_CODE, CIGAR_OP_CHARS, DistanceMetric

CigarTuples = List[Tuple[int, int]]


@dataclasses.dataclass
class Cigar:
    """Alignment edit-transcript + end coordinates.

    `ops` holds one char per op ('M','X','I','D'), empty when null.
    (reference: alignment/cigar.h cigar_t; begin/end offsets collapse to the
    string itself here.)
    """

    ops: str = ""
    score: int = 0
    end_v: int = 0
    end_h: int = 0

    def is_null(self) -> bool:
        return len(self.ops) == 0

    def clear(self) -> None:
        self.ops = ""
        self.score = 0
        self.end_v = 0
        self.end_h = 0


def ops_to_rle(ops: str) -> List[Tuple[str, int]]:
    """Run-length encode an op-char string into [(char, length)]."""
    if not ops:
        return []
    out: List[Tuple[str, int]] = []
    last = ops[0]
    n = 1
    for c in ops[1:]:
        if c == last:
            n += 1
        else:
            out.append((last, n))
            last = c
            n = 1
    out.append((last, n))
    return out


def ops_to_cigartuples(ops: str) -> CigarTuples:
    """RLE into pysam-style (code, length) tuples (reference: align.pyx:759-786)."""
    return [(CIGAR_CHAR_TO_CODE[c], n) for c, n in ops_to_rle(ops)]


def ops_to_cigarstring(ops: str) -> str:
    """RLE into e.g. '3M1X4M' (reference: align.pyx:731-757)."""
    return "".join(f"{n}{c}" for c, n in ops_to_rle(ops))


def cigartuples_to_str(cigartuples) -> str:
    """String format of cigartuples (reference: align.pyx:280-295)."""
    if not cigartuples:
        return ""
    str_codes = list(CIGAR_OP_CHARS)
    return "".join(f"{l}{str_codes[opp]}" for opp, l in cigartuples)


# ---------------------------------------------------------------------------
# Scoring a CIGAR under the (original, pre-Eizenga) penalty model
# (reference: alignment/cigar.c:244-345)
# ---------------------------------------------------------------------------

def cigar_score(ops: str, penalties: Penalties) -> int:
    m = penalties.distance_metric
    if m in (DistanceMetric.INDEL, DistanceMetric.EDIT):
        return sum(1 for c in ops if c in "XDI")
    if m == DistanceMetric.GAP_LINEAR:
        score = 0
        for c in ops:
            if c == "M":
                score -= penalties.orig_match
            elif c == "X":
                score -= penalties.orig_mismatch
            else:  # I/D
                score -= penalties.orig_gap_extension1
        return score
    if m == DistanceMetric.GAP_AFFINE:
        score = 0
        last = ""
        for c in ops:
            if c == "M":
                score -= penalties.orig_match
            elif c == "X":
                score -= penalties.orig_mismatch
            elif c == "D":
                score -= penalties.orig_gap_extension1 + (
                    0 if last == "D" else penalties.orig_gap_opening1)
            elif c == "I":
                score -= penalties.orig_gap_extension1 + (
                    0 if last == "I" else penalties.orig_gap_opening1)
            last = c
        return score
    # affine2p: each I/D run is scored min(gap1, gap2) per run
    score = 0
    for c, n in ops_to_rle(ops):
        if c == "M":
            score -= penalties.orig_match * n
        elif c == "X":
            score -= penalties.orig_mismatch * n
        else:
            s1 = penalties.orig_gap_opening1 + penalties.orig_gap_extension1 * n
            s2 = penalties.orig_gap_opening2 + penalties.orig_gap_extension2 * n
            score -= min(s1, s2)
    return score


# ---------------------------------------------------------------------------
# Maxtrim: keep the maximum-scoring prefix of the CIGAR
# (reference: alignment/cigar.c:419-613; dispatch wavefront_aligner.c:663-675)
# ---------------------------------------------------------------------------

def cigar_maxtrim(cigar: Cigar, penalties: Penalties) -> bool:
    """Trim `cigar` in place to its max-scoring prefix; True if trimmed.

    Matches with match-score 0 are counted as -1 (favoring longer prefixes),
    mirroring the C `match_score = (match != 0) ? match : -1` trick.
    Does not apply to edit/indel metrics (returns False).
    """
    m = penalties.distance_metric
    if m in (DistanceMetric.INDEL, DistanceMetric.EDIT):
        return False
    ops = cigar.ops
    if not ops:
        return False
    match_score = penalties.orig_match if penalties.orig_match != 0 else -1

    if m == DistanceMetric.GAP_AFFINE_2P:
        return _maxtrim_affine2p(cigar, penalties, match_score)

    max_score = 0
    max_i = -1  # index of last kept op (C: max_score_offset rel. begin)
    max_end_v = 0
    max_end_h = 0
    score = 0
    end_v = 0
    end_h = 0
    last = ""
    for i, c in enumerate(ops):
        if c == "M":
            score -= match_score
            end_v += 1
            end_h += 1
        elif c == "X":
            score -= penalties.orig_mismatch
            end_v += 1
            end_h += 1
        elif c == "I":
            if m == DistanceMetric.GAP_LINEAR:
                score -= penalties.orig_gap_extension1
            else:
                score -= penalties.orig_gap_extension1 + (
                    0 if last == "I" else penalties.orig_gap_opening1)
            end_h += 1
        elif c == "D":
            if m == DistanceMetric.GAP_LINEAR:
                score -= penalties.orig_gap_extension1
            else:
                score -= penalties.orig_gap_extension1 + (
                    0 if last == "D" else penalties.orig_gap_opening1)
            end_v += 1
        last = c
        if max_score < score:
            max_score = score
            max_i = i
            max_end_v = end_v
            max_end_h = end_h
    trimmed = max_i != len(ops) - 1
    if max_score == 0:
        cigar.clear()
    else:
        cigar.ops = ops[: max_i + 1]
        cigar.score = max_score
        cigar.end_v = max_end_v
        cigar.end_h = max_end_h
    return trimmed


def _maxtrim_affine2p(cigar: Cigar, penalties: Penalties, match_score: int) -> bool:
    """Affine2p maxtrim considers only run boundaries (reference: cigar.c:556-613)."""
    ops = cigar.ops

    def run_score(c: str, n: int, pos) -> int:
        if c == "M":
            pos[0] += n
            pos[1] += n
            return match_score * n
        if c == "X":
            pos[0] += n
            pos[1] += n
            return penalties.orig_mismatch * n
        s1 = penalties.orig_gap_opening1 + penalties.orig_gap_extension1 * n
        s2 = penalties.orig_gap_opening2 + penalties.orig_gap_extension2 * n
        if c == "D":
            pos[0] += n
        else:
            pos[1] += n
        return min(s1, s2)

    max_score = 0
    max_i = -1
    max_end_v = 0
    max_end_h = 0
    score = 0
    pos = [0, 0]  # end_v, end_h
    i = 0
    for c, n in ops_to_rle(ops):
        score -= run_score(c, n, pos)
        i += n
        if max_score < score:
            max_score = score
            max_i = i - 1
            max_end_v = pos[0]
            max_end_h = pos[1]
    trimmed = max_i != len(ops) - 1
    if max_score == 0:
        cigar.clear()
    else:
        cigar.ops = ops[: max_i + 1]
        cigar.score = max_score
        cigar.end_v = max_end_v
        cigar.end_h = max_end_h
    return trimmed


# ---------------------------------------------------------------------------
# Pretty printers
# ---------------------------------------------------------------------------

def cigar_sprint(ops: str, print_matches: bool) -> str:
    """RLE print; with print_matches=False 'M' runs are elided (C ETRACE).

    (reference: alignment/cigar.c:705-739 cigar_sprint)
    """
    out = []
    for c, n in ops_to_rle(ops):
        if print_matches or c != "M":
            out.append(f"{n}{c}")
    return "".join(out)


def cigar_sprint_sam(ops: str, show_mismatches: bool) -> str:
    """SAM-style CIGAR (X folded into M unless show_mismatches).

    (reference: alignment/cigar.c:754-778 cigar_sprint_SAM_CIGAR)
    """
    if not ops:
        return ""
    mapped = ops if show_mismatches else ops.replace("X", "M")
    return "".join(f"{n}{c}" for c, n in ops_to_rle(mapped))


def cigar_discover_mismatches(pattern: str, text: str, cigar: Cigar) -> None:
    """Re-derive 'M'/'X' in an M-run CIGAR by comparing the sequences.

    Normalizes external CIGARs (e.g. from a SAM record or another
    aligner) into this library's explicit-mismatch form: each 'M' op is
    compared against the sequences and kept as 'M' or rewritten to 'X';
    the walk stops when either sequence is exhausted and any remaining
    unaligned tail is appended as 'D' (pattern left) then 'I' (text
    left), ops past the stop point dropped -- byte-faithful to the
    reference (reference: alignment/cigar.c:375-407
    cigar_discover_mismatches, including its break-then-pad tail
    handling). Unknown ops raise (the reference exit(1)s).
    """
    out: List[str] = []
    p = 0
    t = 0
    for c in cigar.ops:
        if p >= len(pattern) or t >= len(text):
            break
        if c == "M":
            out.append("M" if pattern[p] == text[t] else "X")
            p += 1
            t += 1
        elif c == "I":
            out.append("I")
            t += 1
        elif c == "D":
            out.append("D")
            p += 1
        else:
            raise ValueError(f"[CIGAR] Wrong edit operation: {c!r}")
    out.append("D" * (len(pattern) - p))
    out.append("I" * (len(text) - t))
    cigar.ops = "".join(out)


# SAM numeric opcodes (reference: alignment/cigar.c:38-55 sam_cigar_lut)
_SAM_OP = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6,
           "=": 7, "X": 8}


def cigar_get_sam_u32(ops: str, show_mismatches: bool = False):
    """Numeric SAM CIGAR: uint32 array of (length << 4) | opcode.

    With show_mismatches=False, 'X' folds into 'M' (code 0); with True,
    'M' runs emit '=' (code 7) and 'X' stays 8 -- byte-faithful to the
    reference's buffer encoding (reference: alignment/cigar.c:181-243
    cigar_compute_CIGAR / cigar_get_CIGAR).
    """
    import numpy as np
    if not ops:
        return np.zeros(0, dtype=np.uint32)
    mapped = ops if show_mismatches else ops.replace("X", "M")
    out = []
    for c, n in ops_to_rle(mapped):
        code = _SAM_OP["="] if (show_mismatches and c == "M") else _SAM_OP[c]
        out.append((n << 4) | code)
    return np.asarray(out, dtype=np.uint32)


def cigar_print_pretty_c(
    cigar: Cigar, pattern: str, text: str, file=None
) -> None:
    """WFA2-lib's pretty-print format (reference: alignment/cigar.c:778-863).

    Used by `WavefrontAligner.cigar_print_pretty` (align.pyx:445-459).
    """
    stream = file if file is not None else sys.stdout
    ops = cigar.ops
    pattern_alg: List[str] = []
    ops_alg: List[str] = []
    text_alg: List[str] = []
    p = 0
    t = 0
    for c in ops:
        if c == "M":
            if p < len(pattern) and t < len(text) and pattern[p] != text[t]:
                pattern_alg.append(pattern[p])
                ops_alg.append("X")
                text_alg.append(text[t])
            else:
                pattern_alg.append(pattern[p] if p < len(pattern) else "")
                ops_alg.append("|")
                text_alg.append(text[t] if t < len(text) else "")
            p += 1
            t += 1
        elif c == "X":
            if p < len(pattern) and t < len(text) and pattern[p] != text[t]:
                pattern_alg.append(pattern[p])
                ops_alg.append(" ")
                text_alg.append(text[t])
            else:
                pattern_alg.append(pattern[p] if p < len(pattern) else "")
                ops_alg.append("X")
                text_alg.append(text[t] if t < len(text) else "")
            p += 1
            t += 1
        elif c == "I":
            pattern_alg.append("-")
            ops_alg.append(" ")
            text_alg.append(text[t] if t < len(text) else "")
            t += 1
        elif c == "D":
            pattern_alg.append(pattern[p] if p < len(pattern) else "")
            ops_alg.append(" ")
            text_alg.append("-")
            p += 1
    i = 0
    while p < len(pattern):
        pattern_alg.append(pattern[p])
        if len(ops_alg) <= len(pattern_alg) - 1:
            ops_alg.append("?")
        p += 1
        i += 1
    i = 0
    while t < len(text):
        text_alg.append(text[t])
        if len(ops_alg) < len(text_alg):
            ops_alg.append("?")
        t += 1
        i += 1
    print(f"      ALIGNMENT {cigar_sprint(ops, True)}", file=stream)
    print(f"      ETRACE    {cigar_sprint(ops, False)}", file=stream)
    print(f"      CIGAR     {cigar_sprint_sam(ops, False)}", file=stream)
    print(f"      PATTERN    {''.join(pattern_alg)}", file=stream)
    print(f"                 {''.join(ops_alg)}", file=stream)
    print(f"      TEXT       {''.join(text_alg)}", file=stream)
