"""Alignment self-check: re-validate a produced CIGAR against the sequences.

Analog of WFA2-lib's built-in correctness check
(reference: wavefront_debug.c:40-119, enabled by
system.check_alignment_correct).
"""
from __future__ import annotations

from typing import Optional

from ..attributes import Penalties
from ..cigar import cigar_score


def check_alignment(ops: str, pattern: str, text: str,
                    penalties: Optional[Penalties] = None,
                    score: Optional[int] = None,
                    end_v: Optional[int] = None,
                    end_h: Optional[int] = None,
                    matches=None) -> None:
    """Raise AssertionError if the CIGAR is inconsistent with the sequences.

    Checks: ops consume exactly [0, end_v) x [0, end_h); 'M' covers equal
    chars, 'X' covers unequal chars; optional score re-derivation matches.
    `matches(a, b)`: custom equality for wildcard / match-class modes
    (defaults to char equality).
    """
    if matches is None:
        matches = lambda a, b: a == b
    v = 0
    h = 0
    for c in ops:
        if c == "M":
            assert v < len(pattern) and h < len(text), "M out of bounds"
            assert matches(pattern[v], text[h]), \
                f"M over mismatch at (v={v},h={h}): {pattern[v]}!={text[h]}"
            v += 1
            h += 1
        elif c == "X":
            assert v < len(pattern) and h < len(text), "X out of bounds"
            assert not matches(pattern[v], text[h]), \
                f"X over match at (v={v},h={h})"
            v += 1
            h += 1
        elif c == "I":
            assert h < len(text), "I out of bounds"
            h += 1
        elif c == "D":
            assert v < len(pattern), "D out of bounds"
            v += 1
        else:
            raise AssertionError(f"unknown op {c!r}")
    if end_v is not None:
        assert v == end_v, f"pattern consumption {v} != end_v {end_v}"
    if end_h is not None:
        assert h == end_h, f"text consumption {h} != end_h {end_h}"
    if penalties is not None and score is not None and ops:
        derived = cigar_score(ops, penalties)
        assert derived == score, f"re-derived score {derived} != {score}"
