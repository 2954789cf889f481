"""Core constants of the wavefront-alignment engine.

The port's own copy of `pywfa_tpu/constants.py`; every enum is an IntEnum or
IntFlag, so its members compare equal by value to the JAX package's.

Semantics mirror WFA2-lib (reference: pywfa/WFA2_lib/wavefront/wfa.h:46-55,
wavefront_offset.h:38-57) but the encodings here are our own, chosen for
dense-tensor batched execution.
"""
from __future__ import annotations

import enum

# ---------------------------------------------------------------------------
# Offsets / diagonals
#
# A wavefront cell on diagonal k holds "offset" = h (columns of text consumed).
# v = offset - k. Diagonal of cell (h, v) is k = h - v.
# (reference: wavefront_offset.h:50-57)
# ---------------------------------------------------------------------------
OFFSET_NULL = -(2**30)  # sentinel: cell not reachable (reference: INT32_MIN/2)
DIAGONAL_NULL = 2**31 - 1

# ---------------------------------------------------------------------------
# Alignment status codes (reference: wfa.h:46-55)
# ---------------------------------------------------------------------------
STATUS_ALG_COMPLETED = 0       # complete alignment found
STATUS_ALG_PARTIAL = 1         # partial alignment found (dropped/trimmed)
STATUS_MAX_STEPS_REACHED = -100
STATUS_OOM = -200
STATUS_UNATTAINABLE = -300
# internal
STATUS_OK = -1
STATUS_END_REACHED = -2
STATUS_END_UNREACHABLE = -3

STATUS_MESSAGES = {
    STATUS_ALG_COMPLETED: "Alignment finished successfully",
    STATUS_ALG_PARTIAL: "Alignment finished successfully (partial alignment)",
    STATUS_MAX_STEPS_REACHED: "Alignment failed. Maximum number of steps reached",
    STATUS_OOM: "Alignment failed. Maximum memory limit reached",
    STATUS_UNATTAINABLE: "Alignment failed. Unattainable under current heuristics",
}


class DistanceMetric(enum.IntEnum):
    """Distance models (reference: wavefront_penalties.h distance_metric_t)."""

    INDEL = 0
    EDIT = 1
    GAP_LINEAR = 2
    GAP_AFFINE = 3
    GAP_AFFINE_2P = 4


class AlignmentScope(enum.IntEnum):
    COMPUTE_SCORE = 0
    COMPUTE_ALIGNMENT = 1


class AlignmentSpan(enum.IntEnum):
    END_TO_END = 0
    ENDS_FREE = 1


class MemoryMode(enum.IntEnum):
    HIGH = 0
    MED = 1
    LOW = 2
    ULTRALOW = 3  # "biwfa"


class HeuristicStrategy(enum.IntFlag):
    """OR-able heuristic strategies (reference: wavefront_heuristic.h:41-49)."""

    NONE = 0
    BANDED_STATIC = 1
    BANDED_ADAPTIVE = 2
    WFADAPTIVE = 4
    XDROP = 8
    ZDROP = 16
    WFMASH = 32


class Component(enum.IntEnum):
    """Wavefront components (reference: affine2p_penalties.h matrix types)."""

    M = 0
    I1 = 1
    D1 = 2
    I2 = 3
    D2 = 4


# ---------------------------------------------------------------------------
# CIGAR op codes -- pysam-style numeric codes used by pywfa's cigartuples
# (reference: align.pyx:11-14 `codes` LUT and str_codes list)
# ---------------------------------------------------------------------------
CIGAR_OP_CHARS = "MIDNSHP=XB"
CIGAR_CHAR_TO_CODE = {c: i for i, c in enumerate(CIGAR_OP_CHARS)}
CIGAR_M, CIGAR_I, CIGAR_D, CIGAR_N, CIGAR_S, CIGAR_H, CIGAR_P = range(7)
CIGAR_EQ, CIGAR_X, CIGAR_B = 7, 8, 9

# Backtrace source types, ordered so that packing (offset << 4) | type and
# taking the max reproduces WFA2-lib's tie-breaking priority
# M > D2_ext > D2_open > D1_ext > D1_open > I2_ext > I2_open > I1_ext > I1_open
# (reference: wavefront_backtrace.c:49-59)
BT_M = 9
BT_D2_EXT = 8
BT_D2_OPEN = 7
BT_D1_EXT = 6
BT_D1_OPEN = 5
BT_I2_EXT = 4
BT_I2_OPEN = 3
BT_I1_EXT = 2
BT_I1_OPEN = 1
BT_NONE = 0
