"""pywfa_tpu_torch: the PyTorch / CUDA port of pywfa_tpu.

Wavefront alignment on one NVIDIA GPU (Hopper, sm_90a), byte-exact
against the JAX package `pywfa_tpu`, which stays the reference. This
package imports torch, never jax, and nothing of `pywfa_tpu`: it keeps
its own copies of the modules it shares with it (constants, attributes,
cigar, oracle, align, utils, and the native host library, built at first
use).

Covered so far: pywfa's `WavefrontAligner` and the batch and stream API
for all five distance metrics (gap-affine, gap-affine 2-piece,
gap-linear, edit, indel), end-to-end or ends-free with or without a match
bonus, WF-extension mode, full CIGAR or score only, with every heuristic,
wildcards and match classes: every configuration of a short-read call
that `pywfa_tpu` answers. Memory modes other than high and pairs past
256 bp raise NotImplementedError naming their ROADMAP item.
"""
from .align import (
    AlignmentResult,
    WavefrontAligner,
    cigartuples_to_str,
    clip_cigartuples,
    elide_mismatches_from_cigar,
)
from .batch import BatchResult, BatchWavefrontAligner, align_pairs, align_pairs_stream

__all__ = ["WavefrontAligner", "AlignmentResult", "clip_cigartuples",
           "cigartuples_to_str", "elide_mismatches_from_cigar",
           "BatchResult", "BatchWavefrontAligner", "align_pairs",
           "align_pairs_stream"]
