"""pywfa_tpu_torch: the PyTorch / CUDA port of pywfa_tpu.

Batched wavefront alignment on one NVIDIA GPU (Hopper, sm_90a), byte-exact
against the JAX package `pywfa_tpu`, which stays the reference. This
package imports torch and never jax; from `pywfa_tpu` it reuses only the
jax-free modules (constants, attributes, cigar, oracle, native).

Covered so far: the batch and stream API for gap-affine, end-to-end,
full-CIGAR alignment without heuristics. Other configurations raise
NotImplementedError naming their ROADMAP item.
"""
from .batch import BatchResult, BatchWavefrontAligner, align_pairs, align_pairs_stream

__all__ = ["BatchResult", "BatchWavefrontAligner", "align_pairs",
           "align_pairs_stream"]
