"""pywfa-compatible single-pair API on the port.

`WavefrontAligner` is the reference package's `pywfa_tpu.align`
class (jax-free at import) with its engine seam routed to this package:
every property, `AlignmentResult`, the clip and elide helpers,
`check_alignment` and `verbose` are the reference's own, so they stay
byte-identical. Only where an alignment runs differs:

- backend "auto" or "torch": `engine_adapter.align_single` on `device`
  (the hand-written CUDA kernels on "cuda", their plain torch versions on
  "cpu");
- backend "numpy": the scalar oracle, chosen explicitly;
- backend "jax" is refused: that engine belongs to `pywfa_tpu`.
"""
from __future__ import annotations

from pywfa_tpu import align as _ref
from pywfa_tpu.align import (  # noqa: F401
    AlignmentResult,
    clip_cigartuples,
    cigartuples_to_str,
    elide_mismatches_from_cigar,
)
from pywfa_tpu.constants import STATUS_MAX_STEPS_REACHED

from .batch import _resolve_device
from .engine_adapter import align_single

__all__ = [
    "WavefrontAligner",
    "AlignmentResult",
    "clip_cigartuples",
    "cigartuples_to_str",
    "elide_mismatches_from_cigar",
]

BACKENDS = ("auto", "torch", "numpy")


class WavefrontAligner(_ref.WavefrontAligner):
    """Wavefront aligner with pywfa's exact interface, on one device.

    Arguments are pywfa's, plus `backend` ("auto", "torch" or "numpy")
    and `device` ("cuda" by default, which raises when CUDA is absent;
    "cpu" runs the kernels' plain torch versions). Configurations off the
    ported slice raise NotImplementedError naming their ROADMAP item when
    aligning.
    """

    def __init__(self, pattern=None, *args, device="cuda", **kwargs):
        super().__init__(pattern, *args, **kwargs)
        if self._backend not in BACKENDS:
            raise ValueError(
                f"backend {self._backend!r} is not one of {BACKENDS}; the "
                "jax engine is pywfa_tpu.WavefrontAligner's")
        self._oracle = None
        self._device = (None if self._backend == "numpy"
                        else _resolve_device(device))

    def _run_engine(self, bpattern: bytes, btext: bytes, wildcard):
        if self._backend == "numpy":
            # the reference's oracle branch, which keeps the oracle for
            # wavefront_align_resume
            return super()._run_engine(bpattern, btext, wildcard)
        self._oracle = None
        return align_single(self._attributes(), bpattern, btext, wildcard,
                            device=self._device)

    def wavefront_align_resume(self):
        """Continue a MAX_STEPS-paused alignment after `max_steps` was
        raised; returns the score. The numpy backend continues from the
        oracle's retained wavefronts; the device backend aligns again at
        the raised cap (the same result by the engine/oracle contract)."""
        if self._status != STATUS_MAX_STEPS_REACHED:
            raise ValueError(
                "wavefront_align_resume requires a MAX_STEPS_REACHED "
                f"alignment (status is {self._status})")
        self.timer.start()
        if self._oracle is not None:
            result = self._oracle.align_resume(self._max_steps)
        else:
            t = self._text.upper().encode("ascii")
            wc = self._bwildcard if self._wildcard else None
            result = align_single(self._attributes(), self._bpattern, t, wc,
                                  device=self._device)
        self.timer.stop()
        self._status = result.status
        self._cigar_ops = result.ops
        self._score = result.score
        self._dropped = result.dropped
        return self._score
