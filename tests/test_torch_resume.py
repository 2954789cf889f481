"""Pause at the step cap and resume, in the port: the twins of the batch
tests of `tests/test_resume.py`.

`pywfa_tpu_torch.batch.align_pairs_resumable` runs a batch through the
checkpointed segmented executor (device="cpu": the fused loop's plain
version with its state in and out) and returns a `PausedBatch` for the
pairs that hit `max_alignment_steps`; `align_pairs_resume` continues them
with a raised cap from their retained state. The resumed results equal a
fresh run at the raised cap and the JAX package's own resumed results, in
status, score and CIGAR. Tolerance: zero.
"""
import pytest
import torch

import pywfa_tpu_torch
from pywfa_tpu import batch as BT
from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.constants import STATUS_MAX_STEPS_REACHED
from pywfa_tpu_torch import batch as PB
from pywfa_tpu_torch.ops import config as C
from tests.test_resume import _mk_pairs

torch.set_num_threads(1)


def _attr(**kw):
    ref = WavefrontAligner(backend="numpy", span="end-to-end",
                           **kw)._attributes()
    return ref, C.attributes_from_reference(ref)


def _key(r):
    return (r.status, r.score, r.ops)


def test_batch_resume_equals_fresh():
    # a mixed batch: pair 0 is trivial and completes, the rest pause
    ps, ts = _mk_pairs(5, 100, 14, seed=4)
    ps[0] = ts[0]
    ref_small, small = _attr(max_steps=9)
    res, paused = PB.align_pairs_resumable(small, ps, ts, device="cpu")
    assert len(res) == 5 and res[0].status == 0 and paused is not None
    hit = [r for r in res if r.status == STATUS_MAX_STEPS_REACHED]
    assert len(hit) >= 3 and all(r.score == -9 for r in hit)
    ref_res, ref_paused = BT.align_pairs_resumable(ref_small, ps, ts)
    assert list(map(_key, res)) == list(map(_key, ref_res))
    res2, paused2 = PB.align_pairs_resume(paused, 100_000)
    assert paused2 is None and len(res2) == 5
    _, full = _attr()
    fresh = PB.align_pairs(full, ps, ts, device="cpu")
    assert list(map(_key, res2)) == list(map(_key, fresh))
    ref_res2, _ = BT.align_pairs_resume(ref_paused, 100_000)
    assert list(map(_key, res2)) == list(map(_key, ref_res2))


def test_batch_resume_chained():
    ps, ts = _mk_pairs(3, 100, 14, seed=5)
    _, small = _attr(max_steps=7)
    res, paused = PB.align_pairs_resumable(small, ps, ts, device="cpu")
    assert paused is not None
    res, paused = PB.align_pairs_resume(paused, 11)  # still paused
    assert paused is not None
    assert any(r.score == -11 for r in res)
    res, paused = PB.align_pairs_resume(paused, 100_000)
    assert paused is None
    _, full = _attr()
    fresh = PB.align_pairs(full, ps, ts, device="cpu")
    assert list(map(_key, res)) == list(map(_key, fresh))


def test_resumable_no_pause_returns_none():
    ps, ts = _mk_pairs(3, 60, 3, seed=6)
    _, attr = _attr()
    res, paused = PB.align_pairs_resumable(attr, ps, ts, device="cpu")
    assert paused is None
    fresh = PB.align_pairs(attr, ps, ts, device="cpu")
    assert list(map(_key, res)) == list(map(_key, fresh))


@pytest.mark.parametrize("kw", [
    dict(distance="affine2p"), dict(heuristic="adaptive"),
    dict(distance="levenshtein"),
])
def test_batch_resume_under_other_configurations(kw):
    """The pause crosses a segment boundary of the resumed run (segments
    of 64 scores), under another metric and with a heuristic's carry."""
    ps, ts = _mk_pairs(4, 120, 16, seed=8)
    _, small = _attr(max_steps=6, **kw)
    res, paused = PB.align_pairs_resumable(small, ps, ts, device="cpu")
    assert paused is not None
    saved = PB.REPLAY_CHOICES_BYTES
    res, paused = PB.align_pairs_resume(paused, 100_000)
    assert paused is None and PB.REPLAY_CHOICES_BYTES == saved
    _, full = _attr(**kw)
    fresh = PB.align_pairs(full, ps, ts, device="cpu")
    assert list(map(_key, res)) == list(map(_key, fresh))


def test_aligner_resume_stays_on_the_oracle():
    """`wavefront_align_resume` of the pywfa API continues the paused
    oracle run, as in the reference, whatever the device."""
    ps, ts = _mk_pairs(1, 80, 12, seed=3)
    a = pywfa_tpu_torch.WavefrontAligner(ps[0].decode(), span="end-to-end",
                                         max_steps=5, device="cpu")
    a.wavefront_align(ts[0].decode())
    assert a.status == STATUS_MAX_STEPS_REACHED
    a.max_steps = 100_000
    score = a.wavefront_align_resume()
    b = WavefrontAligner(ps[0].decode(), span="end-to-end", backend="numpy")
    assert score == b.wavefront_align(ts[0].decode())
    assert a.cigarstring == b.cigarstring


def test_resume_after_pairs_finished_before_the_pause(monkeypatch):
    """Segments of 64 scores; two pairs finish in the first segment and
    four pause at 150, past two boundaries: the boundaries' snapshots keep
    the running pairs alone, the pause keeps every pair, and the batch
    resumes, through a second pause, to the results of a fresh run."""
    monkeypatch.setattr(PB, "CHOICES_BYTES_CAP", 1)
    monkeypatch.setattr(PB, "REPLAY_CHOICES_BYTES", 1)
    ps, ts = _mk_pairs(4, 200, 70, seed=12)
    easy_p, easy_t = _mk_pairs(2, 200, 3, seed=13)
    ps, ts = easy_p + ps, easy_t + ts
    _, small = _attr(max_steps=150)
    res, paused = PB.align_pairs_resumable(small, ps, ts, device="cpu")
    assert paused is not None
    assert [r.status for r in res[:2]] == [0, 0]
    assert all(r.status == STATUS_MAX_STEPS_REACHED for r in res[2:])
    B = paused.state["carry"].shape[0]
    assert paused.state["rows"] is None
    assert paused.state["ring"].shape[0] == B
    assert len(paused.snaps) >= 2
    assert all(sn["rows"] is not None and sn["rows"].tolist() == [2, 3, 4, 5]
               for sn in paused.snaps)
    res, paused = PB.align_pairs_resume(paused, 200)
    assert paused is not None
    assert paused.snaps[-1]["rows"] is not None
    res, paused = PB.align_pairs_resume(paused, 100_000)
    assert paused is None
    _, full = _attr()
    fresh = PB.align_pairs(full, ps, ts, device="cpu")
    assert list(map(_key, res)) == list(map(_key, fresh))
