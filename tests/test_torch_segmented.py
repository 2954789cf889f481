"""The port's segmented executor on the CPU: the twins of
`tests/test_segmented.py`, the memory modes and the wide bands.

Caps forced down to one byte (segments of 64 scores) give the results of
one shot and of `pywfa_tpu.batch.align_pairs`, under every kind of
configuration; every memory mode gives the results of high; a pinned band
of 1152 and of 4096 diagonals gives the results of the default ladder.
Status, score and CIGAR (and where it says so every field) are equal.
The two calibration tests of `tests/test_segmented.py` have no twin: see
`tests/test_torch_long_reads.py`.
"""
import collections
import random

import numpy as np
import pytest
import torch

import pywfa_tpu_torch
from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.batch import align_pairs as ref_align_pairs
from pywfa_tpu.oracle import OracleAligner
from pywfa_tpu_torch import batch as PB
from pywfa_tpu_torch.ops import config as C
from pywfa_tpu_torch.ops import fused_loop as TFL
from tests.test_long_reads import _ont_pair
from tests.test_segmented import _pairs

torch.set_num_threads(1)


def _attr(**kw):
    """(the JAX package's attributes, the port's) for the same kwargs."""
    ref = WavefrontAligner(backend="numpy", **kw)._attributes()
    return ref, C.attributes_from_reference(ref)


def _key(r):
    return (r.status, r.score, r.ops)


def _segmented_case():
    pairs = _pairs(3, 8, 60, 160)
    return ([p.encode() for p, _ in pairs], [t.encode() for _, t in pairs])


def test_segmented_matches_oneshot(monkeypatch):
    """Caps forced to one byte (segments of 64 scores): the results of one
    shot, and the reference's."""
    bp, bt = _segmented_case()
    ref, attr = _attr(span="end-to-end")
    one = PB.align_pairs(attr, bp, bt, device="cpu")
    monkeypatch.setattr(PB, "CHOICES_BYTES_CAP", 1)
    monkeypatch.setattr(PB, "REPLAY_CHOICES_BYTES", 1)
    before = PB.segmented_runs["segments"]
    seg = PB.align_pairs(attr, bp, bt, device="cpu")
    assert PB.segmented_runs["segments"] >= before + 2
    assert list(map(_key, seg)) == list(map(_key, one))
    assert list(map(_key, seg)) == list(map(_key,
                                            ref_align_pairs(ref, bp, bt)))


def test_segmented_matches_oracle_divergent(monkeypatch):
    rng = random.Random(9)
    bp = ["".join(rng.choice("ACGT") for _ in range(120)).encode()
          for _ in range(4)]
    bt = ["".join(rng.choice("ACGT") for _ in range(100)).encode()
          for _ in range(4)]
    ref, attr = _attr(span="end-to-end")
    monkeypatch.setattr(PB, "CHOICES_BYTES_CAP", 1)
    monkeypatch.setattr(PB, "REPLAY_CHOICES_BYTES", 1)
    seg = PB.align_pairs(attr, bp, bt, device="cpu")
    orc = OracleAligner(ref)
    assert list(map(_key, seg)) == [_key(orc.align(p, t))
                                    for p, t in zip(bp, bt)]


@pytest.mark.parametrize("kw", [
    dict(span="end-to-end"),
    dict(span="end-to-end", scope="score"),
    dict(span="end-to-end", distance="affine2p"),
    dict(span="end-to-end", heuristic="adaptive"),
    dict(text_begin_free=10, text_end_free=10, match=-1),
    dict(span="end-to-end", distance="levenshtein", wildcard="N"),
    dict(span="end-to-end", match_classes="iupac"),
])
def test_segmented_configurations_match_oneshot(monkeypatch, kw):
    """Caps forced to one byte under other metrics, scopes, a heuristic,
    the seeded span, a wildcard and match classes (which extend by the
    equality bits): the results of one shot."""
    bp, bt = _segmented_case()
    api = pywfa_tpu_torch.WavefrontAligner(backend="numpy", **kw)
    attr = api._attributes()
    wildcard = api._bwildcard if api._wildcard else None
    one = PB.align_pairs(attr, bp, bt, wildcard=wildcard, device="cpu")
    monkeypatch.setattr(PB, "CHOICES_BYTES_CAP", 1)
    monkeypatch.setattr(PB, "REPLAY_CHOICES_BYTES", 1)
    seg = PB.align_pairs_finish(PB.align_pairs_dispatch(
        attr, bp, bt, wildcard, device="cpu", _force_segmented=True))
    for field in ("status", "score", "ops", "end_v", "end_h", "wf_score",
                  "dropped"):
        assert [getattr(r, field) for r in seg] == [getattr(r, field)
                                                    for r in one], field


@pytest.mark.parametrize("fits", [True, False])
def test_table_cap_picks_the_extension(monkeypatch, fits):
    """A segmented run extends by the run-length table while the table's
    bytes stay within LCP_TABLE_BYTES_CAP_REMAT and by the equality bits
    one byte past it, with the same results."""
    bp, bt = _segmented_case()
    _, attr = _attr(span="end-to-end")
    one = PB.align_pairs(attr, bp, bt, device="cpu")
    monkeypatch.setattr(PB, "CHOICES_BYTES_CAP", 1)
    monkeypatch.setattr(PB, "REPLAY_CHOICES_BYTES", 1)
    built = []
    build = PB.E.build_extension

    def spy(cfg, pat, txt):
        ext = build(cfg, pat, txt)
        built.append((2 * pat.shape[0] * cfg.W * txt.shape[1],
                      "table" if ext["table"] is not None else "bits"))
        return ext

    monkeypatch.setattr(PB.E, "build_extension", spy)
    PB.align_pairs(attr, bp, bt, device="cpu")
    table_bytes = built[0][0]
    assert {kind for _, kind in built} == {"table"}
    del built[:]
    monkeypatch.setattr(PB, "LCP_TABLE_BYTES_CAP_REMAT",
                        table_bytes if fits else table_bytes - 1)
    seg = PB.align_pairs(attr, bp, bt, device="cpu")
    assert built[0] == (table_bytes, "table" if fits else "bits")
    assert list(map(_key, seg)) == list(map(_key, one))


@pytest.mark.parametrize("mode", ["medium", "low", "biwfa"])
def test_memory_modes_give_the_results_of_high(monkeypatch, mode):
    """With the record budget at 1 MiB each lower mode segments earlier
    (a 16th, a 64th of it), and every mode answers as high does."""
    rng = random.Random(11)
    pairs = [_ont_pair(rng, 400) for _ in range(4)]
    bp = [p.encode() for p, _ in pairs]
    bt = [t.encode() for _, t in pairs]
    monkeypatch.setattr(PB, "CHOICES_BYTES_CAP", 2**20)
    high = pywfa_tpu_torch.BatchWavefrontAligner(span="end-to-end",
                                                 device="cpu").align(bp, bt)
    before = PB.segmented_runs["runs"]
    got = pywfa_tpu_torch.BatchWavefrontAligner(
        span="end-to-end", memory_mode=mode, device="cpu").align(bp, bt)
    assert PB.segmented_runs["runs"] > before
    assert list(map(_key, got)) == list(map(_key, high))
    a = pywfa_tpu_torch.WavefrontAligner(bp[0].decode(), span="end-to-end",
                                         memory_mode=mode, device="cpu")
    a(bt[0].decode())
    assert (a.status, a.score) == (high[0].status, high[0].score)


@pytest.mark.parametrize("W", [1152, 4096])
def test_wide_bands_match_the_default_rungs(W):
    """A pinned band of 1152 (several diagonals a thread) and of 4096
    (past a block's shared memory, the ring in global memory on the card)
    gives the results of the default ladder."""
    rng = random.Random(13)
    pairs = [_ont_pair(rng, 300) for _ in range(3)]
    bp = [p.encode() for p, _ in pairs]
    bt = [t.encode() for _, t in pairs]
    _, attr = _attr(span="end-to-end")
    cfg = C.full_config(attr, 320, 320, W=W)
    assert TFL.supported(cfg) and TFL.ring_in_global(cfg) == (W == 4096)
    got = PB.align_pairs(attr, bp, bt, device="cpu", W=W, S_cap=700)
    assert list(map(_key, got)) == list(map(_key, PB.align_pairs(
        attr, bp, bt, device="cpu")))


def test_progress_lines_at_segment_boundaries(monkeypatch, capsys):
    bp, bt = _segmented_case()
    api = pywfa_tpu_torch.WavefrontAligner(backend="numpy",
                                           span="end-to-end", verbose=4)
    monkeypatch.setattr(PB, "CHOICES_BYTES_CAP", 1)
    monkeypatch.setattr(PB, "REPLAY_CHOICES_BYTES", 1)
    PB.align_pairs(api._attributes(), bp, bt, device="cpu")
    err = capsys.readouterr().err
    assert "[pywfa_tpu_torch::align] Score 63 " in err
    assert "running" in err and "host-snapshots" in err


@pytest.mark.parametrize("mode", ["high", "medium", "low", "biwfa"])
def test_snapshots_keep_the_running_pairs_alone(monkeypatch, mode):
    """Caps forced to one byte under each memory mode: each boundary's
    snapshot keeps the ring rows of the pairs still running there and no
    others (the padded batch's pairs are done at once), its `compact`
    span counts them, each replay's `expand` span puts as many back, and
    the results are those of one shot and of the reference."""
    from pywfa_tpu_torch import spans
    bp, bt = _segmented_case()
    ref, _ = _attr(span="end-to-end")
    attr = pywfa_tpu_torch.WavefrontAligner(
        backend="numpy", span="end-to-end", memory_mode=mode)._attributes()
    one = PB.align_pairs(attr, bp, bt, device="cpu")
    monkeypatch.setattr(PB, "CHOICES_BYTES_CAP", 1)
    monkeypatch.setattr(PB, "REPLAY_CHOICES_BYTES", 1)
    monkeypatch.setattr(PB, "_PROF", True)
    running, snaps = [], []

    def forward(fn):
        def run(*args):
            out, state = fn(*args)
            running.append(torch.nonzero(
                out["status"] == C.ST_OVERFLOW_S).flatten().tolist())
            return out, state
        return run

    def snapshot(fn):
        def run(state, rows=None):
            snaps.append(fn(state, rows))
            return snaps[-1]
        return run

    for name in ("align_batch_start", "align_batch_resume"):
        monkeypatch.setattr(PB.E, name, forward(getattr(PB.E, name)))
    monkeypatch.setattr(PB, "_snapshot", snapshot(PB._snapshot))
    spans.reset()
    seg = PB.align_pairs(attr, bp, bt, device="cpu")
    counts = collections.defaultdict(list)
    for _, name, _, _, _, count in spans.log:
        counts[name].append(count)
    spans.reset()
    boundaries = [r for r in running if r]
    assert boundaries and len(snaps) == len(boundaries)
    for snap, r in zip(snaps, boundaries):
        B = snap["carry"].shape[0]
        kept = (list(range(B)) if snap["rows"] is None
                else snap["rows"].tolist())
        assert kept == r and snap["ring"].shape[0] == len(r)
    assert any(snap["ring"].shape[0] < snap["carry"].shape[0]
               for snap in snaps)
    assert counts["compact"] == [len(r) for r in boundaries]
    assert counts["expand"] and not (collections.Counter(counts["expand"])
                                     - collections.Counter(counts["compact"]))
    assert list(map(_key, seg)) == list(map(_key, one))
    assert list(map(_key, seg)) == list(map(_key,
                                            ref_align_pairs(ref, bp, bt)))


def test_restore_gives_a_left_out_pair_a_null_ring():
    """A compact snapshot restored into a used state: the kept pairs' ring
    rows come back, every other pair's ring is NULL, lohi and carry are
    whole, and the snapshot is left as it was."""
    g = torch.Generator().manual_seed(3)
    state = {k: torch.randint(-9, 9, shape, dtype=torch.int32, generator=g)
             for k, shape in (("ring", (6, 5, 32)), ("lohi", (6, 5, 2)),
                              ("carry", (6, 12)))}
    state["s"] = 63
    snap = PB._snapshot(state, np.array([1, 4]))
    assert snap["rows"].tolist() == [1, 4] and snap["ring"].shape[0] == 2
    held = {k: v.clone() for k, v in snap.items() if k != "s"}
    used = {k: torch.zeros_like(state[k]) for k in ("ring", "lohi", "carry")}
    for into in (None, used):
        got = PB._restore(snap, torch.device("cpu"), into=into)
        assert got["s"] == 63
        assert torch.equal(got["ring"][[1, 4]], state["ring"][[1, 4]])
        assert (got["ring"][[0, 2, 3, 5]] == C.NULL).all()
        assert torch.equal(got["lohi"], state["lohi"])
        assert torch.equal(got["carry"], state["carry"])
        if into is not None:
            assert got["ring"] is used["ring"]
    assert all(torch.equal(snap[k], v) for k, v in held.items())
    whole = PB._snapshot(state, np.arange(6))
    assert whole["rows"] is None
    assert torch.equal(PB._restore(whole, torch.device("cpu"))["ring"],
                       state["ring"])
