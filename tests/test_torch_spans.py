"""The port's span tree (`pywfa_tpu_torch/spans.py`) on the CPU.

Under the switch (`batch._PROF`) the batch path records one tree of
spans from the entry points down to the walk's syncs: every span sits
under a parent the layers allow, self times are never negative and sum
to the roots' durations, an escalated rung's dispatch and finish sit
under the escalation, and the spans carry what the batch did (forward
segments and replays as `segmented_runs` counts them, a walk's steps
with at most one sync in four, an escalation's pairs). With the switch
off nothing is recorded, and a profiler range opens only while a
profiler runs.
"""
import random

import pytest
import torch

import pywfa_tpu_torch.batch as PB
from pywfa_tpu_torch import spans
from pywfa_tpu_torch.align import WavefrontAligner

# each span's allowed parents ("" for a root)
PARENTS = {
    "call": {""},
    "dispatch": {"call", "escalate", ""},
    "config": {"dispatch"},
    "encode": {"dispatch", "segmented"},
    "push": {"dispatch", "segmented"},
    "stage_out": {"dispatch"},
    "enqueue": {"dispatch"},
    "decode": {"enqueue"},
    # a segmented run builds the extension's input once, for every segment
    "extension": {"enqueue", "segmented"},
    "loop": {"enqueue", "forward", "replay"},
    "pack": {"enqueue"},
    "walk": {"enqueue", "replay"},
    "sync": {"walk"},
    "segmented": {"dispatch", ""},
    "forward": {"segmented"},
    "snapshot": {"segmented"},
    "compact": {"snapshot"},
    "replay": {"segmented"},
    "restore": {"segmented", "replay"},
    "expand": {"restore"},
    "gather": {"segmented"},
    "pull_wait": {""},
    "finish": {"", "call", "escalate"},
    "pull": {"finish"},
    "native_fill": {"finish", "segmented"},
    "assemble": {"finish", "segmented"},
    "escalate": {"finish", "segmented"},
    "oracle": {"finish", "segmented"},
}


def _escalating_batch():
    """Three close pairs and one at 60% divergence, which overflows the
    first rung's caps."""
    rng = random.Random(3)

    def seq(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    def mut(p, rate):
        return "".join(c if rng.random() > rate else rng.choice("ACGT")
                       for c in p)

    base = [seq(100) for _ in range(4)]
    return ([p.encode() for p in base],
            [mut(p, 0.03).encode() for p in base[:3]]
            + [mut(base[3], 0.6).encode()])


def _zero(counts):
    for k in counts:
        counts[k] = 0


@pytest.fixture
def traced(monkeypatch):
    """The switch on, every span and segmented_runs zeroed."""
    monkeypatch.setenv("PYWFA_STREAM_GC", "1")
    monkeypatch.setattr(PB, "_PROF", True)
    spans.reset()
    _zero(PB.segmented_runs)
    yield
    spans.reset()


def _check_tree():
    """Every logged span under an allowed parent, self times not
    negative and summing to the roots' totals; returns the log."""
    assert not spans._stack
    log = list(spans.log)
    assert log
    for _, name, parent, d, own, _ in log:
        assert parent in PARENTS[name], (name, parent)
        assert own >= 0 and d >= own
    roots = sum(d for _, _, parent, d, _, _ in log if not parent)
    assert sum(own for *_, own, _ in log) == pytest.approx(roots, rel=1e-9)
    assert sum(spans.self_s.values()) == pytest.approx(roots, rel=1e-9)
    for name in spans.n:
        assert spans.n[name] == sum(1 for e in log if e[1] == name)
    return log


def _check_counts(log):
    """Each walk took steps and synced at most once in four of them (a
    walk of more than four steps at least once); each escalation sent
    pairs on; the segmented executor's spans match segmented_runs."""
    steps = [e[5] for e in log if e[1] == "walk"]
    assert steps and min(steps) > 0
    assert sum(c > 4 for c in steps) <= spans.n["sync"] \
        <= sum(c // 4 for c in steps)
    assert all(e[5] > 0 for e in log if e[1] == "escalate")
    assert spans.n["forward"] == PB.segmented_runs["segments"]
    assert spans.n["replay"] == PB.segmented_runs["replays"]
    # one count a snapshot and a restore: the pairs whose rows they moved
    assert spans.n["compact"] == spans.n["snapshot"]
    assert spans.n["expand"] == spans.n["restore"]


def test_an_escalating_stream_is_one_tree(traced):
    attr = WavefrontAligner(backend="numpy", span="end-to-end")._attributes()
    pats, txts = _escalating_batch()
    list(PB.align_pairs_stream(attr, [(pats, txts)] * 2, depth=1,
                               device="cpu"))
    log = _check_tree()
    _check_counts(log)
    under = {(name, parent) for _, name, parent, *_ in log}
    assert {("dispatch", "escalate"), ("finish", "escalate"),
            ("walk", "enqueue"), ("sync", "walk")} <= under
    # one pair of each batch's four sent to the next rung
    assert [e[5] for e in log if e[1] == "escalate"] == [1, 1]
    assert spans.n["dispatch"] == 4 and spans.n["pull_wait"] == 2
    # the PYWFA_PROF keys count as before beside the spans
    assert PB.PROF_N["f.escalate"] == 2


def test_a_segmented_batch_is_one_tree(traced, monkeypatch):
    # segments of 64 scores, so that the run has several to replay
    monkeypatch.setattr(PB, "REPLAY_CHOICES_BYTES", 1)
    monkeypatch.setattr(PB, "CHOICES_BYTES_CAP", 1)
    attr = WavefrontAligner(backend="numpy", span="end-to-end")._attributes()
    pats, txts = _escalating_batch()
    res = PB.align_pairs_finish(PB.align_pairs_dispatch(
        attr, pats, txts, device="cpu"))
    assert len(res) == 4
    log = _check_tree()
    _check_counts(log)
    assert PB.segmented_runs["segments"] > 1
    assert PB.segmented_runs["replays"] > 1
    under = {(name, parent) for _, name, parent, *_ in log}
    assert {("segmented", "dispatch"), ("forward", "segmented"),
            ("loop", "forward"), ("replay", "segmented"),
            ("restore", "replay"), ("walk", "replay"),
            ("compact", "snapshot"), ("expand", "restore"),
            ("gather", "segmented"), ("native_fill", "segmented")} <= under


def test_a_call_is_one_tree(traced):
    a = WavefrontAligner(span="end-to-end", device="cpu")
    pats, txts = _escalating_batch()
    for p, t in zip(pats, txts):
        a(t.decode(), p.decode())
    log = _check_tree()
    _check_counts(log)
    assert spans.n["call"] == 4
    roots = {name for _, name, parent, *_ in log if not parent}
    assert roots == {"call"}
    under = {(name, parent) for _, name, parent, *_ in log}
    assert {("dispatch", "call"), ("finish", "call")} <= under


def test_switch_off_records_nothing(monkeypatch):
    monkeypatch.setattr(PB, "_PROF", False)
    spans.reset()
    opened = []
    monkeypatch.setattr(spans, "begin", opened.append)
    attr = WavefrontAligner(backend="numpy", span="end-to-end")._attributes()
    pats, txts = _escalating_batch()
    list(PB.align_pairs_stream(attr, [(pats, txts)], device="cpu"))
    monkeypatch.setattr(PB, "CHOICES_BYTES_CAP", 1)
    PB.align_pairs_finish(PB.align_pairs_dispatch(
        attr, pats, txts, device="cpu"))
    WavefrontAligner(device="cpu")(txts[0].decode(), pats[0].decode())
    assert not opened
    assert not spans.total_s and not spans.self_s and not spans.n
    assert not spans.log and not spans._stack


def test_the_switch_is_read_when_a_site_runs(traced, monkeypatch):
    """One switch: patching batch._PROF turns the engine's spans on and
    off too (the walk's among them), without a re-import."""
    attr = WavefrontAligner(backend="numpy", span="end-to-end")._attributes()
    pats, txts = _escalating_batch()
    PB.align_pairs(attr, pats[:3], txts[:3], device="cpu")
    assert spans.n["walk"] == 1 and spans.n["loop"] == 1
    monkeypatch.setattr(PB, "_PROF", False)
    PB.align_pairs(attr, pats[:3], txts[:3], device="cpu")
    assert spans.n["walk"] == 1 and spans.n["loop"] == 1


def test_ranges_open_only_under_a_profiler(traced, monkeypatch):
    attr = WavefrontAligner(backend="numpy", span="end-to-end")._attributes()
    pats, txts = _escalating_batch()
    made = []
    real = spans._profiler.record_function

    def record(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(spans._profiler, "record_function", record)
    PB.align_pairs(attr, pats[:3], txts[:3], device="cpu")
    assert not made
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        PB.align_pairs(attr, pats[:3], txts[:3], device="cpu")
    assert set(made) == {spans.PREFIX + k for k in spans.n}
    names = {ev.name for ev in prof.events()}
    assert {"wfa:dispatch", "wfa:walk", "wfa:sync", "wfa:finish"} <= names
    assert not spans._stack


def test_an_exception_closes_the_spans_it_left_open(traced, monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("the fill failed")

    monkeypatch.setattr(PB, "_native_fill", broken)
    attr = WavefrontAligner(backend="numpy", span="end-to-end")._attributes()
    pats, txts = _escalating_batch()
    with pytest.raises(RuntimeError):
        PB.align_pairs(attr, pats[:3], txts[:3], device="cpu")
    assert not spans._stack
    assert spans.n["native_fill"] == 1 and spans.n["finish"] == 1


def test_report_lists_each_span_per_unit(traced):
    assert spans.report() == ""
    spans.begin("a")
    spans.begin("b")
    spans.end(3)
    spans.end()
    lines = spans.report(units=2).splitlines()
    assert [ln.split()[0] for ln in lines] == sorted(
        ["a", "b"], key=spans.self_s.get, reverse=True)
    assert all(ln.rstrip().endswith("x     0.50") for ln in lines)
    assert [e[1:3] + e[5:] for e in spans.log] == [("b", "a", 3),
                                                   ("a", "", 0)]
    torch.testing.assert_close(spans.total_s["a"], spans.self_s["a"]
                               + spans.total_s["b"])
