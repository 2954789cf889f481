"""The readers of the program's own spans (program_spans.py and the
metrics that read it) and of the walk's idle share: None without their
input, the window's spans alone when they have it, the slice's busy time
untouched by the program's ranges, and on the CPU a traced run of each
cell that reports them with self times that fit in the window."""
import collections
import time
from types import SimpleNamespace

import pytest

from wfabench import harness, manifest, program_spans, tracing

SPAN_READERS = ("api_self_ms.call", "dispatch_self_ms.stream",
                "walk_self_ms.stream", "walk_self_ms.call",
                "walk_wait_ms.stream", "walk_steps.stream",
                "forward_ms.stream", "finish_self_ms.stream",
                "escalated_share.stream")
NEW = SPAN_READERS + ("device_idle_walk_share.stream",)


def read(name, ctx):
    return manifest.load_reader(name).read(ctx)


def ctx_of(window, slice_=None):
    return SimpleNamespace(window=window, slice=slice_)


@pytest.fixture
def program_log(monkeypatch):
    """The program's span log, replaced by a list the test fills."""
    from pywfa_tpu_torch import spans
    log = collections.deque(maxlen=spans.LOG_MAX)
    monkeypatch.setattr(spans, "log", log)
    return log


@pytest.mark.parametrize("name", NEW)
def test_each_reader_returns_none_without_its_input(name, program_log):
    assert read(name, ctx_of({})) is None
    window = {"t_start": 1.0, "t_end": 2.0, "batches": 2, "calls": 2,
              "pairs": 8}
    # no span closed yet, and no profiled slice
    assert read(name, ctx_of(dict(window))) is None
    # spans only outside the window
    program_log.append((0.5, "walk", "enqueue", 0.1, 0.1, 4))
    assert read(name, ctx_of(dict(window))) is None


def test_a_log_that_lost_the_window_start_is_not_read(program_log,
                                                      monkeypatch):
    from pywfa_tpu_torch import spans
    monkeypatch.setattr(spans, "LOG_MAX", 2)
    program_log.extend([(1.5, "walk", "enqueue", 0.1, 0.1, 4),
                        (1.6, "walk", "enqueue", 0.1, 0.1, 4)])
    ctx = ctx_of({"t_start": 1.0, "t_end": 2.0, "batches": 2})
    assert read("walk_self_ms.stream", ctx) is None


def test_readers_total_the_window_alone(program_log):
    program_log.extend([
        (0.9, "walk", "enqueue", 9.0, 9.0, 99),       # before the window
        (1.2, "sync", "walk", 0.002, 0.002, 0),
        (1.2, "walk", "enqueue", 0.010, 0.008, 12),
        (1.3, "dispatch", "escalate", 0.004, 0.001, 0),
        (1.3, "finish", "escalate", 0.003, 0.002, 0),
        (1.4, "escalate", "finish", 0.008, 0.001, 3),
        (1.5, "config", "dispatch", 0.001, 0.001, 0),
        (1.6, "forward", "segmented", 0.020, 0.005, 0),
        (1.7, "call", "", 0.030, 0.006, 0),
        (2.5, "walk", "enqueue", 9.0, 9.0, 99)])      # after it
    w = {"t_start": 1.0, "t_end": 2.0, "batches": 2, "calls": 3,
         "pairs": 12}
    ctx = ctx_of(w)
    got = {name: read(name, ctx) for name in SPAN_READERS}
    assert got["walk_self_ms.stream"] == pytest.approx(4.0)
    assert got["walk_self_ms.call"] == pytest.approx(8 / 3)
    assert got["walk_wait_ms.stream"] == pytest.approx(1.0)
    assert got["walk_steps.stream"] == pytest.approx(6.0)
    assert got["dispatch_self_ms.stream"] == pytest.approx(1.0)
    assert got["finish_self_ms.stream"] == pytest.approx(1.5)
    assert got["escalated_share.stream"] == pytest.approx(25.0)
    assert got["forward_ms.stream"] == pytest.approx(10.0)
    assert got["api_self_ms.call"] == pytest.approx(2.0)
    assert ctx.program_spans["n"]["walk"] == 1


def test_escalated_share_counts_each_pair_once(program_log):
    # 16 pairs in two batches: 4 of the first leave their first rung and
    # 2 of those the next rung too (an escalation inside the other); 1 of
    # the second
    program_log.extend([
        (1.3, "escalate", "finish", 0.05, 0.001, 2),
        (1.4, "escalate", "finish", 0.2, 0.001, 4),
        (1.6, "escalate", "finish", 0.1, 0.001, 1)])
    ctx = ctx_of({"t_start": 1.0, "t_end": 2.0, "batches": 2, "pairs": 16})
    assert read("escalated_share.stream", ctx) == pytest.approx(100 * 5 / 16)
    assert ctx.program_spans["count"]["escalate"] == 7


def _ev(name, a, b, device):
    from torch.autograd import DeviceType
    return SimpleNamespace(name=name,
                           time_range=SimpleNamespace(start=a, end=b),
                           device_type=getattr(DeviceType, device))


def test_program_ranges_leave_the_busy_time_and_label_the_walk_gaps():
    # a 100 us slice: kernels at 10-20 and 60-70; the benchmark's own
    # wfa:walk range over 20-90
    base = [_ev("wfa:slice", 0, 100, "CPU"),
            _ev("fused_loop", 10, 20, "CUDA"),
            _ev("elementwise_kernel", 60, 70, "CUDA"),
            _ev("wfa:walk", 20, 90, "CPU")]
    # the program's walk and sync ranges inside it, and the profiler's
    # copies of the program's ranges on the device's timeline
    program = [_ev("wfa:walk", 21, 89, "CPU"), _ev("wfa:sync", 30, 58, "CPU"),
               _ev("wfa:walk", 21, 89, "CUDA"), _ev("wfa:sync", 30, 58, "CUDA"),
               _ev("wfa:dispatch", 0, 9, "CPU"),
               _ev("wfa:dispatch", 0, 9, "CUDA")]
    before = tracing.read_slice(base)
    after = tracing.read_slice(base + program)
    assert after["busy_s"] == before["busy_s"] == pytest.approx(20e-6)
    assert after["device_events"] == before["device_events"] == 2
    gaps = dict(after["idle_gaps"])
    # 20-60 has its middle inside the sync; 70-100 inside the walk alone
    assert gaps["sync"] == pytest.approx(40e-6)
    assert gaps["walk"] == pytest.approx(30e-6)
    assert gaps["dispatch"] == pytest.approx(10e-6)
    ctx = ctx_of({"batches": 1}, after)
    assert read("device_idle_walk_share.stream", ctx) == pytest.approx(30.0)


@pytest.mark.parametrize("name", ["illumina150-full-stream",
                                  "ont10k-full-stream",
                                  "illumina150-api-call"])
def test_a_traced_cpu_run_reports_the_new_metrics(name, small_cell,
                                                  monkeypatch):
    from pywfa_tpu_torch import batch, spans
    monkeypatch.setattr(batch, "_PROF", batch._PROF)  # restored after
    monkeypatch.setenv("PYWFA_STREAM_GC", "1")
    if name.startswith("ont10k"):
        # every rung segmented, as a 10 kb batch of 512 is on the card
        monkeypatch.setattr(batch, "CHOICES_BYTES_CAP", 1)
    cell = small_cell(name)
    wanted = {m["name"] for m in cell["per_layer"]
              if m["name"] in SPAN_READERS}
    spans.reset()
    seen = []
    real = program_spans._read

    def spy(window):
        seen.append((window, real(window)))
        return seen[-1][1]

    monkeypatch.setattr(program_spans, "_read", spy)
    out = harness.run_cell(cell, 2**31 + 9, 0.5, True, "cpu",
                           time.perf_counter())
    assert out["result"]["correct"]
    assert wanted <= set(out["result"]["metrics"])
    # read once a run; the self times of the window's spans fit in its
    # wall, and none is negative
    (window, sp), = seen
    assert sum(sp["self"].values()) <= window["t_end"] - window["t_start"]
    assert all(e[4] >= 0 for e in spans.log)
    spans.reset()
