"""The PYWFA_PROF stage report of the port's batch pipeline against the
reference's, and bench_torch.py's one JSON line against bench.py's.

Both packages' `batch._PROF` are turned on by patching the module
constant; the same two small batches run through both packages'
`align_pairs_stream` (dispatch, pull, finish): a gap-affine batch with one
pair at 60% divergence, which escalates past the first rung, and an indel
batch with one pair of disjoint alphabets, whose score passes the
terminal rung's cap and goes to the host oracle. Both reports carry the
same keys, and the same count under each: the two pipelines take the same
steps at these points (the port's walk runs inside d.push_enqueue, as the
reference's runs inside its one compiled program).
"""
import ast
import json
import os
import random
import subprocess
import sys

import pytest

import pywfa_tpu.batch as RB
import pywfa_tpu_torch.batch as PB
from pywfa_tpu.align import WavefrontAligner as RefAligner
from pywfa_tpu_torch.align import WavefrontAligner as PortAligner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"d.config", "d.encode", "d.push_enqueue", "p.pull_wait", "f.pull",
        "f.native_fill", "f.assemble", "f.escalate", "f.oracle"}


def _batches():
    rng = random.Random(3)

    def seq(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    def mut(p, rate):
        return "".join(c if rng.random() > rate else rng.choice("ACGT")
                       for c in p)

    base = [seq(100) for _ in range(4)]
    escalating = ([p.encode() for p in base],
                  [mut(p, 0.03).encode() for p in base[:3]]
                  + [mut(base[3], 0.6).encode()])
    to_oracle = ([seq(40).encode() for _ in range(2)] + [b"A" * 60],
                 [seq(40).encode() for _ in range(2)] + [b"C" * 60])
    return [("escalates", dict(span="end-to-end"), escalating),
            ("oracle", dict(distance="indel", span="end-to-end"), to_oracle)]


@pytest.mark.parametrize("case", range(2), ids=["escalates", "oracle"])
def test_stage_report_matches_the_reference(case, monkeypatch):
    monkeypatch.setenv("PYWFA_STREAM_GC", "1")  # no gc.freeze in the test
    monkeypatch.setattr(RB, "_PROF", True)
    monkeypatch.setattr(PB, "_PROF", True)
    name, kw, (pats, txts) = _batches()[case]
    counts, results = [], []
    for mod, aligner, dev in ((RB, RefAligner, {}),
                              (PB, PortAligner, {"device": "cpu"})):
        mod.PROF.clear()
        mod.PROF_N.clear()
        attr = aligner(backend="numpy", **kw)._attributes()
        res = list(mod.align_pairs_stream(attr, [(pats, txts)], depth=1,
                                          **dev))[0]
        results.append([(r.status, r.score, r.ops) for r in res])
        counts.append(dict(mod.PROF_N))
        report = mod.prof_report()
        assert not mod.PROF and not mod.PROF_N  # reset
        lines = report.splitlines()
        assert len(lines) == len(counts[-1])
        for line in lines:
            key, rest = line.split(None, 1)
            assert key in KEYS and "ms total" in rest
            assert rest.rstrip().endswith(f"x {counts[-1][key]})")
    ref, port = counts
    assert results[0] == results[1]
    assert set(ref) == set(port)
    for key in ("d.encode", "f.escalate", "f.oracle"):
        assert ref.get(key) == port.get(key), key
    # every other key as well: the two pipelines take the same steps here
    assert ref == port
    wanted = "f.escalate" if name == "escalates" else "f.oracle"
    assert port[wanted] == 1
    assert set(port) == KEYS - {"f.oracle" if name == "escalates"
                                else "f.escalate"}


def test_stage_report_off_records_nothing():
    assert PB._PROF is (os.environ.get("PYWFA_PROF", "") not in ("", "0"))
    if PB._PROF:
        pytest.skip("PYWFA_PROF is set in this environment")
    PB.PROF.clear()
    PB.PROF_N.clear()
    attr = PortAligner(backend="numpy", span="end-to-end")._attributes()
    pats, txts = _batches()[0][2]
    list(PB.align_pairs_stream(attr, [(pats, txts)], device="cpu"))
    assert not PB.PROF and not PB.PROF_N
    assert PB.prof_report() == ""


def _bench_keys():
    """The keys of the dict bench.py prints, read from its source."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result"
                        for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("bench.py prints no result dict")


def test_bench_torch_prints_bench_py_keys():
    env = dict(os.environ, BENCH_B="8", BENCH_ITERS="2")
    out = subprocess.run([sys.executable, "bench_torch.py", "--device", "cpu"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == _bench_keys() == ["metric", "value", "unit",
                                           "vs_baseline"]
    assert line["metric"] == "alignment_cell_updates_per_s"
    assert line["unit"] == "cells/s" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 10e6, 3)
    err = out.stderr.strip().splitlines()[-1]
    assert err.startswith("# batch=8 len=150 W=128 S_cap=96 ops_out=32")
    assert "build=plain" in err and "device=cpu" in err
