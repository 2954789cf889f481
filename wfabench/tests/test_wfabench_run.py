"""run.py: no card, no result; JAX and the JAX package are looked for by
whole top-level names; on the card, one short run prints the contract's
line."""
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

RUN = os.path.join(ROOT, "wfabench", "run.py")


def run(args, env=None):
    return subprocess.run([sys.executable, RUN] + args, cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, **(env or {})))


def test_exits_without_a_card_and_prints_no_result():
    p = run(["--workload", "illumina150-full-stream", "--seed", "1",
             "--seconds", "1", "--trace", "0"], {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
    assert "no CUDA device" in p.stderr


def test_unknown_cell_is_refused():
    p = run(["--workload", "no-such-cell", "--seed", "1", "--seconds", "1",
             "--trace", "0"])
    assert p.returncode != 0 and not p.stdout.strip()


def test_forbidden_modules_compare_whole_top_level_names():
    sys.path.insert(0, os.path.dirname(RUN))
    try:
        import run as R
    finally:
        sys.path.pop(0)
    assert R.forbidden_modules({"pywfa_tpu_torch": 1,
                                "pywfa_tpu_torch.batch": 1,
                                "jaxtyping": 1, "flaxen": 1}) == []
    assert R.forbidden_modules({"pywfa_tpu.align": 1, "jax": 1,
                                "jaxlib.xla": 1, "flax": 1}) == \
        ["flax", "jax", "jaxlib.xla", "pywfa_tpu.align"]


@pytest.mark.cuda
def test_one_short_run_on_the_card(cuda_device):
    p = run(["--workload", "illumina150-full-stream", "--seed",
             str(2**31 + 3), "--seconds", "2", "--trace", "0"])
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared" and line["correct"]
    assert set(line["metrics"]) == {"alignments_per_s", "setup_s"}
    assert line["device"]["platform"] == "gpu"
