"""Cross-engine fuzz of the port on the CPU (the twin of
tests/test_crosscheck_fuzz.py), and its two fuzzers' CPU runs.

The public WavefrontAligner API: the port's (device="cpu", the kernels'
plain torch versions) against the reference's scalar oracle
(`pywfa_tpu.WavefrontAligner(backend="numpy")`) on (score, status,
cigarstring), the reference test's five configurations and six trials
each. Then tools/fuzz_parity_torch.py and tools/fuzz_partials_torch.py at
fixed seeds on device="cpu", held against `pywfa_tpu.oracle.OracleAligner`,
the reference's own oracle, with the reference's own attributes for the
same arguments. No JAX program is compiled.
"""
import importlib.util
import os
import random
import types

import numpy as np
import pytest

import pywfa_tpu.align as RAlign
import pywfa_tpu.attributes as RA
import pywfa_tpu.constants as RK
import pywfa_tpu.oracle as RO
from pywfa_tpu_torch import WavefrontAligner
from pywfa_tpu_torch import batch as PB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACGT = np.array(list("ACGT"))
REFERENCE = types.SimpleNamespace(WavefrontAligner=RAlign.WavefrontAligner,
                                  OracleAligner=RO.OracleAligner,
                                  HeuristicParams=RA.HeuristicParams,
                                  HeuristicStrategy=RK.HeuristicStrategy)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _seq(rng, n):
    return "".join(rng.choice(ACGT, n))


def _mutate(rng, s, rate):
    out = []
    for c in s:
        r = rng.random()
        if r < rate * 0.5:
            out.append(rng.choice(ACGT))
        elif r < rate * 0.75:
            continue
        elif r < rate:
            out.extend([c, rng.choice(ACGT)])
        else:
            out.append(c)
    return "".join(out)


CONFIGS = [
    dict(),
    dict(distance="affine2p"),
    dict(span="ends-free", pattern_begin_free=20, pattern_end_free=20,
         text_begin_free=20, text_end_free=20),
    dict(distance="levenshtein"),
    dict(scope="score"),
]


@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_crosscheck_fuzz(ci):
    kw = CONFIGS[ci]
    rng = np.random.default_rng(7 + ci)
    for trial in range(6):
        L = int(rng.integers(30, 400))
        p = _seq(rng, L)
        if trial == 5:
            t = _seq(rng, int(rng.integers(30, 400)))  # unrelated, high score
        else:
            t = _mutate(rng, p, rate=float(rng.uniform(0.02, 0.25)))
        a_t = WavefrontAligner(p, device="cpu", **kw)
        a_c = RAlign.WavefrontAligner(p, backend="numpy", **kw)
        rt, rc = a_t(t), a_c(t)
        assert (rt.score, rt.status, rt.cigarstring) == \
            (rc.score, rc.status, rc.cigarstring), \
            (ci, trial, rt.score, rc.score, rt.status, rc.status,
             rt.cigarstring, rc.cigarstring)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_parity_tool_on_cpu(seed):
    """Ten random configurations a seed through the batch path on the CPU,
    each pair against the reference's oracle under the per-pair free-end
    clamps; no pair goes to the oracle for an inconsistent walk or a
    dropped walk."""
    tool = _tool("fuzz_parity_torch")
    lines = []
    done, bad = tool.run(10, seed, device="cpu", reference=REFERENCE,
                         emit=lines.append)
    assert bad is None and done == 10, lines
    assert PB.oracle_fallbacks["inconsistent walk"] == 0
    assert PB.oracle_fallbacks["dropped"] == 0


def test_fuzz_parity_tool_draws_the_reference_corpus():
    """The tool's generators are the reference tool's: the same seed gives
    the same configurations and pairs as tools/fuzz_parity.py's."""
    import ast
    tool = _tool("fuzz_parity_torch")
    src = open(os.path.join(REPO, "tools", "fuzz_parity.py")).read()
    tree = ast.parse(src)
    names = ("rand_seq", "mutate", "random_config")
    ref = {}
    code = ast.Module(body=[n for n in tree.body if isinstance(
        n, ast.FunctionDef) and n.name in names], type_ignores=[])
    exec(compile(code, "fuzz_parity.py", "exec"), ref)
    assert set(names) <= set(ref)
    a, b = random.Random(5), random.Random(5)
    for _ in range(40):
        assert tool.random_config(a) == ref["random_config"](b)
        assert tool.random_pairs(a) == _reference_pairs(ref, b)


def _reference_pairs(ref, rng):
    """The pair mix of tools/fuzz_parity.py's run_iter, on its functions."""
    n = rng.randint(2, 10)
    pairs = []
    for _ in range(n):
        mode = rng.random()
        if mode < 0.6:
            p = ref["rand_seq"](rng, rng.randint(2, 150))
            t = ref["mutate"](rng, p, rng.uniform(0, 0.25),
                              rng.uniform(0, 0.15))
        elif mode < 0.8:
            p = ref["rand_seq"](rng, rng.randint(2, 100))
            t = ref["rand_seq"](rng, rng.randint(2, 100))
        else:
            base = ref["rand_seq"](rng, rng.randint(5, 60))
            p = ref["rand_seq"](rng, rng.randint(0, 10)) + base
            t = base + ref["rand_seq"](rng, rng.randint(0, 10))
        pairs.append((p, t))
    return pairs


@pytest.mark.parametrize("seed0", [0, 3])
def test_fuzz_partials_tool_on_cpu(seed0):
    """The composite heuristic strategies and the WF-extension run on the
    CPU, on (status, score, ops, end_v, end_h, dropped) against the
    reference's oracle; no fallback for an inconsistent walk or a
    dropped walk."""
    tool = _tool("fuzz_partials_torch")
    lines = []
    bad = tool.fuzz(seed0, 3, device="cpu", reference=REFERENCE,
                    emit=lines.append)
    assert bad == 0, lines
    assert PB.oracle_fallbacks["inconsistent walk"] == 0
    assert PB.oracle_fallbacks["dropped"] == 0
