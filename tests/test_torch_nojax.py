"""The port stands on its own: it runs with jax absent, as it must on a
GPU host without it, and imports nothing of the JAX package `pywfa_tpu`.

A subprocess installs an import hook that refuses `jax`, `jaxlib` and
`pywfa_tpu`, imports pywfa_tpu_torch, aligns 8 pairs on the CPU through
the batch API (two distance metrics), through `WavefrontAligner` with
pywfa's defaults (ends-free, both scopes) and through the command line (a
lowercase pattern file), checks them against the port's scalar oracle,
builds a mesh of two CPU devices, and asserts that neither jax nor
`pywfa_tpu` entered sys.modules. A scan of the sources holds the same for
every file that runs on the card.
"""
import os
import re
import subprocess
import sys

SCRIPT = r"""
import sys

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "pywfa_tpu"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, _NoJax())

import torch
torch.set_num_threads(1)
import pywfa_tpu_torch
from pywfa_tpu_torch.oracle import OracleAligner
from tests.corpus import random_pairs

pairs = random_pairs(41, 8, 20, 90, 0.05, 0.05, as_bytes=True)
aligner = pywfa_tpu_torch.BatchWavefrontAligner(span="end-to-end",
                                                device="cpu")
res = aligner.align([p for p, _ in pairs], [t for _, t in pairs])
for (p, t), r in zip(pairs, res):
    o = OracleAligner(aligner._attr).align(p, t)
    assert (r.status, r.score, r.ops) == (o.status, o.score, o.ops), (p, t)
aligner2 = pywfa_tpu_torch.BatchWavefrontAligner(
    distance="affine2p", span="end-to-end", device="cpu")
for (p, t), r in zip(pairs, aligner2.align([p for p, _ in pairs],
                                           [t for _, t in pairs])):
    o = OracleAligner(aligner2._attr).align(p, t)
    assert (r.status, r.score, r.ops) == (o.status, o.score, o.ops), (p, t)
for scope in ("full", "score"):
    a = pywfa_tpu_torch.WavefrontAligner(scope=scope, device="cpu")
    o = pywfa_tpu_torch.WavefrontAligner(scope=scope, backend="numpy")
    for p, t in pairs:
        a(t.decode(), p.decode())
        o(t.decode(), p.decode())
        assert (a.status, a.score, a.cigarstring, a.locations) == (
            o.status, o.score, o.cigarstring, o.locations), (p, t)
# the mesh and the command line, on the CPU
import os
import tempfile
import torch
from pywfa_tpu_torch import cli
from pywfa_tpu_torch.parallel import make_mesh
from pywfa_tpu_torch.utils import write_fasta
mesh = make_mesh([torch.device("cpu")] * 2)
assert mesh.size == 2 and mesh.group is None
with tempfile.TemporaryDirectory() as tmp:
    pfa, tfa, out = (os.path.join(tmp, n) for n in ("p.fa", "t.fa", "o.tsv"))
    write_fasta(pfa, [(f"p{i}", p.decode().lower())
                      for i, (p, _) in enumerate(pairs)])
    write_fasta(tfa, [(f"t{i}", t.decode()) for i, (_, t) in enumerate(pairs)])
    assert cli.main(["align", "--patterns", pfa, "--texts", tfa, "--out", out,
                     "--span", "end-to-end", "--device", "cpu"]) == 0
    rows = [r.split("\t") for r in open(out).read().splitlines()]
for (p, t), row in zip(pairs, rows):
    o = OracleAligner(aligner._attr).align(p, t)
    assert row[2:4] == [str(o.status), str(o.score)], (p, t, row)
assert len(rows) == len(pairs)
assert "jax" not in sys.modules and "jaxlib" not in sys.modules
assert pywfa_tpu_torch.native.lib() is not None
assert not [m for m in sys.modules
            if m == "pywfa_tpu" or m.startswith("pywfa_tpu.")]
print("OK", len(res))
"""


def test_port_imports_and_aligns_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("OK 8")


def test_port_sources_never_import_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "pywfa_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as fh:
                    src = fh.read()
                assert "import jax" not in src and "from jax" not in src, name


IMPORTS_REFERENCE = re.compile(r"^\s*(from|import)\s+pywfa_tpu(\.|\s|$)",
                               re.MULTILINE)


def test_sources_that_run_on_the_card_never_import_the_jax_package():
    """Nothing under pywfa_tpu_torch/, nor the scripts (the smoke run, the
    profiler, the build timer, the bench), the tools (the worker, the two
    fuzzers, the soak) and the tests that run without jax, imports
    `pywfa_tpu` or a module of it;
    nor does any of them but the package (scanned above) import jax."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [os.path.join(root, "chip_smoke.py"),
             os.path.join(root, "profile_torch.py"),
             os.path.join(root, "time_builds.py"),
             os.path.join(root, "bench_torch.py"),
             os.path.join(root, "tools", "mp_worker_torch.py"),
             os.path.join(root, "tools", "fuzz_parity_torch.py"),
             os.path.join(root, "tools", "fuzz_partials_torch.py"),
             os.path.join(root, "tools", "soak_sanitize_torch.py"),
             os.path.join(root, "tests", "test_torch_cuda.py")]
    for dirpath, _, files in os.walk(os.path.join(root, "pywfa_tpu_torch")):
        paths += [os.path.join(dirpath, n) for n in files
                  if n.endswith(".py")]
    assert len(paths) > 15
    for path in paths:
        with open(path) as fh:
            src = fh.read()
        found = IMPORTS_REFERENCE.search(src)
        assert found is None, (path, found and found.group(0))
        assert "import jax" not in src and "from jax" not in src, path
    assert IMPORTS_REFERENCE.search("from pywfa_tpu.oracle import X")
    assert IMPORTS_REFERENCE.search("    import pywfa_tpu")
    assert not IMPORTS_REFERENCE.search("from pywfa_tpu_torch import batch")
