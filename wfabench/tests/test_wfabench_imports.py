"""What the benchmark's modules import: never JAX or the JAX package
(top-level names compared whole), the reference nothing of the program,
and no module reads the program's own measuring scripts."""
import ast
import os

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "wfabench")
FORBIDDEN = {"jax", "jaxlib", "flax", "pywfa_tpu"}


def modules(path):
    for dirpath, _, files in os.walk(path):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path):
    """Top-level names of every module a file imports."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(modules(BENCH)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_and_no_jax_package(path):
    if os.path.basename(path) == "test_wfabench_imports.py":
        return
    found = set(imported(path)) & FORBIDDEN
    assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_program():
    for path in modules(os.path.join(BENCH, "reference")):
        names = set(imported(path))
        assert not names & (FORBIDDEN | {"pywfa_tpu_torch", "wfabench"}), \
            path


def test_the_scan_tells_the_port_from_the_jax_package(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import pywfa_tpu_torch.batch\nfrom pywfa_tpu_torch "
                 "import align\n")
    assert not set(imported(str(f))) & FORBIDDEN
    f.write_text("from pywfa_tpu.ops import engine\n")
    assert set(imported(str(f))) & FORBIDDEN == {"pywfa_tpu"}


def test_no_module_reads_the_programs_measuring_scripts():
    scripts = ("bench.py", "bench_torch", "chip_smoke", "profile_torch",
               "bench_all", "bench_scaling")
    for path in modules(BENCH):
        if os.path.basename(path) == "test_wfabench_imports.py":
            continue
        names = set(imported(path))
        assert not names & {s.replace(".py", "") for s in scripts}, path
