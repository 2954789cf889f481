"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix and metric resolves by name, the manifest keeps the
contract's shape, and a new part is found without editing a file."""
import hashlib
import json
import os
import re
import shutil

from conftest import ROOT
from wfabench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return manifest.load(ROOT)


def test_every_cell_resolves_to_its_files():
    b = bench()
    for w in b["workloads"]:
        cell = manifest.resolve(b, w["name"], ROOT)
        assert cell["config"]["name"] == w["config"]
        manifest.load_driver(cell["traffic"]["driver"])
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert callable(manifest.load_reader(m["name"]).read)
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in b["workloads"])


def test_manifest_keeps_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"][1].startswith(b["paths"][0] + "/")
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = manifest.resolve(b, w["name"], ROOT)
        reported = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell["per_layer"]
    assert len(json.dumps(b)) < 64 * 1024


def _tree_digest(path):
    h = hashlib.sha256()
    for dirpath, dirnames, files in sorted(os.walk(path)):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for f in sorted(files):
            if f.endswith(".pyc"):
                continue
            p = os.path.join(dirpath, f)
            h.update(p[len(path):].encode())
            with open(p, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def test_new_parts_are_found_without_editing_a_file(tmp_path):
    root = tmp_path / "checkout"
    bench_dir = root / "wfabench"
    shutil.copytree(os.path.join(ROOT, "wfabench"), bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        (root / "BENCHMARK.json").write_text(fh.read())
    before = _tree_digest(str(bench_dir))
    # a throwaway configuration, traffic mix and metric: new files only
    cfg = json.loads((bench_dir / "configs" / "illumina150.json").read_text())
    cfg.update(name="toy", reads=dict(cfg["reads"], length=40))
    (bench_dir / "configs" / "toy.json").write_text(json.dumps(cfg))
    tr = json.loads((bench_dir / "traffic" / "full-stream.json").read_text())
    tr["depth"] = 1
    (bench_dir / "traffic" / "toy-mix.json").write_text(json.dumps(tr))
    (bench_dir / "metrics" / "toy_ms.stream.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    b["configs"].append({"name": "toy", "source": "a test",
                         "file": "wfabench/configs/toy.json", "reduced": [],
                         "why": "a test"})
    b["workloads"].append({"name": "toy-cell", "config": "toy",
                           "traffic": "toy-mix", "chips": 1, "why": "x"})
    b["end_to_end"][0].setdefault("workloads", []).append("toy-cell")
    b["per_layer"].append({"name": "toy_ms.stream", "unit": "ms",
                           "better": "lower", "source": "program_span",
                           "layer": "batch dispatch",
                           "moves": b["end_to_end"][0]["name"],
                           "workloads": ["toy-cell"]})
    cell = manifest.resolve(b, "toy-cell", str(root), str(bench_dir))
    assert cell["config"]["reads"]["length"] == 40
    assert cell["traffic"]["depth"] == 1
    assert [m["name"] for m in cell["per_layer"]] == ["toy_ms.stream"]
    reader = manifest.load_reader("toy_ms.stream", str(bench_dir))
    assert reader.read(None) == 42.0
    manifest.load_driver(cell["traffic"]["driver"], str(bench_dir))
    # the files that were there are as they were
    for f in ("configs/toy.json", "traffic/toy-mix.json",
              "metrics/toy_ms.stream.py"):
        os.unlink(bench_dir / f)
    assert _tree_digest(str(bench_dir)) == before
