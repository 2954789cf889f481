"""Find a cell's parts by name: `BENCHMARK.json` at the repository root
names the cells, configurations and metrics; each configuration's file,
each traffic mix (`traffic/<name>.json`), each window driver
(`drivers/<name>.py`) and each per-layer metric's reader
(`metrics/<name>.py`) is a file of its own beside this one. A new cell,
configuration, traffic mix or metric is new files and entries; no file here
needs an edit."""
from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, workload: str, root: str = ROOT,
            bench_dir: str = HERE) -> dict:
    """The cell `workload` with its configuration, traffic mix and the
    metrics it reports, each read from its file."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json "
                       f"(cells: {', '.join(sorted(cells))})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    config = _read_json(os.path.join(root, entry["file"]))
    traffic = _read_json(os.path.join(bench_dir, "traffic",
                                      cell["traffic"] + ".json"))
    end_to_end = [m for m in bench["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, workload) and m["moves"] in reported]
    return {"name": workload, "chips": cell["chips"], "config": config,
            "traffic": traffic, "end_to_end": end_to_end,
            "per_layer": per_layer, "bench_dir": bench_dir}


def _module(path: str, label: str) -> ModuleType:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str, bench_dir: str = HERE) -> ModuleType:
    """drivers/<name>.py: how a traffic mix drives the program's window."""
    return _module(os.path.join(bench_dir, "drivers", name + ".py"),
                   "wfabench_driver_" + name.replace("-", "_"))


def load_reader(metric: str, bench_dir: str = HERE) -> ModuleType:
    """metrics/<metric>.py: the reader of one per-layer metric, whose
    `read(ctx)` returns the value or None when it finds nothing to read."""
    return _module(os.path.join(bench_dir, "metrics", metric + ".py"),
                   "wfabench_metric_" + metric.replace(".", "_")
                   .replace("-", "_"))
