"""Run one cell of the benchmark of pywfa_tpu_torch, once.

    python3 wfabench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the CUDA cards the cell asks
for. It loads the cell by name from BENCHMARK.json, makes the traffic from
the seed, warms up, measures for --seconds, judges the answers against the
plain reference, and prints one JSON line last on standard output: the
cell's end-to-end metrics (--trace 0) or its per-layer metrics, the
profiled slice's device time and breakdown (--trace 1). Without a card it
exits non-zero and prints no result.
"""
import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names that may not be loaded in the process that prints
# the result: the JAX package the port was made from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "pywfa_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_line() -> dict:
    """The cards' names and power limits as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        out = [f"nvidia-smi: {exc}"]
    return {"nvidia_smi": out}


def main(argv=None) -> int:
    args = parse(argv)
    from wfabench import manifest
    cell = manifest.resolve(manifest.load(ROOT), args.workload, ROOT)
    # the program's build caches stay inside the checkout, at fixed paths
    # (its nvcc and g++ libraries go to build/pywfa_tpu_torch by itself)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "wfabench", sub)
    if args.trace:
        # read when pywfa_tpu_torch.batch is imported
        os.environ["PYWFA_PROF"] = "1"
    import torch
    if not torch.cuda.is_available():
        print("wfabench: no CUDA device; the benchmark measures the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"wfabench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    from wfabench import harness
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_PROC)
    found = forbidden_modules()
    if found:
        print("wfabench: modules of JAX or the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    result = out["result"]
    info = dict(card_line(), cards=torch.cuda.device_count(),
                window_s=out["window_s"], counters=out["counters"],
                slice=out["slice"], roofline=out["roofline"],
                wrong_by_kind=out["judged"])
    print("# wfabench " + json.dumps(info), flush=True)
    print(json.dumps(result), flush=True)
    print("wrong answers by kind: " + " ".join(
        f"{k} {v}" for k, v in out["judged"].items()), file=sys.stderr)
    for name, c in result["compared"].items():
        limit = (f"limit {c['limit']}" if "limit" in c
                 else f"at least {c['at_least']}")
        print(f"{name} {c['value']} {limit}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
