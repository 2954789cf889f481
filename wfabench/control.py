"""The control of the comparison that decides `correct`, at a cell's own
size; the benchmark's runs do not run it.

    python3 wfabench/control.py --workload <cell> --seeds 1,2,3 [--device cuda]

For each seed it makes the cell's pool as a run does and puts the plain
reference in the program's place, computed in 8-bit integers (the nearest
precision below the 16 bits the configurations state), and judges those
answers as a run judges the program's. One line a reading:
`control int8 seed=<n> <number>=<value> ...`.
"""
import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def int8_reading(cell: dict, seed: int, device) -> dict:
    """The compared numbers of the reference in 8-bit integers, over the
    whole pool of the seed."""
    import numpy as np
    import torch

    from wfabench import check, manifest
    from wfabench.reference.dp import affine_costs
    driver = manifest.load_driver(cell["traffic"]["driver"],
                                  cell["bench_dir"])
    pats, txts = driver.make_pool(cell, np.random.default_rng(seed % 2**64))
    pen = cell["config"]["penalties"]
    idx = list(range(len(pats)))
    cost_of = check.reference_costs(pats, txts, idx, pen, device)
    low = affine_costs(pats, txts, pen["mismatch"], pen["gap_opening"],
                       pen["gap_extension"], device=device, dtype=torch.int8)
    answers = [(j, (0, -int(low[j]), None)) for j in idx]
    return check.judge(pats, txts, answers, cost_of, pen, full=False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from wfabench import manifest
    cell = manifest.resolve(manifest.load(ROOT), args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        nums = int8_reading(cell, seed, args.device)
        print(f"control int8 seed={seed} " + " ".join(
            f"{k}={v}" for k, v in nums.items())
            + f" seconds={time.perf_counter() - t0:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
