#!/usr/bin/env python
"""Benchmark of the PyTorch port: batched gap-affine alignment with full
CIGAR on one CUDA card (the twin of bench.py).

Headline metric (BASELINE.md): alignment cell-updates/s at 150 bp,
batch=4096, affine penalties, full-CIGAR scope. "Cell updates" uses the
standard GCUPS-equivalent convention: plen * tlen DP cells per pair (the
work a classic DP aligner would do for the same workload).

The same knobs and defaults as bench.py (BENCH_B 4096, BENCH_L 150,
BENCH_ITERS 5, BENCH_DIV 0.02, BENCH_W 128, BENCH_SCAP 96), the same pairs
and the same compacted walk-op output as production's first rung. It
drives the port's production device pipeline on inputs staged on the
card once: `ops/config.full_config`, `batch.pack_tokens`, then
`ops/engine.align_batch_packed_full` (decode, eq-bits, the fused loop,
the walk, the packing). Each of BENCH_ITERS repetitions is timed by CUDA
events; the metric is taken from their median.

    python bench_torch.py [--device cuda|cpu]

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline"},
and one '#' line on stderr: the shape, ms a batch (median and range),
alignments/s, the fused loop's build and the card's name and power limit.
`--device cpu` runs the same pipeline through the kernels' plain torch
versions (timed by the host clock).
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_CELLS_PER_S = 10e6  # BASELINE.md north-star: >= 10M cell-updates/s

B = int(os.environ.get("BENCH_B", 4096))
L = int(os.environ.get("BENCH_L", 150))
ITERS = int(os.environ.get("BENCH_ITERS", 5))
DIVERGENCE = float(os.environ.get("BENCH_DIV", 0.02))


def make_pairs(rng, n, length, divergence):
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    pats = alphabet[rng.integers(0, 4, size=(n, length))]
    txts = pats.copy()
    nmut = max(1, int(length * divergence))
    for i in range(n):
        idx = rng.choice(length, size=nmut, replace=False)
        txts[i, idx] = alphabet[(rng.integers(1, 4, size=nmut)
                                 + np.searchsorted(alphabet, txts[i, idx])) % 4]
    return ([pats[i].tobytes() for i in range(n)],
            [txts[i].tobytes() for i in range(n)])


def card_name():
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not measured (no nvidia-smi)"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "not measured"


def main(argv):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from pywfa_tpu_torch import batch as PB
    from pywfa_tpu_torch.align import WavefrontAligner
    from pywfa_tpu_torch.ops import config as C
    from pywfa_tpu_torch.ops import engine as E
    from pywfa_tpu_torch.ops import fused_loop

    device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "the plain torch versions on the host")

    rng = np.random.default_rng(0)
    pats, txts = make_pairs(rng, B, L, DIVERGENCE)

    api = WavefrontAligner(backend="numpy", span="end-to-end")
    attr = api._attributes()
    # sized bucket: bounded band + score cap with escalation unnecessary at
    # this divergence (2% of 150bp -> scores ~< 40)
    W = int(os.environ.get("BENCH_W", 128))
    S_cap = int(os.environ.get("BENCH_SCAP", 96))
    cfg = C.full_config(attr, L, L, W=W, S_cap=S_cap)
    # production parity: dispatch compacts the walk-op pull at
    # non-terminal rungs (batch.align_pairs_dispatch ops_out rule)
    oc = min(cfg.S_cap, max(32, C._round_up(cfg.S_cap // 3, 2)))
    if oc < cfg.S_cap:
        cfg = dataclasses.replace(cfg, ops_out=oc)
    chunk = cfg.extend_chunk

    pat_np = PB.encode_batch(pats, cfg.Lp, chunk, PB.PATTERN_SENTINEL)
    txt_np = PB.encode_batch(txts, cfg.Lt, chunk, PB.TEXT_SENTINEL)
    lens_np = np.full((B,), L, dtype=np.int32)
    # inputs staged on the card once, as bench.py stages them: a stream
    # overlaps its pushes with the device work of the batches before
    packed = torch.from_numpy(np.concatenate(
        [PB.pack_tokens(pat_np, lens_np, width=cfg.Lp),
         PB.pack_tokens(txt_np, lens_np, width=cfg.Lt)], axis=1)).to(dev)
    plen = torch.from_numpy(lens_np).to(dev)
    tlen = torch.from_numpy(lens_np.copy()).to(dev)
    frees = torch.zeros((B, 4), dtype=torch.int32, device=dev)
    max_steps = 2**31 - 1

    def run():
        return E.align_batch_packed_full(cfg, packed, plen, tlen, frees,
                                         max_steps)

    # warm-up (the kernels' load) + correctness probe
    out = run().cpu().numpy()
    if C.packed_layout(cfg) == "compact":
        status, fb = out[:B].astype(np.int32), out[B: 2 * B]
    else:
        meta = out[: 7 * B * 4].view(np.int32).reshape(7, B)
        status, fb = meta[0], meta[6]
    n_ok = int((status == C.ST_END_REACHED).sum())
    assert n_ok == B, f"only {n_ok}/{B} pairs completed in bucket"
    assert not fb.any(), "traceback fallback triggered"

    for counts in (fused_loop.build_launches, fused_loop.group_launches):
        for k in counts:
            counts[k] = 0
    times = []
    for _ in range(ITERS):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
    dt = float(np.median(times))

    cells = B * L * L
    cells_per_s = cells / dt
    result = {
        "metric": "alignment_cell_updates_per_s",
        "value": round(cells_per_s, 1),
        "unit": "cells/s",
        "vs_baseline": round(cells_per_s / BASELINE_CELLS_PER_S, 3),
    }
    print(json.dumps(result))
    build = fused_loop.kernel_build(cfg, B)
    if build == "group":
        build += f" G={fused_loop.group_size(cfg, B)}"
    if dev.type != "cuda":
        build = "plain"
    launched = {k: v for k, v in fused_loop.build_launches.items() if v}
    print(f"# batch={B} len={L} W={cfg.W} S_cap={cfg.S_cap} "
          f"ops_out={cfg.ops_out} iters={ITERS} "
          f"time/batch={dt * 1e3:.3f}ms (median; range "
          f"{min(times) * 1e3:.3f}-{max(times) * 1e3:.3f}) "
          f"alignments/s={B / dt:.0f} build={build} launches={launched} "
          f"device={dev.type}: "
          + (card_name() if dev.type == "cuda" else "host"),
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
