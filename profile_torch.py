#!/usr/bin/env python3
"""Host and device breakdown of the PyTorch port's paths on one CUDA GPU.

    python3 profile_torch.py

Wraps the port's stage functions with host timers (inclusive: nested
stages add up to more than the wall; device stages show their enqueue
time unless they synchronise) and runs:

- pywfa_tpu_torch.WavefrontAligner(device="cuda") with pywfa's defaults,
  one 150 bp pair per call, full and score scope (128 calls each);
- BatchWavefrontAligner.align_stream, depth 3, 4 x 4096 pairs, twice
  each: gap-affine ends-free reads in 200 bp windows (text frees 50) and
  end-to-end score-only; affine2p end to end with full CIGARs and a
  long-gap share; levenshtein end-to-end score-only;
- align_pairs_stream, depth 3, 4 x 4096 pairs, twice each, over
  chip_smoke.py's streams A-D: wf-adaptive with a divergent share, z-drop
  with chimeric reads (partial results), ends-free windows with match -1,
  wildcard N.

Prints, per path, the wall per unit (call or batch) and each stage's ms
per unit, then the device busy share of one more pass under
torch.profiler (the sum of device time over the wall). The first line is
the card's name and power limit. Data come from chip_smoke.py's
generators, seeded.
"""
import functools
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from chip_smoke import (B_MAIN, DIV, L, N_NEW_BATCHES, SEED, WINDOW,
                        WINDOW_FREE, make_gap_pairs, make_pairs, make_windows,
                        mutate, run_stream, slice_streams)

N_CALLS = 128
N_PROFILED_CALLS = 64

totals = defaultdict(float)
calls = defaultdict(int)


def _wrap(module, name):
    fn = getattr(module, name)

    @functools.wraps(fn)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            totals[name] += time.perf_counter() - t0
            calls[name] += 1

    setattr(module, name, timed)


def install_timers():
    from pywfa_tpu_torch import batch as PB
    from pywfa_tpu_torch.ops import engine as TE
    from pywfa_tpu_torch.ops import fused_loop
    for name in ("align_pairs_dispatch", "align_pairs_pull",
                 "align_pairs_finish", "_encode_side", "_to_device",
                 "_native_fill"):
        _wrap(PB, name)
    for name in ("decode_packed", "decode_fused", "build_eq_bits",
                 "traceback_walk", "pack_walked", "pack_meta"):
        _wrap(TE, name)
    _wrap(fused_loop, "align_batch_fused_loop")


def report(title, fn, units):
    """Run fn (which handles `units` units) under the timers; print the
    wall and the stages per unit."""
    totals.clear()
    calls.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"== {title}: wall {1e3 * wall / units:.3f} ms per unit "
          f"(n={units})", flush=True)
    for name, t in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"   {name}: {1e3 * t / units:.3f} ms/unit "
              f"({calls[name] / units:.1f} calls/unit)", flush=True)


def busy_share(title, fn):
    """Device time over wall for one pass of fn under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device rows only (kernels, copies, memsets): the CPU-side rows that
    # launched them report the same device time again
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    print(f"   profiler: {title} wall {1e3 * wall:.1f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms, busy share {busy_us / 1e3 / (1e3 * wall):.4f}",
          flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
          .stdout.strip().splitlines()[0], flush=True)
    import pywfa_tpu_torch
    from pywfa_tpu_torch import BatchWavefrontAligner
    dev = torch.device("cuda", 0)
    install_timers()

    rng = np.random.default_rng(SEED + 4)
    singles = []
    for _ in range(N_CALLS):
        p = bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L)])
        singles.append((p.decode(), mutate(rng, p, DIV, 0.01).decode()))
    for scope in ("full", "score"):
        a = pywfa_tpu_torch.WavefrontAligner(scope=scope, device=dev)
        for p, t in singles[:4]:  # warm-up: kernel load, allocations
            a(t, p)

        def run(pairs=singles, a=a):
            for p, t in pairs:
                a(t, p)

        report(f"WavefrontAligner {scope}, one {L} bp pair per call", run,
               N_CALLS)
        busy_share(f"{N_PROFILED_CALLS} calls", functools.partial(
            run, singles[:N_PROFILED_CALLS]))

    streams = [
        ("endsfree_window",
         BatchWavefrontAligner(text_begin_free=WINDOW_FREE,
                               text_end_free=WINDOW_FREE, device=dev),
         [make_windows(rng, B_MAIN, L, WINDOW, DIV)
          for _ in range(N_NEW_BATCHES)]),
        ("e2e_score",
         BatchWavefrontAligner(span="end-to-end", scope="score", device=dev),
         [make_pairs(rng, B_MAIN, L, DIV) for _ in range(N_NEW_BATCHES)]),
        ("affine2p_e2e_gaps",
         BatchWavefrontAligner(distance="affine2p", span="end-to-end",
                               device=dev),
         [make_gap_pairs(rng, B_MAIN, L, DIV)
          for _ in range(N_NEW_BATCHES)]),
        ("edit_e2e_score",
         BatchWavefrontAligner(distance="levenshtein", span="end-to-end",
                               scope="score", device=dev),
         [make_pairs(rng, B_MAIN, L, DIV) for _ in range(N_NEW_BATCHES)]),
    ]
    for name, aligner, batches in streams:
        list(aligner.align_stream(iter(batches[:1]), depth=1))

        def run(aligner=aligner, batches=batches):
            for _ in aligner.align_stream(iter(batches), depth=3):
                pass

        for rep in range(2):
            report(f"stream {name} rep {rep}, per {B_MAIN}-pair batch", run,
                   len(batches))
        busy_share(f"{len(batches)} batches", run)

    for name, _, attr, wildcard, batches in slice_streams(rng, dev,
                                                          N_NEW_BATCHES):
        run_stream(attr, wildcard, batches[:1], dev, depth=1)
        run = functools.partial(run_stream, attr, wildcard, batches, dev)
        for rep in range(2):
            report(f"stream {name} rep {rep}, per {B_MAIN}-pair batch", run,
                   len(batches))
        busy_share(f"{len(batches)} batches", run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
