#!/usr/bin/env python3
"""Host breakdown of the PyTorch port's paths on one CUDA GPU, by the
program's own spans.

    python3 profile_torch.py [api] [streams] [slice] [long]

(every section when none is named)

Turns on the program's span tree (`batch._PROF`, see
`pywfa_tpu_torch/spans.py`: one span a layer from the API down to the
walk's host syncs, each with its self time, the duration less its
children's) and runs:

- pywfa_tpu_torch.WavefrontAligner(device="cuda") with pywfa's defaults,
  one 150 bp pair per call, full and score scope (128 calls each);
- BatchWavefrontAligner.align_stream, depth 3, 4 x 4096 pairs, twice
  each: gap-affine ends-free reads in 200 bp windows (text frees 50) and
  end-to-end score-only; affine2p end to end with full CIGARs and a
  long-gap share; levenshtein end-to-end score-only;
- align_pairs_stream, depth 3, 4 x 4096 pairs, twice each, over
  chip_smoke.py's streams A-D: wf-adaptive with a divergent share, z-drop
  with chimeric reads (partial results), ends-free windows with match -1,
  wildcard N;
- the long-read paths of chip_smoke.py: stream E (4 x 256 ONT-like pairs
  of 1 kb, memory mode high: two one-shot rungs), stream F (the same under
  memory_mode="biwfa": the second rung segmented, with the run-length
  table) and batch G (16 pairs of 10 kb under high and under low), where
  the segmented executor's spans split its time: forward segments (each
  with the wait for its end), snapshots, restores, replays (each with its
  loop and walk) and the gather.

Prints, per path, the wall per unit (call or batch) and each span's self
and total ms and count per unit, the largest self time first; the self
times of the spans and the time outside them make up the wall. The
first line is the card's name and power limit. Data come from
chip_smoke.py's generators, seeded.
"""
import functools
import subprocess
import sys
import time

import numpy as np
import torch

from chip_smoke import (B_G, B_LONG, B_MAIN, DIV, L, L_G, L_LONG,
                        N_NEW_BATCHES, SEED, WINDOW, WINDOW_FREE,
                        make_gap_pairs, make_long_inputs, make_pairs,
                        make_windows, mutate, run_stream, slice_streams)

N_CALLS = 128


def report(title, fn, units):
    """Run fn (which handles `units` units) with the spans on; print the
    wall and each span's self and total per unit."""
    from pywfa_tpu_torch import spans
    torch.cuda.synchronize()
    spans.reset()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"== {title}: wall {1e3 * wall / units:.3f} ms per unit "
          f"(n={units}), spans' self {1e3 * sum(spans.self_s.values()) / units:.3f}",
          flush=True)
    print(spans.report(units), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
          .stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    from pywfa_tpu_torch import batch
    batch._PROF = True
    sections = sys.argv[1:] or ["api", "streams", "slice", "long"]

    rng = np.random.default_rng(SEED + 4)
    if "long" in sections:
        long_reads(dev)
    if "api" in sections:
        api_calls(dev, rng)
    if "streams" in sections:
        metric_streams(dev, rng)
    if "slice" in sections:
        heuristic_streams(dev, rng)
    return 0


def long_reads(dev):
    from pywfa_tpu_torch import BatchWavefrontAligner
    inputs = make_long_inputs()
    for name, mode in (("E 1 kb high", "high"), ("F 1 kb biwfa", "biwfa")):
        aligner = BatchWavefrontAligner(span="end-to-end", memory_mode=mode,
                                        device=dev)
        batches = inputs["ef"]
        list(aligner.align_stream(iter(batches[:1]), depth=1))

        def run(aligner=aligner, batches=batches):
            for _ in aligner.align_stream(iter(batches), depth=3):
                pass

        for rep in range(2):
            report(f"stream {name} rep {rep}, per batch of {B_LONG} pairs "
                   f"of {L_LONG} bp", run, len(batches))
    for mode in ("high", "low"):
        aligner = BatchWavefrontAligner(span="end-to-end", memory_mode=mode,
                                        device=dev)
        run = functools.partial(aligner.align, *inputs["g"])
        run()
        for rep in range(2):
            report(f"batch G {mode} rep {rep}, {B_G} pairs of {L_G} bp",
                   run, 1)


def api_calls(dev, rng):
    import pywfa_tpu_torch
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


def metric_streams(dev, rng):
    from pywfa_tpu_torch import BatchWavefrontAligner
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


def heuristic_streams(dev, rng):
    for name, _, attr, wildcard, batches in slice_streams(rng, dev,
                                                          N_NEW_BATCHES):
        run_stream(attr, wildcard, batches[:1], dev, depth=1)
        run = functools.partial(run_stream, attr, wildcard, batches, dev)
        for rep in range(2):
            report(f"stream {name} rep {rep}, per {B_MAIN}-pair batch", run,
                   len(batches))


if __name__ == "__main__":
    sys.exit(main())
