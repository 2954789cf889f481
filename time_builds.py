#!/usr/bin/env python3
"""Time the fused loop's builds at the long-read and terminal shapes on
one CUDA GPU, for a same-call comparison of two trees.

    python3 time_builds.py [--tree DIR]

Imports `pywfa_tpu_torch` from DIR (default: this script's directory), so
that the same script times a parent tree and the change in turns: unpack
the parent with `git archive <commit> | tar -x -C build/parent` and run

    for t in build/parent . . build/parent; do
        python3 time_builds.py --tree $t; done

Each tree builds its own kernels (into DIR/build/pywfa_tpu_torch). The
shapes are chip_smoke.py's, from its seeded generators: gap-affine end
to end with the choice record at the terminal rung of 150 bp reads (256
pairs, 64 unrelated, W=384, S_cap=649) and at the first rung (4096 pairs,
W=256, S_cap=96); stream F's first segment (256 pairs of 1 kb, W=896,
292 scores, on the run-length table, score only); 8 pairs of 1 kb at
W=2176 (S_cap=700); 8 of G's pairs cut to 5 kb at W=3584 (S_cap=700); G's
first rung (W=1792, one shot); and batch G's rung 2 (16 pairs of 10 kb, W=6912,
score only) over its first 96 scores and over its first segment under
memory_mode="low" (2427 scores). Every build the tree has for a band of
that width (general, narrow and warp up to 1024 diagonals; general and
cluster past them) is timed by CUDA events, the mean of `REPS` calls
after a warm-up; beside each, the kernel's own device time
from torch.profiler (chip_smoke.kernel_only_ms; None where it records
none). Prints the card's name and power limit, then one JSON object a
line: {"tree", "shape", "build", "ms", "kernel_only_ms", and for the
cluster build "active_clusters", "threads"}.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

REPS = 10


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(
        __file__)))
    tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from pywfa_tpu_torch import BatchWavefrontAligner
    from pywfa_tpu_torch import batch as PB
    from pywfa_tpu_torch.constants import MemoryMode
    from pywfa_tpu_torch.ops import config as C
    from pywfa_tpu_torch.ops import engine as TE
    from pywfa_tpu_torch.ops import fused_loop
    import numpy as np

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    if not os.path.abspath(fused_loop.__file__).startswith(tree):
        raise SystemExit(f"imported {fused_loop.__file__}, not from {tree}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    attr = BatchWavefrontAligner(span="end-to-end", device=dev)._attr
    rng = np.random.default_rng(cs.SEED + 1)
    related = cs.make_pairs(rng, 192, cs.L, cs.DIV)
    unrelated = cs.make_pairs(rng, 64, cs.L, 0.0)[0], \
        cs.make_pairs(rng, 64, cs.L, 0.0)[0]
    term = (related[0] + unrelated[0], related[1] + unrelated[1])
    main_pairs = cs.make_pairs(rng, cs.B_MAIN, cs.L, cs.DIV)
    long_inputs = cs.make_long_inputs()
    pats1k, txts1k = long_inputs["ef"][0]
    pats_g, txts_g = long_inputs["g"]
    MAXS = cs.MAXS

    def one_shot(cfg, pairs):
        args = cs._device_inputs(cfg, *pairs, dev)
        return cfg, lambda build: fused_loop.align_batch_fused_loop(
            cfg, *args, MAXS, build=build)

    def first_segment(cfg, pairs, use_table):
        pat, txt, plen, tlen, frees = cs._token_rows(cfg, *pairs, dev)
        if use_table:
            ext = TE.build_extension(cfg, pat, txt)
            bits, table = ext["bits"], ext["table"]
        else:
            bits, table = TE.build_eq_bits(cfg, pat, txt), None
        state = fused_loop.new_state(cfg, len(pairs[0]), dev)
        return cfg, lambda build: fused_loop.align_batch_fused_loop(
            cfg, bits, plen, tlen, frees, MAXS, table=table, state=state,
            fresh=True, build=build)

    cfg_f = cs.rung2_config(attr, pats1k, txts1k, cs.B_LONG)
    budget = min(PB.REPLAY_CHOICES_BYTES, PB.CHOICES_BYTES_CAP
                 // PB.MEMORY_MODE_DIVISOR[MemoryMode.ULTRALOW])
    cfg_f = dataclasses.replace(
        cfg_f, S_cap=max(64, budget // (cs.B_LONG * cfg_f.W)),
        record_choices=False)
    cfg_g = dataclasses.replace(cs.rung2_config(attr, pats_g, txts_g, cs.B_G),
                                record_choices=False)
    budget_g = min(PB.REPLAY_CHOICES_BYTES, PB.CHOICES_BYTES_CAP
                   // PB.MEMORY_MODE_DIVISOR[MemoryMode.LOW])
    K_g = max(64, budget_g // (cs.B_G * cfg_g.W))
    shapes = [
        ("terminal",) + one_shot(C.full_config(attr, 160, 160), term),
        ("rung1",) + one_shot(C.full_config(attr, 160, 160, W=256,
                                             S_cap=96), main_pairs),
        ("F_first_segment",) + first_segment(cfg_f, (pats1k, txts1k), True),
        ("w2176",) + one_shot(dataclasses.replace(
            C.full_config(attr, 1024, 1088, W=2176), S_cap=700),
            (pats1k[:8], txts1k[:8])),
        # 8 of G's pairs cut to 5 kb at W=3584, the band of a 5 kb pair's
        # second rung (the ring just fits a block)
        ("w3584",) + one_shot(dataclasses.replace(
            C.full_config(attr, 5120, 5376, W=3584), S_cap=700),
            ([p[:5000] for p in pats_g[:8]], [t[:5000] for t in txts_g[:8]])),
        # G's first rung, one shot: W=1792
        ("G_rung1",) + one_shot(cs.rung1_config(attr, pats_g, txts_g),
                                (pats_g, txts_g)),
        ("G_96",) + first_segment(dataclasses.replace(cfg_g, S_cap=96),
                                  (pats_g, txts_g), False),
        ("G_first_segment",) + first_segment(dataclasses.replace(
            cfg_g, S_cap=K_g), (pats_g, txts_g), False),
    ]
    for name, cfg, run in shapes:
        # the builds a band of this width can take
        builds = ("general", "narrow", "warp") if cfg.W <= 1024 \
            else ("general", "cluster")
        for build in (b for b in builds if b in fused_loop.BUILDS):
            row = {"tree": tree, "shape": name, "build": build}
            try:
                run(build)
                torch.cuda.synchronize()
                row["ms"] = cs.cuda_ms(lambda: run(build), REPS)
                row["kernel_only_ms"] = cs.kernel_only_ms(lambda: run(build))
                if build == "cluster":
                    row["active_clusters"] = fused_loop.active_clusters()
                    row["threads"] = fused_loop.launch_shape(
                        cfg, len(pats_g), "cluster")[0]
            except (RuntimeError, NotImplementedError) as e:
                row["refused"] = str(e)[:120]
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
