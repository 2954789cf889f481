#!/usr/bin/env python3
"""Time the fused loop's builds at the terminal, rung-1 and long-read
shapes on one CUDA GPU, for a same-call comparison of two trees.

    python3 time_builds.py [--tree DIR] [--sweep | --streams | --lcp]
                           [--only NAME,...]

Imports `pywfa_tpu_torch` from DIR (default: this script's directory), so
that the same script times a parent tree and the change in turns: unpack
the parent with `git archive <commit> | tar -x -C build/parent` and run

    for t in build/parent . . build/parent; do
        python3 time_builds.py --tree $t; done

The shapes and their generators come from the `chip_smoke.py` beside this
script, whichever tree is timed; each tree builds its own kernels (into
DIR/build/pywfa_tpu_torch), and the build's seconds are printed first.
The shapes: gap-affine end to end with the choice record at the terminal
rung of 150 bp reads (256 pairs, 64 unrelated, W=384, S_cap=649), the
probe batch's own terminal launch (16 pairs, two real) and the 2-piece
metric's terminal rung (the same 256 pairs, W=512), then the first rung
(4096 pairs, W=256, S_cap=96); stream F's first segment (256 pairs of
1 kb, W=896, 292 scores, on the run-length table, score only); 8 pairs of
1 kb at W=2176 (S_cap=700); 8 of G's pairs cut to 5 kb at W=3584
(S_cap=700); G's first rung (W=1792, one shot); and batch G's rung 2 (16
pairs of 10 kb, W=6912, score only) over its first 96 scores and over its
first segment under memory_mode="low" (2427 scores). Every build the
tree's `fused_loop.BUILDS` has for a band of that width (all but the
cluster build up to 1024 diagonals: the parent's narrow and warp builds,
the group build at the G its routing gives; the general and the cluster
build past them) is timed by CUDA events, the mean of `REPS` calls after
a warm-up; beside each, the kernel's own device time from torch.profiler
(chip_smoke.kernel_only_ms; None where it records none). Prints the
card's name and power limit, then one JSON object a line: {"tree",
"shape", "build", "ms", "kernel_only_ms", and for the group build "G",
for the cluster build "active_clusters", "threads"}. --only times the
named shapes alone.

With --streams it prints instead the rate of two of chip_smoke.py's
timed streams, 4 batches of 4096 150 bp pairs at 2% divergence, gap-
affine end to end in the score scope and with full CIGARs, three runs
each after a warm-up batch: {"tree", "stream", "alignments_s"}.

With --lcp it times instead the run-length table (K3) at
chip_smoke.lcp_shapes (the five shapes of the paths, 65537 pairs of
150 bp and a 49 kb pattern row against a 1 kb text), at the diagonals a
thread and threads a group the tree's launch picks and, where its wrapper
takes `cells` and `segments`, at every other choice too, by CUDA events
and alone (torch.profiler), beside the bound: {"tree", "shape", "cells",
"segments", "picked", "ms", "kernel_only_ms", "bound_ms"} or "refused"
where the tree's kernel refuses the shape; then
engine.align_batch on the sharded batch's 4096 pairs of 150 bp at the
first rung (W=256, S_cap=96): the call by CUDA events, and K3, the fused
loop and every kernel inside it by torch.profiler.

With --sweep it prints instead ptxas' registers and spills of the
builds' kernels for `e2e` and `affine2p_e2e`, and chip_smoke.step_sweep:
the us a score step at the gap-affine terminal rung for B in 16 (the
probe's terminal launch), 132, 256 and 512 pairs and max_steps in 50,
100, 200 and 386, on every build up to 1024 diagonals (the group build
also at each G of SWEEP_G that its C side takes).
"""
import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

REPS = 10
# the G at which --sweep times the group build beside its routed one
SWEEP_G = (1, 2, 4, 8)
HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke():
    """The chip_smoke.py beside this script, whichever tree is timed."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def sweep(cs, tree, dev, attr, seconds, output):
    """--sweep: the builds' registers and spills for e2e and affine2p_e2e
    (template arguments <0, 0, 1, 0> and <1, 0, 1, 0>), then the step
    sweep on every build up to 1024 diagonals."""
    from pywfa_tpu_torch.ops import fused_loop
    print(json.dumps({"tree": tree, "build_s": seconds}), flush=True)
    for line in cs.ptxas_lines("fused_loop", output):
        if "<0, 0, 1, 0>" in line or "<1, 0, 1, 0>" in line:
            print(line, flush=True)
    builds = {b: dict(build=b) for b in fused_loop.BUILDS
              if b not in ("general", "cluster")}
    if "group" in fused_loop.BUILDS:
        for G in SWEEP_G:
            builds[f"group_G{G}"] = dict(build="group", group=G)

    def emit(line):
        print(json.dumps({"tree": tree, "line": line}), flush=True)

    def guarded(label, kw):
        try:
            cs.step_sweep(dev, attr, {label: kw}, emit)
        except RuntimeError as e:
            emit(f"step sweep [{label}] refused: {str(e)[:120]}")

    for label, kw in builds.items():
        guarded(label, kw)


def streams(cs, tree, dev):
    """--streams: alignments/s of chip_smoke's e2e_score stream and of the
    same pairs with full CIGARs, three runs each."""
    import numpy as np
    import torch
    from pywfa_tpu_torch import BatchWavefrontAligner
    rng = np.random.default_rng(cs.SEED + 3)
    batches = [cs.make_pairs(rng, cs.B_MAIN, cs.L, cs.DIV)
               for _ in range(cs.N_NEW_BATCHES)]
    n = cs.N_NEW_BATCHES * cs.B_MAIN
    for name, scope in (("e2e_score", "score"), ("e2e", "full")):
        aligner = BatchWavefrontAligner(span="end-to-end", scope=scope,
                                        device=dev)
        # a warm-up batch, then the timed stream (chip_smoke._timed_stream
        # without its launch counts, which a parent tree may not have)
        list(aligner.align_stream(iter(batches[:1]), depth=1))
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            list(aligner.align_stream(iter(batches), depth=3))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(json.dumps({"tree": tree, "stream": name,
                              "alignments_s": n / wall}), flush=True)


def lcp(cs, tree, dev, attr, long_inputs, cfg_f):
    """--lcp: K3 at chip_smoke's held shapes, then engine.align_batch on
    the sharded batch's pairs (see the module docstring)."""
    import inspect

    import numpy as np
    import torch
    from pywfa_tpu_torch.ops import config as C
    from pywfa_tpu_torch.ops import engine as TE
    from pywfa_tpu_torch.ops import lcp_table
    takes_cells = "cells" in inspect.signature(
        lcp_table.build_lcp_table_hmajor).parameters
    for name, (pats, txts), cfg, wildcard, kmin in cs.lcp_shapes(
            attr, long_inputs, cfg_f):
        pat, txt, *_ = cs._token_rows(cfg, pats, txts, dev)
        B, Ltp = len(pats), txt.shape[1]
        # (diagonals a thread, threads a group): the tree's launch_shape
        # first, then every other choice; a thread a diagonal before
        picked, choices = (1, 1), [(1, 1)]
        if takes_cells:
            picked = lcp_table.launch_shape(B, cfg.W, Ltp)[:2]
            choices = [(c, S)
                       for c in lcp_table.CELLS[lcp_table.table_dtype(Ltp)]
                       for S in lcp_table.SEGMENTS]
        for cells, segments in sorted(choices, key=lambda c: c != picked):
            kw = dict(cells=cells, segments=segments) if takes_cells else {}

            def run():
                return lcp_table.build_lcp_table_hmajor(
                    cfg.W, kmin, wildcard, pat, txt, **kw)

            row = {"tree": tree, "shape": name, "cells": cells,
                   "segments": segments,
                   "picked": (cells, segments) == picked}
            try:
                out = run()
                torch.cuda.synchronize()
                row["bound_ms"] = cs.lcp_bound(
                    out.numel() * out.element_size() + pat.numel()
                    + txt.numel(), out.numel())[0]
                del out
                row["ms"] = cs.cuda_ms(run, REPS)
                row["kernel_only_ms"] = cs.kernel_only_ms(run,
                                                          name="lcp_table")
            except RuntimeError as e:
                row["refused"] = str(e)[:120]
            print(json.dumps(row), flush=True)
    rng = np.random.default_rng(cs.SEED + 12)
    pats, txts = cs.make_pairs(rng, cs.B_MAIN, cs.L, cs.DIV)
    cfg = C.full_config(attr, 160, 160, W=256, S_cap=96)
    args = cs._token_rows(cfg, pats, txts, dev)

    def batch():
        return TE.align_batch(cfg, *args, cs.MAXS)

    row = {"tree": tree, "shape": f"align_batch_{cs.B_MAIN}x{cs.L}",
           "ms": cs.cuda_ms(batch, REPS)}
    for key, kernel in (("lcp_table_ms", "lcp_table"),
                        ("fused_loop_ms", "fused_loop"), ("all_ms", "")):
        row[key] = cs.kernel_only_ms(batch, name=kernel)
    print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--streams", action="store_true")
    ap.add_argument("--lcp", action="store_true")
    ap.add_argument("--only", default="")
    opts = ap.parse_args()
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    cs = _smoke()
    from pywfa_tpu_torch import BatchWavefrontAligner
    from pywfa_tpu_torch.constants import MemoryMode
    from pywfa_tpu_torch.ops import config as C
    from pywfa_tpu_torch.ops import cuda_build
    from pywfa_tpu_torch.ops import engine as TE
    from pywfa_tpu_torch.ops import fused_loop

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    if not os.path.abspath(fused_loop.__file__).startswith(tree):
        raise SystemExit(f"imported {fused_loop.__file__}, not from {tree}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    cuda_build.build()
    seconds = time.perf_counter() - t0
    output = cuda_build.last_build.get("fused_loop", (0, ""))[1]
    dev = torch.device("cuda", 0)
    attr = BatchWavefrontAligner(span="end-to-end", device=dev)._attr
    if opts.sweep:
        sweep(cs, tree, dev, attr, seconds, output)
        return 0
    if opts.streams:
        streams(cs, tree, dev)
        return 0
    print(json.dumps({"tree": tree, "build_s": seconds}), flush=True)
    rng = np.random.default_rng(cs.SEED + 1)
    main_pairs = cs.make_pairs(rng, cs.B_MAIN, cs.L, cs.DIV)
    related, unrelated = cs.terminal_pairs(rng)
    term = (related[0] + unrelated[0], related[1] + unrelated[1])
    lone = cs.sweep_batches()[0][1]
    a2p = cs.metric_attr("affine2p", span="end-to-end")[0]
    long_inputs = cs.make_long_inputs()
    pats1k, txts1k = long_inputs["ef"][0]
    pats_g, txts_g = long_inputs["g"]
    MAXS = cs.MAXS

    def one_shot(cfg, pairs):
        args = cs._device_inputs(cfg, *pairs, dev)
        return cfg, len(pairs[0]), lambda build: \
            fused_loop.align_batch_fused_loop(cfg, *args, MAXS, build=build)

    def first_segment(cfg, pairs, use_table):
        pat, txt, plen, tlen, frees = cs._token_rows(cfg, *pairs, dev)
        if use_table:
            ext = TE.build_extension(cfg, pat, txt)
            bits, table = ext["bits"], ext["table"]
        else:
            bits, table = TE.build_eq_bits(cfg, pat, txt), None
        state = fused_loop.new_state(cfg, len(pairs[0]), dev)
        return cfg, len(pairs[0]), lambda build: \
            fused_loop.align_batch_fused_loop(
                cfg, bits, plen, tlen, frees, MAXS, table=table,
                state=state, fresh=True, build=build)

    cfg_f = cs.f_segment_config(attr, pats1k, txts1k)
    cfg_g = dataclasses.replace(cs.rung2_config(attr, pats_g, txts_g),
                                record_choices=False)
    # batch G's own segment length under memory_mode="low"
    K_g = cs.rung_plan(dataclasses.replace(attr, memory_mode=MemoryMode.LOW),
                       pats_g, txts_g, second=True)[0].cfg.S_cap
    if opts.lcp:
        lcp(cs, tree, dev, attr, long_inputs, cfg_f)
        return 0
    shapes = [
        ("terminal",) + one_shot(C.full_config(attr, 160, 160), term),
        ("terminal_probe",) + one_shot(C.full_config(attr, 160, 160), lone),
        ("affine2p_terminal",) + one_shot(C.full_config(a2p, 160, 160),
                                          term),
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
    only = set(filter(None, opts.only.split(",")))
    for name, cfg, B, run in shapes:
        if only and name not in only:
            continue
        # the builds of the tree that take a band of this width
        builds = [b for b in fused_loop.BUILDS
                  if (b != "cluster") == (cfg.W <= 1024) or b == "general"]
        for build in builds:
            row = {"tree": tree, "shape": name, "build": build}
            try:
                run(build)
                torch.cuda.synchronize()
                row["ms"] = cs.cuda_ms(lambda: run(build), REPS)
                row["kernel_only_ms"] = cs.kernel_only_ms(lambda: run(build))
                if build == "group":
                    row["G"] = fused_loop.launch_shape(cfg, B, "group",
                                                       dev)[1]
                if build == "cluster":
                    row["active_clusters"] = fused_loop.active_clusters()
                    row["threads"] = fused_loop.launch_shape(
                        cfg, B, "cluster")[0]
            except (RuntimeError, NotImplementedError) as e:
                row["refused"] = str(e)[:120]
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
