#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; nothing falls back):

1. Device: the card's name and power limit from nvidia-smi, whether the
   native host library built and loaded; exits nonzero without CUDA.
2. Build: compiles the three CUDA sources side by side, the walk's
   kernel, the run-length table (K3) and the fused-loop kernel (52
   variants: 5 distance
   metrics x 2 spans x 2 scopes, each with and without the heuristic
   cascade, plus the seeded ends-free span of the 3 metrics with a match
   weight, each built four ways: group, narrow, cluster and general) from
   the checkout; prints ptxas' registers and spills per kernel.
3. Each kernel variant against its plain torch version on the card, byte
   for byte, at the main paths' shapes, through every build of
   `fused_loop.BUILDS` that takes a band of at most 1024 diagonals: the
   group build (G warps a pair over the live band, a persistent grid:
   what `fused_loop.kernel_build` picks for every short-read shape but a
   one-shot terminal rung, at the G of `fused_loop.group_size`, and at
   G = 1 too where that G is larger), the narrow build (a block a pair, a
   thread a diagonal: what it picks at a one-shot terminal rung, whose
   score cap passes its width) and the general build (one block a pair,
   any band). Each line names the build and the G the routing picks; its
   time is the `ms` of the kernels line. (The fourth build, the cluster
   build, is for bands past 1024 diagonals: phase 10.)
   Gap-affine: end to end with the choice record, 4096 pairs of 150 bp
   at 2% divergence at the first rung (W=256, S_cap=96) and at W=128, and
   256 pairs (64 unrelated) at the terminal rung (W=384, S_cap=649), and
   the probe batch's own terminal launch (its two pairs over disjoint
   alphabets padded to 16); ends-free with the record, 4096
   150 bp reads in 200 bp windows with text frees of 50 at their first
   rung, and the main pairs with all frees 0; score only, the end-to-end
   rung-1 and terminal sets and the windows; one WavefrontAligner call
   with pywfa's defaults in both scopes (a 150 bp pair padded to 16 pairs
   at Lp = Lt = 256, W=256, S_cap=96); and stream E's second rung (256
   pairs of 1 kb, W=896, S_cap=768), a one-shot run of a wide live band.
   Affine2p, gap-linear, edit and indel: the main pairs at each metric's
   first rung (W=384, 128, 256, 256) with the record and score only,
   affine2p at its terminal rung (W=512, S_cap=649), the windows under
   affine2p and edit, and one WavefrontAligner call a metric in both
   scopes. The heuristic and seeded variants: gap-affine at the first
   rung on the pairs of streams A, B and C below (wf-adaptive, z-drop,
   match -1 in windows, and wf-adaptive on those windows with and
   without the match bonus), with the record and score only, and under
   wf-adaptive at the terminal rung; affine2p under wf-adaptive at its
   first rung; and one WavefrontAligner call for every heuristic or
   seeded variant of every metric. Every build is held to max_abs_err 0.
   Times by CUDA events in turns: at a terminal rung the narrow build and
   the group build at its G (narrow, group, group, narrow), elsewhere the
   group build at G = 1 and at its G (1, G, G, 1) where they differ; the
   general build once; beside them the kernel alone (torch.profiler) and
   memset_ms,
   the [S_cap, B, W] torch.zeros of the choice record alone (inside every
   recording time), and the bound, the least time the card could take:
   the eq words read once plus the choice levels these pairs write over
   3.35 TB/s, or the cells these pairs compute times an operation count
   a cell over 67 Tops/s, whichever is larger (the memset is not in it).
   Then the step sweep at the gap-affine terminal rung on the narrow build
   and on the group build at its routed G (`step_sweep`): us a score step
   for B of 16 (the probe's terminal launch), 132, 256 and 512 pairs and
   max_steps of 50, 100, 200 and 386, log lines only.
4. Stream: BatchWavefrontAligner(distance="affine", span="end-to-end",
   device="cuda").align_stream over 8 batches of 4096 pairs (timed:
   alignments/s), then over one probe batch (25% divergence, unrelated
   pairs, an N row, mixed lengths) that escalates up to the terminal rung.
   The kernel's launch count over both must cover every batch and rung,
   every pair must complete, and 512 sampled pairs plus every probe pair
   must equal the scalar oracle in score and CIGAR. Prints the per-stage
   ms/batch measured on one 4096-pair batch.
5. API: pywfa_tpu_torch.WavefrontAligner(device="cuda") with pywfa's
   defaults (ends-free, zero frees) on 256 single 150 bp pairs and the
   README / reference-test golden pairs, in the full and the score scope;
   every result equals the reference's numpy oracle on score, status,
   CIGAR and start/end. Prints the median ms per call.
6. Four timed streams of 4 x 4096 pairs, alignments/s, 512 sampled pairs
   each equal to the oracle: gap-affine ends-free reads in windows (text
   frees of 50); gap-affine end-to-end score-only; affine2p end to end
   with full CIGARs, one pair in eight carrying a 30-60 bp indel (what
   the second gap piece is for); levenshtein end-to-end score-only (the
   candidate-filter use).
7. Per new metric, a probe batch that escalates to the terminal rung,
   every pair against the oracle, and WavefrontAligner on 64 single pairs
   in both scopes (48 with pywfa's defaults, 16 end to end).
8. Four timed streams of 8 x 4096 pairs of this slice, alignments/s, 512
   sampled pairs each equal to the oracle in every field: A, gap-affine
   end to end under wf-adaptive 10/50/1 with one pair in eight at 15-20%
   divergence; B, gap-affine end to end under z-drop 100 with one text in
   eight ending in 50 unrelated bases (partial results, assembled from
   the card's walk: with pywfa's penalties the drop mostly falls on
   sparse wavefronts between two mismatches, on about a fifth of all
   reads, not on the chimeric tails); C, ends-free windows with match -1 (the boundary
   seeded at every score); D, wildcard N with 1% of bases N (the
   token-row push).
9. A probe batch under each of the six heuristics, escalating, every pair
   against the oracle; and WavefrontAligner one pair a call, both scopes,
   with heuristic="adaptive" end to end, heuristic="X-drop" on the
   default span (edit and indel, which take no drop: "adaptive"),
   match=-1 with and without a heuristic (the three metrics with a match
   weight), under every metric, and wildcard="N" and
   WF-extension under gap-affine: every heuristic and seeded variant
   launches.

10. Long reads (the segmented executor, the run-length table K3, bands
   past 1024 diagonals). K3 against its plain version at the shapes the
   paths give it: Ltp=176, B=4096, W=256 (uint8), the 1 kb segmented shape
   of stream F (int16), one with a wildcard, one with B=16 and W=1152,
   and the CLI's 150 bp batch in its length bucket (Ltp=272, int16); and
   the two shapes the first CUDA kernel refused: 65537 pairs of 150 bp
   (uint8), and one pair whose 49 kb pattern row holds its 1 kb text
   (W=896, int16). Each line logs the kernel's time by CUDA events and
   alone (torch.profiler), cells/s and the share of its bound. The
   fused loop's table variant against its plain version and against the
   bits variant at that 1 kb shape, as the segments stream F runs (first
   segment from WF0, then a later one from the stored state; the forward
   scope without the record and the replay scope with it), with the times
   of both extensions, on the group build (a segment's state and the
   table at W=896) against the general build, which must leave the same
   state.
   The wide bands against plain: W=2176 (8 pairs, one shot); the
   second rung of 10 kb reads with batch G's 16 pairs (W=6912) and of the
   same pairs cut to 5 kb (W=3584), each a later segment of 96 scores from
   the kernel's own state; and G's first segment at its own length under
   memory_mode="low" (held against the general build, and the 96 scores
   after it against plain: the plain version takes about 0.1 s a score
   step there), on the cluster build (8 CTAs a pair at W=6912, 4 at
   W=3584 and W=2176, three diagonals a thread) against the
   general build (a block a pair, the ring in global memory at W=6912),
   with cudaOccupancyMaxActiveClusters and each shape's bound; the
   routing takes the cluster build at W=6912 and W=3584 and the general
   build at
   W=2176 (three diagonals a thread of one block, as fast). Every segment
   and wide shape is timed general, new, new, general in turns (CUDA
   events), beside the routed build alone (torch.profiler). Then stream E, 4 x 256 pairs of
   1 kb, ONT-like (4% substitutions, 3% indels), gap-affine end to end,
   full CIGAR, memory mode high: pairs escalate past the first rung;
   stream F, the same pairs under memory_mode="biwfa": the escalated
   rung's record passes the mode's budget, so the segmented executor runs,
   launching K3 and the table variants, in more than one segment a run,
   with results equal to E's pair for pair; batch G, 16 pairs of 10 kb at
   5% divergence under memory_mode="low" (second rung segmented, on bits,
   ring in global memory) equal to the same batch under high and, for two
   pairs, to the oracle; resume: E's first batch with max_steps=200
   through align_pairs_resumable, then align_pairs_resume, equal to the
   fresh results; and WavefrontAligner(device="cuda") on single 1 kb and
   5 kb pairs in both scopes. No pair of these phases may go to the host
   oracle; streams E and F and the resume must launch the group build and
   not the general build, batch G the cluster build (for its second rung;
   its first, W=1792, takes the general build) and the long API pairs the
   cluster build (the 5 kb pair's second rung, W=3584) and not the
   general build.
11. Dry run: `parallel.dryrun.dryrun_multichip` over every card of the
   host (end to end with each shard's walk, ends-free with per-pair
   frees, wf-adaptive, tight caps re-run at 4x the score cap, the
   segmented run with host snapshots and replays), as the reference's
   dry run asserts; then the table variants it launches that no earlier
   phase holds (`endsfree_table`, `e2e_heur_table`) against plain at its
   shapes.
12. Sharded main path: 4096 pairs of 150 bp at 2% divergence, gap-affine
   end to end with the record at the first rung (W=256, S_cap=96),
   through `parallel.sharded_align_batch` on a mesh of every card with
   the meta gathered over a one-rank NCCL group; byte-equal to
   `engine.align_batch` on one card, choices included. It extends by the
   run-length table (K3 at 176 x 4096 x 256, uint8) like the reference's
   `align_batch`; `e2e_table` is held against plain at this shape. Then
   a mesh of eight shards on the first card, whose 512-pair shards take
   another G than the whole batch, byte-equal too. ms a
   batch of the whole batch and of the sharded call with and without the
   gather, in turns, of the gather alone, and each one's build and G;
   inside the whole batch the device time of K3, of the fused loop and of
   every kernel (torch.profiler).
13. CLI: `python -m pywfa_tpu_torch.cli align` in a subprocess over FASTA
   files written here (16384 pairs of 150 bp at 2%, 512 ONT-like 1 kb
   pairs at 7%, a lowercase read, a pattern with an N, 32 pairs of
   30-120 bp: four length buckets), --batch-size 4096: ends-free in tsv
   and in paf, then end to end in the high mode and under --memory-mode
   biwfa, which must run its 150 bp batches segmented and launch K3 and
   give the high mode's rows. Every row has status 0, 256 sampled rows
   equal the oracle (ends-free and end to end), no pair goes to the host
   oracle; pairs/s of each run. The launches come from each run's
   verbose "# device:" line.
14. The in-place compare (`engine.extend_mode` "chunk": the token rows
   compared from each cell's offset to the first mismatch, for batches
   whose equality words would pass `engine.EQ_BITS_BYTES_CAP`). Its branch
   of every build against its plain version and against the words on the
   same build, byte for byte (status, final_s, end_k, end_off, the whole
   choice record, and for segments the ring, the bands and the carry):
   rung 1 (4096 x 150 bp, W=256, S_cap=96, the group build); the
   gap-affine terminal rung (256 x W=384, S_cap=649: the group build,
   since the narrow one extends by the words alone); one WavefrontAligner
   call's batch with the wildcard N and one under the IUPAC classes; F's
   segment (256 x W=896, Ltp=1040), the first from WF0 and a later one
   from the stored state, forward and replay scopes (group); G's later
   segment of 96 scores at W=6912 on the cluster build, the same segment
   on the general build. At rung 1, F's and G's segments, chunk against
   bits in turns by CUDA events (chunk, bits, bits, chunk; the bits side
   builds its words), each kernel alone beside them (log lines). Then
   batch H, 64 ONT-like pairs of 50 kb at G's divergence, gap-affine end
   to end, full CIGAR, memory_mode="low": once as routed, which must
   extend by the rows on every launch (both rungs pass the cap), once with
   the cap raised in the process, on the words; the two equal pair for
   pair in every field, no pair at the host oracle; each run's wall,
   peak device memory and `engine.memory_estimate` of each rung. Each of
   H's rungs as the routed run launched it (W=8448 and W=33792 on the
   general build, the ring in global memory): a forward segment from WF0
   and the replay of the next one from its state, against the plain
   version, state included (these are the kernels line's records of the
   compare); H's first and last pair against the host oracle, which runs
   in a process of its own from the start of the script. Last, batch G
   under PYWFA_EXTEND=chunk, equal to batch G.
15. The parity fuzz (tools/fuzz_parity_torch.py, FUZZ_PARITY_ITERS
   random configurations from FUZZ_SEED: metric, penalties, span, frees,
   heuristics, match bonus, wildcard, step cap, scope, memory mode; each
   batch on the card against the oracle and, every field of every result,
   against the same batch on the plain versions on the CPU), the partials
   fuzz (tools/fuzz_partials_torch.py, FUZZ_PARTIALS_ITERS seeds:
   composite heuristics and WF-extension against the oracle) and the long
   share: LONG_FUZZ_CONFIGS random configurations under the high, low or
   biwfa memory mode, each a batch of LONG_FUZZ_B ONT-like pairs of 3-10
   kb at 2-10% divergence, against the host oracle (a process a
   configuration, started with H's); it must launch the general and the
   cluster build.
16. The soak (tools/soak_sanitize_torch.py, SOAK_ITERS iterations) in a
   process of its own under CUDA_LAUNCH_BLOCKING=1: numpy traps, every
   completed CIGAR self-checked; its last line ends "no traps fired".
17. bench_torch.py at its defaults (W=128, as bench.py) and at
   BENCH_W=256 (the first rung production derives): its JSON line
   (bench.py's four keys) and its '#' line (ms a batch, build, card).
18. The PYWFA_PROF stage report of a stream of phase 4's eight 4096-pair
   batches, depth 3: each of the dispatch, pull and finish keys once a
   batch.
19. The walk's kernel (csrc/walk.cu) against its plain twin on streams of
   its own: every walk of three 4096-pair batches and a probe batch, a
   WavefrontAligner call a metric on each span, a 1 kb batch run
   segmented and a batch of the benchmark's ont10k cell (512 pairs of
   10 kb from its generator, its aligner arguments: a one-shot rung, then
   segmented replays) is walked by both and held to the byte; then the
   kernel's time (a call by CUDA events, alone by torch.profiler, the
   launch's host time, the plain loop's) at a 4096-pair walk, a call's and
   the widest upper segment of each segmented batch; `engine.walk_runs`
   printed, no walk of the plain loop.

Each main-path phase zeroes the kernels' launch counts (by variant, by
build and the group build's by G) and the count of pairs sent to the host
oracle just before it and reads them just after; it fails unless its
kernel variants launched, unless a short-read phase (4-9) launched the
group build (a probe batch with G > 1, the stream's first rung with
G = 1), unless a
long-read phase (10) launched the build its band routes to, unless the
dry run (11) launched the group build and the sharded batch (12) the
group build at G = 1 and K3, if a timed stream, an API phase or a CLI
run (13) sent any pair to the oracle, or if any phase did so for an
inconsistent walk; batch H (14) fails unless its routed run launched only
the in-place compare and its words run only the words. Phases 15-19 fail
on any mismatch, trap, or pair sent to the oracle for an inconsistent or
a dropped walk; their launches are logged and stay out of the kernels
line, which fails unless the main paths walked with the kernel alone. The
line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
import collections
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
B_MAIN = 4096
L = 150
DIV = 0.02
N_BATCHES = 8
WINDOW = 200
WINDOW_FREE = 50
N_NEW_BATCHES = 4
N_SLICE_BATCHES = 8
N_SLICE_API = 12
ZDROP = 100
XDROP = 20
CHIMERA_TAIL = 50
N_RATE = 0.01
N_API = 256
N_METRIC_API = 64
MAXS = 2**31 - 1
# long reads: streams E and F, batch G
L_LONG = 1000
B_LONG = 256
N_LONG_BATCHES = 4
ONT_SUB, ONT_IND = 0.04, 0.03
L_G = 10000
B_G = 16
G_SUB, G_IND = 0.04, 0.025
# batch H (phase 14): ONT-like pairs of 50 kb at batch G's divergence,
# whose equality words pass engine.EQ_BITS_BYTES_CAP at every rung
L_H = 50000
B_H = 64
RESUME_STEPS = 200

# the four metrics beside gap-affine, as WavefrontAligner's `distance`
METRICS = ("affine2p", "linear", "levenshtein", "indel")

# the fuzz (phase 15): tools/fuzz_parity_torch.py's iterations from its
# seed, tools/fuzz_partials_torch.py's seeds from it, and the long share:
# configurations of random_config with the memory mode drawn from high,
# low and biwfa, each a batch of ONT-like pairs of 3-10 kb at 2-10%
# divergence, held against the host oracle in a process a configuration
FUZZ_SEED = 0
FUZZ_PARITY_ITERS = 200
FUZZ_PARTIALS_ITERS = 20
LONG_FUZZ_SEED = 15
LONG_FUZZ_CONFIGS = 6
LONG_FUZZ_B = 4
LONG_FUZZ_LEN = (3000, 10000)
LONG_FUZZ_DIV = (0.02, 0.10)
# the soak (phase 16): tools/soak_sanitize_torch.py's iterations
SOAK_ITERS = 10

# the card's published peaks (NVIDIA H100 SXM data sheet): device memory,
# and 32-bit operations outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# integer operations of one cell of one score step, counted from the
# kernel's source (extension, termination test, candidates, priority
# maximum, bounds, band, trim), by components of the metric
OPS_PER_CELL = {1: 60, 3: 110, 5: 170}


def log(msg):
    print(msg, flush=True)


def make_pairs(rng, n, length, divergence):
    """n pairs of `length` bp: random ACGT patterns, texts with
    int(length * divergence) substitutions each."""
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    pats = alphabet[rng.integers(0, 4, size=(n, length))]
    txts = pats.copy()
    nmut = max(1, int(length * divergence))
    for i in range(n):
        idx = rng.choice(length, size=nmut, replace=False)
        txts[i, idx] = alphabet[(rng.integers(1, 4, size=nmut)
                                 + np.searchsorted(alphabet, txts[i, idx]))
                                % 4]
    return ([pats[i].tobytes() for i in range(n)],
            [txts[i].tobytes() for i in range(n)])


def make_windows(rng, n, length, window, divergence):
    """n reads of `length` bp, each copied with int(length * divergence)
    substitutions into a random window of `window` bp at a random offset."""
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads, copies = make_pairs(rng, n, length, divergence)
    wins = alphabet[rng.integers(0, 4, size=(n, window))]
    offs = rng.integers(0, window - length + 1, size=n)
    for i in range(n):
        wins[i, offs[i]:offs[i] + length] = np.frombuffer(copies[i],
                                                          dtype=np.uint8)
    return reads, [wins[i].tobytes() for i in range(n)]


def make_gap_pairs(rng, n, length, divergence, share=0.125):
    """make_pairs, with one text in 1/share losing or gaining one run of
    30-60 bases at a random place."""
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    pats, txts = make_pairs(rng, n, length, divergence)
    for i in np.flatnonzero(rng.random(n) < share):
        g = int(rng.integers(30, 61))
        at = int(rng.integers(10, length - g - 10))
        if rng.random() < 0.5:
            txts[i] = txts[i][:at] + txts[i][at + g:]
        else:
            txts[i] = (txts[i][:at] + alphabet[rng.integers(0, 4, g)].tobytes()
                       + txts[i][at:])
    return pats, txts


def make_divergent_mix(rng, n, length, divergence, share=0.125):
    """make_pairs, with one pair in 1/share at 15-20% divergence instead
    (substitutions), which pass the first rung's score cap."""
    pats, txts = make_pairs(rng, n, length, divergence)
    for i in np.flatnonzero(rng.random(n) < share):
        _, t = make_pairs(rng, 1, length, float(rng.uniform(0.15, 0.20)))
        pats[i] = _[0]
        txts[i] = t[0]
    return pats, txts


def make_chimeras(rng, n, length, divergence, share=0.125,
                  tail=CHIMERA_TAIL):
    """make_pairs, with one text in 1/share ending in `tail` bases that
    have nothing to do with the read (a chimeric read)."""
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    pats, txts = make_pairs(rng, n, length, divergence)
    for i in np.flatnonzero(rng.random(n) < share):
        txts[i] = (txts[i][:length - tail]
                   + alphabet[rng.integers(0, 4, tail)].tobytes())
    return pats, txts


def make_n_pairs(rng, n, length, divergence, rate=N_RATE):
    """make_pairs with a share `rate` of all bases, on both sides,
    replaced by N."""
    pats, txts = make_pairs(rng, n, length, divergence)

    def with_n(seqs):
        arr = np.frombuffer(b"".join(seqs), dtype=np.uint8).reshape(
            n, length).copy()
        arr[rng.random(arr.shape) < rate] = ord("N")
        return [arr[i].tobytes() for i in range(n)]

    return with_n(pats), with_n(txts)


def make_ont_pairs(rng, n, length, sub, ind):
    """n pairs: random ACGT patterns of `length` bp; each text copies its
    pattern base by base, dropping a base with probability ind / 2,
    inserting a random base before it with probability ind / 2, and
    replacing it by a random base (itself included) with probability
    sub."""
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    pats, txts = [], []
    for _ in range(n):
        p = alphabet[rng.integers(0, 4, length)]
        r = rng.random(length)
        keep = r >= ind / 2
        insert = keep & (r < ind)
        base = np.where(rng.random(length) < sub,
                        alphabet[rng.integers(0, 4, length)], p)
        # each kept base, preceded by a random base where one is inserted
        out = np.empty((length, 2), dtype=np.uint8)
        out[:, 0] = alphabet[rng.integers(0, 4, length)]
        out[:, 1] = base
        take = np.stack([insert, keep], axis=1)
        pats.append(p.tobytes())
        txts.append(out[take].tobytes() or b"A")
    return pats, txts


def reset_counts():
    """Zero the kernels' launch counts (the fused loop's by variant, by
    build and the group build's by G, the run-length table's), the count
    of pairs sent to the host oracle, by reason, and the segmented
    executor's counts."""
    from pywfa_tpu_torch import batch as PB
    from pywfa_tpu_torch.ops import engine as TE
    from pywfa_tpu_torch.ops import fused_loop, lcp_table
    for counts in (fused_loop.variant_launches, fused_loop.build_launches,
                   fused_loop.group_launches, lcp_table.launches,
                   PB.oracle_fallbacks, PB.segmented_runs, TE.walk_runs):
        for k in counts:
            counts[k] = 0


def read_counts():
    """The launch counts: the fused loop's by variant, under
    "build_<name>" by build and under "group_G<n>" the group build's by
    G; the run-length table's; the walk's kernel ("walk") and the walks
    the plain loop ran ("walk_plain", 0 on the card)."""
    from pywfa_tpu_torch.ops import engine as TE
    from pywfa_tpu_torch.ops import fused_loop, lcp_table
    builds = {"build_" + k: v for k, v in fused_loop.build_launches.items()}
    groups = {f"group_G{g}": v
              for g, v in sorted(fused_loop.group_launches.items()) if v}
    return dict(fused_loop.variant_launches, **lcp_table.launches, **builds,
                **groups, walk=TE.walk_runs["kernel"],
                walk_plain=TE.walk_runs["plain"])


def group_counts(counts):
    """The group build's launches by G, from read_counts."""
    return {int(k[7:]): v for k, v in counts.items()
            if k.startswith("group_G")}


def check_group(phase, counts, wide=False, one=False):
    """A short-read main path runs on the group build: fail unless it
    launched it, with G > 1 warps a pair at least once where `wide` (a
    probe batch, whose terminal rung walks a band of hundreds of
    diagonals) and with one warp a pair where `one` (the first rung of
    4096 pairs); print what each build and each G launched."""
    builds = {k[6:]: v for k, v in counts.items() if k.startswith("build_")}
    by_g = group_counts(counts)
    log(f"builds [{phase}]: {builds}; group build by G: {by_g}")
    if builds["group"] == 0:
        raise AssertionError(f"{phase} never launched the group build")
    if wide and not any(v for g, v in by_g.items() if g > 1):
        raise AssertionError(f"{phase} never launched the group build with "
                             f"G > 1: {by_g}")
    if one and not by_g.get(1):
        raise AssertionError(f"{phase} never launched the group build with "
                             f"G = 1: {by_g}")


def check_build(phase, counts, build, general=False):
    """A long-read main path runs on the build `kernel_build` names for its
    band (the group build up to 1024 diagonals, the cluster build past 3072
    diagonals or where the ring passes one block): fail unless it launched that
    build, or if it launched the general build where none of its bands
    routes there (`general` False); print what each build launched."""
    builds = {k[6:]: v for k, v in counts.items() if k.startswith("build_")}
    log(f"builds [{phase}]: {builds}")
    if builds[build] == 0 or (builds["general"] and not general):
        raise AssertionError(f"{phase} must launch the {build} build"
                             + ("" if general else " and not the general "
                                "one") + f": {builds}")


def in_turns(run, new, reps):
    """Mean ms a call of run(build) by CUDA events, the general build and
    the new one in turns (general, new, new, general); returns the means
    and the four times."""
    times = collections.defaultdict(list)
    order = ("general", new, new, "general")
    for b in order:
        times[b].append(cuda_ms(lambda: run(b), reps))
    return ({b: float(np.mean(v)) for b, v in times.items()},
            [times[b][i] for b, i in zip(order, (0, 0, 1, 1))])


def launched(counts):
    """The variants of `counts` that launched at all."""
    return {k: v for k, v in counts.items() if v}


def check_fallbacks(phase, timed):
    """Print the pairs the phase sent to the host oracle, by reason. A
    timed stream or an API phase must send none; no phase may send one
    for an inconsistent walk, which would be a wrong kernel or walk hiding
    behind the oracle."""
    from pywfa_tpu_torch import batch as PB
    fb = dict(PB.oracle_fallbacks)
    log(f"oracle fallbacks [{phase}]: {fb}")
    if fb["inconsistent walk"]:
        raise AssertionError(f"{phase}: {fb['inconsistent walk']} pairs had "
                             "an inconsistent walk")
    if timed and any(fb.values()):
        raise AssertionError(f"{phase}: pairs went to the host oracle: {fb}")
    return fb


def metric_attr(metric, params=None, **kw):
    """(attributes, prefix of the kernel variants' names) of a metric;
    `params` is a HeuristicParams that replaces the attributes' own."""
    from pywfa_tpu_torch.align import WavefrontAligner
    from pywfa_tpu_torch.ops import fused_loop
    attr = WavefrontAligner(backend="numpy", distance=metric,
                            **kw)._attributes()
    if params is not None:
        attr = dataclasses.replace(attr, heuristic=params)
    return attr, fused_loop.METRIC_PREFIX[attr.penalties.distance_metric]


def heuristics():
    """The six heuristics, by name: WFA2-lib's default wf-adaptive
    10/50/1, and parameters at which each of the others acts on 150 bp
    reads."""
    from pywfa_tpu_torch.attributes import HeuristicParams
    from pywfa_tpu_torch.constants import HeuristicStrategy as HS
    return {
        "wfadaptive": HeuristicParams(strategy=HS.WFADAPTIVE),
        "wfmash": HeuristicParams(strategy=HS.WFMASH,
                                  max_distance_threshold=30),
        "xdrop": HeuristicParams(strategy=HS.XDROP, xdrop=XDROP),
        "zdrop": HeuristicParams(strategy=HS.ZDROP, zdrop=ZDROP),
        "banded_static": HeuristicParams(strategy=HS.BANDED_STATIC,
                                         min_k=-20, max_k=20),
        "banded_adaptive": HeuristicParams(strategy=HS.BANDED_ADAPTIVE,
                                           min_k=-15, max_k=15,
                                           steps_between_cutoffs=2),
    }


def mutate(rng, p, sub, ind):
    out = bytearray()
    for c in p:
        r = rng.random()
        if r < ind / 2:
            continue
        if r < ind:
            out.append(b"ACGT"[rng.integers(4)])
        out.append(c if rng.random() > sub else b"ACGT"[rng.integers(4)])
    return bytes(out) or b"A"


def make_probe(rng):
    """64 pairs that leave the first rung or the 2-bit push: 24 at 25%
    divergence, 14 unrelated, 2 over disjoint alphabets (every base a
    mismatch: past the second rung's score cap, so they reach the terminal
    rung), one with an N, 23 of mixed lengths."""
    def rand(n, alphabet=b"ACGT"):
        a = np.frombuffer(alphabet, np.uint8)
        return bytes(a[rng.integers(0, len(a), n)])
    pats, txts = [], []
    for _ in range(24):
        p = rand(L)
        pats.append(p)
        txts.append(mutate(rng, p, 0.2, 0.05))
    for _ in range(14):
        pats.append(rand(L))
        txts.append(rand(int(rng.integers(100, L + 1))))
    for _ in range(2):
        pats.append(rand(L, b"AC"))
        txts.append(rand(L, b"GT"))
    p = rand(L)
    pats.append(p[:70] + b"N" + p[71:])
    txts.append(mutate(rng, p, 0.02, 0.0))
    for _ in range(23):
        p = rand(int(rng.integers(20, L + 1)))
        pats.append(p)
        txts.append(mutate(rng, p, 0.05, 0.02))
    return pats, txts


def cuda_ms(fn, reps):
    """Mean ms of fn over `reps` runs by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


# profiler sessions that recorded fewer launches of the timed kernel than
# were made (kernel_only_ms), and all sessions: logged at the end
PROFILER_SESSIONS = collections.Counter()


def kernel_only_ms(fn, reps=5, name="fused_loop"):
    """Mean ms a call of fn spends in the kernels whose name holds `name`
    (the fused loop's by default; "" for every kernel) alone, by
    torch.profiler's device rows (no host gap); None where the profiler
    records no device time. A named kernel is launched once a call: a
    session can come back with fewer of its launches than were made (the
    rest of the records lost), so the time is the mean of the launches it
    recorded, not their sum over `reps`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # the profiler now and then returns a session without its device rows,
    # or with some of them: ask again before settling
    best = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name in e.key]
        us = sum(e.self_device_time_total for e in rows)
        count = sum(e.count for e in rows)
        PROFILER_SESSIONS["sessions"] += 1
        if us <= 0 or count == 0:
            continue
        if not name:
            if count % reps == 0:
                return us / 1e3 / reps
            PROFILER_SESSIONS["short"] += 1
            continue
        if count == reps:
            return us / 1e3 / count
        PROFILER_SESSIONS["short"] += 1
        if best is None or count > best[1]:
            best = (us / 1e3 / count, count)
    return None if best is None else best[0]


def host_ms(fn, reps):
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    from pywfa_tpu_torch import native
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"native host library loaded: {native.lib() is not None}")


def ptxas_lines(lib, output):
    """ptxas' registers and spills, one line a kernel of nvcc's output for
    `lib`: the fused loop's kernels by build and template arguments
    <metric, span, record, heuristic>, the table's by output type,
    diagonals a thread, wildcard and whole-store (W a multiple of the
    cells) instantiation."""
    lines = []
    name = "?"
    spills = ""
    for line in output.splitlines():
        m = re.search(r"fused_loop(_[a-z]+)?ILi(\d)ELi(\d)ELb([01])ELb([01])E",
                      line)
        t = re.search(r"lcp_tableI(\w)Li(\d)ELb([01])ELb([01])E", line)
        if lib == "walk" and "Compiling" in line:
            name = ""
        elif m and "Compiling" in line:
            name = "{}<{}, {}, {}, {}>".format(m.group(1) or "",
                                               *m.groups()[1:])
        elif t and "Compiling" in line:
            name = "<{}, {} cells, wildcard {}, full stores {}>".format(
                "uint8" if t.group(1) == "h" else "int16",
                4 * int(t.group(2)), t.group(3), t.group(4))
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            lines.append(f"ptxas {lib}{name}: "
                         f"{line.split(':', 1)[1].strip()}; {spills}")
    return lines


def phase_build():
    from pywfa_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    paths = cuda_build.build()
    for name in paths:
        cuda_build.load(name)
    log(f"build: {time.perf_counter() - t0:.2f} s, every source side by "
        f"side ({', '.join(sorted(paths.values()))})")
    for lib, (seconds, output) in sorted(cuda_build.last_build.items()):
        log(f"  nvcc {lib}.cu: done after {seconds:.2f} s")
        for line in ptxas_lines(lib, output):
            log("  " + line)


# the step sweep at the gap-affine terminal rung: batch sizes and step caps
SWEEP_B = (16, 132, 256, 512)
SWEEP_STEPS = (50, 100, 200, 386)


def terminal_pairs(rng):
    """The terminal shape's pairs, drawn after the main pairs: 192 related
    150 bp pairs and 64 unrelated ones, whose live bands fill W."""
    related = make_pairs(rng, 192, L, DIV)
    unrelated = (make_pairs(rng, 64, L, 0.0)[0],
                 make_pairs(rng, 64, L, 0.0)[0])
    return related, unrelated


def sweep_batches():
    """(B, pairs) of the step sweep: the probe batch's own terminal launch
    (its two pairs over disjoint alphabets, padded with "A" / "A" pairs to
    16 as batch._bucket_B pads), then the terminal shape's 64 unrelated
    pairs replicated to each larger B."""
    rng = np.random.default_rng(SEED)
    for _ in range(N_BATCHES):
        make_pairs(rng, B_MAIN, L, DIV)
    pats, txts = make_probe(rng)
    lone = (pats[38:40] + [b"A"] * 14, txts[38:40] + [b"A"] * 14)
    rng = np.random.default_rng(SEED + 1)
    make_pairs(rng, B_MAIN, L, DIV)
    _, (up, ut) = terminal_pairs(rng)
    out = [(16, lone)]
    for B in SWEEP_B[1:]:
        out.append((B, ((up * -(-B // 64))[:B], (ut * -(-B // 64))[:B])))
    return out


def step_sweep(dev, attr, builds, emit=log):
    """The µs a score step of each build at the gap-affine terminal rung
    (W=384, S_cap=649): every batch of sweep_batches, each step cap of
    SWEEP_STEPS through align_batch_fused_loop's max_steps. Per point the
    kernel's own device time (kernel_only_ms) and the call's (CUDA
    events; at a few steps it is the host's, not the kernel's); the slope
    of the kernel's time between two caps is a step's cost at the bands
    those steps reach. `builds` maps a label to the `build` argument (and,
    for the group build, the G) a launch takes; returns the points."""
    from pywfa_tpu_torch.ops import config as C
    from pywfa_tpu_torch.ops import fused_loop
    cfg = C.full_config(attr, 160, 160)
    points = []
    for B, (pats, txts) in sweep_batches():
        args = _device_inputs(cfg, pats, txts, dev)
        for label, kw in builds.items():
            prev = None
            for steps in SWEEP_STEPS:
                def run():
                    return fused_loop.align_batch_fused_loop(cfg, *args,
                                                             steps, **kw)
                ms = cuda_ms(run, 5)
                alone = kernel_only_ms(run, 3)
                per = 1e3 * (alone if alone is not None else ms) / steps
                slope = None
                if prev is not None and alone is not None:
                    slope = 1e3 * (alone - prev[1]) / (steps - prev[0])
                if alone is not None:  # the slope from the last measured cap
                    prev = (steps, alone)
                point = dict(build=label, B=B, max_steps=steps, ms=ms,
                             kernel_only_ms=alone, us_a_step=per,
                             slope_us_a_step=slope)
                points.append(point)
                emit(f"step sweep [{label}] B={B} W={cfg.W} "
                     f"max_steps={steps} ms={ms:.4f} "
                     f"kernel_only_ms={_fmt(alone)} us_a_step={per:.3f} "
                     f"slope_us_a_step="
                     + ("-" if slope is None else f"{slope:.3f}"))
    return points


def _device_inputs(cfg, pats, txts, dev, frees_row=(0, 0, 0, 0)):
    from pywfa_tpu_torch import batch as PB
    from pywfa_tpu_torch.ops import engine as TE
    plens = np.fromiter(map(len, pats), dtype=np.int32, count=len(pats))
    tlens = np.fromiter(map(len, txts), dtype=np.int32, count=len(txts))
    pat_np, pp = PB._encode_side(pats, cfg.Lp, cfg.extend_chunk,
                                 PB.PATTERN_SENTINEL, plens)
    txt_np, pt = PB._encode_side(txts, cfg.Lt, cfg.extend_chunk,
                                 PB.TEXT_SENTINEL, tlens)
    rows = PB._to_device(np.concatenate([pp, pt], axis=1), dev)
    lens = PB._to_device(np.stack([plens, tlens]), dev)
    pat, txt = TE.decode_packed(cfg, rows, lens[0], lens[1])
    bits = TE.build_eq_bits(cfg, pat, txt)
    # per-pair clamped frees, as the batch path builds them
    frees = np.minimum(np.array([frees_row], dtype=np.int32),
                       np.stack([plens, plens, tlens, tlens], axis=1))
    return bits, lens[0], lens[1], PB._to_device(frees, dev)


def rung_plan(attr, pats, txts, second=False, wildcard=None, Lp=None,
              Lt=None):
    """The batch path's plan (batch._plan_rung) of the first rung of these
    pairs, or of the second (batch._next_caps), which they escalate to when
    they pass the first; and the handle the dispatch makes."""
    import torch
    from pywfa_tpu_torch import batch as PB
    h = PB._prepare(attr, pats, txts, wildcard, torch.device("cpu"), Lp=Lp,
                    Lt=Lt)
    if not second:
        return h.rung, h
    W, S_cap = PB._next_caps(h.rung, h.attr0, h.maxLp, h.maxLt)
    return PB._plan_rung(h.attr0, h.Lp, h.Lt, min(h.maxLp, h.maxLt), h.B,
                         wildcard, W, S_cap, True), h


def rung1_config(attr, pats, txts, wildcard=None):
    """The first rung the batch path picks for these pairs."""
    return rung_plan(attr, pats, txts, wildcard=wildcard)[0].cfg


def api_single_inputs(attr, pat, txt):
    """The 16-pair batch and the first-rung config of one WavefrontAligner
    call, as engine_adapter.align_single and batch.align_pairs_dispatch
    build them: power-of-two length buckets, "A"/"A" pad pairs."""
    from pywfa_tpu_torch import engine_adapter as EA
    from pywfa_tpu_torch.attributes import validate_alignment
    rung, h = rung_plan(
        validate_alignment(attr, len(pat), len(txt)), [pat], [txt],
        Lp=EA._bucket_len(len(pat), EA.DEFAULT_SCHEDULE),
        Lt=EA._bucket_len(len(txt), EA.DEFAULT_SCHEDULE))
    return (h.patterns, h.texts), rung.cfg


def kernel_bound(cfg, args, out, cells, seg_base=0, state_bytes=0,
                 ext_bytes=None):
    """(bound_ms, bound_by): the least time the card could take for this
    call. Bytes: every input read once (the eq words, the lengths, the
    frees on the ends-free span) and every output written once (the result
    block and, with the record, the levels these pairs reach, W bytes
    each; the memset of the whole [S_cap, B, W] tensor is not counted)
    over the card's memory rate. Operations: the cells these pairs compute
    (the non-zero choice bytes of the recording run, plus WF0) times the
    metric's count a cell, over the card's 32-bit rate. A segment from
    score seg_base also moves state_bytes (its state, read and written),
    and of the extension's input only ext_bytes, what its cells read."""
    from pywfa_tpu_torch.constants import AlignmentSpan
    B = out["status"].shape[0]
    nbytes = (args[0].numel() * 4 if ext_bytes is None else ext_bytes)
    nbytes += B * 8 + B * 16 + state_bytes
    if cfg.span == AlignmentSpan.ENDS_FREE:
        nbytes += B * 16
    if cfg.record_choices:
        nbytes += int((out["final_s"] - seg_base).clamp(min=0).sum()) * cfg.W
    ops = cells * OPS_PER_CELL[cfg.n_comp]
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _build_label(key):
    """A (build, G) key of phase 3's times as its log label."""
    return key[0] if key[1] is None else f"group_G{key[1]}"


def phase_kernel_vs_plain(attr, dev, long_inputs):
    from pywfa_tpu_torch.align import WavefrontAligner as RefAligner
    from pywfa_tpu_torch.ops import config as C
    from pywfa_tpu_torch.ops import fused_loop
    rng = np.random.default_rng(SEED + 1)
    main = make_pairs(rng, B_MAIN, L, DIV)
    related, unrelated = terminal_pairs(rng)
    term = (related[0] + unrelated[0], related[1] + unrelated[1])
    windows = make_windows(rng, B_MAIN, L, WINDOW, DIV)
    ef_attr = RefAligner(backend="numpy", text_begin_free=WINDOW_FREE,
                         text_end_free=WINDOW_FREE)._attributes()
    default_attr = RefAligner(backend="numpy")._attributes()
    score_attr = RefAligner(backend="numpy", scope="score")._attributes()
    p = make_pairs(rng, 1, L, 0.0)[0][0]
    single = (p, mutate(rng, p, DIV, 0.01))
    win_cfg = rung1_config(ef_attr, *windows)
    rung1 = C.full_config(attr, 160, 160, W=256, S_cap=96)
    terminal = C.full_config(attr, 160, 160)
    wfree = (0, 0, WINDOW_FREE, WINDOW_FREE)
    zero = (0, 0, 0, 0)
    shapes = [
        ("rung1", main, rung1, zero),
        ("w128", main, C.full_config(attr, 160, 160, W=128, S_cap=96), zero),
        ("terminal", term, terminal, zero),
        # the probe batch's own terminal launch: two pairs over disjoint
        # alphabets padded to 16
        ("terminal_probe", sweep_batches()[0][1], terminal, zero),
        ("endsfree_window", windows, win_cfg, wfree),
        ("endsfree_default", main, rung1_config(default_attr, *main), zero),
        ("score_rung1", main,
         dataclasses.replace(rung1, record_choices=False), zero),
        ("score_terminal", term,
         dataclasses.replace(terminal, record_choices=False), zero),
        ("score_endsfree_window", windows,
         dataclasses.replace(win_cfg, record_choices=False), wfree),
        ("api_single",) + api_single_inputs(default_attr, *single) + (zero,),
        ("api_single_score",) + api_single_inputs(score_attr, *single)
        + (zero,),
    ]
    for metric in METRICS:
        m_attr, prefix = metric_attr(metric, span="end-to-end")
        m_rung1 = rung1_config(m_attr, *main)
        shapes.append((prefix + "rung1", main, m_rung1, zero))
        shapes.append((prefix + "score_rung1", main,
                       dataclasses.replace(m_rung1, record_choices=False),
                       zero))
        if metric == "affine2p":
            shapes.append((prefix + "terminal", term,
                           C.full_config(m_attr, 160, 160), zero))
        if metric in ("affine2p", "levenshtein"):
            m_ef, _ = metric_attr(metric, text_begin_free=WINDOW_FREE,
                                  text_end_free=WINDOW_FREE)
            shapes.append((prefix + "endsfree_window", windows,
                           rung1_config(m_ef, *windows), wfree))
        for scope, tag in (("full", ""), ("score", "_score")):
            m_def, _ = metric_attr(metric, scope=scope)
            shapes.append((prefix + "api_single" + tag,)
                          + api_single_inputs(m_def, *single) + (zero,))
    shapes += slice_shapes(rng, main, term, windows, single)
    # stream E's second rung, one shot: a live band of hundreds of
    # diagonals on 256 pairs
    pats1k, txts1k = long_inputs["ef"][0]
    shapes.append(("e_rung2", (pats1k, txts1k),
                   rung2_config(attr, pats1k, txts1k), zero))
    records = {}
    # the builds a short-read shape can take (the cluster build is for
    # bands past 1024 diagonals: phase 10)
    builds = [b for b in fused_loop.BUILDS if b != "cluster"]
    for name, (pats, txts), cfg, frees_row in shapes:
        args = _device_inputs(cfg, pats, txts, dev, frees_row)
        B = len(pats)
        build = fused_loop.kernel_build(cfg, B)
        G = fused_loop.launch_shape(cfg, B, "group", dev)[1]

        def run(b, g=None):
            return fused_loop.align_batch_fused_loop(cfg, *args, MAXS,
                                                     build=b, group=g)

        want = fused_loop.align_batch_fused_loop_ref(cfg, *args, MAXS)
        torch.cuda.synchronize()
        err = 0
        # every build at its routed shape, and the group build at one warp
        # a pair too where the routing gives it more
        for b, g in [(b, None) for b in builds] + (
                [("group", 1)] if G > 1 else []):
            got = run(b, g)
            torch.cuda.synchronize()
            if set(got) != set(want) or (
                    "choices" in got) != cfg.record_choices:
                raise AssertionError(f"{name} ({b}): outputs {sorted(got)} "
                                     f"vs {sorted(want)}")
            e = _max_err(name, got, want, LOOP_KEYS)
            if e != 0:
                raise AssertionError(f"{name}: the {b} build (G={g or G}) "
                                     f"differs from the plain version ({e})")
            err = max(err, e)
        got = run(build)
        status = torch.bincount(got["status"].long(), minlength=6).tolist()
        # in turns: the narrow build and the group build at its G where the
        # routing takes the narrow build, else the group build at its G and
        # at one warp a pair where they differ; then the general build
        if build == "narrow":
            order = (("narrow", None), ("group", G), ("group", G),
                     ("narrow", None))
        elif G > 1:
            order = (("group", 1), ("group", G), ("group", G), ("group", 1))
        else:
            order = (("group", G), ("group", G))
        times = collections.defaultdict(list)
        for key in order:
            times[key].append(cuda_ms(lambda: run(*key), 10))
        general_ms = cuda_ms(lambda: run("general"), 10)
        t_ms = {key: float(np.mean(v)) for key, v in times.items()}
        # the kernel alone, where the event time above is a call's host
        # time (a small batch, a few steps)
        only = {key: kernel_only_ms(lambda: run(*key)) for key in t_ms}
        routed = ("narrow", None) if build == "narrow" else ("group", G)
        memset_ms = cuda_ms(lambda: torch.zeros(
            (cfg.S_cap, B, cfg.W), dtype=torch.uint8, device=dev), 20) \
            if cfg.record_choices else 0.0
        p_ms = cuda_ms(lambda: fused_loop.align_batch_fused_loop_ref(
            cfg, *args, MAXS), 2)
        rec = got if cfg.record_choices else fused_loop.align_batch_fused_loop(
            dataclasses.replace(cfg, record_choices=True), *args, MAXS)
        cells = int(torch.count_nonzero(rec["choices"])) + B
        del rec
        b_ms, b_by = kernel_bound(cfg, args, got, cells)
        log(f"kernel vs plain [{name}] variant={fused_loop.variant(cfg)} "
            f"B={B} W={cfg.W} S_cap={cfg.S_cap} Lp={cfg.Lp} "
            f"Lt={cfg.Lt} NQ={args[0].shape[0]} "
            f"steps={int(got['steps'])} "
            f"status_counts={status} max_abs_err={err} build={build} G={G} "
            f"pairs_a_block={fused_loop.group_pairs(cfg, B, G)} "
            + "".join(f"{_build_label(key)}_ms={t_ms[key]:.4f} "
                      f"({', '.join(f'{t:.4f}' for t in times[key])}) "
                      for key in t_ms)
            + f"general_ms={general_ms:.4f} memset_ms={memset_ms:.4f} "
            f"kernel_only_ms "
            f"{', '.join(f'{_build_label(k)}={_fmt(v)}' for k, v in only.items())} "
            f"plain_ms={p_ms:.2f} "
            f"bound_ms={b_ms:.3g} bound_by={b_by} cells={cells} "
            f"group_smem={fused_loop.group_pairs(cfg, B, G) * fused_loop.group_pair_bytes(cfg, G)} "
            f"block_smem={fused_loop.smem_bytes(cfg)}")
        records[name] = dict(variant=fused_loop.variant(cfg), err=err,
                             build=build,
                             G=G if build == "group" else None,
                             ms=t_ms[routed], alone=only[routed],
                             plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                             B=B)
    return records


def slice_api_configs(metric):
    """WavefrontAligner's arguments that reach the heuristic and seeded
    kernel variants of a metric (and, under gap-affine, the wildcard and
    WF-extension paths), by name."""
    from pywfa_tpu_torch.constants import DistanceMetric
    from pywfa_tpu_torch.ops import fused_loop
    configs = {"adaptive_e2e": dict(heuristic="adaptive", span="end-to-end")}
    seeded = [fused_loop.METRIC_PREFIX[m] for m in fused_loop.SEEDED_METRICS]
    if metric_attr(metric)[1] in seeded:
        configs["xdrop"] = dict(heuristic="X-drop", xdrop=XDROP)
        configs["match"] = dict(match=-1)
        configs["match_adaptive"] = dict(match=-1, heuristic="adaptive")
    else:
        # the drops do not go with edit and indel
        configs["adaptive"] = dict(heuristic="adaptive")
    if metric_attr(metric)[0].penalties.distance_metric == \
            DistanceMetric.GAP_AFFINE:
        configs["wildcard"] = dict(wildcard="N")
        configs["extension"] = dict(extension=True)
    return configs


def slice_shapes(rng, main, term, windows, single):
    """The shapes at which the heuristic and seeded variants are held
    against the plain version: (name, pairs, config, frees row)."""
    from pywfa_tpu_torch.ops import config as C
    heur = heuristics()
    zero = (0, 0, 0, 0)
    wfree = (0, 0, WINDOW_FREE, WINDOW_FREE)
    free_kw = dict(text_begin_free=WINDOW_FREE, text_end_free=WINDOW_FREE)
    mix = make_divergent_mix(rng, B_MAIN, L, DIV)
    chimeras = make_chimeras(rng, B_MAIN, L, DIV)
    shapes = []

    def both_scopes(name, pairs, cfg, frees_row):
        shapes.append((name, pairs, cfg, frees_row))
        shapes.append((name + "_score", pairs,
                       dataclasses.replace(cfg, record_choices=False),
                       frees_row))

    adaptive, _ = metric_attr("affine", heur["wfadaptive"], span="end-to-end")
    both_scopes("heur_wfadaptive_rung1", mix, rung1_config(adaptive, *mix),
                zero)
    zdrop, _ = metric_attr("affine", heur["zdrop"], span="end-to-end")
    both_scopes("heur_zdrop_rung1", chimeras, rung1_config(zdrop, *chimeras),
                zero)
    shapes.append(("heur_wfadaptive_terminal", term,
                   C.full_config(adaptive, 160, 160), zero))
    seeded, _ = metric_attr("affine", match=-1, **free_kw)
    both_scopes("seed_window", windows, rung1_config(seeded, *windows), wfree)
    ef_heur, _ = metric_attr("affine", heur["wfadaptive"], **free_kw)
    both_scopes("heur_endsfree_window", windows,
                rung1_config(ef_heur, *windows), wfree)
    seed_heur, _ = metric_attr("affine", heur["wfadaptive"], match=-1,
                               **free_kw)
    both_scopes("heur_seed_window", windows,
                rung1_config(seed_heur, *windows), wfree)
    a2p, prefix = metric_attr("affine2p", heur["wfadaptive"],
                              span="end-to-end")
    both_scopes(prefix + "heur_wfadaptive_rung1", mix,
                rung1_config(a2p, *mix), zero)
    for metric in ("affine",) + METRICS:
        prefix = metric_attr(metric)[1]
        for cname, kw in slice_api_configs(metric).items():
            if cname in ("wildcard", "extension"):
                continue  # no kernel variant of their own
            for scope, tag in (("full", ""), ("score", "_score")):
                attr, _ = metric_attr(metric, scope=scope, **kw)
                shapes.append((f"{prefix}api_{cname}{tag}",)
                              + api_single_inputs(attr, *single) + (zero,))
    return shapes


def phase_stream(dev):
    from pywfa_tpu_torch import BatchWavefrontAligner
    from pywfa_tpu_torch import batch as PB
    from pywfa_tpu_torch.cigar import ops_to_cigarstring
    from pywfa_tpu_torch.oracle import OracleAligner
    from pywfa_tpu_torch.ops import config as C
    from pywfa_tpu_torch.ops import engine as TE
    from pywfa_tpu_torch.ops import fused_loop
    rng = np.random.default_rng(SEED)
    batches = [make_pairs(rng, B_MAIN, L, DIV) for _ in range(N_BATCHES)]
    probe = make_probe(rng)
    aligner = BatchWavefrontAligner(distance="affine", span="end-to-end",
                                    device="cuda")
    attr = aligner._attr
    # warm-up (not counted): first-use allocations and the kernel load
    list(aligner.align_stream(iter(batches[:1]), depth=1))
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    results = list(aligner.align_stream(iter(batches), depth=3))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_fallbacks("stream e2e", timed=True)
    t0 = time.perf_counter()
    results += list(aligner.align_stream(iter([probe]), depth=3))
    torch.cuda.synchronize()
    probe_wall = time.perf_counter() - t0
    check_fallbacks("stream e2e + probe", timed=False)
    counts = read_counts()
    check_group("stream e2e + probe", counts, wide=True, one=True)
    launches = counts["e2e"]
    n_main = N_BATCHES * B_MAIN
    log(f"stream: {N_BATCHES} batches, {n_main} pairs in {wall:.3f} s = "
        f"{n_main / wall:.0f} alignments/s ({1e3 * wall / N_BATCHES:.2f} "
        f"ms/batch); probe batch of {len(probe[0])} pairs in "
        f"{1e3 * probe_wall:.1f} ms; fused-loop launches {launches}")
    # one launch per main batch, three for the probe batch (its rungs)
    if launches < N_BATCHES + 3:
        raise AssertionError(f"the stream launched the kernel {launches} "
                             "times; the probe batch must reach the "
                             "terminal rung")
    if [len(r) for r in results] != [len(b[0]) for b in batches + [probe]]:
        raise AssertionError("result counts differ from the input")
    flat = [r for rs in results for r in rs]
    bad = [i for i, r in enumerate(flat) if r.status != 0]
    if bad:
        raise AssertionError(f"{len(bad)} pairs did not complete, e.g. {bad[:5]}")

    pats = [p for b in batches + [probe] for p in b[0]]
    txts = [t for b in batches + [probe] for t in b[1]]
    sample = sorted(rng.choice(N_BATCHES * B_MAIN, 512, replace=False)
                    .tolist()) + list(range(N_BATCHES * B_MAIN, len(flat)))
    oracle = OracleAligner(attr)
    for i in sample:
        o = oracle.align(pats[i], txts[i])
        r = flat[i]
        if (r.score, r.ops) != (o.score, o.ops):
            raise AssertionError(f"pair {i}: {r.score} {r.cigarstring} vs "
                                 f"oracle {o.score} "
                                 f"{ops_to_cigarstring(o.ops)}")
    log(f"oracle: {len(sample)} pairs equal in score and CIGAR "
        f"({len(probe[0])} probe pairs included)")

    # per-stage ms/batch on one 4096-pair batch, each stage on its own
    pats1, txts1 = batches[1]
    h = PB.align_pairs_dispatch(attr, pats1, txts1, device=dev)
    cfg = h.rung.cfg
    PB.align_pairs_finish(h)
    log(f"first rung: W={cfg.W} S_cap={cfg.S_cap} ops_out={cfg.ops_out} "
        f"Lp={cfg.Lp} Lt={cfg.Lt} layout={C.packed_layout(cfg)}")
    plens = np.full(B_MAIN, L, dtype=np.int32)

    def encode():
        _, pp = PB._encode_side(pats1, cfg.Lp, cfg.extend_chunk,
                                PB.PATTERN_SENTINEL, plens)
        _, pt = PB._encode_side(txts1, cfg.Lt, cfg.extend_chunk,
                                PB.TEXT_SENTINEL, plens)
        return np.concatenate([pp, pt], axis=1)

    rows_np = encode()
    lens_np = np.stack([plens, plens])
    rows = PB._to_device(rows_np, dev)
    lens = PB._to_device(lens_np, dev)
    frees = torch.zeros((B_MAIN, 4), dtype=torch.int32, device=dev)
    bits = TE.build_eq_bits(cfg, *TE.decode_packed(cfg, rows, lens[0],
                                                   lens[1]))
    out = fused_loop.align_batch_fused_loop(cfg, bits, lens[0], lens[1],
                                            frees, 2**31 - 1)
    ok = TE.walkable(out)
    walked = TE.traceback_walk(cfg, out["choices"], out["final_s"],
                               out["end_k"], ok)
    packed = TE.pack_walked(cfg, out, ok, walked)
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)

    def finish():
        hh = PB.align_pairs_pull(
            PB.align_pairs_dispatch(attr, pats1, txts1, device=dev))
        t = time.perf_counter()
        PB.align_pairs_finish(hh)
        return time.perf_counter() - t

    stages = {
        "encode": host_ms(encode, 5),
        "h2d": cuda_ms(lambda: (PB._to_device(rows_np, dev),
                                PB._to_device(lens_np, dev)), 10),
        "eq_bits": cuda_ms(lambda: TE.build_eq_bits(
            cfg, *TE.decode_packed(cfg, rows, lens[0], lens[1])), 10),
        "kernel": cuda_ms(lambda: fused_loop.align_batch_fused_loop(
            cfg, bits, lens[0], lens[1], frees, 2**31 - 1), 20),
        "walk": cuda_ms(lambda: TE.traceback_walk(
            cfg, out["choices"], out["final_s"], out["end_k"], ok), 10),
        "pack": cuda_ms(lambda: TE.pack_walked(cfg, out, ok, walked), 10),
        "d2h": cuda_ms(lambda: host.copy_(packed, non_blocking=True), 20),
        "finish": 1e3 * min(finish() for _ in range(3)),
    }
    log("stage ms/batch (4096 x 150 bp, first rung): " + ", ".join(
        f"{k}={v:.3f}" for k, v in stages.items()))
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.0f}"
        " MiB")
    return counts


# README and reference-test golden pairs: (pattern, text, aligner kwargs)
GOLDEN = [
    ("TCTTTACTCGCGCGTTGGAGAAATACAATAGT", "TCTATACTGCGCGTTTGGAGAAATAAAATAGT",
     {}),
    ("AAAAACCTTTTTAAAAAA", "GGCCAAAAACCAAAAAA", {}),
    ("AAAAAAAAAAAACCTTTTAAAAAAGAAAAAAA", "ACCCCCCCCCCCAAAAACCAAAAAAAAAAAAA",
     {}),
    ("AATTAATTTAAGTCTAGGCTACTTTCGGTACTTTGTTCTT",
     "AATTTAAGTCTAGGCTACTTTCGGTACTTTCTT", {"span": "end-to-end"}),
    ("AATTAATTTAAGTCTAGGCTACTTTCGGTACTTTGTTCTT",
     "AATTTAAGTCTAGGCTACTTTCGGTACTTTCTT", {}),
    ("AAAAACCTTTTTAAAAAA", "GGCCAAAAACCGGGGGGG", {}),
    ("AAAAACCGGGG", "AAAAACC", {}),
    ("AAAAACC", "AAAAACCGGGG", {}),
    ("GGGGAAAAACC", "AAAAACCGGGG", {}),
    ("AAAAACCGGGG", "GGGGAAAAACC", {}),
    ("GGGGAAAAACC", "AAAAACC", {}),
    ("GGGGAAAAACC", "CCCCCAAAAACC", {}),
    ("GGGGAAAAACCGGGGG", "CCCCCAAAAACCTTTTT", {}),
    ("AAAAACC", "CCCCCAAAAACCTTTTT", {}),
]


def _api_fields(res):
    return (res.score, res.status, res.cigarstring, res.pattern_start,
            res.pattern_end, res.text_start, res.text_end)


def phase_api(dev):
    """pywfa_tpu_torch.WavefrontAligner with pywfa's defaults on the card,
    one pair per call, against the reference's numpy oracle."""
    import pywfa_tpu_torch
    from pywfa_tpu_torch.align import WavefrontAligner as RefAligner
    rng = np.random.default_rng(SEED + 2)
    pats, txts = make_pairs(rng, N_API // 2, L, DIV)
    singles = list(zip(pats, txts))
    for _ in range(N_API - len(singles)):
        p = bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L)])
        singles.append((p, mutate(rng, p, DIV, 0.01)))
    singles = [(p.decode(), t.decode(), {}) for p, t in singles]
    reset_counts()
    per_call = {}
    n_checked = 0
    for scope, items in (("full", singles + GOLDEN),
                         ("score", singles[:64] + GOLDEN)):
        aligners = {}
        times = []
        n_single = len(items) - len(GOLDEN)
        for i, (p, t, kw) in enumerate(items):
            key = tuple(sorted(kw.items()))
            if key not in aligners:
                aligners[key] = (
                    pywfa_tpu_torch.WavefrontAligner(scope=scope, device=dev,
                                                     **kw),
                    RefAligner(scope=scope, backend="numpy", **kw))
            port, ref = aligners[key]
            t0 = time.perf_counter()
            got = _api_fields(port(t, p))
            if i < n_single:
                times.append(time.perf_counter() - t0)
            want = _api_fields(ref(t, p))
            if got != want:
                raise AssertionError(f"WavefrontAligner({scope}) {p} / {t}: "
                                     f"{got} vs oracle {want}")
            n_checked += 1
        per_call[scope] = 1e3 * float(np.median(times))
    counts = read_counts()
    check_fallbacks("api", timed=True)
    check_group("api", counts)
    a = pywfa_tpu_torch.WavefrontAligner(GOLDEN[0][0], device=dev)
    if (a.wavefront_align(GOLDEN[0][1]), a.cigarstring) != (
            -24, "3M1X4M1D7M1I9M1X6M"):
        raise AssertionError("the README example differs from its golden")
    log(f"api: WavefrontAligner(device='cuda'), pywfa defaults: "
        f"{n_checked} calls equal to the oracle in score, status, CIGAR "
        f"and start/end; median ms/call full={per_call['full']:.3f} "
        f"score={per_call['score']:.3f} (single {L} bp pairs); "
        f"launches {launched(counts)}")
    for variant in ("endsfree", "endsfree_score", "e2e", "e2e_score"):
        if counts[variant] == 0:
            raise AssertionError(f"the API phase never launched {variant}")
    return counts


def _timed_stream(aligner, batches):
    """(results, wall seconds, launch counts) of one stream, after a
    warm-up batch that is not counted."""
    list(aligner.align_stream(iter(batches[:1]), depth=1))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = list(aligner.align_stream(iter(batches), depth=3))
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0, read_counts()


def phase_new_streams(dev):
    """Four timed streams of 8 x 4096 pairs: gap-affine ends-free reads in
    windows and end-to-end score-only, affine2p end to end with full
    CIGARs and a long-gap share, levenshtein end-to-end score-only; 512
    sampled pairs of each against the oracle."""
    from pywfa_tpu_torch import BatchWavefrontAligner
    from pywfa_tpu_torch.oracle import OracleAligner
    rng = np.random.default_rng(SEED + 3)
    streams = [
        ("endsfree_window", "endsfree",
         BatchWavefrontAligner(text_begin_free=WINDOW_FREE,
                               text_end_free=WINDOW_FREE, device=dev),
         [make_windows(rng, B_MAIN, L, WINDOW, DIV)
          for _ in range(N_NEW_BATCHES)]),
        ("e2e_score", "e2e_score",
         BatchWavefrontAligner(span="end-to-end", scope="score", device=dev),
         [make_pairs(rng, B_MAIN, L, DIV) for _ in range(N_NEW_BATCHES)]),
        ("affine2p_e2e_gaps", "affine2p_e2e",
         BatchWavefrontAligner(distance="affine2p", span="end-to-end",
                               device=dev),
         [make_gap_pairs(rng, B_MAIN, L, DIV)
          for _ in range(N_NEW_BATCHES)]),
        ("edit_e2e_score", "edit_e2e_score",
         BatchWavefrontAligner(distance="levenshtein", span="end-to-end",
                               scope="score", device=dev),
         [make_pairs(rng, B_MAIN, L, DIV) for _ in range(N_NEW_BATCHES)]),
    ]
    counts = collections.Counter()
    for name, variant, aligner, batches in streams:
        results, wall, c = _timed_stream(aligner, batches)
        check_fallbacks(f"stream {name}", timed=True)
        check_group(f"stream {name}", c)
        n = N_NEW_BATCHES * B_MAIN
        log(f"stream [{name}]: {N_NEW_BATCHES} batches, {n} pairs in "
            f"{wall:.3f} s = {n / wall:.0f} alignments/s "
            f"({1e3 * wall / N_NEW_BATCHES:.2f} ms/batch); launches "
            f"{launched(c)}")
        if c[variant] < N_NEW_BATCHES:
            raise AssertionError(f"stream {name} launched {variant} "
                                 f"{c[variant]} times")
        flat = [r for rs in results for r in rs]
        if len(flat) != n or any(r.status != 0 for r in flat):
            raise AssertionError(f"stream {name}: not every pair completed")
        pats = [p for b in batches for p in b[0]]
        txts = [t for b in batches for t in b[1]]
        oracle = OracleAligner(aligner._attr)
        for i in sorted(rng.choice(n, 512, replace=False).tolist()):
            o = oracle.align(pats[i], txts[i])
            r = flat[i]
            want = (o.status, o.score, o.ops, o.end_v, o.end_h)
            if (r.status, r.score, r.ops, r.end_v, r.end_h) != want:
                raise AssertionError(f"stream {name} pair {i}: {r} vs "
                                     f"oracle {want}")
        log(f"oracle: stream [{name}]: 512 sampled pairs equal")
        counts.update(c)
    return counts


def phase_metrics(dev):
    """Each new metric through the batch API and the pywfa API on the
    card: a probe batch that escalates to its terminal rung, every pair
    against the oracle (indel's unrelated pairs may pass the terminal
    rung's score cap and go to the oracle: counted and printed), then
    WavefrontAligner on 64 single pairs in both scopes, 48 with pywfa's
    defaults and 16 end to end, against the numpy oracle."""
    import pywfa_tpu_torch
    from pywfa_tpu_torch import BatchWavefrontAligner
    from pywfa_tpu_torch import batch as PB
    from pywfa_tpu_torch.align import WavefrontAligner as RefAligner
    rng = np.random.default_rng(SEED + 5)
    pats, txts = make_pairs(rng, N_METRIC_API // 2, L, DIV)
    singles = list(zip(pats, txts))
    for _ in range(N_METRIC_API - len(singles)):
        p = bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L)])
        singles.append((p, mutate(rng, p, DIV, 0.01)))
    rng.shuffle(singles)
    singles = [(p.decode(), t.decode(),
                {} if i < 3 * N_METRIC_API // 4 else {"span": "end-to-end"})
               for i, (p, t) in enumerate(singles)]
    total = collections.Counter()
    for metric in METRICS:
        prefix = metric_attr(metric)[1]
        probe = make_probe(rng)
        aligner = BatchWavefrontAligner(distance=metric, span="end-to-end",
                                        device=dev)
        reset_counts()
        t0 = time.perf_counter()
        res = aligner.align(*probe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = read_counts()
        fb = check_fallbacks(f"probe {metric}", timed=False)
        check_group(f"probe {metric}", c, wide=True)
        if c[prefix + "e2e"] < 2:
            raise AssertionError(f"probe {metric}: {c[prefix + 'e2e']} "
                                 "launches; the batch must escalate")
        for i, (p, t, r) in enumerate(zip(*probe, res)):
            o = PB._oracle_one(aligner._attr, p, t)
            want = (o.status, o.score, o.ops, o.end_v, o.end_h)
            if (r.status, r.score, r.ops, r.end_v, r.end_h) != want:
                raise AssertionError(f"probe {metric} pair {i}: {r} vs "
                                     f"oracle {want}")
        log(f"probe [{metric}]: {len(res)} pairs equal to the oracle in "
            f"{1e3 * wall:.1f} ms; {c[prefix + 'e2e']} launches; "
            f"{sum(fb.values())} pairs answered by the host oracle")
        total.update(c)

        reset_counts()
        per_call = {}
        for scope in ("full", "score"):
            aligners = {}
            times = []
            for p, t, kw in singles:
                key = tuple(sorted(kw.items()))
                if key not in aligners:
                    aligners[key] = (
                        pywfa_tpu_torch.WavefrontAligner(
                            distance=metric, scope=scope, device=dev, **kw),
                        RefAligner(distance=metric, scope=scope,
                                   backend="numpy", **kw))
                port, ref = aligners[key]
                t0 = time.perf_counter()
                got = _api_fields(port(t, p))
                times.append(time.perf_counter() - t0)
                want = _api_fields(ref(t, p))
                if got != want:
                    raise AssertionError(
                        f"WavefrontAligner({metric}, {scope}) {p} / {t}: "
                        f"{got} vs oracle {want}")
            per_call[scope] = 1e3 * float(np.median(times))
        c = read_counts()
        check_fallbacks(f"api {metric}", timed=True)
        check_group(f"api {metric}", c)
        log(f"api [{metric}]: {2 * len(singles)} calls equal to the oracle; "
            f"median ms/call full={per_call['full']:.3f} "
            f"score={per_call['score']:.3f}; launches {launched(c)}")
        for tail in ("endsfree", "endsfree_score", "e2e", "e2e_score"):
            if c[prefix + tail] == 0:
                raise AssertionError(f"api {metric} never launched "
                                     f"{prefix + tail}")
        total.update(c)
    return total


def slice_streams(rng, dev, n_batches):
    """The four streams of this slice: (name, kernel variant, aligner or
    attributes, wildcard byte, batches)."""
    from pywfa_tpu_torch import BatchWavefrontAligner
    zdrop, _ = metric_attr("affine", heuristics()["zdrop"], span="end-to-end")
    wild = BatchWavefrontAligner(span="end-to-end", wildcard="N", device=dev)
    return [
        ("A wfadaptive", "e2e_heur",
         BatchWavefrontAligner(span="end-to-end", heuristic="adaptive",
                               device=dev)._attr, None,
         [make_divergent_mix(rng, B_MAIN, L, DIV) for _ in range(n_batches)]),
        ("B zdrop chimeras", "e2e_heur", zdrop, None,
         [make_chimeras(rng, B_MAIN, L, DIV) for _ in range(n_batches)]),
        ("C windows match -1", "endsfreeseed",
         BatchWavefrontAligner(match=-1, text_begin_free=WINDOW_FREE,
                               text_end_free=WINDOW_FREE, device=dev)._attr,
         None,
         [make_windows(rng, B_MAIN, L, WINDOW, DIV)
          for _ in range(n_batches)]),
        ("D wildcard N", "e2e", wild._attr, wild._wildcard,
         [make_n_pairs(rng, B_MAIN, L, DIV) for _ in range(n_batches)]),
    ]


def run_stream(attr, wildcard, batches, dev, depth=3):
    from pywfa_tpu_torch import align_pairs_stream
    return list(align_pairs_stream(attr, iter(batches), wildcard=wildcard,
                                   depth=depth, device=dev))


RESULT_FIELDS = ("status", "score", "ops", "end_v", "end_h", "dropped")


def _result_fields(r):
    return tuple(getattr(r, f) for f in RESULT_FIELDS)


def phase_slice_streams(dev):
    """Streams A-D through align_pairs_stream, 8 x 4096 pairs each: no
    pair may go to the host oracle (dropped pairs are assembled from the
    card's walk), every pair completes or comes back partial, 512 sampled
    pairs equal the oracle in every field."""
    from pywfa_tpu_torch import batch as PB
    rng = np.random.default_rng(SEED + 6)
    counts = collections.Counter()
    for name, variant, attr, wildcard, batches in slice_streams(
            rng, dev, N_SLICE_BATCHES):
        run_stream(attr, wildcard, batches[:1], dev, depth=1)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        results = run_stream(attr, wildcard, batches, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = read_counts()
        check_fallbacks(f"stream {name}", timed=True)
        check_group(f"stream {name}", c)
        n = N_SLICE_BATCHES * B_MAIN
        flat = [r for rs in results for r in rs]
        partial = sum(r.status == 1 for r in flat)
        dropped = sum(r.dropped for r in flat)
        log(f"stream [{name}]: {N_SLICE_BATCHES} batches, {n} pairs in "
            f"{wall:.3f} s = {n / wall:.0f} alignments/s "
            f"({1e3 * wall / N_SLICE_BATCHES:.2f} ms/batch); {partial} "
            f"partial, {dropped} dropped; launches {launched(c)}")
        if c[variant] < N_SLICE_BATCHES:
            raise AssertionError(f"stream {name} launched {variant} "
                                 f"{c[variant]} times")
        if len(flat) != n or any(r.status not in (0, 1) for r in flat):
            raise AssertionError(f"stream {name}: not every pair completed "
                                 "or came back partial")
        if name.startswith("B") and dropped < n // 16:
            raise AssertionError(f"stream {name}: {dropped} dropped pairs; "
                                 "the stream must hold partial results")
        if not name.startswith("B") and partial:
            raise AssertionError(f"stream {name}: {partial} partial results")
        pats = [p for b in batches for p in b[0]]
        txts = [t for b in batches for t in b[1]]
        for i in sorted(rng.choice(n, 512, replace=False).tolist()):
            want = _result_fields(PB._oracle_one(attr, pats[i], txts[i],
                                                 wildcard))
            if _result_fields(flat[i]) != want:
                raise AssertionError(f"stream {name} pair {i}: {flat[i]} vs "
                                     f"oracle {want}")
        log(f"oracle: stream [{name}]: 512 sampled pairs equal")
        counts.update(c)
    return counts


def phase_slice_api(dev):
    """A probe batch under each heuristic, every pair against the oracle;
    then WavefrontAligner one pair a call under every metric with the
    arguments of slice_api_configs, both scopes, against the numpy
    oracle."""
    import pywfa_tpu_torch
    from pywfa_tpu_torch import batch as PB
    from pywfa_tpu_torch.align import WavefrontAligner as RefAligner
    rng = np.random.default_rng(SEED + 7)
    total = collections.Counter()
    for hname, h in heuristics().items():
        attr, _ = metric_attr("affine", h, span="end-to-end")
        probe = make_probe(rng)
        reset_counts()
        t0 = time.perf_counter()
        res = PB.align_pairs(attr, *probe, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = read_counts()
        fb = check_fallbacks(f"probe {hname}", timed=False)
        check_group(f"probe {hname}", c, wide=True)
        if c["e2e_heur"] < 2:
            raise AssertionError(f"probe {hname}: {c['e2e_heur']} launches; "
                                 "the batch must escalate")
        for i, (p, t, r) in enumerate(zip(*probe, res)):
            want = _result_fields(PB._oracle_one(attr, p, t))
            if _result_fields(r) != want:
                raise AssertionError(f"probe {hname} pair {i}: {r} vs "
                                     f"oracle {want}")
        log(f"probe [{hname}]: {len(res)} pairs equal to the oracle in "
            f"{1e3 * wall:.1f} ms; {c['e2e_heur']} launches; "
            f"{sum(r.status == 1 for r in res)} partial; "
            f"{sum(fb.values())} pairs answered by the host oracle")
        total.update(c)

    pats, txts = make_pairs(rng, N_SLICE_API // 2, L, DIV)
    singles = list(zip(pats, txts))
    for _ in range(N_SLICE_API - len(singles) - 2):
        p = bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L)])
        singles.append((p, mutate(rng, p, DIV, 0.01)))
    # a read in a window, and a chimeric read
    singles.append(tuple(s[0] for s in make_windows(rng, 1, 100, 140, DIV)))
    singles.append(tuple(s[0] for s in make_chimeras(rng, 1, L, DIV, 1.0)))
    singles = [(p.decode(), t.decode()) for p, t in singles]
    for metric in ("affine",) + METRICS:
        prefix = metric_attr(metric)[1]
        reset_counts()
        times = collections.defaultdict(list)
        n_calls = 0
        for cname, kw in slice_api_configs(metric).items():
            for scope in ("full", "score"):
                port = pywfa_tpu_torch.WavefrontAligner(
                    distance=metric, scope=scope, device=dev, **kw)
                ref = RefAligner(distance=metric, scope=scope,
                                 backend="numpy", **kw)
                for p, t in singles:
                    if cname == "wildcard":
                        p = p[:40] + "N" + p[41:]
                    t0 = time.perf_counter()
                    got = _api_fields(port(t, p))
                    times[cname, scope].append(time.perf_counter() - t0)
                    want = _api_fields(ref(t, p))
                    if got != want:
                        raise AssertionError(
                            f"WavefrontAligner({metric}, {scope}, {kw}) "
                            f"{p} / {t}: {got} vs oracle {want}")
                    n_calls += 1
        c = read_counts()
        check_fallbacks(f"slice api {metric}", timed=True)
        check_group(f"slice api {metric}", c)
        med = ", ".join(f"{cn} {sc}={1e3 * float(np.median(v)):.3f}"
                        for (cn, sc), v in times.items())
        log(f"slice api [{metric}]: {n_calls} calls equal to the oracle; "
            f"median ms/call {med}; launches {launched(c)}")
        total.update(c)
    return total


def make_long_inputs():
    """The pairs of the long-read phases, from the seed: streams E and F
    (N_LONG_BATCHES batches of B_LONG ONT-like 1 kb pairs), batch G
    (B_G pairs of 10 kb at 5% divergence) and batch H (B_H pairs of 50 kb
    at G's divergence)."""
    rng = np.random.default_rng(SEED + 8)
    return dict(
        ef=[make_ont_pairs(rng, B_LONG, L_LONG, ONT_SUB, ONT_IND)
            for _ in range(N_LONG_BATCHES)],
        g=make_ont_pairs(rng, B_G, L_G, G_SUB, G_IND),
        h=make_ont_pairs(np.random.default_rng(SEED + 12), B_H, L_H, G_SUB,
                         G_IND))


# batch H's pairs held against the host oracle, as batch G's are
H_ORACLE = (0, B_H - 1)


class HostOracle:
    """The host oracle (batch._oracle_one) on a few pairs, in a process of
    its own, so that it runs beside the phases that come first: the
    pairs go in and the results come back as pickles in a temporary
    directory. `result` waits for it; `stop` ends it wherever it is."""

    CODE = ("import pickle, sys, time; sys.path.insert(0, sys.argv[1]); "
            "from pywfa_tpu_torch import batch as PB; "
            "jobs = pickle.load(open(sys.argv[2], 'rb')); "
            "t0 = time.perf_counter(); "
            "res = [PB._oracle_one(*j) for j in jobs]; "
            "pickle.dump((res, time.perf_counter() - t0), "
            "open(sys.argv[3], 'wb'))")

    def __init__(self, attr, pairs, wildcard=None):
        import os
        import pickle
        import tempfile
        self.dir = tempfile.TemporaryDirectory()
        src = os.path.join(self.dir.name, "pairs.pkl")
        self.out = os.path.join(self.dir.name, "results.pkl")
        with open(src, "wb") as f:
            pickle.dump([(attr, p, t, wildcard) for p, t in pairs], f)
        root = os.path.dirname(os.path.abspath(__file__))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", self.CODE, root, src, self.out])

    def result(self, timeout):
        """(results, the oracle's own seconds, seconds waited here)."""
        import pickle
        t0 = time.perf_counter()
        rc = self.proc.wait(timeout=timeout)
        if rc != 0:
            raise AssertionError(f"the host oracle's process exited {rc}")
        with open(self.out, "rb") as f:
            res, secs = pickle.load(f)
        return res, secs, time.perf_counter() - t0

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.dir.cleanup()


def start_h_oracle(attr, long_inputs):
    """Start the host oracle on batch H's pairs H_ORACLE (about 40 s and
    20 GB of host memory a 50 kb pair) beside the phases before phase 14;
    the caller stops it."""
    pats, txts = long_inputs["h"]
    oracle = HostOracle(attr, [(pats[i], txts[i]) for i in H_ORACLE])
    long_inputs["h_oracle"] = oracle
    return oracle


def rung2_config(attr, pats, txts):
    """The second rung the batch path picks for the pairs that pass the
    first (batch.align_pairs_finish's escalation): 4x the score cap, the
    band sized to match."""
    return rung_plan(attr, pats, txts, second=True)[0].cfg


def _token_rows(cfg, pats, txts, dev):
    """(pat, txt, plen, tlen, frees) on the card: the int8 token rows as
    the segmented executor pushes them, zero frees."""
    from pywfa_tpu_torch import batch as PB
    plens = np.fromiter(map(len, pats), dtype=np.int32, count=len(pats))
    tlens = np.fromiter(map(len, txts), dtype=np.int32, count=len(txts))
    pat_np, _ = PB._encode_side(pats, cfg.Lp, cfg.extend_chunk,
                                PB.PATTERN_SENTINEL, plens)
    txt_np, _ = PB._encode_side(txts, cfg.Lt, cfg.extend_chunk,
                                PB.TEXT_SENTINEL, tlens)
    return (PB._to_device(pat_np, dev), PB._to_device(txt_np, dev),
            PB._to_device(plens, dev), PB._to_device(tlens, dev),
            torch.zeros((len(pats), 4), dtype=torch.int32, device=dev))


def _max_err(name, got, want, keys):
    err = 0
    for key in keys:
        if key not in want:
            continue
        a, b = got[key], want[key]
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: {key} {a.shape}/{a.dtype} vs "
                                 f"{b.shape}/{b.dtype}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


LOOP_KEYS = ("status", "final_s", "end_k", "end_off", "choices")


def _state_err(name, got, want, running):
    """Largest difference between two states over the pairs still
    running (a done pair's ring is never read again)."""
    return _max_err(name, {k: got[k][running] for k in ("ring", "lohi",
                                                        "carry")},
                    {k: want[k][running] for k in ("ring", "lohi", "carry")},
                    ("ring", "lohi", "carry"))


# K3's shapes beside the main paths': the first kernel's two refusals
LCP_MANY = 65537          # pairs: past a grid dimension of 65535
LCP_LONG_PATTERN = 49152  # bp: a pattern row past 48 KiB ...
LCP_LONG_AT = 48400       # ... holding its 1 kb text from here on
# integer operations of a table cell: the kernel compares, steps and masks
# four cells a 32-bit word in about eight word operations
LCP_OPS_PER_CELL = 2


def lcp_shapes(attr, long_inputs, cfg_f):
    """K3's held shapes, (name, (pats, txts), cfg, wildcard, kmin): the
    short-read batch (Ltp=176, B=4096, W=256, uint8: the sharded batch's),
    stream F's segmented 1 kb batch (`cfg_f`, int16: F's and the resume's),
    one with a wildcard, one with B=16 and W=1152, the CLI's 150 bp batch
    in its length bucket (Ltp=272, int16); then 65537 pairs of 150 bp
    (uint8), and one pair whose 49 kb pattern row holds its 1 kb text at
    diagonal -48400, inside a band of 896 (int16)."""
    from pywfa_tpu_torch.ops import config as C
    rng = np.random.default_rng(SEED + 9)
    main = make_pairs(rng, B_MAIN, L, DIV)
    wild = make_n_pairs(rng, B_LONG, L, DIV)
    mid = make_ont_pairs(rng, 16, 400, ONT_SUB, ONT_IND)
    many = make_pairs(rng, LCP_MANY, L, DIV)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    p = alphabet[rng.integers(0, 4, LCP_LONG_PATTERN)].tobytes()
    t = mutate(rng, p[LCP_LONG_AT:LCP_LONG_AT + L_LONG], ONT_SUB, ONT_IND)
    cfg_long = C.full_config(attr, LCP_LONG_PATTERN, 1024, W=896)
    short = C.full_config(attr, 160, 160, W=256)
    shapes = [
        ("lcp_short_u8", main, short, -1),
        ("lcp_1kb_i16", long_inputs["ef"][0], cfg_f, -1),
        ("lcp_wildcard_u8", wild,
         C.full_config(attr, 160, 160, W=256, wildcard=ord("N")), ord("N")),
        ("lcp_w1152_i16", mid, C.full_config(attr, 512, 512, W=1152), -1),
        # the CLI's 150 bp batches under biwfa: the (256, 256) bucket
        ("lcp_cli_i16", main, C.full_config(attr, 256, 256, W=256), -1),
        ("lcp_many_pairs_u8", many, short, -1),
    ]
    return [(n, pairs, cfg, wc, cfg.kmin) for n, pairs, cfg, wc in shapes] \
        + [("lcp_long_pattern_i16", ([p], [t[:1024]]), cfg_long, -1,
            -LCP_LONG_AT - cfg_long.W // 2)]


def lcp_bound(nbytes, cells):
    """(ms, "bytes" or "operations"): the least time the card could take
    for a table of `cells` cells and `nbytes` bytes (the rows read once,
    the table written once)."""
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * cells * LCP_OPS_PER_CELL / PEAK_OPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _table_err(got, want):
    """Largest difference between two tables, a slice of text positions
    at a time (a table may hold gigabytes)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"table {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    if torch.equal(got, want):
        return 0
    step = max(1, (1 << 26) // max(1, got[0].numel()))
    return max(int((got[h:h + step].int() - want[h:h + step].int())
                   .abs().max()) for h in range(0, got.shape[0], step))


def f_segment_config(attr, pats1k, txts1k):
    """Stream F's segment: its second rung (256 x W=896) cut to the
    segment length that memory_mode="biwfa" gives it, without the
    record."""
    from pywfa_tpu_torch.constants import MemoryMode
    biwfa = dataclasses.replace(attr, memory_mode=MemoryMode.ULTRALOW)
    rung = rung_plan(biwfa, pats1k, txts1k, second=True)[0]
    if not rung.segmented:
        raise AssertionError(f"stream F's second rung {rung.cfg.W} wide "
                             "would not run in segments")
    return rung.cfg


def phase_long_kernels(dev, long_inputs):
    """K3, the table variants and the wide-band layouts against their
    plain versions (see the module docstring, phase 10)."""
    from pywfa_tpu_torch import BatchWavefrontAligner
    from pywfa_tpu_torch.constants import MemoryMode
    from pywfa_tpu_torch.ops import config as C
    from pywfa_tpu_torch.ops import engine as TE
    from pywfa_tpu_torch.ops import fused_loop, lcp_table
    attr = BatchWavefrontAligner(span="end-to-end", device=dev)._attr
    records = {}
    pats1k, txts1k = long_inputs["ef"][0]
    cfg_f = f_segment_config(attr, pats1k, txts1k)
    K = cfg_f.S_cap

    # --- K3 against its plain version ---
    for name, (pats, txts), cfg, wildcard, kmin in lcp_shapes(
            attr, long_inputs, cfg_f):
        pat, txt, *_ = _token_rows(cfg, pats, txts, dev)

        def kernel():
            return lcp_table.build_lcp_table_hmajor(cfg.W, kmin, wildcard,
                                                    pat, txt)

        def plain():
            return lcp_table.build_lcp_table_hmajor_ref(cfg.W, kmin,
                                                        wildcard, pat, txt)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = _table_err(got, want)
        nbytes = got.numel() * got.element_size() + pat.numel() + txt.numel()
        cells = got.numel()
        del got, want
        k_ms, p_ms = cuda_ms(kernel, 10), cuda_ms(plain, 1)
        alone = kernel_only_ms(kernel, name="lcp_table")
        b_ms, b_by = lcp_bound(nbytes, cells)
        # the kernel's own device time where the profiler has it: the
        # events time of a small table is the host's launch rate
        ms = alone if alone is not None else k_ms
        log(f"kernel vs plain [{name}] kernel=lcp_table B={len(pats)} "
            f"W={cfg.W} Lpp={pat.shape[1]} Ltp={txt.shape[1]} kmin={kmin} "
            f"wildcard={wildcard} out_bytes={nbytes} max_abs_err={err} "
            f"kernel_ms={k_ms:.4f} kernel_only_ms={_fmt(alone)} "
            f"plain_ms={p_ms:.2f} bound_ms={b_ms:.3g} bound_by={b_by} "
            f"cells_per_s={cells / (ms * 1e-3):.4g} "
            f"bound_share={b_ms / ms:.3f}")
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from plain version")
        records[name] = dict(
            variant="lcp_table", err=err, ms=ms, call_ms=k_ms, plain_ms=p_ms,
            bound_ms=b_ms, bound_by=b_by, B=len(pats), cells=cells)

    # --- the table variant against plain, against the bits variant and
    # against the general build, as the segments of stream F: the forward
    # scope and the replay scope ---
    pat, txt, plen, tlen, frees = _token_rows(cfg_f, pats1k, txts1k, dev)
    table = TE.build_extension(cfg_f, pat, txt)["table"]
    bits = TE.build_eq_bits(cfg_f, pat, txt)
    if table is None:
        raise AssertionError("the 1 kb segmented shape must extend by table")
    for record in (False, True):
        cfg = dataclasses.replace(cfg_f, record_choices=record)
        name = "table_1kb" + ("_replay" if record else "_forward")
        new = fused_loop.kernel_build(cfg, B_LONG, table=table,
                                      state=fused_loop.new_state(cfg, 1, dev))

        def segment(fn, state, fresh, use_table=True, **kw):
            return fn(cfg, None if use_table else bits, plen, tlen, frees,
                      MAXS, table=table if use_table else None, state=state,
                      fresh=fresh, seg_base=0 if fresh else K - 1, **kw)

        states = {}
        outs = {}
        err = 0
        kernel = fused_loop.align_batch_fused_loop
        for fresh in (True, False):
            for tag, fn, use_table, kw in (
                    ("kernel", kernel, True, {}),
                    ("plain", fused_loop.align_batch_fused_loop_ref, True,
                     {}),
                    ("bits", kernel, False, {}),
                    ("general", kernel, True, dict(build="general"))):
                if fresh:
                    states[tag] = fused_loop.new_state(cfg, B_LONG, dev)
                outs[tag] = segment(fn, states[tag], fresh, use_table, **kw)
            torch.cuda.synchronize()
            running = outs["kernel"]["status"] == 5
            for other in ("plain", "bits", "general"):
                err = max(err,
                          _max_err(name, outs["kernel"], outs[other],
                                   LOOP_KEYS),
                          _state_err(name, states["kernel"], states[other],
                                     running))
            # the builds' states are equal for every pair, done or not
            err = max(err, _state_err(name, states["kernel"],
                                      states["general"],
                                      torch.ones_like(running)))
            if fresh and not bool(running.any()):
                raise AssertionError(f"{name}: no pair passes the first "
                                     "segment")
        status = torch.bincount(outs["kernel"]["status"].long(),
                                minlength=6).tolist()
        st = fused_loop.new_state(cfg, B_LONG, dev)
        t_ms, turns = in_turns(
            lambda b: segment(kernel, st, True, build=b), new, 10)
        b_ms = cuda_ms(lambda: segment(kernel, st, True, False), 10)
        only = kernel_only_ms(lambda: segment(kernel, st, True))
        p_ms = cuda_ms(lambda: segment(fused_loop.align_batch_fused_loop_ref,
                                       st, True), 1)
        # the bound of the first segment: the table cells these pairs read
        # (one load a cell a step), the state written once, the levels
        first = fused_loop.align_batch_fused_loop(
            dataclasses.replace(cfg, record_choices=True), None, plen, tlen,
            frees, MAXS, table=table)
        cells = int(torch.count_nonzero(first["choices"])) + B_LONG
        state_bytes = sum(st[k].numel() * 4 for k in ("ring", "lohi",
                                                      "carry"))
        nbytes = (cells * table.element_size() + state_bytes + B_LONG * 40
                  + (int(first["final_s"].clamp(min=0).sum()) * cfg.W
                     if record else 0))
        del first
        t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
        t_ops = 1e3 * cells * OPS_PER_CELL[cfg.n_comp] / PEAK_OPS_PER_S
        variant = fused_loop.variant(cfg, table=True)
        G = fused_loop.launch_shape(cfg, B_LONG, "group", dev)[1]
        log(f"kernel vs plain [{name}] variant={variant} B={B_LONG} "
            f"W={cfg.W} K={K} Ltp={table.shape[0]} segments=2 "
            f"status_counts={status} max_abs_err={err} build={new} "
            f"{new}_ms={t_ms[new]:.4f} general_ms={t_ms['general']:.4f} "
            f"turns(general,{new},{new},general)="
            f"{','.join(f'{t:.4f}' for t in turns)} "
            f"kernel_only_ms={_fmt(only)} {new}_bits_ms={b_ms:.4f} "
            f"plain_ms={p_ms:.2f} bound_ms={max(t_bytes, t_ops):.3g} "
            f"bound_by={'bytes' if t_bytes >= t_ops else 'operations'} "
            f"cells={cells} "
            f"G={G} pairs_a_block={fused_loop.group_pairs(cfg, B_LONG, G)}")
        if err != 0:
            raise AssertionError(f"{name}: the table variant differs from "
                                 "its plain version, the bits variant or "
                                 "the general build")
        records[name] = dict(
            variant=variant, err=err, build=new, G=G, ms=t_ms[new],
            alone=only, plain_ms=p_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", B=B_LONG)
    del table, bits

    # --- the wide-band layouts against plain, the cluster build against
    # the general build ---
    low = BatchWavefrontAligner(span="end-to-end", device=dev)._attr
    pats_g, txts_g = long_inputs["g"]
    cfg_g = dataclasses.replace(rung2_config(low, pats_g, txts_g),
                                record_choices=False)
    # batch G's own segment length under memory_mode="low"
    K_g = rung_plan(dataclasses.replace(low, memory_mode=MemoryMode.LOW),
                    pats_g, txts_g, second=True)[0].cfg.S_cap
    pats_5k, txts_5k = [p[:5000] for p in pats_g], [t[:5000] for t in txts_g]
    cfg_5k = dataclasses.replace(C.full_config(attr, 5120, 5376, W=3584),
                                 S_cap=96, record_choices=False)
    wide = [
        ("wide_2176_shared_ring",
         (pats1k[:8], txts1k[:8]),
         dataclasses.replace(C.full_config(attr, 1024, 1088, W=2176),
                             S_cap=700), 0),
        # the 10 kb rung at batch G's own B: the kernel runs 8 segments of
        # 96 scores, then kernel and plain run one more from copies of
        # that state (the plain version is one Python iteration a score)
        ("wide_10kb_global_ring", (pats_g, txts_g),
         dataclasses.replace(cfg_g, S_cap=96), 8),
        ("wide_10kb_global_ring_replay", (pats_g, txts_g),
         dataclasses.replace(cfg_g, S_cap=96, record_choices=True), 8),
        # G's pairs cut to 5 kb at W=3584, the band of a 5 kb pair's second
        # rung (4 CTAs a pair; the ring just fits one block), the same way
        ("wide_3584_shared_ring", (pats_5k, txts_5k), cfg_5k, 8),
        ("wide_3584_shared_ring_replay", (pats_5k, txts_5k),
         dataclasses.replace(cfg_5k, record_choices=True), 8),
        # G's first segment at its own length, from WF0, against the
        # general build
        ("wide_10kb_segment", (pats_g, txts_g),
         dataclasses.replace(cfg_g, S_cap=K_g), -1),
        ("wide_10kb_segment_replay", (pats_g, txts_g),
         dataclasses.replace(cfg_g, S_cap=K_g, record_choices=True), -1),
    ]
    for name, (pats, txts), cfg, lead in wide:
        pat, txt, plen, tlen, frees = _token_rows(cfg, pats, txts, dev)
        bits = TE.build_eq_bits(cfg, pat, txt)
        in_global = fused_loop.ring_in_global(cfg)
        if in_global != ("global" in name or "segment" in name):
            raise AssertionError(f"{name}: ring_in_global={in_global}")
        # the build the routing takes here, and the cluster build against
        # the general one whichever it is
        taken = fused_loop.kernel_build(cfg, len(pats))
        new = "cluster"
        if lead <= 0:
            def kernel(b=None, st=None):
                st = st if st is not None else (
                    fused_loop.new_state(cfg, len(pats), dev) if lead < 0
                    else None)
                return fused_loop.align_batch_fused_loop(
                    cfg, bits, plen, tlen, frees, MAXS, state=st,
                    fresh=True, build=b)

            sk, sg = (fused_loop.new_state(cfg, len(pats), dev)
                      if lead < 0 else None for _ in range(2))
            got = kernel(new, st=sk)
            gen = kernel("general", st=sg)
            torch.cuda.synchronize()
            err = _max_err(name, got, gen, LOOP_KEYS)
            p_ms = None
            if lead == 0:
                t0 = time.perf_counter()
                want = fused_loop.align_batch_fused_loop_ref(
                    cfg, bits, plen, tlen, frees, MAXS)
                torch.cuda.synchronize()
                p_ms = 1e3 * (time.perf_counter() - t0)
                err = max(err, _max_err(name, got, want, LOOP_KEYS))
            else:
                # G's own segment length: the plain version takes about
                # 0.1 s a score step at this width, too long for the whole
                # segment; the cluster build is held against the general
                # build, results and the whole state, and the next 96
                # scores from copies of its end state against plain
                err = max(err, _state_err(name, sk, sg, torch.ones_like(
                    got["status"], dtype=torch.bool)))
                tail = dataclasses.replace(cfg, S_cap=96)
                tails = {}
                for tag, fn, kw in (
                        ("cluster", fused_loop.align_batch_fused_loop,
                         dict(build=new)),
                        ("general", fused_loop.align_batch_fused_loop,
                         dict(build="general")),
                        ("plain", fused_loop.align_batch_fused_loop_ref,
                         {})):
                    st = {k: (v.clone() if torch.is_tensor(v) else v)
                          for k, v in sk.items()}
                    tails[tag] = (fn(tail, bits, plen, tlen, frees, MAXS,
                                     state=st, fresh=False,
                                     seg_base=cfg.S_cap - 1, **kw), st)
                torch.cuda.synchronize()
                (tk, tsk), (tg, tsg), (tp, tsp) = (
                    tails[t] for t in ("cluster", "general", "plain"))
                tail_running = tk["status"] == 5
                tail_err = max(_max_err(name, tk, tp, LOOP_KEYS),
                               _max_err(name, tg, tp, LOOP_KEYS),
                               _state_err(name, tsk, tsp, tail_running),
                               _state_err(name, tsk, tsg,
                                          torch.ones_like(tail_running)))
                log(f"kernel vs plain [{name}_next_96] scores "
                    f"[{cfg.S_cap - 1}, {cfg.S_cap + 94}] from the "
                    f"segment's state: running={int(tail_running.sum())} "
                    f"max_abs_err={tail_err}")
                err = max(err, tail_err)
                del tails, tk, tsk, tg, tsg, tp, tsp
            rec = got if cfg.record_choices else \
                fused_loop.align_batch_fused_loop(
                    dataclasses.replace(cfg, record_choices=True), bits,
                    plen, tlen, frees, MAXS)
            cells = int(torch.count_nonzero(rec["choices"])) + len(pats)
            del rec
            state_bytes = (sum(sk[k].numel() * 4 for k in ("ring", "lohi",
                                                           "carry"))
                           if lead < 0 else 0)
            # a segment reads the words its cells read, a one-shot run all
            b_ms, b_by = kernel_bound(cfg, (bits,), got, cells,
                                      state_bytes=state_bytes,
                                      ext_bytes=cells * 4 if lead < 0
                                      else None)
            reps = 5
        else:
            fwd = dataclasses.replace(cfg, record_choices=False)
            ext = dict(bits=bits, table=None)
            out, state = TE.align_batch_start(fwd, ext, plen, tlen, frees,
                                              MAXS)
            for _ in range(lead - 1):
                out, state = TE.align_batch_resume(fwd, ext, plen, tlen,
                                                   frees, MAXS, state)
            if not bool((out["status"] == 5).all()):
                raise AssertionError(f"{name}: pairs ended in the lead")

            def copy():
                return {k: (v.clone() if torch.is_tensor(v) else v)
                        for k, v in state.items()}

            def kernel(b=None, st=None):
                return fused_loop.align_batch_fused_loop(
                    cfg, bits, plen, tlen, frees, MAXS, state=st or copy(),
                    fresh=False, seg_base=state["s"], build=b)

            sk, sg, sp = copy(), copy(), copy()
            got = kernel(new, st=sk)
            gen = kernel("general", st=sg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = fused_loop.align_batch_fused_loop_ref(
                cfg, bits, plen, tlen, frees, MAXS, state=sp, fresh=False,
                seg_base=state["s"])
            torch.cuda.synchronize()
            p_ms = 1e3 * (time.perf_counter() - t0)
            running = got["status"] == 5
            err = max(_max_err(name, got, want, LOOP_KEYS),
                      _max_err(name, gen, want, LOOP_KEYS),
                      _state_err(name, sk, sp, running),
                      _state_err(name, sk, sg, torch.ones_like(running)))
            # the bound of this segment: the words its cells read, its
            # state in and out, its levels
            rec = got if cfg.record_choices else \
                fused_loop.align_batch_fused_loop(
                    dataclasses.replace(cfg, record_choices=True), bits,
                    plen, tlen, frees, MAXS, state=copy(), fresh=False,
                    seg_base=state["s"])
            cells = int(torch.count_nonzero(rec["choices"]))
            del rec
            state_bytes = 2 * sum(state[k].numel() * 4
                                  for k in ("ring", "lohi", "carry"))
            b_ms, b_by = kernel_bound(cfg, (bits,), got, cells,
                                      seg_base=state["s"],
                                      state_bytes=state_bytes,
                                      ext_bytes=cells * 4)
            reps = 5  # each with the state's copy
        t_ms, turns = in_turns(lambda b: kernel(b), new, reps)
        only = kernel_only_ms(lambda: kernel(taken))
        kernel(new)
        clusters = fused_loop.active_clusters()
        threads, n_cta = fused_loop.launch_shape(cfg, len(pats), new, dev)
        status = torch.bincount(got["status"].long(), minlength=6).tolist()
        log(f"kernel vs plain [{name}] variant={fused_loop.variant(cfg)} "
            f"B={len(pats)} W={cfg.W} S_cap={cfg.S_cap} Lt={cfg.Lt} "
            f"NQ={bits.shape[0]} ring_in_global={in_global} build={taken} "
            f"threads={threads} ctas_a_pair={n_cta} "
            f"cluster_smem={fused_loop.cluster_smem_bytes(cfg, n_cta)} "
            f"active_clusters={clusters} "
            f"general_threads={fused_loop.block_threads(cfg.W)} "
            f"final_s_max={int(got['final_s'].max())} "
            f"status_counts={status} max_abs_err={err} "
            f"{new}_ms={t_ms[new]:.4f} general_ms={t_ms['general']:.4f} "
            f"turns(general,{new},{new},general)="
            f"{','.join(f'{t:.4f}' for t in turns)} "
            f"kernel_only_ms[{taken}]={_fmt(only)} plain_ms={_fmt(p_ms)} "
            f"bound_ms={b_ms:.3g} bound_by={b_by} cells={cells}")
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from plain version "
                                 "or the general build")
        if p_ms is None:
            # not held against the plain version here: no record of its own
            del bits
            continue
        records[name] = dict(variant=fused_loop.variant(cfg), err=err,
                             build=taken, ms=t_ms[taken], alone=only,
                             plain_ms=p_ms,
                             bound_ms=b_ms, bound_by=b_by, B=len(pats))
        del bits
    torch.cuda.empty_cache()
    return records


def phase_long_reads(dev, long_inputs):
    """Streams E and F, batch G, resume and the single long pairs (see the
    module docstring, phase 10)."""
    import pywfa_tpu_torch
    from pywfa_tpu_torch import BatchWavefrontAligner
    from pywfa_tpu_torch import batch as PB
    from pywfa_tpu_torch.align import WavefrontAligner as RefAligner
    rng = np.random.default_rng(SEED + 10)
    total = collections.Counter()
    batches = long_inputs["ef"]
    n = N_LONG_BATCHES * B_LONG

    def stream(name, aligner):
        list(aligner.align_stream(iter(batches[:1]), depth=1))  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        results = list(aligner.align_stream(iter(batches), depth=3))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = read_counts()
        seg = dict(PB.segmented_runs)
        check_fallbacks(f"stream {name}", timed=True)
        flat = [r for rs in results for r in rs]
        if len(flat) != n or any(r.status != 0 for r in flat):
            raise AssertionError(f"stream {name}: not every pair completed")
        log(f"stream [{name}]: {N_LONG_BATCHES} batches, {n} pairs of "
            f"{L_LONG} bp in {wall:.3f} s = {n / wall:.0f} alignments/s "
            f"({1e3 * wall / N_LONG_BATCHES:.1f} ms/batch); segmented "
            f"{seg}; launches {launched(c)}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
        total.update(c)
        return flat, c, seg

    e_res, c, seg = stream("E 1 kb high", BatchWavefrontAligner(
        span="end-to-end", device=dev))
    if c["e2e"] < 2 * N_LONG_BATCHES or seg["runs"]:
        raise AssertionError("stream E must escalate past its first rung in "
                             f"one shot: launches {launched(c)}, {seg}")
    check_build("stream E", c, "group")
    pats = [p for b in batches for p in b[0]]
    txts = [t for b in batches for t in b[1]]
    attr = BatchWavefrontAligner(span="end-to-end", device=dev)._attr
    for i in sorted(rng.choice(n, 8, replace=False).tolist()):
        want = _result_fields(PB._oracle_one(attr, pats[i], txts[i]))
        if _result_fields(e_res[i]) != want:
            raise AssertionError(f"stream E pair {i} differs from the oracle")
    log("oracle: stream [E]: 8 sampled pairs equal")

    f_res, c, seg = stream("F 1 kb biwfa", BatchWavefrontAligner(
        span="end-to-end", memory_mode="biwfa", device=dev))
    if (seg["runs"] < N_LONG_BATCHES or seg["segments"] <= seg["runs"]
            or seg["replays"] <= seg["runs"]):
        raise AssertionError(f"stream F must run in segments: {seg}")
    for variant in ("lcp_table", "e2e_score_table", "e2e_table"):
        if c[variant] < N_LONG_BATCHES:
            raise AssertionError(f"stream F launched {variant} "
                                 f"{c[variant]} times")
    # its segments (W=896, the table) on the group build
    check_build("stream F", c, "group")
    if list(map(_result_fields, f_res)) != list(map(_result_fields, e_res)):
        raise AssertionError("stream F differs from stream E")
    log(f"stream [F] equals stream [E] pair for pair ({n} pairs, every "
        "field)")

    # --- batch G: 10 kb under low against high and the oracle ---
    pats_g, txts_g = long_inputs["g"]
    g = {}
    for mode in ("high", "low"):
        aligner = BatchWavefrontAligner(span="end-to-end", memory_mode=mode,
                                        device=dev)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        g[mode] = aligner.align(pats_g, txts_g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = read_counts()
        seg = dict(PB.segmented_runs)
        check_fallbacks(f"batch G {mode}", timed=True)
        log(f"batch [G 10 kb {mode}]: {B_G} pairs of {L_G} bp in "
            f"{wall:.3f} s; scores {min(r.score for r in g[mode])}.."
            f"{max(r.score for r in g[mode])}; segmented {seg}; launches "
            f"{launched(c)}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
        if (mode == "low") != bool(seg["runs"]):
            raise AssertionError(f"batch G {mode}: segmented runs {seg}")
        if mode == "low" and (seg["segments"] <= seg["runs"]
                              or c["lcp_table"] or c["e2e_score"] < 2):
            raise AssertionError("batch G low must run in segments on the "
                                 f"equality bits: {seg}, {launched(c)}")
        # its second rung (W=6912) on the cluster build, its first (W=1792,
        # the ring in one block) on the general build
        check_build(f"batch G {mode}", c, "cluster", general=True)
        total.update(c)
    if list(map(_result_fields, g["low"])) != list(map(_result_fields,
                                                       g["high"])):
        raise AssertionError("batch G under low differs from high")
    # held again under PYWFA_EXTEND=chunk (phase 14)
    long_inputs["g_low"] = g["low"]
    t0 = time.perf_counter()
    for i in (0, B_G - 1):
        want = _result_fields(PB._oracle_one(attr, pats_g[i], txts_g[i]))
        if _result_fields(g["low"][i]) != want:
            raise AssertionError(f"batch G pair {i} differs from the oracle")
    log(f"batch [G] low equals high on {B_G} pairs, and the oracle on 2 "
        f"(oracle: {time.perf_counter() - t0:.1f} s)")

    # --- resume: E's first batch paused at RESUME_STEPS steps ---
    small = dataclasses.replace(attr, system=dataclasses.replace(
        attr.system, max_alignment_steps=RESUME_STEPS))
    reset_counts()
    t0 = time.perf_counter()
    res, paused = PB.align_pairs_resumable(small, *batches[0], device=dev)
    n_paused = sum(r.status == PB.STATUS_MAX_STEPS_REACHED for r in res)
    if paused is None or n_paused < B_LONG // 2:
        raise AssertionError(f"resume: {n_paused} pairs paused")
    res, paused = PB.align_pairs_resume(paused, 10**6)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = read_counts()
    check_fallbacks("resume", timed=True)
    if paused is not None or list(map(_result_fields, res)) != list(
            map(_result_fields, e_res[:B_LONG])):
        raise AssertionError("the resumed batch differs from the fresh one")
    log(f"resume: {n_paused} of {B_LONG} pairs paused at {RESUME_STEPS} "
        f"steps, resumed "
        f"equal to the fresh results in {wall:.3f} s; segmented "
        f"{dict(PB.segmented_runs)}; launches {launched(c)}")
    check_build("resume", c, "group")
    total.update(c)

    # --- WavefrontAligner on single long pairs, both scopes ---
    reset_counts()
    singles = [make_ont_pairs(rng, 1, length, ONT_SUB, ONT_IND)
               for length in (1000, 5000)]
    for (p,), (t,) in singles:
        for scope in ("full", "score"):
            for kw in ({}, {"span": "end-to-end"}):
                port = pywfa_tpu_torch.WavefrontAligner(scope=scope,
                                                        device=dev, **kw)
                ref = RefAligner(scope=scope, backend="numpy", **kw)
                t0 = time.perf_counter()
                got = _api_fields(port(t.decode(), p.decode()))
                ms = 1e3 * (time.perf_counter() - t0)
                if got != _api_fields(ref(t.decode(), p.decode())):
                    raise AssertionError(
                        f"WavefrontAligner({scope}, {kw}) on a {len(p)} bp "
                        "pair differs from the oracle")
                log(f"api long [{len(p)} bp, {scope}, "
                    f"{kw.get('span', 'ends-free')}]: equal to the oracle, "
                    f"score {got[0]}, {ms:.1f} ms")
    c = read_counts()
    check_fallbacks("api long", timed=True)
    log(f"api long: launches {launched(c)}")
    # the 5 kb pair's second rung (W=3584) on the cluster build, the
    # other rungs on the group build
    check_build("api long", c, "cluster")
    total.update(c)
    return total



def _rows(cfg, pat, txt):
    """The extension's input of the in-place compare (build_extension
    under PYWFA_EXTEND=chunk): the token rows, or their class masks."""
    from pywfa_tpu_torch.ops import engine as TE
    ext = TE.build_extension(dataclasses.replace(cfg, extend_force="chunk"),
                             pat, txt)
    if ext["pat"] is None:
        raise AssertionError("PYWFA_EXTEND=chunk built no token rows")
    return ext


def _copy_state(state):
    return {k: (v.clone() if torch.is_tensor(v) else v)
            for k, v in state.items()}


def chunk_in_turns(chunk, bits, reps):
    """Mean ms a call of chunk() and of bits() by CUDA events, in turns
    (chunk, bits, bits, chunk); returns the means and the four times."""
    times = collections.defaultdict(list)
    order = ("chunk", "bits", "bits", "chunk")
    for side in order:
        times[side].append(cuda_ms(chunk if side == "chunk" else bits, reps))
    return ({k: float(np.mean(v)) for k, v in times.items()},
            [times[k][i] for k, i in zip(order, (0, 0, 1, 1))])


def _chunk_record(name, cfg, B, build, G, err, call_ms, alone, p_ms, bound,
                  routed=False):
    """A kernels-line record of the in-place compare: `call_ms` the call
    by CUDA events, `alone` the kernel alone (torch.profiler); `routed`
    where a routed run (batch H) launches this very shape."""
    from pywfa_tpu_torch.ops import fused_loop
    return name, dict(variant=fused_loop.variant(cfg, chunk=True), err=err,
                      build=build, G=G if build == "group" else None,
                      ms=call_ms, alone=alone, plain_ms=p_ms,
                      bound_ms=bound[0], bound_by=bound[1], B=B, W=cfg.W,
                      routed=routed)


def phase_chunk_kernels(dev, long_inputs):
    """The in-place compare of every build against its plain version and
    against the words on the same build (see the module docstring, phase
    14)."""
    from pywfa_tpu_torch import BatchWavefrontAligner
    from pywfa_tpu_torch.align import WavefrontAligner as RefAligner
    from pywfa_tpu_torch.ops import config as C
    from pywfa_tpu_torch.ops import engine as TE
    from pywfa_tpu_torch.ops import fused_loop
    attr = BatchWavefrontAligner(span="end-to-end", device=dev)._attr
    default_attr = RefAligner(backend="numpy")._attributes()
    rng = np.random.default_rng(SEED + 11)
    main = make_pairs(rng, B_MAIN, L, DIV)
    related, unrelated = terminal_pairs(rng)
    term = (related[0] + unrelated[0], related[1] + unrelated[1])
    p = make_pairs(rng, 1, L, 0.0)[0][0]
    p_n = make_n_pairs(rng, 1, L, DIV, rate=0.03)
    amb = np.frombuffer(b"NRYSWKM", dtype=np.uint8)
    iupac = []
    for seq in (p, mutate(rng, p, DIV, 0.01)):
        arr = np.frombuffer(seq, dtype=np.uint8).copy()
        at = rng.random(len(arr)) < 0.05
        arr[at] = amb[rng.integers(0, len(amb), int(at.sum()))]
        iupac.append(arr.tobytes())
    (wpats, wtxts), wcfg = api_single_inputs(default_attr, p_n[0][0],
                                             p_n[1][0])
    (cpats, ctxts), ccfg = api_single_inputs(default_attr, *iupac)
    shapes = [
        # (name, pairs, config, timed against the words)
        ("chunk_rung1", main, C.full_config(attr, 160, 160, W=256, S_cap=96),
         True),
        ("chunk_terminal", term, C.full_config(attr, 160, 160), False),
        ("chunk_api_wildcard", (wpats, wtxts),
         dataclasses.replace(wcfg, wildcard=ord("N")), False),
        ("chunk_api_classes", (cpats, ctxts),
         dataclasses.replace(ccfg, match_classes="iupac"), False),
    ]
    records = {}
    for name, (pats, txts), cfg, timed in shapes:
        # zero frees: end to end, or pywfa's default span
        pat, txt, plen, tlen, frees = _token_rows(cfg, pats, txts, dev)
        ext = _rows(cfg, pat, txt)
        B = len(pats)
        build = fused_loop.kernel_build(cfg, B, pat=ext["pat"])
        G = fused_loop.launch_shape(cfg, B, "group", dev)[1]

        def chunk(ext=ext):
            return fused_loop.align_batch_fused_loop(
                cfg, None, plen, tlen, frees, MAXS, pat=ext["pat"],
                txt=ext["txt"])

        def words(bits=None):
            return fused_loop.align_batch_fused_loop(
                cfg, TE.build_eq_bits(cfg, pat, txt) if bits is None
                else bits, plen, tlen, frees, MAXS, build=build)

        got = chunk()
        t0 = time.perf_counter()
        want = fused_loop.align_batch_fused_loop_ref(
            cfg, None, plen, tlen, frees, MAXS, pat=ext["pat"],
            txt=ext["txt"])
        torch.cuda.synchronize()
        p_ms = 1e3 * (time.perf_counter() - t0)
        bits = TE.build_eq_bits(cfg, pat, txt)
        err = max(_max_err(name, got, want, LOOP_KEYS),
                  _max_err(name, got, words(bits), LOOP_KEYS))
        cells = int(torch.count_nonzero(got["choices"])) + B
        bound = kernel_bound(cfg, (None,), got, cells,
                             ext_bytes=ext["pat"].nbytes + ext["txt"].nbytes)
        only = kernel_only_ms(chunk)
        if timed:
            # the words' side builds its words, as a batch does; the rows
            # need no build (build_extension hands them over)
            t_ms, turns = chunk_in_turns(
                lambda: chunk(_rows(cfg, pat, txt)), words, 10)
            only_bits = kernel_only_ms(lambda: words(bits))
            ms = t_ms["chunk"]
            line = (f" chunk_ms={t_ms['chunk']:.4f} "
                    f"bits_with_eq_bits_ms={t_ms['bits']:.4f} "
                    f"turns(chunk,bits,bits,chunk)="
                    f"{','.join(f'{t:.4f}' for t in turns)} "
                    f"kernel_only_ms[chunk]={_fmt(only)} "
                    f"kernel_only_ms[bits]={_fmt(only_bits)}")
        else:
            ms = cuda_ms(chunk, 5)
            line = f" chunk_ms={ms:.4f} kernel_only_ms[chunk]={_fmt(only)}"
        mode = fused_loop.CHUNK_MODES[fused_loop.chunk_mode(cfg)]
        log(f"kernel vs plain [{name}] variant="
            f"{fused_loop.variant(cfg, chunk=True)} B={B} W={cfg.W} "
            f"S_cap={cfg.S_cap} mode={mode} "
            f"build={build} G={G} max_abs_err={err}{line} "
            f"plain_ms={p_ms:.2f} bound_ms={bound[0]:.3g} "
            f"bound_by={bound[1]} cells={cells}")
        if err != 0:
            raise AssertionError(f"{name}: the in-place compare differs from "
                                 "its plain version or the words")
        k, r = _chunk_record(name, cfg, B, build, G, err, ms, only, p_ms,
                             bound)
        records[k] = r
        del got, want, bits, ext

    # --- F's segment: the first from WF0 and a later one from the stored
    # state, the forward and the replay scope, on the group build ---
    pats1k, txts1k = long_inputs["ef"][0]
    cfg_f = f_segment_config(attr, pats1k, txts1k)
    K = cfg_f.S_cap
    pat, txt, plen, tlen, frees = _token_rows(cfg_f, pats1k, txts1k, dev)
    ext = _rows(cfg_f, pat, txt)
    bits = TE.build_eq_bits(cfg_f, pat, txt)
    for record in (False, True):
        cfg = dataclasses.replace(cfg_f, record_choices=record)
        name = "chunk_f" + ("_replay" if record else "_forward")
        build = fused_loop.kernel_build(
            cfg, B_LONG, state=fused_loop.new_state(cfg, 1, dev),
            pat=ext["pat"])

        def segment(fn, state, fresh, rows=True):
            src = dict(pat=ext["pat"], txt=ext["txt"]) if rows else {}
            return fn(cfg, None if rows else bits, plen, tlen, frees, MAXS,
                      state=state, fresh=fresh, seg_base=0 if fresh else K - 1,
                      **src)

        states, outs, err = {}, {}, 0
        kernel = fused_loop.align_batch_fused_loop
        p_ms = 0.0
        for fresh in (True, False):
            for tag, fn, rows in (
                    ("kernel", kernel, True),
                    ("plain", fused_loop.align_batch_fused_loop_ref, True),
                    ("bits", kernel, False)):
                if fresh:
                    states[tag] = fused_loop.new_state(cfg, B_LONG, dev)
                t0 = time.perf_counter()
                outs[tag] = segment(fn, states[tag], fresh, rows)
                torch.cuda.synchronize()
                if tag == "plain" and fresh:
                    p_ms = 1e3 * (time.perf_counter() - t0)
            running = outs["kernel"]["status"] == 5
            err = max(err, _max_err(name, outs["kernel"], outs["plain"],
                                    LOOP_KEYS),
                      _max_err(name, outs["kernel"], outs["bits"], LOOP_KEYS),
                      _state_err(name, states["kernel"], states["plain"],
                                 running),
                      _state_err(name, states["kernel"], states["bits"],
                                 torch.ones_like(running)))
            if fresh and not bool(running.any()):
                raise AssertionError(f"{name}: no pair passes the first "
                                     "segment")
        st = fused_loop.new_state(cfg, B_LONG, dev)
        t_ms, turns = chunk_in_turns(
            lambda: segment(kernel, st, True),
            lambda: fused_loop.align_batch_fused_loop(
                cfg, TE.build_eq_bits(cfg, pat, txt), plen, tlen, frees,
                MAXS, state=st, fresh=True), 10)
        only = kernel_only_ms(lambda: segment(kernel, st, True))
        only_bits = kernel_only_ms(lambda: segment(kernel, st, True, False))
        first = kernel(dataclasses.replace(cfg, record_choices=True), None,
                       plen, tlen, frees, MAXS, pat=ext["pat"], txt=ext["txt"])
        cells = int(torch.count_nonzero(first["choices"])) + B_LONG
        state_bytes = sum(st[k].numel() * 4 for k in ("ring", "lohi",
                                                      "carry"))
        bound = kernel_bound(cfg, (None,), first, cells,
                             state_bytes=state_bytes,
                             ext_bytes=ext["pat"].nbytes + ext["txt"].nbytes)
        del first
        G = fused_loop.launch_shape(cfg, B_LONG, "group", dev)[1]
        ms = t_ms["chunk"]
        log(f"kernel vs plain [{name}] variant="
            f"{fused_loop.variant(cfg, chunk=True)} B={B_LONG} W={cfg.W} "
            f"K={K} Ltp={txt.shape[1]} segments=2 build={build} G={G} "
            f"max_abs_err={err} chunk_ms={t_ms['chunk']:.4f} "
            f"bits_with_eq_bits_ms={t_ms['bits']:.4f} "
            f"turns(chunk,bits,bits,chunk)="
            f"{','.join(f'{t:.4f}' for t in turns)} "
            f"kernel_only_ms[chunk]={_fmt(only)} "
            f"kernel_only_ms[bits]={_fmt(only_bits)} plain_ms={p_ms:.2f} "
            f"bound_ms={bound[0]:.3g} bound_by={bound[1]} cells={cells}")
        if err != 0:
            raise AssertionError(f"{name}: the in-place compare differs from "
                                 "its plain version or the words")
        k, r = _chunk_record(name, cfg, B_LONG, build, G, err, ms, only,
                             p_ms, bound)
        records[k] = r
    del ext, bits

    # --- G's later segment of 96 scores at W=6912, on the cluster and the
    # general build, from the state 8 segments in ---
    pats_g, txts_g = long_inputs["g"]
    cfg = dataclasses.replace(rung2_config(attr, pats_g, txts_g),
                              S_cap=96, record_choices=True)
    fwd = dataclasses.replace(cfg, record_choices=False)
    pat, txt, plen, tlen, frees = _token_rows(cfg, pats_g, txts_g, dev)
    ext = _rows(cfg, pat, txt)
    bits = TE.build_eq_bits(cfg, pat, txt)
    out, state = TE.align_batch_start(fwd, ext, plen, tlen, frees, MAXS)
    for _ in range(7):
        out, state = TE.align_batch_resume(fwd, ext, plen, tlen, frees, MAXS,
                                           state)
    if not bool((out["status"] == 5).all()):
        raise AssertionError("chunk_g: pairs ended in the lead")
    base = state["s"]
    name = "chunk_g_replay"
    build = fused_loop.kernel_build(cfg, B_G, state=state, pat=ext["pat"])
    if build != "cluster":
        raise AssertionError(f"{name}: routed to the {build} build")

    def g_segment(b=None, st=None, rows=True, fn=None):
        src = dict(pat=ext["pat"], txt=ext["txt"]) if rows else {}
        kw = dict(build=b) if fn is None else {}
        return (fn or fused_loop.align_batch_fused_loop)(
            cfg, None if rows else bits, plen, tlen, frees, MAXS,
            state=st if st is not None else _copy_state(state), fresh=False,
            seg_base=base, **src, **kw)

    sts = {t: _copy_state(state) for t in ("cluster", "general", "plain",
                                           "bits")}
    outs = {"cluster": g_segment("cluster", sts["cluster"]),
            "general": g_segment("general", sts["general"]),
            "bits": g_segment("cluster", sts["bits"], rows=False)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs["plain"] = g_segment(st=sts["plain"],
                              fn=fused_loop.align_batch_fused_loop_ref)
    torch.cuda.synchronize()
    p_ms = 1e3 * (time.perf_counter() - t0)
    running = outs["cluster"]["status"] == 5
    err = max(max(_max_err(name, outs["cluster"], outs[t], LOOP_KEYS)
                  for t in ("general", "bits", "plain")),
              _state_err(name, sts["cluster"], sts["plain"], running),
              max(_state_err(name, sts["cluster"], sts[t],
                             torch.ones_like(running))
                  for t in ("general", "bits")))
    t_ms, turns = chunk_in_turns(
        lambda: g_segment("cluster"),
        lambda: fused_loop.align_batch_fused_loop(
            cfg, TE.build_eq_bits(cfg, pat, txt), plen, tlen, frees, MAXS,
            state=_copy_state(state), fresh=False, seg_base=base,
            build="cluster"), 5)
    gen_ms = cuda_ms(lambda: g_segment("general"), 5)
    only = kernel_only_ms(lambda: g_segment("cluster"))
    only_bits = kernel_only_ms(lambda: g_segment("cluster", rows=False))
    cells = int(torch.count_nonzero(outs["cluster"]["choices"]))
    state_bytes = 2 * sum(state[k].numel() * 4 for k in ("ring", "lohi",
                                                         "carry"))
    bound = kernel_bound(cfg, (None,), outs["cluster"], cells, seg_base=base,
                         state_bytes=state_bytes,
                         ext_bytes=ext["pat"].nbytes + ext["txt"].nbytes)
    ms = t_ms["chunk"]
    log(f"kernel vs plain [{name}] variant="
        f"{fused_loop.variant(cfg, chunk=True)} B={B_G} W={cfg.W} "
        f"scores=[{base}, {base + 95}] running={int(running.sum())} "
        f"build={build} max_abs_err={err} chunk_ms={t_ms['chunk']:.4f} "
        f"bits_with_eq_bits_ms={t_ms['bits']:.4f} "
        f"turns(chunk,bits,bits,chunk)="
        f"{','.join(f'{t:.4f}' for t in turns)} "
        f"general_chunk_ms={gen_ms:.4f} kernel_only_ms[chunk]={_fmt(only)} "
        f"kernel_only_ms[bits]={_fmt(only_bits)} plain_ms={p_ms:.2f} "
        f"bound_ms={bound[0]:.3g} bound_by={bound[1]} cells={cells}")
    if err != 0:
        raise AssertionError(f"{name}: the in-place compare differs from its "
                             "plain version, the general build or the words")
    k, r = _chunk_record(name, cfg, B_G, build, None, err, ms, only, p_ms,
                         bound)
    records[k] = r
    del ext, bits, outs, sts
    torch.cuda.empty_cache()
    return records


def h_segments(i, run, dev):
    """Hold one forward segment of batch H's rung `i` (from WF0, no
    record) and one replay segment (the next one, from the forward
    segment's state, with its record) against the plain version on the
    card: the results, the choices and the state (ring, bands, carry).
    `run` is what the routed run gave the rung's first segment: (cfg,
    ext, plen, tlen, frees, max_steps). Returns the kernels-line records
    of the two segments, as H routed them."""
    from pywfa_tpu_torch.ops import fused_loop
    cfg, ext, plen, tlen, frees, max_steps = run
    B, K = plen.shape[0], cfg.S_cap
    fwd = dataclasses.replace(cfg, record_choices=False)
    rec = dataclasses.replace(cfg, record_choices=True)
    rows = dict(pat=ext["pat"], txt=ext["txt"])
    ext_bytes = ext["pat"].nbytes + ext["txt"].nbytes
    kernel = fused_loop.align_batch_fused_loop

    def segment(fn, c, state, fresh):
        return fn(c, None, plen, tlen, frees, max_steps, state=state,
                  fresh=fresh, seg_base=0 if fresh else K - 1, **rows)

    def held(c, fresh, base_state):
        """(kernel out, kernel state, err, plain ms) of one segment."""
        states = {t: (fused_loop.new_state(c, B, dev) if fresh
                      else _copy_state(base_state))
                  for t in ("kernel", "plain")}
        got = segment(kernel, c, states["kernel"], fresh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = segment(fused_loop.align_batch_fused_loop_ref, c,
                       states["plain"], fresh)
        torch.cuda.synchronize()
        p_ms = 1e3 * (time.perf_counter() - t0)
        running = got["status"] == 5
        err = max(_max_err(f"H rung {i}", got, want, LOOP_KEYS),
                  _state_err(f"H rung {i}", states["kernel"],
                             states["plain"], running))
        return got, states["kernel"], err, p_ms, running

    records = {}
    st = fused_loop.new_state(fwd, B, dev)
    for c, fresh in ((fwd, True), (rec, False)):
        got, state, err, p_ms, running = held(c, fresh, st)
        if fresh:
            if not bool(running.any()):
                raise AssertionError(f"H rung {i}: no pair passes the "
                                     "first segment")
            first = segment(kernel, rec, fused_loop.new_state(rec, B, dev),
                            True)
            cells = int(torch.count_nonzero(first["choices"])) + B
            del first
            base, state_bytes = 0, sum(state[k].numel() * 4
                                       for k in ("ring", "lohi", "carry"))

            def call(c=c):
                return segment(kernel, c, fused_loop.new_state(c, B, dev),
                               True)
        else:
            cells = int(torch.count_nonzero(got["choices"]))
            base, state_bytes = K - 1, 2 * sum(
                st[k].numel() * 4 for k in ("ring", "lohi", "carry"))

            def call(c=c):
                return segment(kernel, c, _copy_state(st), False)
        build = fused_loop.kernel_build(c, B, state=state, pat=ext["pat"])
        call_ms = cuda_ms(call, 2)
        only = kernel_only_ms(call, 3)
        bound = kernel_bound(c, (None,), got, cells, seg_base=base,
                             state_bytes=state_bytes, ext_bytes=ext_bytes)
        name = f"chunk_h{i}_" + ("forward" if fresh else "replay")
        log(f"kernel vs plain [{name}] variant="
            f"{fused_loop.variant(c, chunk=True)} B={B} W={c.W} K={K} "
            f"scores=[{base}, {base + K - 1}] running={int(running.sum())} "
            f"build={build} max_abs_err={err} chunk_ms={call_ms:.4f} "
            f"kernel_only_ms[chunk]={_fmt(only)} plain_ms={p_ms:.2f} "
            f"bound_ms={bound[0]:.3g} bound_by={bound[1]} cells={cells}")
        if err != 0:
            raise AssertionError(f"{name}: the in-place compare differs from "
                                 "its plain version")
        G = (fused_loop.launch_shape(c, B, "group", dev)[1]
             if build == "group" else None)
        k, r = _chunk_record(name, c, B, build, G, err, call_ms, only, p_ms,
                             bound, routed=True)
        records[k] = r
        if fresh:
            st = state
        del got
    torch.cuda.empty_cache()
    return records


def phase_chunk_reads(dev, long_inputs, records):
    """Batch H routed (on the rows) and on the words, each rung's segments
    against the plain version and two pairs against the oracle; and batch
    G under PYWFA_EXTEND=chunk (see the module docstring, phase 14)."""
    import os
    from pywfa_tpu_torch import BatchWavefrontAligner
    from pywfa_tpu_torch import batch as PB
    from pywfa_tpu_torch.ops import engine as TE
    from pywfa_tpu_torch.ops import fused_loop
    total = collections.Counter()
    pats, txts = long_inputs["h"]
    results = {}
    build = TE.build_extension
    start = TE.align_batch_start
    # the first segment's inputs of each rung of the routed run
    runs, n_rungs = [], {}
    for side in ("chunk", "bits"):
        cap = TE.EQ_BITS_BYTES_CAP
        # each segmented run's config, the extension it took and, with the
        # replay's record, what memory_estimate counts for it
        rungs = []

        def spy(cfg, pat, txt, table=True):
            ext = build(cfg, pat, txt, table)
            rungs.append((cfg, "chunk" if ext["pat"] is not None else
                          "table" if ext["table"] is not None else "bits",
                          TE.memory_estimate(dataclasses.replace(
                              cfg, record_choices=True), pat.shape[0],
                              table)))
            return ext

        def spy_start(cfg, ext, plen, tlen, frees, max_steps):
            runs.append((cfg, ext, plen, tlen, frees, max_steps))
            return start(cfg, ext, plen, tlen, frees, max_steps)

        if side == "bits":
            # the words however large: the in-process cap raised
            TE.EQ_BITS_BYTES_CAP = 2**62
        else:
            TE.align_batch_start = spy_start
        TE.build_extension = spy
        try:
            aligner = BatchWavefrontAligner(span="end-to-end",
                                            memory_mode="low", device=dev)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            results[side] = aligner.align(pats, txts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            TE.EQ_BITS_BYTES_CAP = cap
            TE.build_extension = build
            TE.align_batch_start = start
        c = read_counts()
        check_fallbacks(f"batch H {side}", timed=True)
        seg = dict(PB.segmented_runs)
        peak = torch.cuda.max_memory_allocated()
        log(f"batch [H 50 kb {side}]: {B_H} pairs of {L_H} bp in "
            f"{wall:.3f} s; scores "
            f"{min(r.score for r in results[side])}.."
            f"{max(r.score for r in results[side])}; rungs "
            + "; ".join(f"W={cfg.W} K={cfg.S_cap} extension={mode} "
                        f"memory_estimate={e['total']} (ring {e['ring']}, "
                        f"choices {e['choices']}, extension "
                        f"{e['lcp_table']}, rows {e['sequences']})"
                        for cfg, mode, e in rungs)
            + f"; peak device memory {peak} B "
            f"({peak / 2**30:.3f} GiB); segmented {seg}; launches "
            f"{launched(c)}")
        chunked = sum(v for k, v in c.items() if k.endswith("_chunk"))
        if side == "chunk" and (not c["e2e_score_chunk"]
                                or not c["e2e_chunk"]
                                or chunked != c["build_general"]
                                + c["build_cluster"] + c["build_group"]
                                + c["build_narrow"]
                                or {m for _, m, _ in rungs} != {"chunk"}):
            raise AssertionError("batch H must extend by the rows in place "
                                 f"on every launch: {launched(c)}")
        if side == "bits" and (chunked or not c["e2e_score"]
                               or {m for _, m, _ in rungs} != {"bits"}):
            raise AssertionError("batch H with the cap raised must extend "
                                 f"by the words: {launched(c)}")
        if len(rungs) < 2 or seg["runs"] != len(rungs):
            raise AssertionError(f"batch H {side} must run its rungs "
                                 f"segmented: {seg}")
        n_rungs[side] = len(rungs)
        total.update(c)
    if list(map(_result_fields, results["chunk"])) != list(
            map(_result_fields, results["bits"])):
        raise AssertionError("batch H on the rows differs from the words")
    log(f"batch [H] on the rows equals the words on {B_H} pairs, every "
        "field")
    if len(runs) != n_rungs["chunk"]:
        raise AssertionError(f"batch H: {len(runs)} segmented starts seen "
                             f"for {n_rungs['chunk']} rungs")
    # --- each rung's segments as H routed them, against the plain version
    t0 = time.perf_counter()
    for i, run in enumerate(runs):
        records.update(h_segments(i, run, dev))
    del runs
    log(f"batch [H] segments against the plain version: "
        f"{time.perf_counter() - t0:.1f} s")
    # --- two pairs against the host oracle, started at the beginning ---
    want, secs, waited = long_inputs["h_oracle"].result(timeout=600)
    for i, w in zip(H_ORACLE, want):
        if _result_fields(results["chunk"][i]) != _result_fields(w):
            raise AssertionError(f"batch H pair {i} differs from the oracle")
    log(f"batch [H] on the rows equals the oracle on {len(H_ORACLE)} pairs "
        f"(oracle: {secs:.1f} s in its own process, {waited:.1f} s waited "
        "for here)")
    del results

    # --- batch G under PYWFA_EXTEND=chunk, read as the config is built ---
    pats_g, txts_g = long_inputs["g"]
    os.environ["PYWFA_EXTEND"] = "chunk"
    try:
        aligner = BatchWavefrontAligner(span="end-to-end", memory_mode="low",
                                        device=dev)
        reset_counts()
        t0 = time.perf_counter()
        got = aligner.align(pats_g, txts_g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del os.environ["PYWFA_EXTEND"]
    c = read_counts()
    check_fallbacks("batch G chunk", timed=True)
    # launches on the words or the table
    other = sum(c[k] for k in fused_loop.VARIANTS + fused_loop.TABLE_VARIANTS)
    log(f"batch [G 10 kb low, PYWFA_EXTEND=chunk]: {B_G} pairs in "
        f"{wall:.3f} s; launches {launched(c)}")
    if not c["e2e_chunk"] or not c["e2e_score_chunk"] or other \
            or c["lcp_table"]:
        raise AssertionError("batch G under PYWFA_EXTEND=chunk must extend "
                             f"by the rows alone: {launched(c)}")
    if list(map(_result_fields, got)) != list(
            map(_result_fields, long_inputs["g_low"])):
        raise AssertionError("batch G under PYWFA_EXTEND=chunk differs from "
                             "batch G")
    log(f"batch [G] under PYWFA_EXTEND=chunk equals batch G on {B_G} pairs "
        "(and so the oracle on 2)")
    total.update(c)
    return total



# the read-set phases: the CLI's read set and its batches
CLI_SHORT = 16384
CLI_LONG = 512
CLI_BATCH = 4096
CLI_ORACLE = 256


def one_shot_record(name, cfg, host, dev):
    """Hold the fused loop as engine.align_batch runs it (the extension of
    build_extension, the build kernel_build names) against its plain
    version on the same inputs, and time both by CUDA events (a call),
    the kernel alone by torch.profiler; `host` holds the batch's (pat,
    txt, plen, tlen, frees) as arrays. Returns
    the kernels line's record of the variant at this shape."""
    from pywfa_tpu_torch.ops import engine as TE
    from pywfa_tpu_torch.ops import fused_loop
    pat, txt, plen, tlen, frees = (torch.from_numpy(np.ascontiguousarray(a))
                                   .to(dev) for a in host)
    ext = TE.build_extension(cfg, pat, txt)
    table = ext["table"]
    args = (ext["bits"], plen, tlen, frees, MAXS)
    B = plen.shape[0]
    build = fused_loop.kernel_build(cfg, B, table)
    G = fused_loop.launch_shape(cfg, B, "group", dev)[1]

    def kernel():
        return fused_loop.align_batch_fused_loop(cfg, *args, table=table)

    def plain():
        return fused_loop.align_batch_fused_loop_ref(cfg, *args, table=table)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = _max_err(name, got, want, LOOP_KEYS)
    if err != 0:
        raise AssertionError(f"{name}: the {build} build differs from the "
                             f"plain version ({err})")
    k_ms, p_ms = cuda_ms(kernel, 10), cuda_ms(plain, 1)
    only = kernel_only_ms(kernel)
    rec = got if cfg.record_choices else fused_loop.align_batch_fused_loop(
        dataclasses.replace(cfg, record_choices=True), *args, table=table)
    cells = int(torch.count_nonzero(rec["choices"])) + B
    # the extension's input: the eq words whole (as phase 3 counts them),
    # of the table the cells these pairs read (one load a cell, as the
    # segments of phase 10 count them)
    ext_t = table if table is not None else ext["bits"]
    b_ms, b_by = kernel_bound(cfg, (ext_t,), got, cells, ext_bytes=(
        ext_t.numel() * 4 if table is None else cells * table.element_size()))
    variant = fused_loop.variant(cfg, table is not None)
    log(f"kernel vs plain [{name}] variant={variant} B={B} W={cfg.W} "
        f"S_cap={cfg.S_cap} Ltp={txt.shape[1]} "
        f"extension={'table' if table is not None else 'bits'} "
        f"steps={int(got['steps'])} max_abs_err={err} build={build} G={G} "
        f"ms={k_ms:.4f} kernel_only_ms={_fmt(only)} plain_ms={p_ms:.2f} "
        f"bound_ms={b_ms:.3g} "
        f"bound_by={b_by} cells={cells}")
    return dict(variant=variant, err=err, build=build,
                G=G if build == "group" else None, ms=k_ms, alone=only,
                plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, B=B)


def phase_dryrun(dev, records):
    """11. The twin of the dry run over every card of the host
    (`parallel.dryrun.dryrun_multichip`, five configurations, each
    asserted as the reference asserts it); then the table variants it
    launched that no earlier phase holds, against their plain versions at
    its shapes."""
    from pywfa_tpu_torch.align import WavefrontAligner as RefAligner
    from pywfa_tpu_torch.ops import config as C
    from pywfa_tpu_torch.parallel import dryrun
    n = torch.cuda.device_count()
    reset_counts()
    t0 = time.perf_counter()
    dryrun.dryrun_multichip(n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = read_counts()
    log(f"dry run: {n} devices in {wall:.3f} s; launches {launched(c)}")
    check_group("dry run", c)
    B = 8 * n
    cfg, host = dryrun._example_inputs(B, 48, 48)
    host = host[:5]
    ef = RefAligner(backend="numpy", span="ends-free", pattern_begin_free=8,
                    pattern_end_free=8, text_begin_free=8,
                    text_end_free=8)._attributes()
    frees = np.zeros((B, 4), dtype=np.int32)
    frees[:, 0] = np.arange(B) % 9
    frees[:, 1] = 8
    frees[:, 2] = (np.arange(B) * 3) % 9
    frees[:, 3] = 8
    heur = RefAligner(backend="numpy", span="end-to-end",
                      heuristic="adaptive")._attributes()
    records["dryrun_endsfree"] = one_shot_record(
        "dryrun_endsfree", C.full_config(ef, 48, 48), host[:4] + (frees,),
        dev)
    records["dryrun_heur"] = one_shot_record(
        "dryrun_heur", C.full_config(heur, 48, 48), host, dev)
    return c


def phase_sharded(dev, records):
    """12. The main path's batch through the mesh: 4096 pairs of 150 bp at
    2% divergence, gap-affine end to end with the record, at the first
    rung (W=256, S_cap=96), over every card of the host with the meta
    gathered over a one-rank NCCL group made here (distributed_init is a
    no-op for one process); byte-equal to engine.align_batch on one card,
    choices included. Prints ms a batch (CUDA events, in turns) of the
    whole batch, of the sharded call with and without the gather, and of
    the gather alone, and the build and G of a shard and of the whole
    batch."""
    import socket

    import torch.distributed as dist
    from pywfa_tpu_torch import batch as PB
    from pywfa_tpu_torch.ops import config as C
    from pywfa_tpu_torch.ops import engine as TE
    from pywfa_tpu_torch.ops import fused_loop
    from pywfa_tpu_torch.parallel import (distributed_init, make_mesh,
                                          mesh as PM, sharded_align_batch)
    rng = np.random.default_rng(SEED + 12)
    pats, txts = make_pairs(rng, B_MAIN, L, DIV)
    attr = PB.BatchWavefrontAligner(span="end-to-end", device=dev)._attr
    cfg = C.full_config(attr, 160, 160, W=256, S_cap=96)
    host = (PB.encode_batch(pats, cfg.Lp, cfg.extend_chunk,
                            PB.PATTERN_SENTINEL),
            PB.encode_batch(txts, cfg.Lt, cfg.extend_chunk,
                            PB.TEXT_SENTINEL),
            np.full(B_MAIN, L, np.int32), np.full(B_MAIN, L, np.int32),
            np.zeros((B_MAIN, 4), np.int32))
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    distributed_init(f"localhost:{port}", 1, 0)
    if dist.is_initialized():
        raise AssertionError("distributed_init must be a no-op for one "
                             "process")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        if mesh.group is None or mesh.size != torch.cuda.device_count():
            raise AssertionError(f"the mesh has {mesh.size} devices and "
                                 f"group {mesh.group}")
        fn = sharded_align_batch(cfg, mesh, gather_results=True)
        reset_counts()
        t0 = time.perf_counter()
        out = fn(*host, MAXS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = read_counts()
        whole_in = [torch.from_numpy(a).to(dev) for a in host]
        whole = TE.align_batch(cfg, *whole_in, MAXS)
        torch.cuda.synchronize()
        err = _max_err("sharded", out, whole, LOOP_KEYS[:-1])
        err = max(err, _max_err(
            "sharded", {"choices": torch.cat([ch.to(dev) for ch in
                                              out["choices"]], dim=1)},
            whole, ("choices",)))
        if err or int(out["steps"]) != int(whole["steps"]):
            raise AssertionError("the sharded batch differs from the "
                                 f"unsharded one ({err})")
        if not bool((whole["status"] == 1).all()):
            raise AssertionError("a pair of the sharded batch did not end")
        shard_B = B_MAIN // mesh.size
        table = TE.build_extension(cfg, *whole_in[:2])["table"]
        shape = {n: (fused_loop.kernel_build(cfg, n, table),
                     fused_loop.launch_shape(cfg, n, "group", dev)[1])
                 for n in (shard_B, B_MAIN)}
        g = PM.make_global_batch(mesh, dict(zip(
            ("pat", "txt", "plen", "tlen", "frees"), host)))
        args = [g[k] for k in ("pat", "txt", "plen", "tlen", "frees")]
        outs = [TE.align_batch(cfg, *a, MAXS) for a in zip(*args)]
        runs = {"whole": lambda: TE.align_batch(cfg, *whole_in, MAXS),
                "sharded": lambda: fn(*args, MAXS),
                "no_gather": lambda: sharded_align_batch(cfg, mesh)(
                    *args, MAXS)}
        # eight shards on the first card: a shard of 512 pairs takes more
        # warps a pair than the whole batch (group_size reads B), and must
        # give the same bytes
        mesh8 = make_mesh([dev] * 8)
        out8 = sharded_align_batch(cfg, mesh8, gather_results=True)(*host,
                                                                    MAXS)
        err8 = max(_max_err("eight shards", out8, whole, LOOP_KEYS[:-1]),
                   _max_err("eight shards", {"choices": torch.cat(
                       out8["choices"], dim=1)}, whole, ("choices",)))
        shape8 = (fused_loop.kernel_build(cfg, B_MAIN // 8, table),
                  fused_loop.launch_shape(cfg, B_MAIN // 8, "group", dev)[1])
        log(f"eight shards of {B_MAIN // 8} on one card: build and G "
            f"{shape8} against the whole batch's {shape[B_MAIN]}; "
            f"max_abs_err {err8}")
        if err8:
            raise AssertionError("eight shards differ from the whole batch")
        times = collections.defaultdict(list)
        for key in ("whole", "no_gather", "sharded", "sharded", "no_gather",
                    "whole"):
            times[key].append(cuda_ms(runs[key], 10))
        gather_ms = cuda_ms(lambda: PM._gather(mesh, outs), 20)
        inside = {k: kernel_only_ms(runs["whole"], name=n) for k, n in (
            ("K3", "lcp_table"), ("fused loop", "fused_loop"),
            ("every kernel", ""))}
        log("inside the whole batch, device ms a call (torch.profiler): "
            + "; ".join(f"{k} {_fmt(v)}" for k, v in inside.items()))
        log(f"sharded main path: {B_MAIN} pairs over {mesh.size} device(s), "
            f"{mesh.process_count} process(es), NCCL gather; byte-equal to "
            f"the unsharded batch (max_abs_err 0, choices included) in "
            f"{wall:.3f} s first call; ms a batch, in turns: "
            + "; ".join(f"{k} {np.mean(v):.4f} ("
                        + ", ".join(f"{t:.4f}" for t in v) + ")"
                        for k, v in times.items())
            + f"; the gather alone {gather_ms:.4f} ms; build and G: a "
            f"shard of {shard_B} {shape[shard_B]}, the whole batch "
            f"{shape[B_MAIN]}; launches {launched(c)}")
        check_group("sharded main path", c, one=True)
        if c["lcp_table"] == 0 or c["e2e_table"] == 0:
            raise AssertionError("the sharded main path must extend by the "
                                 f"run-length table: {launched(c)}")
    finally:
        dist.destroy_process_group()
    records["sharded_rung1"] = one_shot_record("sharded_rung1", cfg, host,
                                               dev)
    return c


def cli_read_set(rng):
    """The CLI phase's read set as (patterns, texts) of (name, sequence):
    CLI_SHORT pairs of 150 bp at 2% divergence, CLI_LONG ONT-like 1 kb
    pairs at 7%, and the probe rows of the verify recipe: a lowercase
    read, a pattern with an N, and 32 pairs of 30-120 bp (two more length
    buckets)."""
    pats, txts = make_pairs(rng, CLI_SHORT, L, DIV)
    lp, lt = make_ont_pairs(rng, CLI_LONG, L_LONG, ONT_SUB, ONT_IND)
    pats += lp
    txts += lt
    p, t = make_pairs(rng, 2, L, DIV)
    pats += p
    txts += [t[0].lower(), t[1]]
    pats[-1] = pats[-1][:70] + b"N" + pats[-1][71:]
    for n in rng.integers(30, 121, 32):
        p, t = make_pairs(rng, 1, int(n), 0.05)
        pats += p
        txts += t
    return ([(f"p{i}", s.decode()) for i, s in enumerate(pats)],
            [(f"r{i} read", s.decode()) for i, s in enumerate(txts)])


def run_cli(root, args, name):
    """Run `python -m pywfa_tpu_torch.cli align` in a subprocess from the
    checkout, verbose; returns (wall s, pairs/s the CLI printed, its
    device counts)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "pywfa_tpu_torch.cli", "align",
                        *args, "--device", "cuda", "--verbose"], cwd=root,
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"cli [{name}] exited {r.returncode}: "
                             f"{r.stderr[-3000:]}")
    rate = re.findall(r"^# (\d+) pairs in ([\d.]+)s \((\d+) pairs/s\)",
                      r.stderr, re.MULTILINE)
    counts = re.findall(r"^# device: (.*)$", r.stderr, re.MULTILINE)
    if not rate or not counts:
        raise AssertionError(f"cli [{name}]: no rate or device line in "
                             f"{r.stderr[-2000:]}")
    return wall, int(rate[-1][2]), json.loads(counts[-1])


def phase_cli(dev):
    """13. The command line over FASTA files: the read set of cli_read_set
    with --batch-size 4096 in tsv and in paf (ends-free, pywfa's
    defaults), then end to end in the high mode and under
    --memory-mode biwfa, which must run segmented and launch K3 (on the
    150 bp batches too) with rows equal to the high mode's. Every row has
    status 0, CLI_ORACLE sampled rows equal the oracle, no pair goes to
    the host oracle. Each run's launches (its verbose device line) add to
    the kernels line."""
    import os
    import tempfile

    from pywfa_tpu_torch import batch as PB
    from pywfa_tpu_torch.cigar import ops_to_cigarstring
    from pywfa_tpu_torch.parallel.bucketing import bucket_pairs
    from pywfa_tpu_torch.utils.io import write_fasta
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    rng = np.random.default_rng(SEED + 13)
    pats, txts = cli_read_set(rng)
    n = len(pats)
    groups = bucket_pairs([s.upper().encode() for _, s in pats],
                          [s.upper().encode() for _, s in txts])
    # the full batches of 150 bp pairs: their rung-1 record passes the
    # biwfa share of the budget, so they run segmented there
    n_short = sum(len(v) // CLI_BATCH for k, v in groups.items()
                  if max(k) <= 256)
    log(f"cli read set: {n} pairs, buckets "
        f"{ {k: len(v) for k, v in sorted(groups.items())} }")
    if len(groups) < 3:
        raise AssertionError("the read set must span three length buckets")
    total = collections.Counter()
    rows = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as tmp:
        pfa, tfa = os.path.join(tmp, "p.fa"), os.path.join(tmp, "t.fa")
        write_fasta(pfa, pats)
        write_fasta(tfa, txts)
        runs = (("tsv", ["--format", "tsv"]), ("paf", ["--format", "paf"]),
                ("e2e high", ["--span", "end-to-end"]),
                ("e2e biwfa", ["--span", "end-to-end", "--memory-mode",
                               "biwfa"]))
        for name, extra in runs:
            out = os.path.join(tmp, name.replace(" ", "_"))
            wall, rate, dc = run_cli(
                root, ["--patterns", pfa, "--texts", tfa, "--out", out,
                       "--batch-size", str(CLI_BATCH), *extra], name)
            with open(out) as fh:
                rows[name] = [r.split("\t") for r in fh.read().splitlines()]
            fb, seg = dc["oracle_fallbacks"], dc["segmented_runs"]
            log(f"cli [{name}]: {n} pairs, {rate} pairs/s as the CLI "
                f"counts (reads to rows), {n / wall:.0f} pairs/s over the "
                f"process's {wall:.2f} s; launches {dc['launches']}; builds "
                f"{dc['builds']}; segmented {seg}; oracle fallbacks {fb}")
            if any(fb.values()):
                raise AssertionError(f"cli [{name}]: pairs went to the host "
                                     f"oracle: {fb}")
            if len(rows[name]) != n:
                raise AssertionError(f"cli [{name}]: {len(rows[name])} rows")
            if name == "e2e biwfa" and (
                    seg["runs"] < n_short
                    or dc["launches"]["lcp_table"] < seg["runs"]):
                raise AssertionError(
                    "cli [e2e biwfa]: the 150 bp batches must run segmented "
                    f"and launch K3 ({n_short} short batches): {seg}, "
                    f"{dc['launches']}")
            total.update(dc["launches"])
    tsv, paf = rows["tsv"], rows["paf"]
    if any(r[2] != "0" for name in ("tsv", "e2e high", "e2e biwfa")
           for r in rows[name]):
        raise AssertionError("cli: a row has a status other than 0")
    if [(r[3], r[4]) for r in tsv] != [(r[12][5:], r[13][5:]) for r in paf]:
        raise AssertionError("cli: the paf rows differ from the tsv rows")
    if rows["e2e biwfa"] != rows["e2e high"]:
        raise AssertionError("cli: biwfa rows differ from the high mode's")
    attrs = {"tsv": PB.BatchWavefrontAligner(device=dev)._attr,
             "e2e high": PB.BatchWavefrontAligner(span="end-to-end",
                                                  device=dev)._attr}
    t0 = time.perf_counter()
    for i in sorted(rng.choice(n, CLI_ORACLE, replace=False).tolist()):
        p = pats[i][1].upper().encode()
        t = txts[i][1].upper().encode()
        for name, attr in attrs.items():
            o = PB._oracle_one(attr, p, t)
            want = [str(o.status), str(o.score), ops_to_cigarstring(o.ops),
                    str(o.end_v), str(o.end_h)]
            if rows[name][i][2:] != want or rows[name][i][:2] != [
                    txts[i][0].split()[0], pats[i][0]]:
                raise AssertionError(f"cli [{name}] row {i} differs from "
                                     f"the oracle: {rows[name][i]} {want}")
    log(f"oracle: cli: {CLI_ORACLE} sampled rows equal, ends-free and end "
        f"to end ({time.perf_counter() - t0:.1f} s)")
    return total



def _load(*parts):
    """The script at `parts` under the checkout's root as a module (tools/
    is no package): ("tools", "fuzz_parity_torch"), ("bench_torch",)."""
    import importlib.util
    import os
    name = parts[-1]
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        *parts[:-1], f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make_long_fuzz():
    """The fuzz's long share, from LONG_FUZZ_SEED: LONG_FUZZ_CONFIGS
    configurations of tools/fuzz_parity_torch.random_config with the
    memory mode drawn from high, low and biwfa, each with a batch of
    LONG_FUZZ_B ONT-like pairs, every pair of its own length in
    LONG_FUZZ_LEN and divergence in LONG_FUZZ_DIV (half substitutions,
    half indels): [(kw, patterns, texts)]."""
    import random
    fz = _load("tools", "fuzz_parity_torch")
    rng = random.Random(LONG_FUZZ_SEED)
    nrng = np.random.default_rng(LONG_FUZZ_SEED)
    share = []
    for _ in range(LONG_FUZZ_CONFIGS):
        kw = fz.random_config(rng)
        kw["memory_mode"] = rng.choice(["high", "low", "biwfa"])
        pats, txts = [], []
        for _ in range(LONG_FUZZ_B):
            n = int(nrng.integers(LONG_FUZZ_LEN[0], LONG_FUZZ_LEN[1] + 1))
            d = float(nrng.uniform(*LONG_FUZZ_DIV))
            p, t = make_ont_pairs(nrng, 1, n, d / 2, d / 2)
            pats += p
            txts += t
        share.append((kw, pats, txts))
    return share


def _api_attr(kw):
    """(attributes, wildcard byte or None) of WavefrontAligner(**kw)."""
    from pywfa_tpu_torch.align import WavefrontAligner
    api = WavefrontAligner(backend="numpy", **kw)
    return api._attributes(), (api._bwildcard if api._wildcard else None)


def start_long_fuzz_oracles(long_inputs):
    """Start the host oracle on each configuration of the fuzz's long
    share, a process a configuration, beside the phases before phase 15;
    the caller stops them."""
    long_inputs["long_fuzz"] = make_long_fuzz()
    oracles = []
    for kw, pats, txts in long_inputs["long_fuzz"]:
        attr, wc = _api_attr(kw)
        oracles.append(HostOracle(attr, list(zip(pats, txts)), wildcard=wc))
    long_inputs["long_fuzz_oracles"] = oracles
    return oracles


def _fault_fallbacks(phase):
    """Fail on a pair sent to the host oracle for an inconsistent walk or a
    dropped walk; print the fallbacks by reason."""
    from pywfa_tpu_torch import batch as PB
    fb = dict(PB.oracle_fallbacks)
    log(f"oracle fallbacks [{phase}]: {fb}")
    if fb["inconsistent walk"] or fb["dropped"]:
        raise AssertionError(f"{phase}: a wrong kernel or walk went to the "
                             f"host oracle: {fb}")


def phase_fuzz(dev, long_inputs):
    """15. The parity fuzz on the card. tools/fuzz_parity_torch.py from
    FUZZ_SEED: FUZZ_PARITY_ITERS random configurations, each batch on the
    card held against the oracle and, every field of every result, against
    the same batch through the plain versions on the CPU;
    tools/fuzz_partials_torch.py, FUZZ_PARTIALS_ITERS seeds from
    FUZZ_SEED (composite heuristics, WF-extension) against the oracle;
    then the long share (make_long_fuzz), each configuration's batch on
    the card against the host oracle's results, which must launch the
    general and the cluster build. Any mismatch, or a fallback for an
    inconsistent or dropped walk, fails. Logs the launches by variant and
    build; they stay out of the kernels line."""
    from pywfa_tpu_torch import batch as PB
    fz = _load("tools", "fuzz_parity_torch")
    reset_counts()
    t0 = time.perf_counter()
    done, bad = fz.run(FUZZ_PARITY_ITERS, FUZZ_SEED, device=dev.type,
                       emit=log)
    if bad is not None:
        raise AssertionError(f"fuzz_parity: mismatch at iteration {done}: "
                             f"{json.dumps(bad)}")
    counts = read_counts()
    log(f"fuzz_parity: {done} iterations from seed {FUZZ_SEED} on {dev.type}, "
        f"0 mismatches against the oracle and the plain versions, "
        f"{time.perf_counter() - t0:.1f} s; launches "
        f"{launched(counts)}")
    _fault_fallbacks("fuzz_parity")

    fp = _load("tools", "fuzz_partials_torch")
    reset_counts()
    t0 = time.perf_counter()
    n_bad = fp.fuzz(FUZZ_SEED, FUZZ_PARTIALS_ITERS, device=dev.type,
                    emit=log)
    if n_bad:
        raise AssertionError(f"fuzz_partials: {n_bad} mismatches")
    log(f"fuzz_partials: seeds {FUZZ_SEED}-"
        f"{FUZZ_SEED + FUZZ_PARTIALS_ITERS - 1} on {dev.type}, 0 mismatches, "
        f"{time.perf_counter() - t0:.1f} s; launches "
        f"{launched(read_counts())}")
    _fault_fallbacks("fuzz_partials")

    reset_counts()
    t0 = time.perf_counter()
    fields = ("status", "score", "ops")
    for i, ((kw, pats, txts), oracle) in enumerate(zip(
            long_inputs["long_fuzz"], long_inputs["long_fuzz_oracles"])):
        attr, wc = _api_attr(kw)
        t1 = time.perf_counter()
        res = PB.align_pairs(attr, pats, txts, wildcard=wc, device=dev)
        card_s = time.perf_counter() - t1
        want, secs, waited = oracle.result(timeout=600)
        for j, (r, o) in enumerate(zip(res, want)):
            got = tuple(getattr(r, f) for f in fields)
            exp = tuple(getattr(o, f) for f in fields)
            if got != exp:
                raise AssertionError(
                    "fuzz long share: mismatch " + json.dumps({
                        "config": i, "kw": kw, "pair": j,
                        "lengths": [len(pats[j]), len(txts[j])],
                        "card": [r.status, r.score, len(r.ops)],
                        "oracle": [o.status, o.score, len(o.ops)]}))
        log(f"fuzz long share [{i}]: {json.dumps(kw)}; lengths "
            f"{[(len(p), len(t)) for p, t in zip(pats, txts)]}; scores "
            f"{[r.score for r in res]}, status {[r.status for r in res]}; "
            f"card {card_s:.2f} s, oracle {secs:.1f} s in its process "
            f"({waited:.1f} s waited); equal")
        _fault_fallbacks(f"fuzz long share [{i}]")
    counts = read_counts()
    builds = {k[6:]: v for k, v in counts.items() if k.startswith("build_")}
    log(f"fuzz long share: {len(long_inputs['long_fuzz'])} configurations, "
        f"{time.perf_counter() - t0:.1f} s; segmented "
        f"{dict(PB.segmented_runs)}; builds {builds}; launches "
        f"{launched(counts)}")
    if not builds["general"] or not builds["cluster"]:
        raise AssertionError("the fuzz's long share must launch the general "
                             f"and the cluster build: {builds}")


def phase_soak(dev, long_inputs):
    """16. tools/soak_sanitize_torch.py on the card, SOAK_ITERS iterations,
    in a process of its own under CUDA_LAUNCH_BLOCKING=1 (every CIGAR
    self-checked, numpy traps raised, no fault fallback)."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CUDA_LAUNCH_BLOCKING="1")
    r = subprocess.run([sys.executable,
                        os.path.join(root, "tools", "soak_sanitize_torch.py"),
                        "0", str(SOAK_ITERS), "--device", dev.type],
                       cwd=root,
                       env=env, capture_output=True, text=True, timeout=600)
    lines = r.stdout.strip().splitlines()
    for line in lines[-3:]:
        log(f"soak: {line}")
    if r.returncode != 0 or not lines or not lines[-1].startswith(
            f"soak_sanitize OK: {SOAK_ITERS} iters") or not lines[-1].endswith(
            "no traps fired"):
        raise AssertionError(f"soak exited {r.returncode}: "
                             f"{r.stdout[-2000:]} {r.stderr[-3000:]}")


def phase_bench(dev, long_inputs):
    """17. bench_torch.py at its defaults (bench.py's W=128) and at
    BENCH_W=256 (the first rung production derives), in this process;
    logs each JSON line and its '#' line."""
    import contextlib
    import io
    import os
    bench = _load("bench_torch")
    for w in ("128", "256"):
        old = os.environ.get("BENCH_W")
        os.environ["BENCH_W"] = w
        out, err = io.StringIO(), io.StringIO()
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = bench.main(["--device", dev.type])
        finally:
            if old is None:
                del os.environ["BENCH_W"]
            else:
                os.environ["BENCH_W"] = old
        line = out.getvalue().strip()
        log(f"bench_torch BENCH_W={w}: {line}")
        log(f"bench_torch BENCH_W={w}: {err.getvalue().strip()}")
        if rc != 0 or list(json.loads(line)) != ["metric", "value", "unit",
                                                 "vs_baseline"]:
            raise AssertionError(f"bench_torch at BENCH_W={w}: {line}")


def phase_stage_report(dev, long_inputs):
    """18. The PYWFA_PROF stage report of one stream of phase 4's eight
    4096-pair batches (depth 3), batch._PROF on for it alone: every
    dispatch, pull and finish key once a batch; beside it the garbage
    collector's pauses in the stream (gc.callbacks)."""
    import gc

    from pywfa_tpu_torch import BatchWavefrontAligner
    from pywfa_tpu_torch import batch as PB
    rng = np.random.default_rng(SEED)
    batches = [make_pairs(rng, B_MAIN, L, DIV) for _ in range(N_BATCHES)]
    aligner = BatchWavefrontAligner(distance="affine", span="end-to-end",
                                    device=dev)
    # the garbage collector's pauses inside the stream, by generation
    gc_ms = collections.Counter()
    gc_t0 = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_ms[info["generation"]] += 1e3 * (time.perf_counter()
                                                - gc_t0[0])

    PB.PROF.clear()
    PB.PROF_N.clear()
    PB._PROF = True
    gc.callbacks.append(on_gc)
    try:
        t0 = time.perf_counter()
        results = list(aligner.align_stream(iter(batches), depth=3))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(PB.PROF_N)
        report = PB.prof_report()
    finally:
        PB._PROF = False
        gc.callbacks.remove(on_gc)
    log(f"stage report (PYWFA_PROF), {N_BATCHES} x {B_MAIN} pairs of {L} bp, "
        f"depth 3, {wall:.3f} s = {N_BATCHES * B_MAIN / wall:.0f} "
        "alignments/s:")
    for line in report.splitlines():
        log(f"  {line}")
    log("garbage collection inside the stream, ms by generation: "
        + (", ".join(f"{g}: {ms:.2f}" for g, ms in sorted(gc_ms.items()))
           or "none"))
    keys = ("d.config", "d.encode", "d.push_enqueue", "p.pull_wait",
            "f.pull", "f.native_fill", "f.assemble")
    if any(counts.get(k) != N_BATCHES for k in keys) or any(
            r.status != 0 for rs in results for r in rs):
        raise AssertionError(f"stage report: {counts}")


def walk_times(label, cfg, choices, seg_base, carry):
    """The walk's kernel at one segment's inputs: the call by CUDA events,
    the kernel alone by torch.profiler, the launch's host time, the most
    steps a pair took (the traced walk's count), and the plain loop's call
    by CUDA events; logs one line and returns the record."""
    from pywfa_tpu_torch import batch as PB
    from pywfa_tpu_torch import spans
    from pywfa_tpu_torch.ops import engine as TE

    def kernel():
        return TE.walk_segment(cfg, choices, seg_base, carry)

    K, B, W = choices.shape
    rec = {"label": label, "K": K, "B": B, "W": W, "seg_base": seg_base,
           "n_comp": cfg.n_comp, "call_ms": cuda_ms(kernel, 50),
           "ms": kernel_only_ms(kernel, reps=5, name="walk"),
           "host_ms": host_ms(kernel, 50),
           "plain_ms": cuda_ms(lambda: TE.walk_segment_ref(
               cfg, choices, seg_base, carry), 3)}
    prof = PB._PROF
    PB._PROF = True
    try:
        kernel()
    finally:
        PB._PROF = prof
    rec["steps"] = next(e[5] for e in reversed(spans.log) if e[1] == "walk")
    log(f"walk kernel [{label}]: K={K} B={B} W={W} seg_base={seg_base}, "
        f"{rec['steps']} steps at most: call {rec['call_ms']:.4f} ms, alone "
        f"{_fmt(rec['ms'])} ms, launch on the host {rec['host_ms']:.4f} ms; "
        f"plain loop {rec['plain_ms']:.3f} ms")
    return rec


def phase_walk(dev):
    """19. The walk's kernel (csrc/walk.cu) against its plain twin,
    ops/engine.walk_segment_ref, on the smoke's streams: while the phase
    runs, every walk_segment call launches the kernel and runs the plain
    loop on the same inputs, and the two must agree to the byte (the ops
    and the five carry fields). The streams: three 4096-pair batches of
    the main stream and the probe batch (one-shot walks at every rung), a
    WavefrontAligner call a metric on each span, a batch of 1 kb pairs run
    segmented (upper segments, their level 0 an alias of the segment
    below), and a batch of the benchmark's ont10k cell: 512 pairs of 10 kb
    from wfabench's generator under the cell's aligner arguments, which
    escalate from a one-shot rung to segmented replays (the cell's upper
    segments, B = 512 and W = 6784 on the card). Then the
    kernel's times (walk_times) at the first 4096-pair walk, at the first
    call's and at the widest upper segment of each segmented batch. Fails
    on a mismatch, on a walk of the plain loop (engine.walk_runs["plain"])
    or on a fault fallback. Returns the records by label: "150 bp batch",
    "a call", "1 kb replay", "10 kb replay"."""
    import os

    import pywfa_tpu_torch
    from pywfa_tpu_torch import BatchWavefrontAligner
    from pywfa_tpu_torch import batch as PB
    from pywfa_tpu_torch.ops import engine as TE
    from wfabench import program as bench_program
    from wfabench import reads as bench_reads
    kernel = TE.walk_segment
    held = collections.Counter()
    shapes = collections.Counter()
    keep = {}

    def checked(cfg, choices, seg_base, carry):
        ops, out = kernel(cfg, choices, seg_base, carry)
        wops, want = TE.walk_segment_ref(cfg, choices, seg_base, carry)
        if not (torch.equal(ops, wops)
                and all(torch.equal(a, b) for a, b in zip(out, want))):
            raise AssertionError(
                f"walk kernel against plain: K, B, W = "
                f"{tuple(choices.shape)}, seg_base {seg_base}, "
                f"{cfg.n_comp} components: differ")
        held["upper" if seg_base else "bottom"] += 1
        shapes[(stage[0], "upper" if seg_base else "bottom")
               + tuple(choices.shape)] += 1
        # the inputs timed: the first walk of a 4096-pair batch and of a
        # call, the widest upper segment of each segmented batch
        label = {"stream": "150 bp batch" if choices.shape[1] == B_MAIN
                 else None, "call": "a call"}.get(stage[0], stage[0])
        if seg_base:
            size = choices.shape[1] * choices.shape[2]
            if label in keep and size < keep[label][0]:
                label = None
        elif label in keep or stage[0] in ("1 kb replay", "10 kb replay"):
            label = None
        if label:
            keep[label] = (choices.shape[1] * choices.shape[2],
                           (cfg, choices, seg_base, carry))
        return ops, out

    stage = ["stream"]
    reset_counts()
    TE.walk_segment = checked
    t0 = time.perf_counter()
    try:
        rng = np.random.default_rng(SEED + 19)
        batches = [make_pairs(rng, B_MAIN, L, DIV) for _ in range(3)]
        aligner = BatchWavefrontAligner(distance="affine", span="end-to-end",
                                        device=dev)
        n = sum(len(r) for r in aligner.align_stream(
            iter(batches + [make_probe(rng)]), depth=3))
        p, q = make_pairs(rng, 1, L, 0.05)
        p, q = p[0].decode(), mutate(rng, q[0], 0.0, 0.04).decode()
        stage[0] = "call"
        for metric in ("affine", "affine2p", "linear", "levenshtein",
                       "indel"):
            for kw in ({"span": "end-to-end"},
                       {"span": "ends-free", "pattern_begin_free": 8,
                        "pattern_end_free": 8, "text_begin_free": 20,
                        "text_end_free": 20}):
                pywfa_tpu_torch.WavefrontAligner(
                    distance=metric, device=dev, **kw)(q, p)
                n += 1
        cap = PB.CHOICES_BYTES_CAP
        PB.CHOICES_BYTES_CAP = 2**21
        try:
            pats = [bytes(np.frombuffer(b"ACGT", np.uint8)[
                rng.integers(0, 4, 1000)]) for _ in range(24)]
            txts = [mutate(rng, x, 0.03, 0.03) for x in pats]
            runs = PB.segmented_runs["runs"]
            stage[0] = "1 kb replay"
            n += len(BatchWavefrontAligner(span="end-to-end", device=dev)
                     .align(pats, txts))
            if PB.segmented_runs["runs"] == runs:
                raise AssertionError("the 1 kb batch did not run segmented")
        finally:
            PB.CHOICES_BYTES_CAP = cap
        # a batch of the ont10k cell, made and aligned as the benchmark's
        # ont10k-full-stream cell does
        bench = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "wfabench")
        with open(os.path.join(bench, "configs", "ont10k.json")) as f:
            config = json.load(f)
        with open(os.path.join(bench, "traffic", "full-stream.json")) as f:
            traffic = json.load(f)
        pats, txts = bench_reads.make_pairs(config["reads"],
                                            config["batch_pairs"], rng)
        runs = PB.segmented_runs["runs"]
        stage[0] = "10 kb replay"
        res = BatchWavefrontAligner(
            device=dev, **bench_program.aligner_kwargs(config, traffic)
        ).align(pats, txts)
        n += len(res)
        if PB.segmented_runs["runs"] == runs or any(r.status for r in res):
            raise AssertionError("the ont10k batch must run segmented and "
                                 "reach every end")
        torch.cuda.synchronize()
    finally:
        TE.walk_segment = kernel
    log(f"walk kernel against plain: {n} pairs, {dict(held)} walks held "
        f"equal to the byte, {time.perf_counter() - t0:.1f} s; walk_runs "
        f"{dict(TE.walk_runs)}; segmented {dict(PB.segmented_runs)}")
    log("walks held by (stage, segment, K, B, W): "
        + ", ".join(f"{k}: {v}" for k, v in sorted(shapes.items())))
    _fault_fallbacks("walk")
    if TE.walk_runs["plain"] or not held["upper"] or not held["bottom"]:
        raise AssertionError(f"the walk phase must run the kernel alone, "
                             f"on bottom and upper segments: "
                             f"{dict(TE.walk_runs)}, {dict(held)}")
    ont = [k for k in shapes if k[:2] == ("10 kb replay", "upper")]
    if not ont or max(k[3] for k in ont) != config["batch_pairs"]:
        raise AssertionError(f"no upper segment of the ont10k batch held: "
                             f"{sorted(shapes)}")
    return {label: walk_times(label, *args)
            for label, (_, args) in sorted(keep.items())}


def main():
    phase_device()
    dev = torch.device("cuda", 0)
    from pywfa_tpu_torch import BatchWavefrontAligner
    attr = BatchWavefrontAligner(span="end-to-end", device=dev)._attr
    long_inputs = make_long_inputs()
    oracles = [start_h_oracle(attr, long_inputs)]
    try:
        oracles += start_long_fuzz_oracles(long_inputs)
        return run_phases(dev, attr, long_inputs)
    finally:
        for oracle in oracles:
            oracle.stop()


def run_phases(dev, attr, long_inputs):
    phase_build()
    records = phase_kernel_vs_plain(attr, dev, long_inputs)
    step_sweep(dev, attr, {"narrow": dict(build="narrow"),
                           "group": dict(build="group")})
    # launches of the main paths only: each phase zeroes the counts before
    # its path and reads them after it
    records.update(phase_long_kernels(dev, long_inputs))
    launches = collections.Counter()
    for phase in (phase_stream, phase_api, phase_new_streams, phase_metrics,
                  phase_slice_streams, phase_slice_api):
        launches.update(phase(dev))
    launches.update(phase_long_reads(dev, long_inputs))
    for phase in (phase_dryrun, phase_sharded):
        t0 = time.perf_counter()
        launches.update(phase(dev, records))
        log(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(phase_cli(dev))
    log(f"phase_cli: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    records.update(phase_chunk_kernels(dev, long_inputs))
    launches.update(phase_chunk_reads(dev, long_inputs, records))
    log(f"phase_chunk: {time.perf_counter() - t0:.1f} s")
    # the checking and measuring tools (15-18): their launches are logged
    # by each phase and kept out of the kernels line, which counts the
    # main paths
    t_tools = time.perf_counter()
    for phase in (phase_fuzz, phase_soak, phase_bench, phase_stage_report):
        t0 = time.perf_counter()
        phase(dev, long_inputs)
        log(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    log(f"phases 15-18: {time.perf_counter() - t_tools:.1f} s")
    t0 = time.perf_counter()
    walk_records = phase_walk(dev)
    log(f"phase_walk: {time.perf_counter() - t0:.1f} s")
    log(f"profiler sessions: {dict(PROFILER_SESSIONS)} (short: fewer "
        "launches of the timed kernel recorded than made; the kernel's "
        "time is then the mean of the launches recorded)")
    nvidia_smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(nvidia_smi)
    log(json.dumps({"kernels": kernel_records(records, launches,
                                               walk_records)}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_records(records, launches, walk_records):
    """One entry a kernel variant for the JSON line: its launches on the
    main paths, and the error, times and bound of the largest shape it was
    held at against its plain version (for the in-place compare, the
    widest segment of batch H's rungs), with the build the main path takes
    at that shape (the build whose time `ms` is) and, on the group build,
    its G. `ms` is the kernel alone by torch.profiler, `call_ms` the call
    by CUDA events. K3's entry: the error over every held shape, the times
    and bound of the shape of at least 1 M cells with the lowest share of
    its bound."""
    from pywfa_tpu_torch.ops import fused_loop
    pallas = "pywfa_tpu/ops/pallas/fused_loop.py"
    # the Pallas lines each variant replaces: the heuristic cascade, the
    # ends-free match seeding, else the kernel body and the score-only
    # call for gap-affine and the metric's branch for the others
    branch = {"": None, "affine2p_": 640, "linear_": 590, "edit_": 569,
              "indel_": 569}
    kernels = []
    # the table variants the long-read paths launch: at least the forward
    # and the replay scope of gap-affine end to end
    table_variants = tuple(v for v in fused_loop.TABLE_VARIANTS
                           if launches[v] or v in ("e2e_table",
                                                   "e2e_score_table"))
    # the in-place compare's variants: those the main paths launched, at
    # least the forward and the replay scope of batch H's rungs
    chunk_variants = tuple(v for v in fused_loop.CHUNK_VARIANTS
                           if launches[v] or v in ("e2e_chunk",
                                                   "e2e_score_chunk"))
    if launches["lcp_table"] == 0:
        raise AssertionError("no main path launched lcp_table")
    held = [r for r in records.values() if r["variant"] == "lcp_table"]
    # the held shape of at least 1 M cells furthest below its bound (a
    # smaller one times the launch)
    timed = min((r for r in held if r["cells"] >= 2**20),
                key=lambda r: r["bound_ms"] / r["ms"])
    kernels.append({
        "name": "lcp_table", "route": "cuda",
        "source": "pywfa_tpu_torch/csrc/lcp_table.cu",
        "replaces": "pywfa_tpu/ops/pallas/lcp_table.py:86",
        "launches": launches["lcp_table"],
        "max_abs_err": max(r["err"] for r in held), "ms": timed["ms"],
        "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
        "bound_by": timed["bound_by"], "library_ms": None,
        "call_ms": timed["call_ms"],
        "ms_is": "call" if timed["ms"] == timed["call_ms"] else "kernel"})
    for variant in fused_loop.VARIANTS + table_variants + chunk_variants:
        if launches[variant] == 0:
            raise AssertionError(f"no main path launched {variant}")
        prefix = next(p for p in sorted(branch, key=len, reverse=True)
                      if variant.startswith(p))
        held = [r for r in records.values() if r["variant"] == variant]
        if not held:
            raise AssertionError(f"{variant} was not held against its plain "
                                 "version")
        # the shape whose times stand for the variant: the first of the
        # largest batches it was held at on a main path's inputs; for the
        # in-place compare, the widest band among the segments held at the
        # shapes a routed run (batch H) launched
        routed = [r for r in held if r.get("routed")]
        if variant in fused_loop.CHUNK_VARIANTS and routed:
            timed = max(routed, key=lambda r: (r["B"], r["W"]))
        else:
            timed = max(held, key=lambda r: r["B"])
        # `ms` the kernel alone (torch.profiler), `call_ms` the call by
        # CUDA events; a call's time stands in only where the profiler
        # recorded no launch of the kernel (`ms_is`)
        alone = timed.get("alone")
        # (a table or a chunk variant is its base variant's instantiation)
        base = variant.removesuffix("_table").removesuffix("_chunk")
        if "_heur" in variant:
            line = 397
        elif "endsfreeseed" in variant:
            line = 720
        else:
            line = branch[prefix] or (919 if base.endswith("_score")
                                      else 197)
        kernels.append({
            "name": f"fused_loop_{variant}", "route": "cuda",
            "source": "pywfa_tpu_torch/csrc/fused_loop.cu",
            "replaces": f"{pallas}:{line}", "launches": launches[variant],
            "max_abs_err": max(r["err"] for r in held),
            "ms": timed["ms"] if alone is None else alone,
            "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": None, "call_ms": timed["ms"],
            "ms_is": "call" if alone is None else "kernel",
            "build": timed.get("build", "general"), "G": timed.get("G")})
    # the walk replaces no TPU kernel (the reference walks with XLA ops);
    # it is bound by latency, a step a dependent load, so its bound is
    # given as the steps of its longest pair; timed at the widest upper
    # segment of the ont10k cell's batch
    if launches["walk"] == 0 or launches["walk_plain"]:
        raise AssertionError("the main paths must walk with the kernel "
                             f"alone: {launches['walk']} launches, "
                             f"{launches['walk_plain']} plain walks")
    timed = walk_records["10 kb replay"]
    kernels.append({
        "name": "walk", "route": "cuda",
        "source": "pywfa_tpu_torch/csrc/walk.cu",
        "replaces": "pywfa_tpu/ops/engine.py:traceback_walk (XLA ops)",
        "launches": launches["walk"], "max_abs_err": 0,
        "ms": timed["call_ms"] if timed["ms"] is None else timed["ms"],
        "plain_ms": timed["plain_ms"], "bound_ms": None,
        "bound_by": f"latency: {timed['steps']} dependent loads a pair",
        "library_ms": None, "call_ms": timed["call_ms"],
        "ms_is": "call" if timed["ms"] is None else "kernel"})
    return kernels


if __name__ == "__main__":
    sys.exit(main())
