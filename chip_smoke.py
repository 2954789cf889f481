#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; nothing falls back):

1. Device: the card's name and power limit from nvidia-smi, whether the
   native host library built and loaded; exits nonzero without CUDA.
2. Build: compiles both CUDA sources side by side, the run-length table
   (K3) and the fused-loop kernel (52 variants: 5 distance
   metrics x 2 spans x 2 scopes, each with and without the heuristic
   cascade, plus the seeded ends-free span of the 3 metrics with a match
   weight) from the checkout; prints ptxas' registers and spills per
   variant.
3. Each kernel variant against its plain torch version on the card, byte
   for byte, at the main paths' shapes. Gap-affine: end to end with the choice
   record, 4096 pairs of 150 bp at 2% divergence at the first rung
   (W=256, S_cap=96) and at W=128, and 256 pairs (64 unrelated) at the
   terminal rung (W=384, S_cap=649); ends-free with the record, 4096
   150 bp reads in 200 bp windows with text frees of 50 at their first
   rung, and the main pairs with all frees 0; score only, the end-to-end
   rung-1 and terminal sets and the windows; and one WavefrontAligner
   call with pywfa's defaults in both scopes (a 150 bp pair padded to 16
   pairs at Lp = Lt = 256, W=256, S_cap=96). Affine2p, gap-linear, edit
   and indel: the main pairs at each metric's first rung (W=384, 128, 256,
   256) with the record and score only, affine2p at its terminal rung
   (W=512, S_cap=649), the windows under affine2p and edit, and one
   WavefrontAligner call a metric in both scopes. The heuristic and
   seeded variants: gap-affine at the first rung on the pairs of streams
   A, B and C below (wf-adaptive, z-drop, match -1 in windows, and
   wf-adaptive on those windows with and without the match bonus), with
   the record and score only, and under wf-adaptive at the terminal
   rung; affine2p under wf-adaptive at its first rung; and one
   WavefrontAligner call for every heuristic or seeded variant of every
   metric. Each of these shapes launches the narrow kernel (one diagonal
   a thread, no state); the general kernel, which a run that keeps a
   state launches, is held against the same plain result and timed
   beside it. All times by CUDA
   events; beside them the bound, the least time the card could take: the
   eq words read once plus the choice levels these pairs write over 3.35
   TB/s, or the cells these pairs compute times an operation count a cell
   over 67 Tops/s, whichever is larger (the [S_cap, B, W] memset is not
   in it).
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
   of stream F (int16), one with a wildcard, one with B=16 and W=1152. The
   fused loop's table variant against its plain version and against the
   bits variant at that 1 kb shape, as the segments stream F runs (first
   segment from WF0, then a later one from the stored state; the forward
   scope without the record and the replay scope with it), with the times
   of both extensions. The wide-band layouts against plain: W=2176 (a
   thread owns several diagonals, the ring in shared memory) and the
   second rung of 10 kb reads (the ring in global memory) with batch G's
   16 pairs, a later segment from the kernel's own state, each with its
   bound. Then stream E, 4 x 256 pairs of
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
   oracle.

Each main-path phase zeroes the kernels' launch counts and the count of
pairs sent to the host oracle just before it and reads them just after; it
fails unless its kernel variants launched, if a timed stream or an API
phase sent any pair to the oracle, or if any phase did so for an
inconsistent walk. The line before the last is the kernels' JSON record;
the last line is {"ok": true, "device": {...}}.
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
RESUME_STEPS = 200

# the four metrics beside gap-affine, as WavefrontAligner's `distance`
METRICS = ("affine2p", "linear", "levenshtein", "indel")

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
    """Zero the kernels' launch counts (the fused loop's by variant, the
    run-length table's), the count of pairs sent to the host oracle, by
    reason, and the segmented executor's counts."""
    from pywfa_tpu_torch import batch as PB
    from pywfa_tpu_torch.ops import fused_loop, lcp_table
    for counts in (fused_loop.variant_launches, lcp_table.launches,
                   PB.oracle_fallbacks, PB.segmented_runs):
        for k in counts:
            counts[k] = 0


def read_counts():
    from pywfa_tpu_torch.ops import fused_loop, lcp_table
    return dict(fused_loop.variant_launches, **lcp_table.launches)


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


def phase_build():
    from pywfa_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    paths = cuda_build.build()
    for name in paths:
        cuda_build.load(name)
    log(f"build: {time.perf_counter() - t0:.2f} s, both sources side by "
        f"side ({', '.join(sorted(paths.values()))})")
    for lib, (seconds, output) in sorted(cuda_build.last_build.items()):
        log(f"  nvcc {lib}.cu: done after {seconds:.2f} s")
        # one line a kernel: the fused loop's template arguments <metric,
        # span, record, heuristic>, the table's output type
        name = "?"
        spills = ""
        for line in output.splitlines():
            m = re.search(r"fused_loop(_narrow)?ILi(\d)ELi(\d)ELb([01])"
                          r"ELb([01])E", line)
            t = re.search(r"lcp_tableI(\w)E", line)
            if m and "Compiling" in line:
                name = "{}<{}, {}, {}, {}>".format(m.group(1) or "",
                                                   *m.groups()[1:])
            elif t and "Compiling" in line:
                name = "<uint8>" if t.group(1) == "h" else "<int16>"
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line:
                log(f"  ptxas {lib}{name}: "
                    f"{line.split(':', 1)[1].strip()}; {spills}")


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


def rung1_config(attr, pats, txts, wildcard=None):
    """The first rung the batch path picks for these pairs."""
    from pywfa_tpu_torch import batch as PB
    from pywfa_tpu_torch.attributes import validate_alignment
    maxLp = max(map(len, pats))
    maxLt = max(map(len, txts))
    attr0 = validate_alignment(attr, maxLp, maxLt)
    _, cfg, _ = PB._derive_config(attr0, PB._bucket_len(maxLp),
                                  PB._bucket_len(maxLt), min(maxLp, maxLt),
                                  None, None, False, wildcard)
    return cfg


def api_single_inputs(attr, pat, txt):
    """The 16-pair batch and the first-rung config of one WavefrontAligner
    call, as engine_adapter.align_single and batch.align_pairs_dispatch
    build them: power-of-two length buckets, "A"/"A" pad pairs."""
    from pywfa_tpu_torch import batch as PB
    from pywfa_tpu_torch import engine_adapter as EA
    from pywfa_tpu_torch.attributes import validate_alignment
    Lp = EA._bucket_len(len(pat), EA.DEFAULT_SCHEDULE)
    Lt = EA._bucket_len(len(txt), EA.DEFAULT_SCHEDULE)
    attr0 = validate_alignment(attr, len(pat), len(txt))
    pad = PB._bucket_B(1) - 1
    pats, txts = [pat] + [b"A"] * pad, [txt] + [b"A"] * pad
    maxLp, maxLt = max(map(len, pats)), max(map(len, txts))
    attr0 = validate_alignment(PB._clamp_frees(attr0, maxLp, maxLt), maxLp,
                               maxLt)
    _, cfg, _ = PB._derive_config(attr0, max(Lp, PB._bucket_len(maxLp)),
                                  max(Lt, PB._bucket_len(maxLt)),
                                  min(maxLp, maxLt), None, None, False)
    return (pats, txts), cfg


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
    bits = args[0]
    B = bits.shape[1]
    nbytes = (bits.numel() * 4 if ext_bytes is None else ext_bytes)
    nbytes += B * 8 + B * 16 + state_bytes
    if cfg.span == AlignmentSpan.ENDS_FREE:
        nbytes += B * 16
    if cfg.record_choices:
        nbytes += int((out["final_s"] - seg_base).clamp(min=0).sum()) * cfg.W
    ops = cells * OPS_PER_CELL[cfg.n_comp]
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernel_vs_plain(attr, dev):
    from pywfa_tpu_torch.align import WavefrontAligner as RefAligner
    from pywfa_tpu_torch.ops import config as C
    from pywfa_tpu_torch.ops import fused_loop
    rng = np.random.default_rng(SEED + 1)
    main = make_pairs(rng, B_MAIN, L, DIV)
    related = make_pairs(rng, 192, L, DIV)
    unrelated = (make_pairs(rng, 64, L, 0.0)[0],
                 make_pairs(rng, 64, L, 0.0)[0])
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
    records = {}
    for name, (pats, txts), cfg, frees_row in shapes:
        args = _device_inputs(cfg, pats, txts, dev, frees_row)
        ms = MAXS
        got = fused_loop.align_batch_fused_loop(cfg, *args, ms)
        want = fused_loop.align_batch_fused_loop_ref(cfg, *args, ms)
        torch.cuda.synchronize()
        if set(got) != set(want) or ("choices" in got) != cfg.record_choices:
            raise AssertionError(f"{name}: outputs {sorted(got)} vs "
                                 f"{sorted(want)}")
        err = 0
        for key in ("status", "final_s", "end_k", "end_off", "choices"):
            if key not in want:
                continue
            a, b = got[key], want[key]
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"{name}: {key} {a.shape}/{a.dtype} vs "
                                     f"{b.shape}/{b.dtype}")
            err = max(err, int((a.long() - b.long()).abs().max()))
        # the general kernel on the same inputs (a run that keeps a state
        # launches it; without one these shapes launch the narrow kernel)
        st = fused_loop.new_state(cfg, len(pats), dev)

        def general():
            return fused_loop.align_batch_fused_loop(cfg, *args, ms,
                                                     state=st, fresh=True)

        err = max(err, _max_err(name, general(), want, LOOP_KEYS))
        status = torch.bincount(got["status"].long(), minlength=6).tolist()
        k_ms = cuda_ms(lambda: fused_loop.align_batch_fused_loop(
            cfg, *args, ms), 20)
        g_ms = cuda_ms(general, 20)
        del st
        p_ms = cuda_ms(lambda: fused_loop.align_batch_fused_loop_ref(
            cfg, *args, ms), 2)
        rec = got if cfg.record_choices else fused_loop.align_batch_fused_loop(
            dataclasses.replace(cfg, record_choices=True), *args, ms)
        cells = int(torch.count_nonzero(rec["choices"])) + len(pats)
        del rec
        b_ms, b_by = kernel_bound(cfg, args, got, cells)
        log(f"kernel vs plain [{name}] variant={fused_loop.variant(cfg)} "
            f"B={len(pats)} W={cfg.W} S_cap={cfg.S_cap} Lp={cfg.Lp} "
            f"Lt={cfg.Lt} NQ={args[0].shape[0]} "
            f"steps={int(got['steps'])} "
            f"status_counts={status} max_abs_err={err} "
            f"kernel_ms={k_ms:.4f} general_kernel_ms={g_ms:.4f} "
            f"plain_ms={p_ms:.2f} "
            f"bound_ms={b_ms:.3g} bound_by={b_by} cells={cells} "
            f"smem={fused_loop.smem_bytes(cfg)}")
        if err != 0:
            raise AssertionError(f"{name}: the narrow or the general kernel "
                                 "differs from the plain version")
        records[name] = dict(variant=fused_loop.variant(cfg), err=err,
                             ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                             bound_by=b_by, B=len(pats))
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
    cfg = h.cfg
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
        med = ", ".join(f"{cn} {sc}={1e3 * float(np.median(v)):.3f}"
                        for (cn, sc), v in times.items())
        log(f"slice api [{metric}]: {n_calls} calls equal to the oracle; "
            f"median ms/call {med}; launches {launched(c)}")
        total.update(c)
    return total


def make_long_inputs():
    """The pairs of the long-read phases, from the seed: streams E and F
    (N_LONG_BATCHES batches of B_LONG ONT-like 1 kb pairs) and batch G
    (B_G pairs of 10 kb at 5% divergence)."""
    rng = np.random.default_rng(SEED + 8)
    return dict(
        ef=[make_ont_pairs(rng, B_LONG, L_LONG, ONT_SUB, ONT_IND)
            for _ in range(N_LONG_BATCHES)],
        g=make_ont_pairs(rng, B_G, L_G, G_SUB, G_IND))


def rung2_config(attr, pats, txts, B):
    """The second rung the batch path picks for the pairs that pass the
    first (batch.align_pairs_finish's escalation): 4x the score cap, the
    band sized to match, for a batch of B pairs."""
    from pywfa_tpu_torch import batch as PB
    from pywfa_tpu_torch.attributes import validate_alignment
    from pywfa_tpu_torch.ops import config as C
    maxLp, maxLt = max(map(len, pats)), max(map(len, txts))
    attr0 = validate_alignment(attr, maxLp, maxLt)
    Lp, Lt = PB._bucket_len(maxLp), PB._bucket_len(maxLt)
    full, cfg, _ = PB._derive_config(attr0, Lp, Lt, min(maxLp, maxLt), None,
                                     None, False, None)
    next_S = min(cfg.S_cap * 4, full.S_cap)
    next_W = min(full.W, C._round_up(
        max(PB._band_for_score(attr0, next_S, maxLp, maxLt), cfg.W * 2),
        128))
    return PB._derive_config(attr0, Lp, Lt, min(maxLp, maxLt), next_W,
                             next_S, True, None)[1]


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


def phase_long_kernels(dev, long_inputs):
    """K3, the table variants and the wide-band layouts against their
    plain versions (see the module docstring, phase 10)."""
    from pywfa_tpu_torch import BatchWavefrontAligner
    from pywfa_tpu_torch import batch as PB
    from pywfa_tpu_torch.constants import MemoryMode
    from pywfa_tpu_torch.ops import config as C
    from pywfa_tpu_torch.ops import engine as TE
    from pywfa_tpu_torch.ops import fused_loop, lcp_table
    rng = np.random.default_rng(SEED + 9)
    attr = BatchWavefrontAligner(span="end-to-end", device=dev)._attr
    records = {}
    pats1k, txts1k = long_inputs["ef"][0]
    cfg_f = rung2_config(attr, pats1k, txts1k, B_LONG)
    # the segment length stream F runs this rung at
    budget = min(PB.REPLAY_CHOICES_BYTES, PB.CHOICES_BYTES_CAP
                 // PB.MEMORY_MODE_DIVISOR[MemoryMode.ULTRALOW])
    K = max(64, budget // (B_LONG * cfg_f.W))
    if cfg_f.S_cap * B_LONG * cfg_f.W <= budget or K >= cfg_f.S_cap:
        raise AssertionError(f"stream F's second rung {cfg_f.S_cap}x{B_LONG}x"
                             f"{cfg_f.W} would not run in segments")
    cfg_f = dataclasses.replace(cfg_f, S_cap=K, record_choices=False)

    # --- K3 against its plain version ---
    main = make_pairs(rng, B_MAIN, L, DIV)
    wild = make_n_pairs(rng, B_LONG, L, DIV)
    mid = make_ont_pairs(rng, 16, 400, ONT_SUB, ONT_IND)
    shapes = [
        ("lcp_short_u8", main, C.full_config(attr, 160, 160, W=256), -1),
        ("lcp_1kb_i16", (pats1k, txts1k), cfg_f, -1),
        ("lcp_wildcard_u8", wild,
         C.full_config(attr, 160, 160, W=256, wildcard=ord("N")), ord("N")),
        ("lcp_w1152_i16", mid, C.full_config(attr, 512, 512, W=1152), -1),
    ]
    for name, (pats, txts), cfg, wildcard in shapes:
        pat, txt, *_ = _token_rows(cfg, pats, txts, dev)

        def kernel():
            return lcp_table.build_lcp_table_hmajor(cfg.W, cfg.kmin, wildcard,
                                                    pat, txt)

        def plain():
            return lcp_table.build_lcp_table_hmajor_ref(cfg.W, cfg.kmin,
                                                        wildcard, pat, txt)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = _max_err(name, {"R": got}, {"R": want}, ("R",))
        nbytes = got.numel() * got.element_size() + pat.numel() + txt.numel()
        del got, want
        k_ms, p_ms = cuda_ms(kernel, 10), cuda_ms(plain, 1)
        # a cell: the window index, two loads, the compare, the run, a store
        t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
        t_ops = 1e3 * txt.shape[1] * len(pats) * cfg.W * 8 / PEAK_OPS_PER_S
        log(f"kernel vs plain [{name}] kernel=lcp_table B={len(pats)} "
            f"W={cfg.W} Lpp={pat.shape[1]} Ltp={txt.shape[1]} "
            f"wildcard={wildcard} out_bytes={nbytes} max_abs_err={err} "
            f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.2f} "
            f"bound_ms={max(t_bytes, t_ops):.3g} "
            f"bound_by={'bytes' if t_bytes >= t_ops else 'operations'}")
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from plain version")
        records[name] = dict(
            variant="lcp_table", err=err, ms=k_ms, plain_ms=p_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            B=len(pats))

    # --- the table variant against plain and against the bits variant, as
    # the segments of stream F: the forward scope and the replay scope ---
    pat, txt, plen, tlen, frees = _token_rows(cfg_f, pats1k, txts1k, dev)
    table = TE.build_extension(cfg_f, pat, txt)["table"]
    bits = TE.build_eq_bits(cfg_f, pat, txt)
    if table is None:
        raise AssertionError("the 1 kb segmented shape must extend by table")
    for record in (False, True):
        cfg = dataclasses.replace(cfg_f, record_choices=record)
        name = "table_1kb" + ("_replay" if record else "_forward")

        def segment(fn, state, fresh, use_table=True):
            return fn(cfg, None if use_table else bits, plen, tlen, frees,
                      MAXS, table=table if use_table else None, state=state,
                      fresh=fresh, seg_base=0 if fresh else K - 1)

        states = {}
        outs = {}
        err = 0
        for fresh in (True, False):
            for tag, fn, use_table in (
                    ("kernel", fused_loop.align_batch_fused_loop, True),
                    ("plain", fused_loop.align_batch_fused_loop_ref, True),
                    ("bits", fused_loop.align_batch_fused_loop, False)):
                if fresh:
                    states[tag] = fused_loop.new_state(cfg, B_LONG, dev)
                outs[tag] = segment(fn, states[tag], fresh, use_table)
            torch.cuda.synchronize()
            running = outs["kernel"]["status"] == 5
            for other in ("plain", "bits"):
                err = max(err,
                          _max_err(name, outs["kernel"], outs[other],
                                   LOOP_KEYS),
                          _state_err(name, states["kernel"], states[other],
                                     running))
            if fresh and not bool(running.any()):
                raise AssertionError(f"{name}: no pair passes the first "
                                     "segment")
        status = torch.bincount(outs["kernel"]["status"].long(),
                                minlength=6).tolist()
        st = fused_loop.new_state(cfg, B_LONG, dev)
        k_ms = cuda_ms(lambda: segment(fused_loop.align_batch_fused_loop, st,
                                       True), 10)
        b_ms = cuda_ms(lambda: segment(fused_loop.align_batch_fused_loop, st,
                                       True, False), 10)
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
        log(f"kernel vs plain [{name}] variant={variant} B={B_LONG} "
            f"W={cfg.W} K={K} Ltp={table.shape[0]} segments=2 "
            f"status_counts={status} max_abs_err={err} "
            f"kernel_ms={k_ms:.4f} bits_kernel_ms={b_ms:.4f} "
            f"plain_ms={p_ms:.2f} bound_ms={max(t_bytes, t_ops):.3g} "
            f"bound_by={'bytes' if t_bytes >= t_ops else 'operations'} "
            f"cells={cells} threads={fused_loop.block_threads(cfg.W)}")
        if err != 0:
            raise AssertionError(f"{name}: the table variant differs from "
                                 "its plain version or the bits variant")
        records[name] = dict(
            variant=variant, err=err, ms=k_ms, plain_ms=p_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", B=B_LONG)
    del table, bits

    # --- the wide-band layouts against plain ---
    low = BatchWavefrontAligner(span="end-to-end", device=dev)._attr
    pats_g, txts_g = long_inputs["g"]
    cfg_g = dataclasses.replace(rung2_config(low, pats_g, txts_g, B_G),
                                record_choices=False)
    wide = [
        ("wide_2176_shared_ring",
         (pats1k[:8], txts1k[:8]),
         dataclasses.replace(C.full_config(attr, 1024, 1088, W=2176),
                             S_cap=700), 0),
        # the 10 kb rung at batch G's own B: the kernel runs 8 segments of
        # 96 scores, then kernel and plain run one more from copies of
        # that state (G's segments are longer: the plain version is one
        # Python iteration a score)
        ("wide_10kb_global_ring", (pats_g, txts_g),
         dataclasses.replace(cfg_g, S_cap=96), 8),
        ("wide_10kb_global_ring_replay", (pats_g, txts_g),
         dataclasses.replace(cfg_g, S_cap=96, record_choices=True), 8),
    ]
    for name, (pats, txts), cfg, lead in wide:
        pat, txt, plen, tlen, frees = _token_rows(cfg, pats, txts, dev)
        bits = TE.build_eq_bits(cfg, pat, txt)
        in_global = fused_loop.ring_in_global(cfg)
        if in_global != ("global" in name):
            raise AssertionError(f"{name}: ring_in_global={in_global}")
        if lead == 0:
            def kernel():
                return fused_loop.align_batch_fused_loop(
                    cfg, bits, plen, tlen, frees, MAXS)

            got = kernel()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = fused_loop.align_batch_fused_loop_ref(
                cfg, bits, plen, tlen, frees, MAXS)
            torch.cuda.synchronize()
            p_ms = 1e3 * (time.perf_counter() - t0)
            err = _max_err(name, got, want, LOOP_KEYS)
            k_ms = cuda_ms(kernel, 5)
            cells = int(torch.count_nonzero(got["choices"])) + len(pats)
            b_ms, b_by = kernel_bound(cfg, (bits,), got, cells)
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

            def kernel(st=None):
                return fused_loop.align_batch_fused_loop(
                    cfg, bits, plen, tlen, frees, MAXS, state=st or copy(),
                    fresh=False, seg_base=state["s"])

            sk, sp = copy(), copy()
            got = kernel(sk)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = fused_loop.align_batch_fused_loop_ref(
                cfg, bits, plen, tlen, frees, MAXS, state=sp, fresh=False,
                seg_base=state["s"])
            torch.cuda.synchronize()
            p_ms = 1e3 * (time.perf_counter() - t0)
            err = max(_max_err(name, got, want, LOOP_KEYS),
                      _state_err(name, sk, sp, got["status"] == 5))
            k_ms = cuda_ms(kernel, 5)  # with the state's copy
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
        status = torch.bincount(got["status"].long(), minlength=6).tolist()
        log(f"kernel vs plain [{name}] variant={fused_loop.variant(cfg)} "
            f"B={len(pats)} W={cfg.W} S_cap={cfg.S_cap} Lt={cfg.Lt} "
            f"NQ={bits.shape[0]} ring_in_global={in_global} "
            f"threads={fused_loop.block_threads(cfg.W)} "
            f"final_s_max={int(got['final_s'].max())} "
            f"status_counts={status} max_abs_err={err} "
            f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.1f} "
            f"bound_ms={b_ms:.3g} bound_by={b_by} cells={cells}")
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from plain version")
        records[name] = dict(variant=fused_loop.variant(cfg), err=err,
                             ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                             bound_by=b_by, B=len(pats))
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
        total.update(c)
    if list(map(_result_fields, g["low"])) != list(map(_result_fields,
                                                       g["high"])):
        raise AssertionError("batch G under low differs from high")
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
    total.update(c)
    return total


def main():
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    from pywfa_tpu_torch import BatchWavefrontAligner
    attr = BatchWavefrontAligner(span="end-to-end", device=dev)._attr
    records = phase_kernel_vs_plain(attr, dev)
    # launches of the main paths only: each phase zeroes the counts before
    # its path and reads them after it
    long_inputs = make_long_inputs()
    records.update(phase_long_kernels(dev, long_inputs))
    launches = collections.Counter()
    for phase in (phase_stream, phase_api, phase_new_streams, phase_metrics,
                  phase_slice_streams, phase_slice_api):
        launches.update(phase(dev))
    launches.update(phase_long_reads(dev, long_inputs))
    nvidia_smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(nvidia_smi)
    log(json.dumps({"kernels": kernel_records(records, launches)}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_records(records, launches):
    """One entry a kernel variant for the JSON line: its launches on the
    main paths, and the error, times and bound of the largest shape it was
    held at against its plain version."""
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
    if launches["lcp_table"] == 0:
        raise AssertionError("no main path launched lcp_table")
    held = [r for r in records.values() if r["variant"] == "lcp_table"]
    # the shape stream F and the resume phase launch it at
    timed = records["lcp_1kb_i16"]
    kernels.append({
        "name": "lcp_table", "route": "cuda",
        "source": "pywfa_tpu_torch/csrc/lcp_table.cu",
        "replaces": "pywfa_tpu/ops/pallas/lcp_table.py:86",
        "launches": launches["lcp_table"],
        "max_abs_err": max(r["err"] for r in held), "ms": timed["ms"],
        "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
        "bound_by": timed["bound_by"], "library_ms": None})
    for variant in fused_loop.VARIANTS + table_variants:
        if launches[variant] == 0:
            raise AssertionError(f"no main path launched {variant}")
        prefix = next(p for p in sorted(branch, key=len, reverse=True)
                      if variant.startswith(p))
        held = [r for r in records.values() if r["variant"] == variant]
        if not held:
            raise AssertionError(f"{variant} was not held against its plain "
                                 "version")
        # the shape whose times stand for the variant: the first of the
        # largest batches it was held at on a main path's inputs
        timed = max(held, key=lambda r: r["B"])
        # (a table variant is its base variant's instantiation)
        base = variant[:-len("_table")] if variant.endswith("_table") \
            else variant
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
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": None})
    return kernels


if __name__ == "__main__":
    sys.exit(main())
