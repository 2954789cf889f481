#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; nothing falls back):

1. Device: the card's name and power limit from nvidia-smi, whether the
   native host library loaded; exits nonzero without CUDA.
2. Build: compiles the fused-loop CUDA kernel from the checkout.
3. Kernel against its plain torch version on the card, byte for byte, at
   the main path's shapes: 4096 pairs of 150 bp at 2% divergence at the
   first rung (W=256, S_cap=96) and at W=128, and 256 pairs (64 unrelated)
   at the terminal rung (W=384, S_cap=649); both times by CUDA events.
4. Stream: BatchWavefrontAligner(distance="affine", span="end-to-end",
   device="cuda").align_stream over 16 batches of 4096 pairs (timed:
   alignments/s), then over one probe batch (25% divergence, unrelated
   pairs, an N row, mixed lengths) that escalates up to the terminal rung.
   The kernel's launch count over both must cover every batch and rung,
   every pair must complete, and 512 sampled pairs plus every probe pair
   must equal the scalar oracle in score and CIGAR. Prints the per-stage
   ms/batch measured on one 4096-pair batch.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
B_MAIN = 4096
L = 150
DIV = 0.02
N_BATCHES = 16


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
    from pywfa_tpu import native
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"native host library loaded: {native.lib() is not None}")


def phase_build():
    from pywfa_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    path = cuda_build.build()
    cuda_build.load()
    log(f"build: {time.perf_counter() - t0:.2f} s ({path})")
    if cuda_build.last_build is not None:
        for line in cuda_build.last_build[1].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")


def _device_inputs(cfg, pats, txts, dev):
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
    frees = torch.zeros((len(pats), 4), dtype=torch.int32, device=dev)
    return bits, lens[0], lens[1], frees


def phase_kernel_vs_plain(attr, dev):
    from pywfa_tpu_torch.ops import config as C
    from pywfa_tpu_torch.ops import fused_loop
    rng = np.random.default_rng(SEED + 1)
    main = make_pairs(rng, B_MAIN, L, DIV)
    related = make_pairs(rng, 192, L, DIV)
    unrelated = (make_pairs(rng, 64, L, 0.0)[0],
                 make_pairs(rng, 64, L, 0.0)[0])
    term = (related[0] + unrelated[0], related[1] + unrelated[1])
    shapes = [
        ("rung1", main, C.full_config(attr, 160, 160, W=256, S_cap=96)),
        ("w128", main, C.full_config(attr, 160, 160, W=128, S_cap=96)),
        ("terminal", term, C.full_config(attr, 160, 160)),
    ]
    records = {}
    for name, (pats, txts), cfg in shapes:
        args = _device_inputs(cfg, pats, txts, dev)
        ms = 2**31 - 1
        got = fused_loop.align_batch_fused_loop(cfg, *args, ms)
        want = fused_loop.align_batch_fused_loop_ref(cfg, *args, ms)
        torch.cuda.synchronize()
        err = 0
        for key in ("status", "final_s", "end_k", "end_off", "choices"):
            a, b = got[key], want[key]
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"{name}: {key} {a.shape}/{a.dtype} vs "
                                     f"{b.shape}/{b.dtype}")
            err = max(err, int((a.long() - b.long()).abs().max()))
        status = torch.bincount(got["status"].long(), minlength=6).tolist()
        k_ms = cuda_ms(lambda: fused_loop.align_batch_fused_loop(
            cfg, *args, ms), 20)
        p_ms = cuda_ms(lambda: fused_loop.align_batch_fused_loop_ref(
            cfg, *args, ms), 3)
        log(f"kernel vs plain [{name}] B={len(pats)} W={cfg.W} "
            f"S_cap={cfg.S_cap} steps={int(got['steps'])} "
            f"status_counts={status} max_abs_err={err} "
            f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.2f}")
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from plain version")
        records[name] = (err, k_ms, p_ms)
    return records


def phase_stream(dev):
    from pywfa_tpu.cigar import ops_to_cigarstring
    from pywfa_tpu.oracle import OracleAligner
    from pywfa_tpu_torch import BatchWavefrontAligner
    from pywfa_tpu_torch import batch as PB
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

    fused_loop.launches = 0
    t0 = time.perf_counter()
    results = list(aligner.align_stream(iter(batches), depth=3))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    results += list(aligner.align_stream(iter([probe]), depth=3))
    torch.cuda.synchronize()
    probe_wall = time.perf_counter() - t0
    launches = fused_loop.launches
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
    return launches


def main():
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    from pywfa_tpu_torch import BatchWavefrontAligner
    attr = BatchWavefrontAligner(span="end-to-end", device=dev)._attr
    records = phase_kernel_vs_plain(attr, dev)
    launches = phase_stream(dev)
    err = max(r[0] for r in records.values())
    _, k_ms, p_ms = records["rung1"]
    log(json.dumps({"kernels": [{
        "name": "fused_loop_affine_e2e", "route": "cuda",
        "source": "pywfa_tpu_torch/csrc/fused_loop.cu",
        "replaces": "pywfa_tpu/ops/pallas/fused_loop.py:197",
        "launches": launches, "max_abs_err": err, "ms": k_ms,
        "plain_ms": p_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
