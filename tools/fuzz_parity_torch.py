#!/usr/bin/env python
"""Cross-engine parity fuzzer of the PyTorch port: random configs x random
pairs (the twin of tools/fuzz_parity.py).

Runs `pywfa_tpu_torch.batch.align_pairs` on randomized configurations
(metric, penalties, span, frees, heuristics, match scores, wildcards, step
caps, scopes, memory modes) against the scalar oracle and asserts
byte-equality of (status, score, ops) under the per-pair free-end clamps.
On `cuda` every batch runs a second time on `device="cpu"` (the kernels'
plain torch versions) and every field of every BatchResult must agree, so
the whole card pipeline, kernels and walk included, is held against the
plain one. After every batch `batch.oracle_fallbacks` must still read 0 for
"inconsistent walk" and "dropped". Run from the repo root:

    python tools/fuzz_parity_torch.py [n_iters] [seed] [--device cuda|cpu]

The first mismatch prints a minimal repro dict and exits nonzero.
`run_iter` takes the oracle side as an argument (`reference`: a namespace
with `WavefrontAligner` and `OracleAligner`), so a test can hold the port
against another package's oracle.
"""
import dataclasses
import json
import os
import random
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pywfa_tpu_torch import batch as PB  # noqa: E402
from pywfa_tpu_torch.align import WavefrontAligner  # noqa: E402
from pywfa_tpu_torch.oracle import OracleAligner  # noqa: E402

# the oracle side by default: the port's own copy of the scalar oracle
PORT = types.SimpleNamespace(WavefrontAligner=WavefrontAligner,
                             OracleAligner=OracleAligner)

# the fallbacks that mean a wrong kernel or walk hid behind the oracle
FAULTS = ("inconsistent walk", "dropped")


def rand_seq(rng, n):
    return "".join(rng.choice("ACGTN") if rng.random() < 0.02
                   else rng.choice("ACGT") for _ in range(n))


def mutate(rng, seq, sub, ind):
    out = []
    for c in seq:
        r = rng.random()
        if r < ind / 2:
            continue
        if r < ind:
            out.append(rng.choice("ACGT"))
        out.append(c if rng.random() > sub else rng.choice("ACGT"))
    return "".join(out) or "A"


def random_config(rng):
    distance = rng.choice(["affine", "affine", "affine", "affine2p",
                           "linear", "levenshtein", "indel"])
    kw = dict(distance=distance)
    kw["span"] = rng.choice(["end-to-end", "ends-free", "ends-free"])
    if distance in ("affine", "affine2p", "linear"):
        kw["mismatch"] = rng.randint(1, 8)
        kw["gap_extension"] = rng.randint(1, 4)
        if distance != "linear":
            kw["gap_opening"] = rng.randint(0, 12)
        if distance == "affine2p":
            kw["gap_opening2"] = rng.randint(10, 40)
            kw["gap_extension2"] = rng.randint(1, 2)
        if rng.random() < 0.25 and distance != "linear":
            kw["match"] = -rng.randint(1, 3)
    if kw["span"] == "ends-free" and rng.random() < 0.6:
        kw["pattern_begin_free"] = rng.randint(0, 20)
        kw["pattern_end_free"] = rng.randint(0, 20)
        kw["text_begin_free"] = rng.randint(0, 20)
        kw["text_end_free"] = rng.randint(0, 20)
    if rng.random() < 0.25 and distance in ("affine", "affine2p", "linear"):
        kw["heuristic"] = rng.choice(["adaptive", "X-drop"])
        kw["min_wavefront_length"] = rng.randint(1, 15)
        kw["max_distance_threshold"] = rng.randint(5, 60)
        kw["steps_between_cutoffs"] = rng.randint(1, 4)
        kw["xdrop"] = rng.randint(5, 40)
    if rng.random() < 0.1:
        kw["wildcard"] = "N"
    if rng.random() < 0.1:
        kw["max_steps"] = rng.randint(3, 50)
    if rng.random() < 0.2:
        kw["scope"] = "score"
    kw["memory_mode"] = rng.choice(["high", "high", "medium", "low", "biwfa"])
    return kw


def random_pairs(rng):
    n = rng.randint(2, 10)
    pairs = []
    for _ in range(n):
        mode = rng.random()
        if mode < 0.6:
            p = rand_seq(rng, rng.randint(2, 150))
            t = mutate(rng, p, rng.uniform(0, 0.25), rng.uniform(0, 0.15))
        elif mode < 0.8:
            p = rand_seq(rng, rng.randint(2, 100))
            t = rand_seq(rng, rng.randint(2, 100))
        else:
            base = rand_seq(rng, rng.randint(5, 60))
            p = rand_seq(rng, rng.randint(0, 10)) + base
            t = base + rand_seq(rng, rng.randint(0, 10))
        pairs.append((p, t))
    return pairs


def clamped(attr, p, t):
    """`attr` with the ends-free slack clamped to one pair, as the batch
    path clamps it per pair (C would abort the process)."""
    f = attr.form
    return dataclasses.replace(attr, form=dataclasses.replace(
        f,
        pattern_begin_free=min(f.pattern_begin_free, len(p)),
        pattern_end_free=min(f.pattern_end_free, len(p)),
        text_begin_free=min(f.text_begin_free, len(t)),
        text_end_free=min(f.text_end_free, len(t))))


def check_fallbacks(where):
    """A repro dict if a fault fallback was counted, else None."""
    bad = {k: PB.oracle_fallbacks[k] for k in FAULTS if PB.oracle_fallbacks[k]}
    if bad:
        return dict(where, oracle_fallbacks=dict(PB.oracle_fallbacks))
    return None


def check_pairs(kw, wc, pairs, batch, reference, where):
    """Hold one batch's results against the oracle of `reference` (the
    wildcard byte `wc`); a repro dict for the first pair that differs,
    else None."""
    attr = reference.WavefrontAligner(backend="numpy", **kw)._attributes()
    for i, (p, t) in enumerate(pairs):
        o = reference.OracleAligner(clamped(attr, p, t), wc).align(
            p.encode(), t.encode())
        b = batch[i]
        if (b.status, b.score, b.ops) != (o.status, o.score, o.ops):
            return dict(where, pattern=p, text=t,
                        engine=[b.status, b.score, b.ops],
                        oracle=[o.status, o.score, o.ops])
    return None


def run_iter(rng, it, device="cuda", reference=PORT):
    """One random configuration and batch: None if it held, else a
    minimal repro dict."""
    kw = random_config(rng)
    pairs = random_pairs(rng)
    api = WavefrontAligner(backend="numpy", **kw)
    attr = api._attributes()
    wc = api._bwildcard if api._wildcard else None
    bp = [p.encode() for p, _ in pairs]
    bt = [t.encode() for _, t in pairs]
    where = {"iter": it, "device": device, "kw": kw}
    try:
        batch = PB.align_pairs(attr, bp, bt, wildcard=wc, device=device)
    except Exception:
        print(f"ENGINE EXCEPTION {json.dumps(where)}")
        print("pairs:", pairs)
        raise
    bad = (check_fallbacks(where)
           or check_pairs(kw, wc, pairs, batch, reference, where))
    if bad is None and device != "cpu":
        plain = PB.align_pairs(attr, bp, bt, wildcard=wc, device="cpu")
        for i, (b, c) in enumerate(zip(batch, plain)):
            if b != c:
                field = next(f.name for f in dataclasses.fields(b)
                             if getattr(b, f.name) != getattr(c, f.name))
                bad = dict(where, pattern=pairs[i][0], text=pairs[i][1],
                           field=field, card=dataclasses.astuple(b),
                           plain=dataclasses.astuple(c))
                break
        bad = bad or check_fallbacks(dict(where, side="cpu"))
    return bad


def run(iters, seed, device="cuda", reference=PORT, emit=print):
    """`iters` iterations from `seed`: (iterations that held, the first
    repro dict or None). Zeroes batch.oracle_fallbacks first."""
    for k in PB.oracle_fallbacks:
        PB.oracle_fallbacks[k] = 0
    rng = random.Random(seed)
    t0 = time.perf_counter()
    for it in range(iters):
        bad = run_iter(rng, it, device, reference)
        if bad is not None:
            emit("MISMATCH " + json.dumps(bad))
            return it, bad
        if (it + 1) % 20 == 0:
            emit(f"... {it + 1}/{iters} ok, "
                 f"{time.perf_counter() - t0:.1f} s, oracle fallbacks "
                 f"{dict(PB.oracle_fallbacks)}")
    return iters, None


def main(argv):
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    iters = int(argv[0]) if len(argv) > 0 else 200
    seed = int(argv[1]) if len(argv) > 1 else 0
    done, bad = run(iters, seed, device)
    print(f"DONE {iters} iters on {device}, {0 if bad is None else 1} "
          f"failures, oracle fallbacks {dict(PB.oracle_fallbacks)}")
    return 1 if bad is not None else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
