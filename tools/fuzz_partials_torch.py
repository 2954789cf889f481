#!/usr/bin/env python
"""Fuzz the PyTorch port's partial, dropped and WF-extension paths against
the scalar oracle (the twin of tools/fuzz_partials.py).

Four composite heuristic strategies (z-drop, x-drop, wf-adaptive with
z-drop, banded-static with z-drop) under three metrics, both spans and
both scopes, on 16 pairs of 30-200 bp a seed, some unrelated, then a
WF-extension run of 8 pairs with random flanks; asserts byte-parity of
(status, score, ops, end_v, end_h, dropped) and counts the pairs the batch
path sent to the oracle, by reason (`batch.oracle_fallbacks`). Run from the
repo root:

    python tools/fuzz_partials_torch.py [seed0] [n_iters] [--device cuda|cpu]

`run` and `run_extension` take the oracle side as an argument
(`reference`: a namespace with `WavefrontAligner`, `HeuristicParams`,
`HeuristicStrategy` and `OracleAligner`), so a test can hold the port
against another package's oracle.
"""
import dataclasses
import functools
import operator
import os
import random
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pywfa_tpu_torch import batch as PB  # noqa: E402
from pywfa_tpu_torch.align import WavefrontAligner  # noqa: E402
from pywfa_tpu_torch.attributes import HeuristicParams  # noqa: E402
from pywfa_tpu_torch.constants import HeuristicStrategy  # noqa: E402
from pywfa_tpu_torch.oracle import OracleAligner  # noqa: E402

PORT = types.SimpleNamespace(WavefrontAligner=WavefrontAligner,
                             HeuristicParams=HeuristicParams,
                             HeuristicStrategy=HeuristicStrategy,
                             OracleAligner=OracleAligner)
FIELDS = ("status", "score", "ops", "end_v", "end_h", "dropped")


def mutate(rng, p, sub, ind):
    t = []
    for c in p:
        r = rng.random()
        if r < ind / 2:
            continue
        if r < ind:
            t.append(rng.choice("ACGT"))
        t.append(c if rng.random() > sub else rng.choice("ACGT"))
    return "".join(t) or "A"


def attributes(ns, distance, kw, strat=None, extension=False):
    """A package's attributes for `kw`, with the heuristic `strat` (a dict:
    the strategy's flag names under "strategy", the other fields as they
    are) and WF-extension."""
    attr = ns.WavefrontAligner(backend="numpy", distance=distance,
                               **kw)._attributes()
    if strat is not None:
        fields = dict(strat)
        flags = functools.reduce(operator.or_, (ns.HeuristicStrategy[n]
                                                for n in fields["strategy"]))
        fields["strategy"] = flags
        attr = dataclasses.replace(attr,
                                   heuristic=ns.HeuristicParams(**fields))
    if extension:
        attr = dataclasses.replace(attr, form=dataclasses.replace(
            attr.form, extension=True))
    return attr


def compare(tag, pairs, res, orc, emit):
    bad = 0
    for i, (p, t) in enumerate(pairs):
        o = orc.align(p.encode(), t.encode())
        b = res[i]
        got = tuple(getattr(b, f) for f in FIELDS)
        want = tuple(getattr(o, f) for f in FIELDS)
        if got != want:
            bad += 1
            emit(f"{tag} i={i}")
            emit(f"  P={p}")
            emit(f"  T={t}")
            emit(f"  got  {got}")
            emit(f"  want {want}")
    return bad


def run(seed, device="cuda", reference=PORT, emit=print):
    rng = random.Random(seed)
    n = 16
    sub = rng.choice([0.05, 0.15, 0.3, 0.5])
    ind = rng.choice([0.02, 0.1, 0.25])
    pairs = []
    for _ in range(n):
        L = rng.randint(30, 200)
        p = "".join(rng.choice("ACGT") for _ in range(L))
        if rng.random() < 0.15:
            # unrelated pair (forces early drops)
            t = "".join(rng.choice("ACGT") for _ in range(rng.randint(30, 200)))
        else:
            t = mutate(rng, p, sub, ind)
        pairs.append((p, t))

    strat = rng.choice([
        dict(strategy=("ZDROP",), zdrop=rng.choice([5, 15, 40]),
             steps_between_cutoffs=rng.choice([1, 2])),
        dict(strategy=("XDROP",), xdrop=rng.choice([5, 15, 40]),
             steps_between_cutoffs=rng.choice([1, 2])),
        dict(strategy=("WFADAPTIVE", "ZDROP"), min_wavefront_length=5,
             max_distance_threshold=20, zdrop=rng.choice([10, 25]),
             steps_between_cutoffs=1),
        dict(strategy=("BANDED_STATIC", "ZDROP"), min_k=-15, max_k=15,
             zdrop=15, steps_between_cutoffs=1),
    ])
    span = rng.choice(["end-to-end", "ends-free"])
    scope = rng.choice(["full", "full", "score"])
    kw = dict(span=span, scope=scope)
    if span == "ends-free":
        kw.update(pattern_begin_free=10, pattern_end_free=10,
                  text_begin_free=10, text_end_free=10)
    distance = rng.choice(["affine", "affine2p", "levenshtein"])
    if distance == "levenshtein":
        strat = dict(strat, strategy=("WFADAPTIVE",), min_wavefront_length=5,
                     max_distance_threshold=20)
    attr = attributes(PORT, distance, kw, strat)
    res = PB.align_pairs(attr, [p.encode() for p, _ in pairs],
                         [t.encode() for _, t in pairs], device=device)
    orc = reference.OracleAligner(attributes(reference, distance, kw, strat))
    return compare(f"MISMATCH seed={seed} strat={strat['strategy']} "
                   f"dist={distance} span={span} scope={scope}", pairs, res,
                   orc, emit)


def run_extension(seed, device="cuda", reference=PORT, emit=print):
    rng = random.Random(seed + 777)
    pairs = []
    for _ in range(8):
        L = rng.randint(30, 150)
        p = "".join(rng.choice("ACGT") for _ in range(L))
        t = mutate(rng, p, 0.2, 0.1)
        # random flank garbage so maxtrim has something to trim
        t = t + "".join(rng.choice("ACGT") for _ in range(rng.randint(0, 40)))
        pairs.append((p, t))
    kw = dict(span="ends-free", pattern_begin_free=0, pattern_end_free=1,
              text_begin_free=0, text_end_free=1)
    attr = attributes(PORT, "affine", kw, extension=True)
    res = PB.align_pairs(attr, [p.encode() for p, _ in pairs],
                         [t.encode() for _, t in pairs], device=device)
    orc = reference.OracleAligner(attributes(reference, "affine", kw,
                                             extension=True))
    return compare(f"EXT MISMATCH seed={seed}", pairs, res, orc, emit)


def fuzz(seed0, iters, device="cuda", reference=PORT, emit=print):
    """Seeds seed0 .. seed0 + iters - 1, both runs each: the mismatches.
    Zeroes batch.oracle_fallbacks first; read it after."""
    for k in PB.oracle_fallbacks:
        PB.oracle_fallbacks[k] = 0
    total_bad = 0
    for s in range(seed0, seed0 + iters):
        total_bad += run(s, device, reference, emit)
        total_bad += run_extension(s, device, reference, emit)
    return total_bad


def main(argv):
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    seed0 = int(argv[0]) if len(argv) > 0 else 0
    iters = int(argv[1]) if len(argv) > 1 else 40
    total_bad = fuzz(seed0, iters, device)
    print(f"done: {iters} iters on {device}, mismatches={total_bad}, "
          f"oracle_fallbacks={dict(PB.oracle_fallbacks)}")
    return 1 if total_bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
