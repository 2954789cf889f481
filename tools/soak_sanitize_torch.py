#!/usr/bin/env python
"""Sanitizer-analog stress soak of the PyTorch port (the twin of
tools/soak_sanitize.py).

Runs the reference soak's corpus (24 pairs of 20-200 bp an iteration,
gap-affine, affine2p or gap-linear, end to end or ends-free with frees of
15) through `batch.align_pairs` under every runtime guard the stack
offers:

  - numpy seterr(all='raise'): host-side numeric traps
  - full self-check of every completed CIGAR against the sequences
    (utils.check.check_alignment -- the reference's
    system.check_alignment_correct, wavefront_debug.c:40-119)
  - `batch.oracle_fallbacks` reads 0 for "inconsistent walk" and
    "dropped" (a wrong kernel or walk hiding behind the oracle)
  - on the card, CUDA_LAUNCH_BLOCKING=1 (set here before torch starts
    CUDA), so that a kernel's fault surfaces at its own launch; the
    card's compute-sanitizer does not run there

Usage: python tools/soak_sanitize_torch.py [seed0] [n_iters]
       [--device cuda|cpu]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

np.seterr(all="raise")


def main(argv):
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if device != "cpu":
        # before the first CUDA call of the process
        os.environ["CUDA_LAUNCH_BLOCKING"] = "1"
    seed0 = int(argv[0]) if len(argv) > 0 else 0
    n_iters = int(argv[1]) if len(argv) > 1 else 30
    import random

    from pywfa_tpu_torch import batch as B
    from pywfa_tpu_torch.align import WavefrontAligner
    from pywfa_tpu_torch.utils.check import check_alignment

    for k in B.oracle_fallbacks:
        B.oracle_fallbacks[k] = 0
    checked = 0
    for it in range(n_iters):
        rng = random.Random(seed0 * 1000 + it)
        n = 24
        pairs = []
        for _ in range(n):
            L = rng.randint(20, 200)
            p = "".join(rng.choice("ACGT") for _ in range(L))
            t = []
            for c in p:
                r = rng.random()
                if r < 0.04:
                    continue
                if r < 0.08:
                    t.append(rng.choice("ACGT"))
                t.append(c if rng.random() > 0.1 else rng.choice("ACGT"))
            pairs.append((p, "".join(t) or "A"))
        span = rng.choice(["end-to-end", "ends-free"])
        kw = dict(span=span)
        if span == "ends-free":
            kw.update(pattern_begin_free=15, pattern_end_free=15,
                      text_begin_free=15, text_end_free=15)
        dist = rng.choice(["affine", "affine2p", "linear"])
        attr = WavefrontAligner(backend="numpy", distance=dist,
                                **kw)._attributes()
        res = B.align_pairs(attr, [p.encode() for p, _ in pairs],
                            [t.encode() for _, t in pairs], device=device)
        for (p, t), r in zip(pairs, res):
            if r.status == 0 and r.ops:
                # completed full CIGARs consume both sequences fully
                # (frees are explicit I/D ops)
                check_alignment(r.ops, p, t, attr.penalties,
                                end_v=len(p), end_h=len(t))
                checked += 1
        faults = {k: B.oracle_fallbacks[k]
                  for k in ("inconsistent walk", "dropped")}
        if any(faults.values()):
            raise AssertionError(f"iter {it} ({dist}, {span}): pairs went "
                                 f"to the host oracle: {faults}")
        if (it + 1) % 10 == 0:
            print(f"iter {it + 1}/{n_iters}: {checked} CIGARs "
                  "self-checked under sanitizer guards", flush=True)
    if device != "cpu":
        import torch
        torch.cuda.synchronize()
    print(f"device {device}, CUDA_LAUNCH_BLOCKING="
          f"{os.environ.get('CUDA_LAUNCH_BLOCKING', '')}, oracle fallbacks "
          f"{dict(B.oracle_fallbacks)}")
    print(f"soak_sanitize OK: {n_iters} iters, {checked} CIGARs checked, "
          "no traps fired")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
