"""Command-line interface: batch alignment of FASTA/FASTQ read sets on a
CUDA GPU.

    python -m pywfa_tpu_torch.cli align --patterns ref.fa --texts reads.fa \
        [--distance affine] [--span ends-free] [--scope full] \
        [--heuristic adaptive|X-drop] [--out out.tsv] [--format tsv|paf] \
        [--device cuda|cpu]

The twin of `pywfa_tpu/cli.py`, with the same arguments and rows, plus
`--device` (the card by default; "cpu" runs the kernels' plain torch
versions). Pairs are matched by record order (pattern[i] vs text[i], the
reference test-suite convention), grouped into length buckets, and aligned
in batches on the device. Output: one row per pair with name, status,
score, CIGAR, and aligned spans. With --verbose, stderr also gets the
progress, the rate, and a last line "# device: {json}" with the kernels'
launches and the pairs the host oracle answered instead of the device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="pywfa_tpu_torch",
                                 description="wavefront aligner on a CUDA "
                                             "GPU")
    sub = ap.add_subparsers(dest="cmd", required=True)
    al = sub.add_parser("align", help="align paired FASTA/FASTQ files")
    al.add_argument("--patterns", required=True,
                    help="FASTA/FASTQ of pattern (reference) sequences")
    al.add_argument("--texts", required=True,
                    help="FASTA/FASTQ of text (read) sequences")
    al.add_argument("--distance", default="affine",
                    choices=["affine", "affine2p", "linear", "levenshtein",
                             "indel"])
    al.add_argument("--span", default="ends-free",
                    choices=["ends-free", "end-to-end"])
    al.add_argument("--scope", default="full", choices=["full", "score"])
    al.add_argument("--match", type=int, default=0)
    al.add_argument("--mismatch", type=int, default=4)
    al.add_argument("--gap-opening", type=int, default=6)
    al.add_argument("--gap-extension", type=int, default=2)
    al.add_argument("--gap-opening2", type=int, default=24)
    al.add_argument("--gap-extension2", type=int, default=1)
    al.add_argument("--heuristic", default=None,
                    choices=[None, "adaptive", "X-drop"])
    al.add_argument("--memory-mode", default="high",
                    choices=["high", "medium", "low", "biwfa"])
    al.add_argument("--batch-size", type=int, default=2048)
    al.add_argument("--out", default="-")
    al.add_argument("--format", default="tsv", choices=["tsv", "paf"])
    al.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    al.add_argument("--verbose", action="store_true")
    return ap


def _emit_tsv(fh, name_p, name_t, r):
    fh.write(f"{name_t}\t{name_p}\t{r.status}\t{r.score}\t"
             f"{r.cigarstring}\t{r.end_v}\t{r.end_h}\n")


def _emit_paf(fh, name_p, name_t, r, plen, tlen):
    """Minimal PAF: qname qlen qstart qend strand tname tlen tstart tend
    matches alnlen mapq + cg tag."""
    matches = sum(l for op, l in r.cigartuples if op == 0)
    alnlen = sum(l for op, l in r.cigartuples)
    fh.write(f"{name_t}\t{tlen}\t0\t{r.end_h}\t+\t{name_p}\t{plen}\t0\t"
             f"{r.end_v}\t{matches}\t{alnlen}\t255\tAS:i:{r.score}\t"
             f"cg:Z:{r.cigarstring}\n")


def device_counts() -> dict:
    """What the device did in this process so far: the fused loop's
    launches by variant and by build, the run-length table's, the pairs
    the host oracle answered by reason, and the segmented runs."""
    from . import batch
    from .ops import fused_loop, lcp_table
    launches = {k: v for k, v in fused_loop.variant_launches.items() if v}
    launches.update(lcp_table.launches)
    return dict(launches=launches, builds=dict(fused_loop.build_launches),
                oracle_fallbacks=dict(batch.oracle_fallbacks),
                segmented_runs=dict(batch.segmented_runs))


def cmd_align(args) -> int:
    from .batch import BatchWavefrontAligner
    from .parallel.bucketing import bucket_pairs
    from .utils.io import read_fastx

    pats = list(read_fastx(args.patterns))
    txts = list(read_fastx(args.texts))
    if len(pats) != len(txts):
        print(f"error: {len(pats)} patterns vs {len(txts)} texts",
              file=sys.stderr)
        return 2
    kwargs = dict(
        distance=args.distance, span=args.span, scope=args.scope,
        match=args.match, mismatch=args.mismatch,
        gap_opening=args.gap_opening, gap_extension=args.gap_extension,
        gap_opening2=args.gap_opening2, gap_extension2=args.gap_extension2,
        heuristic=args.heuristic, memory_mode=args.memory_mode,
    )
    ba = BatchWavefrontAligner(device=args.device, **kwargs)
    bp = [p.sequence.upper().encode() for p in pats]
    bt = [t.sequence.upper().encode() for t in txts]
    groups = bucket_pairs(bp, bt)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    t0 = time.time()
    n_done = 0
    results = [None] * len(bp)
    # pipelined execution: batches of up to --batch-size per length bucket,
    # several in flight so host CIGAR assembly overlaps device compute
    chunks = []
    for (lp, lt), idxs in sorted(groups.items()):
        for start in range(0, len(idxs), args.batch_size):
            chunk = idxs[start:start + args.batch_size]
            chunks.append(((lp, lt), chunk))

    def gen():
        for (lp, lt), chunk in chunks:
            yield ([bp[i] for i in chunk], [bt[i] for i in chunk],
                   dict(Lp=lp, Lt=lt))

    for ((lp, lt), chunk), rs in zip(chunks, ba.align_stream(gen())):
        for i, r in zip(chunk, rs):
            results[i] = r
        n_done += len(chunk)
        if args.verbose:
            print(f"# bucket ({lp},{lt}): {n_done}/{len(bp)} "
                  f"({n_done/(time.time()-t0):.0f} pairs/s)",
                  file=sys.stderr)
    for i, r in enumerate(results):
        if args.format == "tsv":
            _emit_tsv(out, pats[i].name, txts[i].name, r)
        else:
            _emit_paf(out, pats[i].name, txts[i].name, r,
                      len(bp[i]), len(bt[i]))
    if out is not sys.stdout:
        out.close()
    if args.verbose:
        dt = time.time() - t0
        print(f"# {len(bp)} pairs in {dt:.2f}s ({len(bp)/dt:.0f} pairs/s)",
              file=sys.stderr)
        print(f"# device: {json.dumps(device_counts())}", file=sys.stderr)
    return 0


def main(argv: List[str] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.cmd == "align":
        return cmd_align(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
