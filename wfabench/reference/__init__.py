"""The benchmark's plain reference for gap-affine pairwise alignment.

Written from the published recurrences (Gotoh 1982; Marco-Sola et al.,
"Fast gap-affine pairwise alignment using the wavefront algorithm",
Bioinformatics 2021) in NumPy and plain PyTorch. It imports nothing of the
program under test and takes nothing the program made: it reads the
sequences the benchmark generated, and reads the program's answers only to
judge them.

- `dp.affine_costs`: the optimal end-to-end gap-affine cost of many pairs at
  once, row by row (Gotoh), on any torch device.
- `cigar.judge_ops`: checks that an answered op string aligns its pair
  (consumes both sequences, M on equal bases, X on differing ones) and
  scores it.
- `wfa.align`: a scalar wavefront aligner (score, CIGAR and the wavefront
  limits it walked), for tests at small sizes.
"""
