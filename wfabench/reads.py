"""The one generator of read pairs: every configuration's `reads` block
names an edit model and its rates, and this module makes the pairs from a
seeded numpy Generator, vectorised. Frozen here so that no change to the
program can move the yardstick.

Edit models:

- "dataset": WFA2-lib's `generate_dataset` (tools/generate_dataset): a
  random ACGT pattern, and a text with int(length * error_rate) edits at
  distinct positions, each a mismatch (another base), an insertion (a random
  base before the position) or a deletion, the kind drawn with equal
  chances.
- "profile": long reads with a published error profile. Each read carries
  round(length * error_rate) edits at distinct positions, split among
  mismatches, insertions and deletions by a multinomial draw at the
  profile's `ratio`, so that texts are longer or shorter than their
  patterns as such reads are. The split of each read comes from a fixed
  stream (`sizes_seed`), not from the run's seed: every `size_set` reads
  hold the same set of splits, and so of text lengths, in an order drawn
  from the seed. Every seed then does the same work, and only which read
  takes which split and where the edits fall changes.
"""
from __future__ import annotations

import numpy as np

ALPHABET = np.frombuffer(b"ACGT", dtype=np.uint8)


def make_pairs(reads: dict, n: int, rng: np.random.Generator) -> tuple:
    """(patterns, texts), two lists of n ASCII byte strings."""
    kind = reads["model"]
    if kind == "dataset":
        return _dataset(rng, n, reads["length"], reads["error_rate"])
    if kind == "profile":
        return _profile(rng, n, reads["length"], reads["error_rate"],
                        reads["ratio"], reads["size_set"],
                        reads["sizes_seed"])
    raise ValueError(f"unknown edit model {kind!r}")


def _rows(out: np.ndarray, take: np.ndarray) -> list:
    """The kept bytes of each row of out [n, L, 2] under take [n, L, 2]."""
    flat = out[take]
    ends = np.cumsum(take.reshape(take.shape[0], -1).sum(axis=1))
    starts = np.concatenate([[0], ends[:-1]])
    data = flat.tobytes()
    return [data[a:b] or b"A" for a, b in zip(starts.tolist(), ends.tolist())]


def _dataset(rng, n, length, error_rate):
    pats = ALPHABET[rng.integers(0, 4, size=(n, length))]
    n_edits = int(length * error_rate)
    pos = _distinct(rng, n, length, n_edits)
    kinds = rng.integers(0, 3, size=(n, n_edits))
    return _apply(rng, pats, pos, kinds)


def _apply(rng, pats, pos, kinds):
    """(patterns, texts) with edit kinds [n, k] (0 mismatch, 1 insertion, 2
    deletion) applied at positions [n, k] of the patterns [n, L]."""
    n, length = pats.shape
    kind_at = np.full((n, length), -1, dtype=np.int64)
    np.put_along_axis(kind_at, pos, kinds, axis=1)
    # a mismatch moves the base by 1-3 places round the alphabet
    codes = np.searchsorted(ALPHABET, pats)
    other = ALPHABET[(codes + rng.integers(1, 4, size=(n, length))) % 4]
    base = np.where(kind_at == 0, other, pats)
    out = np.empty((n, length, 2), dtype=np.uint8)
    out[:, :, 0] = ALPHABET[rng.integers(0, 4, size=(n, length))]
    out[:, :, 1] = base
    take = np.stack([kind_at == 1, kind_at != 2], axis=2)
    return [row.tobytes() for row in pats], _rows(out, take)


def _distinct(rng, n, length, k):
    """k distinct positions in [0, length) for each of n rows: rows that
    drew a position twice draw again."""
    pos = rng.integers(0, length, size=(n, k))
    while k > 1:
        srt = np.sort(pos, axis=1)
        again = np.flatnonzero((srt[:, 1:] == srt[:, :-1]).any(axis=1))
        if again.size == 0:
            break
        pos[again] = rng.integers(0, length, size=(again.size, k))
    return pos


def splits(n_edits, ratio, size_set, sizes_seed) -> np.ndarray:
    """The fixed set of edit splits, int64 [size_set, 3]: mismatches,
    insertions and deletions of each read."""
    p = np.asarray(ratio, dtype=np.float64)
    return np.random.default_rng(sizes_seed).multinomial(
        n_edits, p / p.sum(), size=size_set)


def _profile(rng, n, length, error_rate, ratio, size_set, sizes_seed):
    k = round(length * error_rate)
    fixed = splits(k, ratio, size_set, sizes_seed)
    tiles = -(-n // size_set)
    counts = fixed[np.concatenate([rng.permutation(size_set)
                                   for _ in range(tiles)])[:n]]
    pats = ALPHABET[rng.integers(0, 4, size=(n, length))]
    # distinct positions: the k smallest of a random key a base; the first
    # counts[:, 0] of them mismatches, then insertions, then deletions
    pos = np.argpartition(rng.random((n, length)), k - 1, axis=1)[:, :k]
    at = np.arange(k)[None, :]
    kinds = ((at >= counts[:, :1]).astype(np.int64)
             + (at >= counts[:, :1] + counts[:, 1:2]))
    return _apply(rng, pats, pos, kinds)
