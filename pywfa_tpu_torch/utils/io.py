"""Sequence IO: FASTA/FASTQ reading without external dependencies.

The reference's tests lean on pysam.FastxFile (tests/test.py:4); this module
provides the equivalent reader for streaming read batches into the aligner.
A copy of `pywfa_tpu/utils/io.py`, which the port does not import.
"""
from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple


@dataclass
class FastxRecord:
    name: str
    sequence: str
    comment: Optional[str] = None
    quality: Optional[str] = None


def _open(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path)


def read_fastx(path: str) -> Iterator[FastxRecord]:
    """Stream records from a FASTA or FASTQ file (gzip ok)."""
    with _open(path) as fh:
        first = fh.read(1)
        if not first:
            return
        fh.seek(0)
        if first == ">":
            yield from _read_fasta(fh)
        elif first == "@":
            yield from _read_fastq(fh)
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ")


def _read_fasta(fh) -> Iterator[FastxRecord]:
    name = None
    comment = None
    chunks: List[str] = []
    for line in fh:
        line = line.rstrip("\n")
        if not line:
            continue
        if line.startswith(">"):
            if name is not None:
                yield FastxRecord(name, "".join(chunks), comment)
            header = line[1:]
            parts = header.split(None, 1)
            name = parts[0] if parts else ""
            comment = parts[1] if len(parts) > 1 else None
            chunks = []
        else:
            chunks.append(line)
    if name is not None:
        yield FastxRecord(name, "".join(chunks), comment)


def _read_fastq(fh) -> Iterator[FastxRecord]:
    while True:
        header = fh.readline().rstrip("\n")
        if not header:
            return
        seq = fh.readline().rstrip("\n")
        fh.readline()  # '+'
        qual = fh.readline().rstrip("\n")
        parts = header[1:].split(None, 1)
        yield FastxRecord(parts[0] if parts else "", seq,
                          parts[1] if len(parts) > 1 else None, qual)


def read_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """(name, sequence) pairs from a FASTA file."""
    for rec in read_fastx(path):
        yield rec.name, rec.sequence


def write_fasta(path: str, records) -> None:
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), 80):
                fh.write(seq[i:i + 80] + "\n")
