"""The port's command line, on the CPU: the twins of tests/test_cli.py
with `--device cpu`, and the output files of `pywfa_tpu_torch.cli` held
byte for byte against `pywfa_tpu.cli`'s on a probe set (a lowercase
read, a read with N, mixed lengths over three length buckets), in tsv and
paf, under two distance metrics."""
import numpy as np
import pytest

from pywfa_tpu import cli as ref_cli
from pywfa_tpu_torch.cli import main
from pywfa_tpu_torch.parallel.bucketing import bucket_pairs
from pywfa_tpu_torch.utils.io import write_fasta


def test_cli_align_tsv(tmp_path):
    pfa = str(tmp_path / "p.fa")
    tfa = str(tmp_path / "t.fa")
    write_fasta(pfa, [("p1", "TCTTTACTCGCGCGTTGGAGAAATACAATAGT"),
                      ("p2", "ACGTACGT")])
    write_fasta(tfa, [("t1", "TCTATACTGCGCGTTTGGAGAAATAAAATAGT"),
                      ("t2", "ACGTACGT")])
    out = str(tmp_path / "out.tsv")
    rc = main(["align", "--patterns", pfa, "--texts", tfa,
               "--span", "ends-free", "--out", out, "--device", "cpu"])
    assert rc == 0
    lines = open(out).read().splitlines()
    assert len(lines) == 2
    f0 = lines[0].split("\t")
    assert f0[0] == "t1" and f0[2] == "0" and f0[3] == "-24"
    assert f0[4] == "3M1X4M1D7M1I9M1X6M"
    f1 = lines[1].split("\t")
    assert f1[3] == "0" and f1[4] == "8M"


def test_cli_align_paf(tmp_path):
    pfa = str(tmp_path / "p.fa")
    tfa = str(tmp_path / "t.fa")
    write_fasta(pfa, [("p1", "ACGTACGTAAACGT")])
    write_fasta(tfa, [("t1", "ACGTACGTAATCGT")])
    out = str(tmp_path / "out.paf")
    rc = main(["align", "--patterns", pfa, "--texts", tfa,
               "--span", "end-to-end", "--format", "paf", "--out", out,
               "--device", "cpu"])
    assert rc == 0
    f = open(out).read().split("\t")
    assert f[0] == "t1" and "cg:Z:10M1X3M" in "\t".join(f)


def _mutate(rng, p, rate):
    out = bytearray()
    for c in p:
        r = rng.random()
        if r < rate / 3:
            continue                                  # deletion
        if r < 2 * rate / 3:
            out.append(b"ACGT"[rng.integers(4)])      # insertion
        out.append(b"ACGT"[rng.integers(4)] if r > 1 - rate / 3 else c)
    return bytes(out)


def probe_set(seed=0):
    """(patterns, texts) as (name, sequence) records: mutated pairs at
    about 40, 100 and 200 bp (three length buckets), a lowercase read and
    a read with an N."""
    rng = np.random.default_rng(seed)
    pats, txts = [], []
    for length in [40, 45, 100, 110, 190, 200] * 2:
        p = bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4,
                                                               length)])
        pats.append(p)
        txts.append(_mutate(rng, p, 0.06))
    p = pats[2]
    pats.append(p)
    txts.append(_mutate(rng, p, 0.03).lower())
    p = pats[4]
    pats.append(p[:60] + b"N" + p[61:])
    txts.append(_mutate(rng, p, 0.03))
    names = range(len(pats))
    return ([(f"p{i}", s.decode()) for i, s in zip(names, pats)],
            [(f"t{i} read {i}", s.decode()) for i, s in zip(names, txts)])


@pytest.mark.parametrize("distance", ["affine", "levenshtein"])
def test_output_files_equal_the_reference_cli(tmp_path, distance):
    pats, txts = probe_set()
    groups = bucket_pairs([s.upper().encode() for _, s in pats],
                          [s.upper().encode() for _, s in txts])
    assert len(groups) >= 3
    pfa, tfa = str(tmp_path / "p.fa"), str(tmp_path / "t.fa")
    write_fasta(pfa, pats)
    write_fasta(tfa, txts)
    for fmt in ("tsv", "paf"):
        args = ["align", "--patterns", pfa, "--texts", tfa, "--distance",
                distance, "--format", fmt, "--batch-size", "8"]
        ref_out = str(tmp_path / f"ref.{fmt}")
        port_out = str(tmp_path / f"port.{fmt}")
        assert ref_cli.main(args + ["--out", ref_out]) == 0
        assert main(args + ["--out", port_out, "--device", "cpu"]) == 0
        with open(ref_out, "rb") as fh:
            ref = fh.read()
        with open(port_out, "rb") as fh:
            assert fh.read() == ref
        rows = ref.decode().splitlines()
        assert len(rows) == len(pats)
        # every row names its read first; the tsv's third field is status 0
        assert all(r.startswith("t") for r in rows)
        if fmt == "tsv":
            assert {r.split("\t")[2] for r in rows} == {"0"}
