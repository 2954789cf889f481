"""The port's utils on the CPU: FASTA / FASTQ reading and writing (the
twins of tests/test_utils.py's IO tests, plus gzip input)."""
import gzip

import pytest

from pywfa_tpu_torch.utils import read_fasta, read_fastx, write_fasta


def test_fasta_io(tmp_path):
    path = str(tmp_path / "x.fa")
    write_fasta(path, [("s1", "ACGT" * 30), ("s2 extra", "TTTT")])
    recs = list(read_fasta(path))
    assert recs[0][1] == "ACGT" * 30
    assert len(recs) == 2


def test_fastq_io(tmp_path):
    path = str(tmp_path / "x.fq")
    with open(path, "w") as fh:
        fh.write("@r1 comment\nACGT\n+\nIIII\n@r2\nTTGG\n+\n!!!!\n")
    recs = list(read_fastx(path))
    assert recs[0].name == "r1" and recs[0].sequence == "ACGT"
    assert recs[0].quality == "IIII"
    assert recs[1].name == "r2"


@pytest.mark.parametrize("kind", ["fasta", "fastq"])
def test_gzip_input(tmp_path, kind):
    """A .gz suffix is read through gzip, FASTA or FASTQ alike; a FASTA
    record's lines are joined and its header split into name and
    comment."""
    path = str(tmp_path / f"x.{kind}.gz")
    text = (">r1 first read\nACGT\nTTGA\n>r2\nGG\n" if kind == "fasta"
            else "@r1 first read\nACGTTTGA\n+\nIIIIIIII\n@r2\nGG\n+\n!!\n")
    with gzip.open(path, "wt") as fh:
        fh.write(text)
    recs = list(read_fastx(path))
    assert [(r.name, r.sequence, r.comment) for r in recs] == [
        ("r1", "ACGTTTGA", "first read"), ("r2", "GG", None)]
    assert recs[0].quality == (None if kind == "fasta" else "IIIIIIII")


def test_not_fastx_is_refused(tmp_path):
    path = str(tmp_path / "x.txt")
    with open(path, "w") as fh:
        fh.write("ACGT\n")
    with pytest.raises(ValueError, match="not FASTA/FASTQ"):
        list(read_fastx(path))
    empty = str(tmp_path / "empty.fa")
    open(empty, "w").close()
    assert list(read_fastx(empty)) == []
