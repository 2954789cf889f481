"""The port's utils on the CPU: FASTA / FASTQ reading and writing (the
twins of tests/test_utils.py's IO tests, plus gzip input); the wavefront
plot and the debug display (twins of its plot and display tests, each
rendering byte-equal to the reference's on the same inputs); and the
sanitizer soak's smoke run."""
import gzip
import io
import os
import subprocess
import sys

import numpy as np
import pytest

import pywfa_tpu.utils.display as RD
import pywfa_tpu.utils.plot as RP
import pywfa_tpu_torch.utils.display as PD
import pywfa_tpu_torch.utils.plot as PP
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


def _same_plot(ref, port):
    """Two WavefrontPlots hold the same records and render the same bytes:
    every grid, every text heatmap, print_plot's sections."""
    assert len(ref.steps) == len(port.steps)
    for a, b in zip(ref.steps, port.steps):
        assert a[:3] == b[:3]
        np.testing.assert_array_equal(a[3], b[3])
    for comp in ("M", "I1", "D1", "I2", "D2"):
        np.testing.assert_array_equal(ref.to_grid(comp), port.to_grid(comp))
        assert ref.to_text(comp) == port.to_text(comp)
    np.testing.assert_array_equal(ref.behavior_grid(), port.behavior_grid())
    rout, pout = io.StringIO(), io.StringIO()
    ref.print_plot(rout)
    port.print_plot(pout)
    assert rout.getvalue() == pout.getvalue() != ""
    return pout.getvalue()


def test_plot(tmp_path):
    args = ("TCTTTACTCGCGCGTTGGAGAAATACAATAGT",
            "TCTATACTGCGCGTTTGGAGAAATAAAATAGT")
    p = PP.plot_alignment(*args, span="end-to-end")
    assert len(p.steps) > 5
    txt = p.to_text()
    assert "." in txt or any(c.isdigit() for c in txt)
    assert (p.to_grid() >= 0).any()
    _same_plot(RP.plot_alignment(*args, span="end-to-end"), p)
    paths = [str(tmp_path / n) for n in ("r.tsv", "p.tsv")]
    RP.plot_alignment(*args, span="end-to-end").save_tsv(paths[0])
    p.save_tsv(paths[1])
    assert open(paths[0]).read() == open(paths[1]).read()


def test_plot_components_affine2p():
    # a 12-base deletion engages the gap2 components (score reaches past
    # o2+e2=25, so I2/D2 wavefronts materialize)
    args = ("TCTTTACTCGCGCGTTGGAGAAATACAATAGTCCGGTTAA",
            "TCTATACTGCGCGTTTGGAGTCCGGTTAG")
    p = PP.plot_alignment(*args, span="end-to-end", distance="affine2p")
    for comp in ("I1", "D1", "I2", "D2"):
        assert len(p.comp_steps[comp]) > 0, comp
    assert (p.to_grid("I1") >= 0).any()
    assert (p.to_grid("D1") >= 0).any()
    bg = p.behavior_grid()
    assert (bg == 1).any() and (bg == 2).any()
    out = _same_plot(RP.plot_alignment(*args, span="end-to-end",
                                       distance="affine2p"), p)
    for section in ("# Heatmap M", "# Heatmap I1", "# Heatmap D2",
                    "# Heatmap Behavior"):
        assert section in out


def test_plot_edit_metric_m_only():
    args = ("ACGTACGTAC", "ACGTTCGTAC")
    p = PP.plot_alignment(*args, distance="levenshtein")
    assert len(p.steps) > 0
    assert all(not v for v in p.comp_steps.values())
    assert (p.to_grid("M") >= 0).any()
    _same_plot(RP.plot_alignment(*args, distance="levenshtein"), p)


@pytest.mark.parametrize("distance", ["affine", "affine2p", "levenshtein"])
def test_print_wavefronts_display(distance):
    """Wavefront-contents debug dump (reference: wavefront_display.c) and
    the dense score matrix with the path marked, byte-equal to the
    reference's renderings."""
    from pywfa_tpu.align import WavefrontAligner as RefAligner
    from pywfa_tpu.oracle import OracleAligner as RefOracle
    from pywfa_tpu_torch.align import WavefrontAligner
    from pywfa_tpu_torch.oracle import OracleAligner
    pair = (b"TCTTTACTCGCGCGTT", b"TCTATACTGCGCGTT")
    outs = []
    for aligner, oracle, display in ((RefAligner, RefOracle, RD),
                                     (WavefrontAligner, OracleAligner, PD)):
        attr = aligner(backend="numpy", distance=distance)._attributes()
        orc = oracle(attr, keep_wavefronts=True)
        r = orc.align(*pair)
        buf = io.StringIO()
        display.print_wavefronts(orc.last_run, 0, r.wf_score, file=buf)
        display.print_score_matrix(pair[0].decode(), pair[1].decode(),
                                   attr.penalties, ops=r.ops, file=buf)
        outs.append((buf.getvalue(), display.score_matrix(
            pair[0].decode(), pair[1].decode(), attr.penalties)))
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    outs = [o for o, _ in outs]
    assert outs[0] == outs[1]
    out = outs[1]
    assert ">[SCORE 0-" in out and " M " in out
    if distance != "levenshtein":
        assert " I1 " in out and " D1 " in out
    assert "[ 3]" in out  # WF0 extended seed on k=0
    assert "*" in out


def test_sanitizer_soak_smoke():
    # the sanitizer-analog soak (tools/soak_sanitize_torch.py), 2 quick
    # iterations on the CPU so CI exercises the guard combination
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "soak_sanitize_torch.py"),
         "1", "2", "--device", "cpu"], capture_output=True, timeout=500,
        cwd=repo)
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    assert b"no traps fired" in out.stdout
    assert out.stdout.strip().splitlines()[-1].startswith(
        b"soak_sanitize OK: 2 iters,")
