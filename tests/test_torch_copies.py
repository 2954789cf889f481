"""Each module the port copied from the JAX package, against its original.

The port imports nothing of `pywfa_tpu`, so it keeps its own constants,
attributes, cigar helpers, scalar oracle, sequence encodings, alignment
check, native host library, FASTA/FASTQ reader and length bucketing.
These tests hold every copy against the module it came from on seeded
inputs; everything is an integer, a string or a byte array, tolerance
zero.
"""
import dataclasses
import enum
import io

import numpy as np
import pytest

import pywfa_tpu.attributes as RA
import pywfa_tpu.cigar as RC
import pywfa_tpu.constants as RK
import pywfa_tpu.native as RN
import pywfa_tpu.oracle as RO
import pywfa_tpu.utils.check as RCheck
import pywfa_tpu.utils.encode as REnc
import pywfa_tpu_torch.attributes as PA
import pywfa_tpu_torch.cigar as PC
import pywfa_tpu_torch.constants as PK
import pywfa_tpu_torch.native as PN
import pywfa_tpu_torch.oracle as PO
import pywfa_tpu_torch.utils.check as PCheck
import pywfa_tpu_torch.utils.encode as PEnc
from pywfa_tpu.align import WavefrontAligner as RefAligner
from pywfa_tpu_torch.align import WavefrontAligner as PortAligner
from pywfa_tpu_torch.ops import config as C
from tests.corpus import random_pairs
from tests.test_torch_engine import window_pairs

METRICS = ("affine", "affine2p", "linear", "levenshtein", "indel")
CORPUS = (random_pairs(71, 10, 10, 80, 0.08, 0.05, unrelated=0.2,
                       as_bytes=True)
          + window_pairs(72, 6, 30, 60, 8)
          + [(b"ACGTNACGTACGTTTGCA", b"ACGTAACGTACCTTTGCA"), (b"A", b"T")])


def _public(module):
    return {n: v for n, v in vars(module).items() if not n.startswith("_")}


def test_constants_are_equal_by_name_and_value():
    ref, port = _public(RK), _public(PK)
    assert set(ref) == set(port)
    n_enums = 0
    for name, value in ref.items():
        if isinstance(value, type) and issubclass(value, enum.Enum):
            n_enums += 1
            assert {m.name: m.value for m in value} == {
                m.name: m.value for m in port[name]}
            # IntEnum and IntFlag members compare equal across packages
            assert all(m == port[name][m.name] for m in value)
        elif isinstance(value, (int, str, tuple, dict)):
            assert value == port[name], name
    assert n_enums >= 5


PEN_ARGS = {
    "penalties_indel": [()],
    "penalties_edit": [()],
    "penalties_linear": [(0, 4, 2), (-1, 3, 2)],
    "penalties_affine": [(0, 4, 6, 2), (-2, 5, 4, 1)],
    "penalties_affine2p": [(0, 4, 6, 2, 24, 1), (-1, 4, 6, 2, 24, 1)],
}


@pytest.mark.parametrize("fn", sorted(PEN_ARGS))
def test_penalties_and_scores_match(fn):
    for args in PEN_ARGS[fn]:
        ref = getattr(RA, fn)(*args)
        port = getattr(PA, fn)(*args)
        assert dataclasses.asdict(ref) == dataclasses.asdict(port)
        assert ref.max_score_scope == port.max_score_scope
        rng = np.random.default_rng(73)
        plens = rng.integers(1, 200, 50)
        tlens = rng.integers(1, 200, 50)
        wf = rng.integers(0, 400, 50)
        np.testing.assert_array_equal(
            RA.classic_score_batch(ref, plens, tlens, wf),
            PA.classic_score_batch(port, plens, tlens, wf))
        for a, b, c in zip(plens[:8], tlens[:8], wf[:8]):
            assert RA.classic_score(ref, int(a), int(b), int(c)) == \
                PA.classic_score(port, int(a), int(b), int(c))
    if PEN_ARGS[fn][0]:
        # a positive match score is refused, as in the reference
        for module in (RA, PA):
            with pytest.raises(ValueError, match="Match score"):
                getattr(module, fn)(*([1] * len(PEN_ARGS[fn][0])))


API_KW = [
    dict(),
    dict(distance="affine2p", span="end-to-end", scope="score"),
    dict(distance="linear", match=-1, mismatch=3, gap_extension=2,
         pattern_begin_free=2, text_end_free=9, max_steps=50),
    dict(distance="levenshtein", heuristic="adaptive",
         min_wavefront_length=7, max_distance_threshold=30,
         steps_between_cutoffs=2),
    dict(distance="indel", heuristic="X-drop", xdrop=33, memory_mode="low",
         verbose=0, extension=True),
]


@pytest.mark.parametrize("kw", API_KW, ids=lambda kw: kw.get("distance", "x"))
def test_attributes_carry_across_field_by_field(kw):
    ref = RefAligner(backend="numpy", **kw)._attributes()
    port = PortAligner(backend="numpy", **kw)._attributes()
    carried = C.attributes_from_reference(ref)
    assert carried == port
    assert dataclasses.asdict(carried) == dataclasses.asdict(ref)

    def walk(r, p):
        assert type(p).__module__.startswith("pywfa_tpu_torch."), type(p)
        for f in dataclasses.fields(r):
            rv, pv = getattr(r, f.name), getattr(p, f.name)
            if dataclasses.is_dataclass(rv):
                walk(rv, pv)
                continue
            assert rv == pv, f.name
            if isinstance(rv, enum.Enum):
                assert type(pv).__module__ == "pywfa_tpu_torch.constants"

    walk(ref, carried)
    for plen, tlen in ((40, 55), (150, 150)):
        if kw.get("extension"):
            continue
        assert dataclasses.asdict(RA.validate_alignment(ref, plen, tlen)) == \
            dataclasses.asdict(PA.validate_alignment(port, plen, tlen))


def test_validate_alignment_refuses_the_same():
    kw = dict(pattern_begin_free=50)
    ref = RefAligner(backend="numpy", **kw)._attributes()
    port = PortAligner(backend="numpy", **kw)._attributes()
    with pytest.raises(Exception) as r:
        RA.validate_alignment(ref, 10, 10)
    with pytest.raises(Exception) as p:
        PA.validate_alignment(port, 10, 10)
    assert type(r.value) is type(p.value) and str(r.value) == str(p.value)


ORACLE_FIELDS = ("status", "score", "ops", "end_v", "end_h", "wf_score",
                 "dropped")


@pytest.mark.parametrize("scope", ["full", "score"])
@pytest.mark.parametrize("span", ["end-to-end", "ends-free"])
@pytest.mark.parametrize("metric", METRICS)
def test_oracle_matches_on_a_seeded_corpus(metric, span, scope):
    kw = dict(distance=metric, span=span, scope=scope)
    if span == "ends-free":
        kw.update(pattern_begin_free=1, pattern_end_free=1,
                  text_begin_free=8, text_end_free=8)
    ref = RO.OracleAligner(RefAligner(backend="numpy", **kw)._attributes())
    port = PO.OracleAligner(PortAligner(backend="numpy", **kw)._attributes())
    for p, t in CORPUS:
        if span == "ends-free" and (len(p) < 1 or len(t) < 8):
            continue
        r, q = ref.align(p, t), port.align(p, t)
        assert [getattr(r, f) for f in ORACLE_FIELDS] == \
            [getattr(q, f) for f in ORACLE_FIELDS], (p, t)


@pytest.mark.parametrize("kw", [
    dict(heuristic="adaptive"), dict(heuristic="X-drop", xdrop=10),
    dict(wildcard="N"), dict(max_steps=9),
    dict(distance="affine2p", heuristic="adaptive"),
], ids=str)
def test_oracle_matches_off_the_ported_slice(kw):
    """The oracle is the whole feature surface: heuristics, wildcards and
    the step cap come across too, though the device path refuses them."""
    ref = RefAligner(backend="numpy", span="end-to-end", **kw)
    port = PortAligner(backend="numpy", span="end-to-end", **kw)
    for p, t in CORPUS[:12]:
        ref(t.decode(), p.decode())
        port(t.decode(), p.decode())
        assert (ref.status, ref.score, ref.cigarstring, ref.locations) == (
            port.status, port.score, port.cigarstring, port.locations)


def _ops_corpus():
    attr = RefAligner(backend="numpy", span="end-to-end")._attributes()
    oracle = RO.OracleAligner(attr)
    return [(p.decode(), t.decode(), oracle.align(p, t).ops)
            for p, t in CORPUS[:14]]


def test_cigar_helpers_match():
    pens = [(RA.penalties_affine(0, 4, 6, 2), PA.penalties_affine(0, 4, 6, 2)),
            (RA.penalties_affine2p(0, 4, 6, 2, 24, 1),
             PA.penalties_affine2p(0, 4, 6, 2, 24, 1)),
            (RA.penalties_edit(), PA.penalties_edit()),
            (RA.penalties_linear(-1, 3, 2), PA.penalties_linear(-1, 3, 2))]
    for pattern, text, ops in _ops_corpus():
        assert RC.ops_to_rle(ops) == PC.ops_to_rle(ops)
        assert RC.ops_to_cigartuples(ops) == PC.ops_to_cigartuples(ops)
        assert RC.ops_to_cigarstring(ops) == PC.ops_to_cigarstring(ops)
        assert RC.cigartuples_to_str(RC.ops_to_cigartuples(ops)) == \
            PC.cigartuples_to_str(PC.ops_to_cigartuples(ops))
        for flag in (False, True):
            assert RC.cigar_sprint(ops, flag) == PC.cigar_sprint(ops, flag)
            assert RC.cigar_sprint_sam(ops, flag) == \
                PC.cigar_sprint_sam(ops, flag)
            np.testing.assert_array_equal(RC.cigar_get_sam_u32(ops, flag),
                                          PC.cigar_get_sam_u32(ops, flag))
        for rp, pp in pens:
            assert RC.cigar_score(ops, rp) == PC.cigar_score(ops, pp)
            rc, pc = RC.Cigar(ops=ops), PC.Cigar(ops=ops)
            assert RC.cigar_maxtrim(rc, rp) == PC.cigar_maxtrim(pc, pp)
            assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
        rout, pout = io.StringIO(), io.StringIO()
        RC.cigar_print_pretty_c(RC.Cigar(ops=ops, score=-5), pattern, text,
                                file=rout)
        PC.cigar_print_pretty_c(PC.Cigar(ops=ops, score=-5), pattern, text,
                                file=pout)
        assert rout.getvalue() == pout.getvalue() != ""


def test_check_alignment_and_encodings_match():
    rp, pp = RA.penalties_affine(0, 4, 6, 2), PA.penalties_affine(0, 4, 6, 2)
    for pattern, text, ops in _ops_corpus():
        assert RCheck.check_alignment(ops, pattern, text, rp) == \
            PCheck.check_alignment(ops, pattern, text, pp)
        if "N" in pattern + text:
            continue
        packed = REnc.pack2bits(pattern.encode())
        np.testing.assert_array_equal(packed, PEnc.pack2bits(pattern.encode()))
        assert PEnc.unpack2bits(packed, len(pattern)) == pattern.encode() == \
            REnc.unpack2bits(packed, len(pattern))
    bad = "M" * 3 + "X"
    with pytest.raises(Exception) as r:
        RCheck.check_alignment(bad, "ACGT", "ACGT", rp)
    with pytest.raises(Exception) as p:
        PCheck.check_alignment(bad, "ACGT", "ACGT", pp)
    assert type(r.value) is type(p.value)


def _token_batch(seqs, stride, sentinel):
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    return b"".join(seqs), lens, stride, sentinel


def test_native_library_matches_the_reference_library():
    """The port's g++ build of its own wfa_native.cpp against the JAX
    package's library: fused encode + 2-bit pack, the pack alone, the
    batched match-fill and the run-length encoding."""
    assert PN.lib() is not None and RN.lib() is not None
    assert PN.library_path().endswith(".so")
    assert "build" in PN.library_path().split("/")
    pats = [p for p, _ in CORPUS]
    txts = [t for _, t in CORPUS]
    for seqs, sentinel in ((pats, 1), (txts, 2),
                           ([p for p in pats if b"N" not in p], 1)):
        flat, lens, stride, sent = _token_batch(seqs, 96 + 16, sentinel)
        r = RN.encode_pack_batch(flat, lens, stride, sent, pack_width=96)
        q = PN.encode_pack_batch(flat, lens, stride, sent, pack_width=96)
        np.testing.assert_array_equal(r[0], q[0])
        assert (r[1] is None) == (q[1] is None)
        if r[1] is not None:
            np.testing.assert_array_equal(r[1], q[1])
            np.testing.assert_array_equal(RN.pack2_batch(r[0], lens, 96),
                                          PN.pack2_batch(q[0], lens, 96))
        else:
            assert PN.pack2_batch(q[0], lens, 96) is None
    # match-fill on walk-op streams made here: X / I / D tokens with and
    # without the match-run flag, spread sparsely over 40 score levels
    rng = np.random.default_rng(74)
    B, S = 12, 40
    pat = rng.integers(65, 69, (B, 64)).astype(np.uint8)
    txt = pat.copy()
    txt[:, 20:30] = rng.integers(65, 69, (B, 10))
    ops = np.zeros((B, S), dtype=np.uint8)
    for b in range(B):
        at = np.sort(rng.choice(S, 4, replace=False))
        ops[b, at] = rng.choice([1, 5], 4)  # mismatches only: lengths hold
    lens64 = np.full(B, 64, dtype=np.int64)
    args = (ops, np.full(B, S, dtype=np.int64), np.zeros(B, dtype=np.int64),
            pat, lens64, txt, lens64, np.zeros(B, dtype=np.int64),
            np.zeros(B, dtype=np.int64), -1)
    r, q = RN.match_fill_batch(*args), PN.match_fill_batch(*args)
    np.testing.assert_array_equal(r[1], q[1])
    for b in range(B):
        n = max(int(r[1][b]), 0)
        np.testing.assert_array_equal(r[0][b, :n], q[0][b, :n])
    row = np.frombuffer(b"MMMXMMIIDMMMM", dtype=np.uint8)
    for a, b in zip(RN.rle(row), PN.rle(row)):
        np.testing.assert_array_equal(a, b)


def test_fastx_io_matches(tmp_path):
    """utils/io.py against its original: the records read from FASTA and
    FASTQ, plain and gzipped, and the bytes write_fasta writes."""
    import gzip

    import pywfa_tpu.utils.io as RIO
    import pywfa_tpu_torch.utils.io as PIO
    rng = np.random.default_rng(75)
    recs = [(f"s{i} c{i}" if i % 2 else f"s{i}",
             "".join(rng.choice(list("ACGTN"), int(n))))
            for i, n in enumerate(rng.integers(0, 200, 9))]
    fq = "".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in recs)
    paths = {}
    for name, writer in (("r.fa", RIO.write_fasta), ("p.fa", PIO.write_fasta)):
        paths[name] = str(tmp_path / name)
        writer(paths[name], recs)
    with open(paths["r.fa"], "rb") as a, open(paths["p.fa"], "rb") as b:
        assert a.read() == b.read()
    for name, text in (("x.fq", fq), ("x.fq.gz", fq),
                       ("x.fa.gz", open(paths["r.fa"]).read())):
        paths[name] = str(tmp_path / name)
        with (gzip.open if name.endswith(".gz") else open)(
                paths[name], "wt") as fh:
            fh.write(text)
    for path in paths.values():
        got = [dataclasses.asdict(r) for r in PIO.read_fastx(path)]
        assert got == [dataclasses.asdict(r) for r in RIO.read_fastx(path)]
        assert len(got) == len(recs)
        assert list(PIO.read_fasta(path)) == list(RIO.read_fasta(path))


def test_bucketing_matches():
    """parallel/bucketing.py against its original: the schedule, the
    bucket of every length up to past the schedule, and the groups of a
    seeded set of pairs."""
    import pywfa_tpu.parallel.bucketing as RB
    import pywfa_tpu_torch.parallel.bucketing as PB
    assert PB.DEFAULT_SCHEDULE == RB.DEFAULT_SCHEDULE
    for schedule in (RB.DEFAULT_SCHEDULE, (100, 300), ()):
        for n in list(range(0, 300)) + [65536, 65537, 200000]:
            assert PB._bucket_len(n, schedule) == RB._bucket_len(n, schedule)
    rng = np.random.default_rng(76)
    pats = [b"A" * int(n) for n in rng.integers(1, 3000, 200)]
    txts = [b"C" * int(n) for n in rng.integers(1, 3000, 200)]
    assert PB.bucket_pairs(pats, txts) == RB.bucket_pairs(pats, txts)
    assert PB.bucket_pairs(pats, txts, (512,)) == RB.bucket_pairs(
        pats, txts, (512,))


@pytest.mark.parametrize("name", ["display", "plot"])
def test_display_and_plot_are_copies(name):
    """utils/display.py and utils/plot.py against their originals: the
    source is the original's but for one line of the docstring, the public
    names are the same, and the dense score matrix of seeded pairs is the
    same under every metric (tests/test_torch_utils.py holds the
    renderings byte for byte)."""
    import importlib
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pywfa_tpu", "utils", f"{name}.py")) as fh:
        ref_src = fh.read()
    with open(os.path.join(root, "pywfa_tpu_torch", "utils",
                           f"{name}.py")) as fh:
        port_src = fh.read()
    note = (f"\n\nA copy of `pywfa_tpu/utils/{name}.py`, which the port does "
            "not import.\n")
    assert note in port_src
    assert port_src.replace(note, "\n", 1) == ref_src
    ref = importlib.import_module(f"pywfa_tpu.utils.{name}")
    port = importlib.import_module(f"pywfa_tpu_torch.utils.{name}")
    assert set(_public(ref)) == set(_public(port))
    if name == "display":
        pen_pairs = [(RA.penalties_affine(0, 4, 6, 2),
                      PA.penalties_affine(0, 4, 6, 2)),
                     (RA.penalties_affine2p(0, 4, 6, 2, 24, 1),
                      PA.penalties_affine2p(0, 4, 6, 2, 24, 1)),
                     (RA.penalties_linear(0, 3, 2),
                      PA.penalties_linear(0, 3, 2)),
                     (RA.penalties_edit(), PA.penalties_edit()),
                     (RA.penalties_indel(), PA.penalties_indel())]
        for p, t in CORPUS[:6]:
            for rp, pp in pen_pairs:
                np.testing.assert_array_equal(
                    ref.score_matrix(p.decode(), t.decode(), rp),
                    port.score_matrix(p.decode(), t.decode(), pp))
