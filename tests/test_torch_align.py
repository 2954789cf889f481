"""pywfa's `WavefrontAligner` on the port against the reference package.

The golden cases of the README examples and of `TestConstruct` run through
`pywfa_tpu_torch.WavefrontAligner(device="cpu")` (the batch pipeline with
the kernels' plain torch versions) and through the reference's
`WavefrontAligner(backend="numpy")` (the scalar oracle); every observable
field must be equal (tolerance zero), and a few cases also run through
the reference's jax backend. The file also covers memory modes and pairs
past 256 bp, property setters, resume after `max_steps` and the
no-CUDA refusal.
"""
import pytest
import torch

import pywfa_tpu
import pywfa_tpu_torch
from pywfa_tpu.constants import STATUS_MAX_STEPS_REACHED

torch.set_num_threads(1)


def _snap(a, res=None):
    """Everything a caller can read after one alignment."""
    out = [a.score, a.status, a.cigarstring, a.cigartuples,
           tuple(a.locations)]
    if res is not None:
        out += [res.pattern_length, res.text_length, res.pattern_start,
                res.pattern_end, res.text_start, res.text_end,
                res.cigartuples, res.score, res.pattern, res.text,
                res.status, res.aligned_pattern, res.aligned_text, str(res),
                repr(res)]
    return out


def sc_readme_basic(make):
    a = make("TCTTTACTCGCGCGTTGGAGAAATACAATAGT")
    score = a.wavefront_align("TCTATACTGCGCGTTTGGAGAAATAAAATAGT")
    assert a.score == score == -24
    assert a.cigarstring == "3M1X4M1D7M1I9M1X6M"
    return [_snap(a)]


def sc_readme_clip(make):
    a = make("AAAAACCTTTTTAAAAAA")
    res = a("GGCCAAAAACCAAAAAA", clip_cigar=False)
    assert pywfa_tpu.cigartuples_to_str(res.cigartuples) == "4I7M5D6M"
    out = [_snap(a, res)]
    res = a("GGCCAAAAACCAAAAAA", clip_cigar=True)
    assert pywfa_tpu.cigartuples_to_str(res.cigartuples) == "4S7M5D6M"
    return out + [_snap(a, res)]


def sc_readme_trim_short_matches(make):
    a = make("AAAAAAAAAAAACCTTTTAAAAAAGAAAAAAA")
    text = "ACCCCCCCCCCCAAAAACCAAAAAAAAAAAAA"
    res = a(text, clip_cigar=False)
    assert res.cigartuples == [(0, 1), (1, 5), (8, 6), (0, 7), (2, 5),
                               (0, 5), (8, 1), (0, 7)]
    out = [_snap(a, res)]
    res = a(text, clip_cigar=True, min_aligned_bases_left=5,
            min_aligned_bases_right=5)
    assert (res.text_start, res.text_end) == (12, 32)
    out.append(_snap(a, res))
    res = a(text, clip_cigar=True, min_aligned_bases_left=5,
            min_aligned_bases_right=5, elide_mismatches=True)
    assert res.cigartuples == [(4, 12), (0, 7), (2, 5), (0, 13)]
    return out + [_snap(a, res)]


def sc_affine(make):
    pattern = "TCTTTACTCGCGCGTTGGAGAAATACAATAGT"
    text = "TCTATACTGCGCGTTTGGAGAAATAAAATAGT"
    a = make(pattern)
    assert a.wavefront_align(text) == -24 and a.status == 0
    out = [_snap(a)]
    a = make()
    res = a(text, pattern, clip_cigar=False)
    assert a.cigarstring == "3M1X4M1D7M1I9M1X6M"
    out.append(_snap(a, res))
    a = make()
    res = a("TCTCCCCATACTGCGCGTTTGGAGAAATAAAA",
            "TCTATACTGCGCGTTTGGAGAAATAAAA", clip_cigar=False)
    return out + [_snap(a, res)]


def sc_scope(make):
    a = make("TCTTTACTCGCGCGTTGGAGAAATACAATAGT", scope="score")
    res = a("TCTATACTGCGCGTTTGGAGAAATAAAATAGT")
    assert (a.status, a.cigarstring, a.score) == (0, "", -24)
    return [_snap(a, res)]


def sc_supress_seqs(make):
    out = []
    for scope, cigar in (("score", ""), ("full", "3M1X4M1D7M1I9M1X6M")):
        a = make("TCTTTACTCGCGCGTTGGAGAAATACAATAGT", scope=scope)
        res = a("TCTATACTGCGCGTTTGGAGAAATAAAATAGT", supress_sequences=True)
        assert res.aligned_pattern is None and res.aligned_text is None
        assert (a.status, a.cigarstring, a.score) == (0, cigar, -24)
        out.append(_snap(a, res))
    return out


def sc_end_to_end(make):
    a = make("AATTAATTTAAGTCTAGGCTACTTTCGGTACTTTGTTCTT", span="end-to-end",
             mismatch=4, gap_opening=6, gap_extension=2)
    res = a("AATTTAAGTCTAGGCTACTTTCGGTACTTTCTT")
    assert a.cigarstring == "4M4D26M3D3M" and res.score == -26
    return [_snap(a, res)]


def sc_ends_free(make):
    a = make("AATTAATTTAAGTCTAGGCTACTTTCGGTACTTTGTTCTT", span="ends-free",
             mismatch=4, gap_opening=6, gap_extension=2)
    res = a("AATTTAAGTCTAGGCTACTTTCGGTACTTTCTT", clip_cigar=True,
            elide_mismatches=True, min_aligned_bases_left=5,
            min_aligned_bases_right=5)
    assert res.aligned_pattern == res.aligned_text
    assert a.cigarstring == "4M4D26M3D3M" and res.score == -26
    return [_snap(a, res)]


def sc_ends_free2(make):
    def A(pattern):
        return make(pattern, span="ends-free", mismatch=4, gap_opening=6,
                    gap_extension=2)

    res = A("AAAAACCTTTTTAAAAAA")("GGCCAAAAACCAAAAAA")
    assert res.text_start == 4 and res.text_end == 17
    out = [_snap(A("AAAAACCTTTTTAAAAAA"), res)]
    res = A("AAAAACCTTTTTAAAAAA")("GGCCAAAAACCGGGGGGG")
    assert res.aligned_pattern == res.aligned_text
    assert res.text_start == 4 and res.text_end == 11
    out.append(_snap(A("AAAAACCTTTTTAAAAAA"), res))
    for pattern, text in [
        ("AAAAACCGGGG", "AAAAACC"),
        ("AAAAACC", "AAAAACCGGGG"),
        ("GGGGAAAAACC", "AAAAACCGGGG"),
        ("AAAAACCGGGG", "GGGGAAAAACC"),
        ("GGGGAAAAACC", "AAAAACC"),
        ("GGGGAAAAACC", "CCCCCAAAAACC"),
        ("GGGGAAAAACCGGGGG", "CCCCCAAAAACCTTTTT"),
        ("AAAAACC", "CCCCCAAAAACCTTTTT"),
    ]:
        a = A(pattern)
        res = a(text)
        assert res.aligned_pattern == res.aligned_text, (pattern, text)
        out.append(_snap(a, res))
    return out


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_readme_basic, sc_readme_clip, sc_readme_trim_short_matches,
    sc_affine, sc_scope, sc_supress_seqs, sc_end_to_end, sc_ends_free,
    sc_ends_free2)}


def _port(pattern=None, **kw):
    return pywfa_tpu_torch.WavefrontAligner(pattern, device="cpu", **kw)


def _ref(backend):
    def make(pattern=None, **kw):
        return pywfa_tpu.WavefrontAligner(pattern, backend=backend, **kw)
    return make


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_golden_cases_match_reference(name):
    assert SCENARIOS[name](_port) == SCENARIOS[name](_ref("numpy"))


@pytest.mark.parametrize("name", ["affine", "scope", "ends_free2"])
def test_golden_cases_match_jax_backend(name):
    assert SCENARIOS[name](_port) == SCENARIOS[name](_ref("jax"))


@pytest.mark.parametrize("kw,item", [
    (dict(memory_mode="low"), "queue 1 item 6"),
    (dict(memory_mode="medium", heuristic="adaptive"), "queue 1 item 6"),
    (dict(memory_mode="biwfa", wildcard="N"), "queue 1 item 6"),
    (dict(heuristic="X-drop", length=300), "queue 1 item 6"),
    (dict(match=-1, length=280), "queue 1 item 6"),
])
def test_off_slice_raises_naming_roadmap(kw, item):
    """What used to be refused under that ROADMAP item runs: memory modes
    other than high, and pairs past 256 bp, whatever else the
    configuration asks for, equal to the reference's oracle."""
    kw = dict(kw)
    reps = kw.pop("length", 10) // 10
    a = _port("ACGTACGTAC" * reps, **kw)
    b = _ref("numpy")("ACGTACGTAC" * reps, **kw)
    text = "ACGTTCGTAC" * reps
    assert _snap(a, a(text)) == _snap(b, b(text))


# pywfa's arguments of this slice, each against the reference's backends
NEW_CONFIGS = {
    "adaptive": dict(heuristic="adaptive"),
    "adaptive-tight": dict(heuristic="adaptive", min_wavefront_length=4,
                           max_distance_threshold=6),
    "xdrop": dict(heuristic="X-drop", xdrop=12),
    "xdrop-2p-score": dict(heuristic="X-drop", xdrop=20,
                           distance="affine2p", scope="score"),
    "match": dict(match=-1),
    "match-frees": dict(match=-2, mismatch=5, gap_opening=7, gap_extension=2,
                        text_begin_free=12, text_end_free=12,
                        pattern_begin_free=3),
    "match-linear-score": dict(match=-1, distance="linear", scope="score",
                               text_begin_free=9, text_end_free=9),
    "wildcard": dict(wildcard="N"),
    "wildcard-e2e": dict(wildcard="N", span="end-to-end",
                         distance="levenshtein"),
    "extension": dict(extension=True),
    "extension-score": dict(extension=True, scope="score"),
}
NEW_PAIRS = [
    ("TCTTTACTCGCGCGTTGGAGAAATACAATAGT", "TCTATACTGCGCGTTTGGAGAAATAAAATAGT"),
    ("AAAAACCTTTTTAAAAAA", "GGCCAAAAACCAAAAAA"),
    ("GGGGAAAAACCGGGGG", "CCCCCAAAAACCTTTTT"),
    ("ACGTNACGTACGTTTGCANACG", "ACGTAACGTACCTTTGCATACG"),
    ("AATTAATTTAAGTCTAGGCTACTTTCGGTACTTTGTTCTT" * 2,
     "AATTTAAGTCTAGGCTACTTTCGGTACTTTCTT" + "GCATGCTAGCTAGGATCCGATCGGATTACA"),
    ("ACGGTCATGCATGCAAGTCGATCGATGCTAGCTAGCTAGTCG",
     "TTGCAGCTAGGCTTAGCGCGATATCGCGATTAGCGCTATAGC"),
]


@pytest.mark.parametrize("name", sorted(NEW_CONFIGS))
def test_new_configurations_match_reference(name):
    """heuristic=, match=, wildcard= and extension= through the card's
    pipeline on the CPU device, against the reference's numpy backend and
    its jax backend."""
    kw = NEW_CONFIGS[name]
    pywfa_tpu_torch.batch.oracle_fallbacks.update(
        dict.fromkeys(pywfa_tpu_torch.batch.oracle_fallbacks, 0))
    for pattern, text in NEW_PAIRS:
        port = _port(pattern, **kw)
        got = _snap(port, port(text))
        assert got == _snap(*(lambda a: (a, a(text)))(
            _ref("numpy")(pattern, **kw)))
        assert got == _snap(*(lambda a: (a, a(text)))(
            _ref("jax")(pattern, **kw)))
    assert not any(pywfa_tpu_torch.batch.oracle_fallbacks.values())


def test_property_setters_then_realign():
    pattern, text = "GGCCAAAAACCAAAAAATT", "AAAAACCTTTTTAAAAAA"
    out = []
    for a in (_port(pattern, check_alignment=True),
              _ref("numpy")(pattern, check_alignment=True)):
        rec = [_snap(a, a(text))]
        a.span = "end-to-end"
        a.mismatch_penalty = 3
        a.gap_opening_penalty = 5
        rec.append(_snap(a, a(text)))
        a.span = "ends-free"
        a.text_begin_free = a.text_end_free = 6
        a.pattern_begin_free = 4
        rec.append(_snap(a, a(text)))
        a.scope = "score"
        rec.append(_snap(a, a(text)))
        out.append(rec)
    assert out[0] == out[1]
    assert out[0][0] != out[0][1] != out[0][2]


@pytest.mark.parametrize("backend", ["auto", "numpy"])
def test_resume_after_max_steps(backend):
    pattern = "TCTTTACTCGCGCGTTGGAGAAATACAATAGT"
    text = "TCTATACTGCGCGTTTGGAGAAATAAAATAGT"
    out = []
    for a in (_port(pattern, max_steps=6, backend=backend),
              _ref("numpy")(pattern, max_steps=6)):
        a(text)
        assert a.status == STATUS_MAX_STEPS_REACHED
        paused = _snap(a)
        a.max_steps = 0
        assert a.wavefront_align_resume() == -24
        out.append([paused, _snap(a)])
    assert out[0] == out[1]
    a = _port(pattern)
    a(text)
    with pytest.raises(ValueError, match="MAX_STEPS_REACHED"):
        a.wavefront_align_resume()


def test_backends_and_devices():
    with pytest.raises(ValueError, match="jax"):
        _port(backend="jax")
    assert _port(backend="torch")("ACGTT", "ACGT").score == -8
    # the numpy backend never touches a device
    assert pywfa_tpu_torch.WavefrontAligner(backend="numpy").wavefront_align(
        "ACGTT", "ACGT") == -8
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pywfa_tpu_torch.WavefrontAligner()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pywfa_tpu_torch.WavefrontAligner("ACGT", backend="torch")


def test_pairs_past_256_bp_raise_naming_roadmap():
    """A 300 bp pair buckets to 512 and its terminal rung to a band of
    1152 diagonals, several a thread: it runs, equal to the oracle."""
    a = _port("ACGT" * 75)
    b = _ref("numpy")("ACGT" * 75)
    assert _snap(a, a("ACGA" * 75)) == _snap(b, b("ACGA" * 75))
    assert a.score == -300
    assert _port("ACGT" * 64)("ACGA" * 64).score == -256
