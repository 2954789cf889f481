"""The fused loop's in-place compare against its bits extension and the
JAX engine's chunked extension.

The plain torch version of the fused loop, extending by comparing the
token rows in place (`engine.extend_mode` "chunk"), must give the same
result dict, choice bytes included, as the same loop extending by the
packed equality words, for the five distance metrics, both spans, one
heuristic, the seeded span, a wildcard and a registered match class; and
the same status, score, end cell and choices as
`pywfa_tpu.ops.engine.align_batch` forced to its chunked compare
(`extend_force="chunk"`, the XLA `_extend_band`). Segments carry the same
state; `EQ_BITS_BYTES_CAP` and PYWFA_EXTEND=chunk route to the compare
with the same results; `memory_estimate` counts the tensors that
`build_extension` and `fused_loop.new_state` make. Tolerance: zero
(integers).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pywfa_tpu import attributes as RA
from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.batch import PATTERN_SENTINEL, TEXT_SENTINEL, encode_batch
from pywfa_tpu.ops import engine as E
from pywfa_tpu_torch import attributes as PA
from pywfa_tpu_torch import batch as PB
from pywfa_tpu_torch.ops import config as C
from pywfa_tpu_torch.ops import engine as TE
from pywfa_tpu_torch.ops import fused_loop as TFL
from tests.corpus import random_pairs
from tests.test_torch_segmented import _attr, _key, _segmented_case
from tests.test_torch_table_extend import CONFIGS, PAIRS

torch.set_num_threads(1)

MAXS = 2**31 - 1
KEYS = ("status", "final_s", "end_k", "end_off", "choices")
# a class table is registered per package, under one name in both
PURINES = {"A": "R", "G": "R", "C": "Y", "T": "Y", "N": "RY"}
RA.register_match_classes("purine_pyrimidine", PURINES)
PA.register_match_classes("purine_pyrimidine", PURINES)


def _ambiguous_pairs(seed, n=10, codes=b"NRY"):
    """Pairs of 40-110 bp at 8% divergence with ambiguity codes on both
    sides."""
    rng = np.random.default_rng(seed)
    amb = np.frombuffer(codes, dtype=np.uint8)
    out = []
    for p, t in random_pairs(seed, n, 40, 110, 0.08, 0.05, as_bytes=True):
        p, t = bytearray(p), bytearray(t)
        for arr in (p, t):
            for j in rng.choice(len(arr), max(1, len(arr) // 12),
                                replace=False):
                arr[j] = int(amb[rng.integers(0, len(amb))])
        out.append((bytes(p), bytes(t)))
    return out


# the table test's configurations, and the two equalities it lacks:
# name: (aligner kwargs, pairs, frees row, config fields)
CHUNK_CONFIGS = dict(
    {name: conf + ({},) for name, conf in CONFIGS.items()},
    affine_wildcard=(dict(span="end-to-end"),
                     _ambiguous_pairs(53, codes=b"N"), (0, 0, 0, 0),
                     dict(wildcard=ord("N"))),
    affine_classes=(dict(span="end-to-end"), _ambiguous_pairs(54),
                    (0, 0, 0, 0), dict(match_classes="purine_pyrimidine")))


def _inputs(name, **over):
    kw, pairs, row, fields = CHUNK_CONFIGS[name]
    attr = WavefrontAligner(backend="numpy", **kw)._attributes()
    maxLp = max(len(p) for p, _ in pairs)
    maxLt = max(len(t) for _, t in pairs)
    cfg = dataclasses.replace(E.full_config(attr, maxLp, maxLt),
                              **dict(fields, **over))
    pat = encode_batch([p for p, _ in pairs], cfg.Lp, cfg.extend_chunk,
                       PATTERN_SENTINEL)
    txt = encode_batch([t for _, t in pairs], cfg.Lt, cfg.extend_chunk,
                       TEXT_SENTINEL)
    plen = np.array([len(p) for p, _ in pairs], dtype=np.int32)
    tlen = np.array([len(t) for _, t in pairs], dtype=np.int32)
    frees = np.minimum(np.array([row], dtype=np.int32),
                       np.stack([plen, plen, tlen, tlen], axis=1))
    return cfg, pat, txt, plen, tlen, frees


def _chunk_extension(cfg, tp, tt):
    """build_extension's rows under PYWFA_EXTEND=chunk."""
    ext = TE.build_extension(dataclasses.replace(cfg, extend_force="chunk"),
                             tp, tt)
    assert ext["bits"] is None and ext["table"] is None
    return ext


@pytest.mark.parametrize("name", sorted(CHUNK_CONFIGS))
def test_chunk_extension_equals_bits_and_reference(name):
    ref_cfg, pat, txt, plen, tlen, frees = _inputs(name)
    cfg = C.from_reference(ref_cfg)
    tp, tt = torch.from_numpy(pat), torch.from_numpy(txt)
    args = (torch.from_numpy(plen), torch.from_numpy(tlen),
            torch.from_numpy(frees))
    bits = TE.build_eq_bits(cfg, tp, tt)
    ext = _chunk_extension(cfg, tp, tt)
    assert ext["pat"].dtype == (torch.int32 if cfg.match_classes
                                else torch.int8)
    by_bits = TFL.align_batch_fused_loop(cfg, bits, *args, MAXS)
    by_rows = TFL.align_batch_fused_loop(cfg, None, *args, MAXS,
                                         pat=ext["pat"], txt=ext["txt"])
    assert set(by_bits) == set(by_rows)
    for k in by_bits:
        assert torch.equal(by_bits[k], by_rows[k]), k
    assert int(by_rows["status"].min()) >= 1
    forced = dataclasses.replace(ref_cfg, extend_force="chunk")
    assert E._extend_mode(forced, txt.shape[1]) == "chunk"
    want = E.align_batch(forced, jnp.asarray(pat), jnp.asarray(txt),
                         jnp.asarray(plen), jnp.asarray(tlen),
                         jnp.asarray(frees), jnp.int32(MAXS))
    for k in KEYS:
        np.testing.assert_array_equal(by_rows[k].numpy(),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("name", ["affine_e2e", "affine_classes"])
def test_chunk_segments_equal_bits_segments(name):
    """A segment from WF0 and the later ones from the stored state, on
    the rows and on the words, to the end: equal results and equal
    states."""
    ref_cfg, pat, txt, plen, tlen, frees = _inputs(name, S_cap=24)
    cfg = C.from_reference(ref_cfg)
    tp, tt = torch.from_numpy(pat), torch.from_numpy(txt)
    args = (torch.from_numpy(plen), torch.from_numpy(tlen),
            torch.from_numpy(frees))
    srcs = {"bits": dict(bits=TE.build_eq_bits(cfg, tp, tt)),
            "rows": _chunk_extension(cfg, tp, tt)}
    states = {k: TFL.new_state(cfg, len(plen), "cpu") for k in srcs}
    for seg in range(8):
        outs = {}
        for k, ext in srcs.items():
            outs[k] = TE._loop(cfg, ext, *args, MAXS, state=states[k],
                               fresh=seg == 0,
                               seg_base=seg * (cfg.S_cap - 1))
        for key in outs["bits"]:
            assert torch.equal(outs["bits"][key], outs["rows"][key]), \
                (seg, key)
        for key in ("ring", "lohi", "carry"):
            assert torch.equal(states["bits"][key], states["rows"][key]), \
                (seg, key)
        running = outs["rows"]["status"] == C.ST_OVERFLOW_S
        if not bool(running.any()):
            break
    assert seg >= 1


def _spy_modes(monkeypatch):
    """Record the mode of every build_extension call of the batch path."""
    built = []
    build = PB.E.build_extension

    def spy(cfg, pat, txt, table=True):
        ext = build(cfg, pat, txt, table)
        B, Ltp = txt.shape
        built.append((4 * -(-Ltp // 32) * B * cfg.W,
                      "table" if ext["table"] is not None
                      else "chunk" if ext["pat"] is not None else "bits"))
        return ext

    monkeypatch.setattr(PB.E, "build_extension", spy)
    return built


@pytest.mark.parametrize("segmented", [True, False])
@pytest.mark.parametrize("fits", [True, False])
def test_bits_cap_picks_the_extension(monkeypatch, fits, segmented):
    """The batch path extends by the equality words while their bytes stay
    within EQ_BITS_BYTES_CAP and compares the rows in place one byte past
    it, segmented (the table off) and one shot, with the same results."""
    bp, bt = _segmented_case()
    _, attr = _attr(span="end-to-end")
    one = PB.align_pairs(attr, bp, bt, device="cpu")
    if segmented:
        monkeypatch.setattr(PB, "CHOICES_BYTES_CAP", 1)
        monkeypatch.setattr(PB, "REPLAY_CHOICES_BYTES", 1)
        monkeypatch.setattr(PB, "LCP_TABLE_BYTES_CAP_REMAT", 0)
    built = _spy_modes(monkeypatch)
    PB.align_pairs(attr, bp, bt, device="cpu")
    words = built[0][0]
    assert {mode for _, mode in built} == {"bits"}
    del built[:]
    monkeypatch.setattr(TE, "EQ_BITS_BYTES_CAP",
                        words if fits else words - 1)
    got = PB.align_pairs(attr, bp, bt, device="cpu")
    assert built[0] == (words, "bits" if fits else "chunk")
    assert list(map(_key, got)) == list(map(_key, one))


def test_forced_chunk_routes_to_the_compare(monkeypatch):
    """PYWFA_EXTEND=chunk, read as the config is built, takes the in-place
    compare on every path (it took the words before), with the results of
    the default route."""
    _, attr = _attr(span="end-to-end")
    bp = [p for p, _ in PAIRS]
    bt = [t for _, t in PAIRS]
    plain = PB.align_pairs(attr, bp, bt, device="cpu")
    monkeypatch.setenv("PYWFA_EXTEND", "chunk")
    cfg = C.full_config(attr, 160, 160)
    assert cfg.extend_force == "chunk"
    for table in (True, False):
        assert TE.extend_mode(cfg, 16, 176, table) == "chunk"
    built = _spy_modes(monkeypatch)
    before = TFL.variant_launches["e2e_chunk"]
    got = PB.align_pairs(attr, bp, bt, device="cpu")
    assert built and {mode for _, mode in built} == {"chunk"}
    # the plain version on the CPU launches no kernel
    assert TFL.variant_launches["e2e_chunk"] == before
    assert list(map(_key, got)) == list(map(_key, plain))


def test_no_build_without_the_branch():
    """kernel_build sends a launch on the rows to a build that compares
    them: a one-shot terminal rung, narrow on the words, stays on the
    group build."""
    ref_cfg, pat, txt, *_ = _inputs("affine_e2e")
    cfg = dataclasses.replace(C.from_reference(ref_cfg), W=384, S_cap=649)
    ext = _chunk_extension(cfg, torch.from_numpy(pat), torch.from_numpy(txt))
    assert TFL.kernel_build(cfg, 256) == "narrow"
    assert TFL.kernel_build(cfg, 256, pat=ext["pat"]) == "group"
    for W in (2176, 6912):
        wide = dataclasses.replace(cfg, W=W)
        assert TFL.kernel_build(wide, 16, pat=ext["pat"]) == \
            TFL.kernel_build(wide, 16)
    assert TFL.variant(cfg, chunk=True) == "e2e_chunk"
    assert set(TFL.CHUNK_VARIANTS) <= set(TFL.variant_launches)
    with pytest.raises(ValueError):
        TFL.align_batch_fused_loop(cfg, TE.build_eq_bits(
            cfg, torch.from_numpy(pat), torch.from_numpy(txt)),
            torch.zeros(len(pat), dtype=torch.int32),
            torch.zeros(len(pat), dtype=torch.int32),
            torch.zeros((len(pat), 4), dtype=torch.int32), MAXS,
            pat=ext["pat"], txt=ext["txt"])


@pytest.mark.parametrize("mode", ["table", "one_shot", "bits", "chunk",
                                  "classes"])
def test_memory_estimate_counts_the_tensors(mode):
    """memory_estimate has the reference's keys and sums them; its
    extension input and rows are the nbytes of what build_extension
    returns (the rows it is given, where it returns none), with the same
    `table` argument (False: a one-shot pipeline, which never builds the
    table), its ring and bands those of a segmented run's state."""
    name = "affine_classes" if mode == "classes" else "affine_e2e"
    over = dict(extend_force={"bits": "bits", "table": "",
                              "one_shot": ""}.get(mode, "chunk"))
    ref_cfg, pat, txt, *_ = _inputs(name, **over)
    cfg = C.from_reference(ref_cfg)
    B = len(pat)
    table = mode != "one_shot"
    est = TE.memory_estimate(cfg, B, table)
    assert set(est) == set(E.memory_estimate(ref_cfg, B))
    assert est["total"] == sum(v for k, v in est.items() if k != "total")
    tp, tt = torch.from_numpy(pat), torch.from_numpy(txt)
    ext = TE.build_extension(cfg, tp, tt, table)
    assert (ext["table"] is not None) == (mode == "table")
    source = ext["table"] if mode == "table" else ext["bits"]
    assert est["lcp_table"] == (0 if source is None else source.nbytes)
    rows = (ext["pat"], ext["txt"]) if ext["pat"] is not None else (tp, tt)
    assert est["sequences"] == rows[0].nbytes + rows[1].nbytes
    assert (ext["pat"] is not None) == (mode in ("chunk", "classes"))
    state = TFL.new_state(cfg, B, "cpu")
    assert est["ring"] == state["ring"].nbytes
    assert est["lohi"] == state["lohi"].nbytes
    assert est["choices"] == cfg.S_cap * B * cfg.W
