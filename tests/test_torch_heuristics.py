"""The heuristic cascade of the fused score loop's plain torch version
against the JAX package.

`align_batch_fused_loop_ref` with each heuristic strategy (wf-adaptive,
wfmash, x-drop, z-drop, banded static and adaptive, and two combinations)
is compared with the Pallas kernel in interpret mode and with the XLA
engine, over four distance metrics, both spans and both scopes: status,
final_s, end_k, end_off and the whole choices tensor, byte for byte
(tolerance zero).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.attributes import HeuristicParams
from pywfa_tpu.batch import PATTERN_SENTINEL, TEXT_SENTINEL, encode_batch
from pywfa_tpu.constants import HeuristicStrategy as HS
from pywfa_tpu.ops import engine as E
from pywfa_tpu.ops.pallas import fused_loop as PFL
from pywfa_tpu_torch.ops import config as C
from pywfa_tpu_torch.ops import engine as TE
from pywfa_tpu_torch.ops import fused_loop as TFL
from tests.corpus import random_pairs

torch.set_num_threads(1)

KEYS = ("status", "final_s", "end_k", "end_off", "choices")
MAXS = 2**31 - 1

# the reference's own heuristic cases (tests/test_pallas_kernel.py,
# tests/test_heuristics_extended.py), with steps_between_cutoffs of 1
# and of more than 1
HEURISTICS = {
    "wfadaptive": HeuristicParams(
        strategy=HS.WFADAPTIVE, min_wavefront_length=5,
        max_distance_threshold=15, steps_between_cutoffs=1),
    "wfmash": HeuristicParams(
        strategy=HS.WFMASH, min_wavefront_length=5,
        max_distance_threshold=12, steps_between_cutoffs=1),
    "xdrop": HeuristicParams(strategy=HS.XDROP, xdrop=10,
                             steps_between_cutoffs=1),
    "zdrop": HeuristicParams(strategy=HS.ZDROP, zdrop=12,
                             steps_between_cutoffs=2),
    "banded_static": HeuristicParams(strategy=HS.BANDED_STATIC, min_k=-12,
                                     max_k=12, steps_between_cutoffs=1),
    "banded_adaptive": HeuristicParams(strategy=HS.BANDED_ADAPTIVE,
                                       min_k=-10, max_k=10,
                                       steps_between_cutoffs=2),
    "wfadaptive+banded": HeuristicParams(
        strategy=HS.WFADAPTIVE | HS.BANDED_STATIC, min_wavefront_length=5,
        max_distance_threshold=25, steps_between_cutoffs=3, min_k=-20,
        max_k=20),
    "xdrop+banded": HeuristicParams(
        strategy=HS.XDROP | HS.BANDED_ADAPTIVE, xdrop=14, min_k=-8, max_k=8,
        steps_between_cutoffs=1),
}

# the grid of this file runs gap-affine; the other metrics have a file
# each (tests/test_torch_heuristics_<metric>.py), so that the files run
# side by side: most of a case's time is the JAX package's compilation
METRICS = ("affine", "affine2p", "linear", "levenshtein")
SPANS = {"end-to-end": (0, 0, 0, 0), "ends-free": (4, 4, 6, 6)}


def pairs_for(seed):
    """Divergent pairs with a share of unrelated ones, so that the drop
    heuristics end some pairs and the band cuts act on the others."""
    return random_pairs(seed, 12, 30, 100, 0.25, 0.15, unrelated=0.25,
                        as_bytes=True)


def build(pairs, span, frees_row, distance, heuristic, record=True, **api_kw):
    """(reference config, pat, txt, plen, tlen, frees) at full caps, frees
    clamped per pair as the batch path builds them."""
    attr = WavefrontAligner(backend="numpy", span=span, distance=distance,
                            **api_kw)._attributes()
    if heuristic is not None:
        attr = dataclasses.replace(attr, heuristic=heuristic)
    maxLp = max(len(p) for p, _ in pairs)
    maxLt = max(len(t) for _, t in pairs)
    cfg = E.full_config(attr, maxLp, maxLt, record_choices=record)
    pat = encode_batch([p for p, _ in pairs], cfg.Lp, cfg.extend_chunk,
                       PATTERN_SENTINEL)
    txt = encode_batch([t for _, t in pairs], cfg.Lt, cfg.extend_chunk,
                       TEXT_SENTINEL)
    plen = np.array([len(p) for p, _ in pairs], dtype=np.int32)
    tlen = np.array([len(t) for _, t in pairs], dtype=np.int32)
    lens = np.stack([plen, plen, tlen, tlen], axis=1)
    frees = np.minimum(np.array([frees_row], dtype=np.int32), lens)
    return cfg, pat, txt, plen, tlen, frees


def run_port(cfg, pat, txt, plen, tlen, frees, max_steps=MAXS):
    tcfg = C.from_reference(cfg)
    bits = TE.build_eq_bits(tcfg, torch.from_numpy(pat),
                            torch.from_numpy(txt))
    return TFL.align_batch_fused_loop_ref(
        tcfg, bits, torch.from_numpy(plen), torch.from_numpy(tlen),
        torch.from_numpy(frees), max_steps)


def run_xla(cfg, pat, txt, plen, tlen, frees, max_steps=MAXS):
    return E.align_batch(cfg, jnp.asarray(pat), jnp.asarray(txt),
                         jnp.asarray(plen), jnp.asarray(tlen),
                         jnp.asarray(frees), jnp.int32(max_steps))


def run_pallas(cfg, pat, txt, plen, tlen, frees, max_steps=MAXS):
    bits = E.build_eq_bits(cfg, jnp.asarray(pat), jnp.asarray(txt))
    return PFL.align_batch_pallas(cfg, len(plen), bits, jnp.asarray(plen),
                                  jnp.asarray(tlen), jnp.asarray(frees),
                                  jnp.int32(max_steps))


def assert_equal(port, ref, record, what, but=None):
    """Every output equal; `but` masks pairs out of the per-pair outputs
    (the choices tensor is compared whole all the same)."""
    assert ("choices" in port) == record
    for k in (KEYS if record else KEYS[:4]):
        a, b = port[k].numpy(), np.asarray(ref[k])
        if but is not None and k != "choices":
            a, b = a[~but], b[~but]
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {k}")


def emptied_edit_wavefront(cfg, port, xla):
    """The pairs on which the reference's two engines part: under edit or
    indel, a wavefront that a band cut has emptied ends the pair in the
    Pallas kernel (ST_END_UNREACHABLE at that score, as the port reports),
    while the XLA engine steps on through empty wavefronts to its score
    cap (ST_OVERFLOW_S). Nothing else differs, the choices included."""
    if cfg.n_comp != 1 or cfg.scope != 2:
        return None
    return ((port["status"].numpy() == C.ST_END_UNREACHABLE)
            & (np.asarray(xla["status"]) == C.ST_OVERFLOW_S))


def check_cascade(name, metric, span, scope):
    """One cell of the heuristic x metric x span x scope grid."""
    record = scope == "full"
    seed = 100 + 7 * sorted(HEURISTICS).index(name) + METRICS.index(metric)
    inputs = build(pairs_for(seed), span, SPANS[span], metric,
                   HEURISTICS[name], record=record)
    port = run_port(*inputs)
    xla = run_xla(*inputs)
    assert_equal(port, xla, record, "xla",
                 but=emptied_edit_wavefront(inputs[0], port, xla))
    assert_equal(port, run_pallas(*inputs), record, "pallas")


@pytest.mark.parametrize("scope", ["full", "score"])
@pytest.mark.parametrize("span", sorted(SPANS))
@pytest.mark.parametrize("name", sorted(HEURISTICS))
def test_cascade_matches_pallas_and_xla(name, span, scope):
    check_cascade(name, "affine", span, scope)


@pytest.mark.parametrize("name", sorted(HEURISTICS))
def test_cascade_acts(name):
    """Each case's heuristic changes what the loop computes: its outputs
    differ from the exact loop's on the same pairs."""
    seed = 100 + 7 * sorted(HEURISTICS).index(name)
    heur = run_port(*build(pairs_for(seed), "end-to-end", SPANS["end-to-end"],
                           "affine", HEURISTICS[name]))
    exact = run_port(*build(pairs_for(seed), "end-to-end",
                            SPANS["end-to-end"], "affine", None))
    assert any(not torch.equal(heur[k], exact[k]) for k in KEYS)
    if name in ("zdrop",):
        dropped = heur["status"] == C.ST_END_UNREACHABLE
        assert dropped.any()
        assert (heur["end_off"][dropped] > C.NULL_THRESHOLD).all()


@pytest.mark.parametrize("name,span", [("zdrop", "end-to-end"),
                                       ("xdrop", "end-to-end"),
                                       ("zdrop", "ends-free")])
def test_match_bonus_drop_matches_pallas_and_xla(name, span):
    """match = -1: the drop heuristics score a match with 1 (swg_match),
    over the transformed penalties."""
    h = dataclasses.replace(HEURISTICS[name], zdrop=14, xdrop=14)
    frees = (0, 0, 0, 0)  # ends-free with a match bonus and zero frees
    inputs = build(pairs_for(301), span, frees, "affine", h, match=-1,
                   mismatch=4, gap_opening=6, gap_extension=2)
    port = run_port(*inputs)
    assert_equal(port, run_xla(*inputs), True, "xla")
    assert_equal(port, run_pallas(*inputs), True, "pallas")
    assert (port["status"] == C.ST_END_UNREACHABLE).any() or name == "xdrop"


@pytest.mark.parametrize("name", ["wfadaptive", "zdrop"])
def test_cascade_under_max_steps_and_small_caps(name):
    """The cascade at a first-rung config (W = 128, S_cap = 96) and under
    a step cap: overflow and max-steps statuses as the XLA engine's."""
    cfg, *rest = build(pairs_for(302), "end-to-end", (0, 0, 0, 0), "affine",
                       HEURISTICS[name])
    small = dataclasses.replace(cfg, W=128, S_cap=96)
    port = run_port(small, *rest)
    assert_equal(port, run_xla(small, *rest), True, "xla small")
    port = run_port(cfg, *rest, max_steps=20)
    assert_equal(port, run_xla(cfg, *rest, max_steps=20), True, "xla steps")
    assert (port["status"] == C.ST_MAX_STEPS).any()


def test_wfmash_with_an_empty_sequence():
    """wfmash divides by the lengths: a pair with an empty text (or
    pattern) takes the float conversion's corner values (NaN to 0,
    saturation), as the XLA engine on the CPU does."""
    pairs = pairs_for(303)[:6] + [(b"ACGTACGTACGTACGTACGT", b""),
                                  (b"", b"ACGTACGTACGTACGTACGT"),
                                  (b"ACGTTGCAACGTTGCAAC", b"A")]
    h = dataclasses.replace(HEURISTICS["wfmash"], min_wavefront_length=2)
    inputs = build(pairs, "end-to-end", (0, 0, 0, 0), "affine", h)
    port = run_port(*inputs)
    assert_equal(port, run_xla(*inputs), True, "xla")
