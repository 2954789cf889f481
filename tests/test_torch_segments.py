"""The segmented run of the port's engine against the JAX engine's.

Segment by segment, `pywfa_tpu_torch.ops.engine.align_batch_start` /
`align_batch_resume` (on CPU tensors: the plain torch version of the fused
loop, with its state in and out) must report the same status, score and
end cell as `pywfa_tpu.ops.engine.align_batch_start` / `align_batch_resume`
with the same segment length; the replay walk must emit the same op blocks
and carry as `align_batch_start_walk` / `align_batch_replay_walk`; a
snapshot taken in the JAX engine and carried over by
`fused_loop.state_from_reference` must finish in the port with the JAX
engine's result; pairs paused at the step cap and un-paused go on to the
one-shot result; and wf-adaptive and z-drop, whose carry crosses segment
boundaries, give the one-shot result at every segment length. Tolerance:
zero (integers).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.attributes import HeuristicParams
from pywfa_tpu.batch import PATTERN_SENTINEL, TEXT_SENTINEL, encode_batch
from pywfa_tpu.constants import HeuristicStrategy
from pywfa_tpu.ops import engine as E
from pywfa_tpu_torch.ops import config as C
from pywfa_tpu_torch.ops import engine as TE
from pywfa_tpu_torch.ops import fused_loop as TFL
from tests.corpus import random_pairs
from tests.test_torch_engine import README_PAIRS, window_pairs

torch.set_num_threads(1)

MAXS = 2**31 - 1
META = ("status", "final_s", "end_k", "end_off")
PAIRS = README_PAIRS + random_pairs(61, 8, 60, 120, 0.08, 0.05,
                                    unrelated=0.15, as_bytes=True)
WINDOWS = window_pairs(62, 8, 60, 100, 12, sub=0.15)
# a chimeric tail: z-drop ends these pairs at their historic maximum
CHIMERAS = [(p, t[:len(t) - 50] + (b"TTGCA" * 10 if i % 2 else t[-50:]))
            for i, (p, t) in enumerate(random_pairs(63, 8, 100, 120, 0.03,
                                                    0.0, as_bytes=True))]

CONFIGS = {
    "affine_e2e": (dict(span="end-to-end"), None, PAIRS, (0, 0, 0, 0)),
    "affine_endsfree": (dict(text_begin_free=12, text_end_free=12), None,
                        WINDOWS, (0, 0, 12, 12)),
    "affine2p_e2e": (dict(distance="affine2p", span="end-to-end"), None,
                     PAIRS, (0, 0, 0, 0)),
    "edit_e2e": (dict(distance="levenshtein", span="end-to-end"), None,
                 PAIRS, (0, 0, 0, 0)),
    "wfadaptive": (dict(span="end-to-end"),
                   HeuristicParams(strategy=HeuristicStrategy.WFADAPTIVE,
                                   min_wavefront_length=5,
                                   max_distance_threshold=20,
                                   steps_between_cutoffs=3), PAIRS,
                   (0, 0, 0, 0)),
    "zdrop": (dict(span="end-to-end"),
              HeuristicParams(strategy=HeuristicStrategy.ZDROP, zdrop=15,
                              steps_between_cutoffs=2), CHIMERAS,
              (0, 0, 0, 0)),
    "seeded": (dict(match=-1, text_begin_free=12, text_end_free=12), None,
               WINDOWS, (0, 0, 12, 12)),
}


def _inputs(name, K, record=False):
    kw, heur, pairs, row = CONFIGS[name]
    attr = WavefrontAligner(backend="numpy", **kw)._attributes()
    if heur is not None:
        attr = dataclasses.replace(attr, heuristic=heur)
    maxLp = max(len(p) for p, _ in pairs)
    maxLt = max(len(t) for _, t in pairs)
    cfg = E.full_config(attr, maxLp, maxLt, S_cap=K, record_choices=record)
    pat = encode_batch([p for p, _ in pairs], cfg.Lp, cfg.extend_chunk,
                       PATTERN_SENTINEL)
    txt = encode_batch([t for _, t in pairs], cfg.Lt, cfg.extend_chunk,
                       TEXT_SENTINEL)
    plen = np.array([len(p) for p, _ in pairs], dtype=np.int32)
    tlen = np.array([len(t) for _, t in pairs], dtype=np.int32)
    frees = np.minimum(np.array([row], dtype=np.int32),
                       np.stack([plen, plen, tlen, tlen], axis=1))
    return cfg, pat, txt, plen, tlen, frees


def _jax_args(pat, txt, plen, tlen, frees, max_steps=MAXS):
    return (jnp.asarray(pat), jnp.asarray(txt), jnp.asarray(plen),
            jnp.asarray(tlen), jnp.asarray(frees), jnp.int32(max_steps))


def _port_args(cfg, pat, txt, plen, tlen, frees):
    ext = TE.build_extension(cfg, torch.from_numpy(pat),
                             torch.from_numpy(txt))
    return ext, (torch.from_numpy(plen), torch.from_numpy(tlen),
                 torch.from_numpy(frees))


def _assert_meta(got, want, where):
    for k in META:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=f"{where}: {k}")


def _host(state):
    return {k: np.asarray(v) for k, v in state.items()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_segments_match_reference(name):
    """Forward segments of 16 scores: the meta of every segment, then the
    replay walk's op blocks and carry, top segment first."""
    K = 16
    ref_cfg, *arrs = _inputs(name, K)
    cfg = C.from_reference(ref_cfg)
    jargs = _jax_args(*arrs)
    ext, pargs = _port_args(cfg, *arrs)
    want, rstate = E.align_batch_start(ref_cfg, *jargs)
    got, state = TE.align_batch_start(cfg, ext, *pargs, MAXS)
    snaps = []
    for seg in range(400):
        _assert_meta(got, want, f"segment {seg}")
        if not (np.asarray(want["status"]) == E.ST_OVERFLOW_S).any():
            break
        snaps.append((_host(rstate),
                      {k: (v.clone() if torch.is_tensor(v) else v)
                       for k, v in state.items()}))
        assert state["s"] == int(rstate["s"])
        want, rstate = E.align_batch_resume(ref_cfg, *jargs, rstate)
        got, state = TE.align_batch_resume(cfg, ext, *pargs, MAXS, state)
    assert len(snaps) >= 2, "the case must cross segment boundaries"

    rec_ref = dataclasses.replace(ref_cfg, record_choices=True)
    rec = C.from_reference(rec_ref)
    ok = np.asarray(want["status"]) == E.ST_END_REACHED
    ok |= ((np.asarray(want["status"]) == E.ST_END_UNREACHABLE)
           & (np.asarray(want["end_off"]) > E.NULL_THRESHOLD))
    rcarry = E.walk_carry_init(np.asarray(want["final_s"]),
                               np.asarray(want["end_k"]), ok)
    carry = TE.walk_carry_init(got["final_s"], got["end_k"],
                               torch.from_numpy(ok))
    for i in range(len(snaps), -1, -1):
        if i == 0:
            rops, rcarry = E.align_batch_start_walk(rec_ref, *jargs, rcarry)
            ops, carry = TE.align_batch_start_walk(rec, ext, *pargs, MAXS,
                                                   carry)
        else:
            rs = {k: jnp.asarray(v) for k, v in snaps[i - 1][0].items()}
            rops, rcarry = E.align_batch_replay_walk(rec_ref, *jargs, rs,
                                                     rcarry)
            ops, carry = TE.align_batch_replay_walk(rec, ext, *pargs, MAXS,
                                                    snaps[i - 1][1], carry)
        np.testing.assert_array_equal(ops.numpy(), np.asarray(rops),
                                      err_msg=f"ops of segment {i}")
        for j, (a, b) in enumerate(zip(carry, rcarry)):
            np.testing.assert_array_equal(
                a.numpy(), np.asarray(b), err_msg=f"carry[{j}] after {i}")
    reached = torch.from_numpy(np.asarray(want["status"])
                               == E.ST_END_REACHED)
    assert not bool((carry[3] | carry[4])[reached].any())


@pytest.mark.parametrize("name", ["affine_e2e", "affine2p_e2e", "wfadaptive",
                                  "zdrop", "seeded"])
def test_state_from_reference_finishes_in_the_port(name):
    """Pause in the JAX engine after two segments, carry the snapshot
    over, finish in the port: the JAX engine's own finish."""
    K = 16
    ref_cfg, *arrs = _inputs(name, K)
    cfg = C.from_reference(ref_cfg)
    jargs = _jax_args(*arrs)
    ext, pargs = _port_args(cfg, *arrs)
    want, rstate = E.align_batch_start(ref_cfg, *jargs)
    want, rstate = E.align_batch_resume(ref_cfg, *jargs, rstate)
    assert (np.asarray(want["status"]) == E.ST_OVERFLOW_S).any()
    state = TFL.state_from_reference(cfg, _host(rstate))
    assert state["s"] == 2 * (K - 1)
    for seg in range(400):
        want, rstate = E.align_batch_resume(ref_cfg, *jargs, rstate)
        got, state = TE.align_batch_resume(cfg, ext, *pargs, MAXS, state)
        _assert_meta(got, want, f"segment {seg + 2}")
        if not (np.asarray(want["status"]) == E.ST_OVERFLOW_S).any():
            break
    assert int((got["status"] == C.ST_END_REACHED).sum()) >= 3


@pytest.mark.parametrize("name", ["affine_e2e", "wfadaptive"])
def test_unpause_max_steps_goes_on_to_the_one_shot_result(name):
    ref_cfg, *arrs = _inputs(name, 400, record=True)
    cfg = C.from_reference(ref_cfg)
    ext, pargs = _port_args(cfg, *arrs)
    whole = TFL.align_batch_fused_loop(cfg, ext["bits"], *pargs, MAXS,
                                       table=ext["table"])
    # pause at 9 steps, as the JAX engine does
    jargs = _jax_args(*arrs, max_steps=9)
    want, rstate = E.align_batch_start(ref_cfg, *jargs)
    got, state = TE.align_batch_start(cfg, ext, *pargs, 9)
    _assert_meta(got, want, "paused")
    paused = got["status"] == C.ST_MAX_STEPS
    assert int(paused.sum()) >= 4 and bool((got["final_s"][paused] == 9).all())
    # un-pause both and finish both
    rstate = E.unpause_max_steps(rstate)
    state = TFL.unpause_max_steps(state)
    assert state["s"] == 9 == int(rstate["s"])
    carry = state["carry"]
    assert not bool((carry[:, TFL.CARRY.index("status")]
                     == C.ST_MAX_STEPS).any())
    want, _ = E.align_batch_resume(ref_cfg, *_jax_args(*arrs), rstate)
    got, _ = TE.align_batch_resume(cfg, ext, *pargs, MAXS, state)
    _assert_meta(got, want, "resumed")
    _assert_meta(got, whole, "resumed vs one shot")
    # levels above the pause, recorded at s - seg_base
    np.testing.assert_array_equal(got["choices"][1:50].numpy(),
                                  whole["choices"][10:59].numpy())


@pytest.mark.parametrize("K", [8, 17, 64])
@pytest.mark.parametrize("name", ["wfadaptive", "zdrop"])
def test_heuristic_carry_crosses_segments(name, K):
    """The cutoff countdown and the drop heuristics' historic maximum live
    in the state: whatever the segment length, the one-shot result."""
    ref_cfg, *arrs = _inputs(name, 600)
    whole_cfg = C.from_reference(ref_cfg)
    cfg = dataclasses.replace(whole_cfg, S_cap=K)
    ext, pargs = _port_args(cfg, *arrs)
    whole = TFL.align_batch_fused_loop(whole_cfg, ext["bits"], *pargs, MAXS,
                                       table=ext["table"])
    got, state = TE.align_batch_start(cfg, ext, *pargs, MAXS)
    n = 1
    while bool((got["status"] == C.ST_OVERFLOW_S).any()):
        got, state = TE.align_batch_resume(cfg, ext, *pargs, MAXS, state)
        n += 1
    assert n >= 2
    _assert_meta(got, whole, f"K={K}")
    if name == "zdrop":
        assert int((got["status"] == C.ST_END_UNREACHABLE).sum()) >= 2
        assert int((got["status"] == C.ST_END_REACHED).sum()) >= 2
