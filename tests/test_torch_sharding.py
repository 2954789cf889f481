"""The port's data-parallel mesh on 8 CPU "devices", against the port's
unsharded run and against `pywfa_tpu`'s sharded run on its virtual
8-device CPU mesh (the twin of tests/test_sharding.py).

Both packages take the same seeded pairs, encoded once with numpy, and the
same config (`ops/config.from_reference`); every comparison is of
integers and array-equal: status, final_s, end_k, end_off and the choice
record, and for the segmented run the segments, statuses and walked op
streams.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.batch import PATTERN_SENTINEL, TEXT_SENTINEL, encode_batch
from pywfa_tpu.ops import engine as E
from pywfa_tpu.parallel import make_mesh as ref_make_mesh
from pywfa_tpu.parallel import sharded_align_batch as ref_sharded
from pywfa_tpu_torch.ops import config as C
from pywfa_tpu_torch.ops import engine as TE
from pywfa_tpu_torch.parallel import bucket_pairs, make_mesh, \
    sharded_align_batch
from pywfa_tpu_torch.parallel.dryrun import (_segmented_under_mesh,
                                             dryrun_multichip)

KEYS = ("status", "final_s", "end_k", "end_off")
CPU8 = [torch.device("cpu")] * 8


def _mk_batch(B, L, seed=0):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    pats_a = alpha[rng.integers(0, 4, (B, L))]
    txts_a = pats_a.copy()
    for i in range(B):
        idx = rng.choice(L, 2, replace=False)
        txts_a[i, idx] = alpha[rng.integers(0, 4, 2)]
    return ([pats_a[i].tobytes() for i in range(B)],
            [txts_a[i].tobytes() for i in range(B)])


def _inputs(cfg, pats, txts, frees=None):
    """Host arrays (pat, txt, plen, tlen, frees) as both packages take
    them."""
    C_ = cfg.extend_chunk
    B = len(pats)
    return (encode_batch(pats, cfg.Lp, C_, PATTERN_SENTINEL),
            encode_batch(txts, cfg.Lt, C_, TEXT_SENTINEL),
            np.array([len(p) for p in pats], np.int32),
            np.array([len(t) for t in txts], np.int32),
            np.zeros((B, 4), np.int32) if frees is None else frees)


def _reference_sharded(cfg, host):
    """pywfa_tpu's sharded_align_batch over its 8 virtual devices."""
    mesh = ref_make_mesh(jax.devices()[:8])
    b1 = NamedSharding(mesh, P("data"))
    b2 = NamedSharding(mesh, P("data", None))
    shard = (b2, b2, b1, b1, b2)
    args = [jax.device_put(jnp.asarray(a), s) for a, s in zip(host, shard)]
    out = ref_sharded(cfg, mesh)(*args, jnp.int32(2**31 - 1))
    return {k: np.asarray(v) for k, v in out.items() if k != "steps"}


def _port_both(cfg, host):
    """The port's unsharded engine.align_batch and its sharded run over 8
    CPU devices, as host arrays (the shards concatenated: choices along
    their batch axis)."""
    tcfg = C.from_reference(cfg)
    args = [torch.from_numpy(a) for a in host]
    one = TE.align_batch(tcfg, *args, 2**31 - 1)
    out = sharded_align_batch(tcfg, make_mesh(CPU8))(*host, 2**31 - 1)
    assert len(out["status"]) == 8
    assert all(s.shape[1] == len(host[0]) // 8 for s in out["choices"])
    sharded = {k: torch.cat(v, dim=1 if k == "choices" else 0).numpy()
               for k, v in out.items() if k != "steps"}
    return {k: v.numpy() for k, v in one.items() if k != "steps"}, sharded


def _assert_all_equal(cfg, host):
    ref = _reference_sharded(cfg, host)
    one, sharded = _port_both(cfg, host)
    assert set(ref) == set(one) == set(sharded)
    for key in ref:
        np.testing.assert_array_equal(sharded[key], one[key], err_msg=key)
        np.testing.assert_array_equal(sharded[key], ref[key], err_msg=key)
    return sharded


def test_sharded_matches_single_device():
    B, L = 32, 64
    pats, txts = _mk_batch(B, L)
    attr = WavefrontAligner(backend="numpy", span="end-to-end")._attributes()
    cfg = E.full_config(attr, L, L)
    out = _assert_all_equal(cfg, _inputs(cfg, pats, txts))
    assert "choices" in out and (out["status"] == E.ST_END_REACHED).all()


def test_sharded_endsfree_perpair_frees_and_heuristic():
    """Sharded step with varied PER-PAIR ends-free frees (multi-cell WF0
    seeding) and, separately, the wf-adaptive heuristic in-loop -- each
    equal to the unsharded port and to the reference's sharded run (the
    CI twin of dryrun_multichip configs 2-3)."""
    from pywfa_tpu.attributes import HeuristicParams
    from pywfa_tpu.constants import HeuristicStrategy

    B, L = 32, 64
    pats, txts = _mk_batch(B, L, seed=3)
    api = WavefrontAligner(backend="numpy", span="ends-free",
                           pattern_begin_free=8, pattern_end_free=8,
                           text_begin_free=8, text_end_free=8)
    frees_v = np.zeros((B, 4), np.int32)
    frees_v[:, 0] = np.arange(B) % 9
    frees_v[:, 1] = 8
    frees_v[:, 2] = (np.arange(B) * 3) % 9
    frees_v[:, 3] = 8
    cfg = E.full_config(api._attributes(), L, L)
    _assert_all_equal(cfg, _inputs(cfg, pats, txts, frees_v))

    attr_h = dataclasses.replace(
        WavefrontAligner(backend="numpy", span="end-to-end")._attributes(),
        heuristic=HeuristicParams(strategy=HeuristicStrategy.WFADAPTIVE,
                                  min_wavefront_length=5,
                                  max_distance_threshold=15,
                                  steps_between_cutoffs=1))
    cfg_h = E.full_config(attr_h, L, L)
    _assert_all_equal(cfg_h, _inputs(cfg_h, pats, txts))


def test_bucketing():
    pats = [b"A" * 30, b"C" * 100, b"G" * 30, b"T" * 500]
    txts = [b"A" * 40, b"C" * 90, b"G" * 25, b"T" * 480]
    groups = bucket_pairs(pats, txts)
    assert groups[(64, 64)] == [0, 2]
    assert groups[(128, 128)] == [1]
    assert groups[(512, 512)] == [3]


def _reference_segmented(cfg, cfg_rec, host):
    """The reference's segmented engine sequence with batch-sharded
    inputs over its 8 devices (tests/test_sharding.py's remat run)."""
    mesh = ref_make_mesh(jax.devices()[:8])
    b1 = NamedSharding(mesh, P("data"))
    b2 = NamedSharding(mesh, P("data", None))
    pat, txt, plen, tlen, frees = [
        jax.device_put(jnp.asarray(a), s)
        for a, s in zip(host, (b2, b2, b1, b1, b2))]
    ms = jnp.int32(2**31 - 1)
    out, state = E.align_batch_start(cfg, pat, txt, plen, tlen, frees, ms)
    snaps = []
    for _ in range(32):
        if not (np.asarray(out["status"]) == E.ST_OVERFLOW_S).any():
            break
        snaps.append({k: np.asarray(v) for k, v in state.items()})
        out, state = E.align_batch_resume(cfg, pat, txt, plen, tlen, frees,
                                          ms, state)
    status = np.asarray(out["status"])
    carry = E.walk_carry_init(jnp.asarray(out["final_s"]),
                              jnp.asarray(out["end_k"]),
                              jnp.asarray(status == E.ST_END_REACHED))
    blocks = []
    for i in range(len(snaps), -1, -1):
        if i == 0:
            ops_seg, carry = E.align_batch_start_walk(
                cfg_rec, pat, txt, plen, tlen, frees, ms, carry)
        else:
            st = {k: jnp.asarray(v) for k, v in snaps[i - 1].items()}
            ops_seg, carry = E.align_batch_replay_walk(
                cfg_rec, pat, txt, plen, tlen, frees, ms, st, carry)
        blocks.insert(0, np.asarray(ops_seg))
    return dict(segments=len(snaps) + 1, status=status,
                final_s=np.asarray(out["final_s"]),
                ops=np.concatenate(blocks, axis=1),
                fallback=np.asarray(carry[4]) | np.asarray(carry[3]))


def test_remat_under_mesh_matches_unsharded():
    """The segmented engine sequence (align_batch_start/resume + replay
    walks) over the 8-device mesh gives the same segments, statuses and
    walked op streams as the port's unsharded run and as the reference's
    sharded run (CI twin of dryrun_multichip config 5)."""
    B, L = 32, 64
    pats, txts = _mk_batch(B, L, seed=5)
    attr = WavefrontAligner(backend="numpy", span="end-to-end")._attributes()
    cfg = dataclasses.replace(E.full_config(attr, L, L), S_cap=8,
                              record_choices=False)
    cfg_rec = dataclasses.replace(cfg, record_choices=True)
    host = _inputs(cfg, pats, txts)
    ref = _reference_segmented(cfg, cfg_rec, host)
    tcfg = C.from_reference(cfg)
    one = _segmented_under_mesh(make_mesh([torch.device("cpu")]), tcfg, host)
    got = _segmented_under_mesh(make_mesh(CPU8), tcfg, host)
    assert ref["segments"] == one["segments"] == got["segments"] >= 2
    assert not ref["fallback"].any() and not got["fallback"].any()
    for key in ("status", "final_s", "ops", "fallback"):
        np.testing.assert_array_equal(got[key], one[key], err_msg=key)
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_dryrun_multichip_on_two_cpu_devices(capsys):
    dryrun_multichip(2, device="cpu")
    assert "dryrun_multichip: 2 devices, B=16: OK" in capsys.readouterr().out


def test_mesh_refuses_a_batch_that_does_not_divide():
    tcfg = C.from_reference(E.full_config(
        WavefrontAligner(backend="numpy", span="end-to-end")._attributes(),
        32, 32))
    pats, txts = _mk_batch(12, 32)
    with pytest.raises(ValueError, match="does not divide"):
        sharded_align_batch(tcfg, make_mesh(CPU8))(
            *_inputs(tcfg, pats, txts), 2**31 - 1)
