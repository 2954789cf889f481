"""Entry points of the port: a one-device check of the batched step and a
dry run of the data-parallel mesh.

The twin of the repository's `__graft_entry__.py` for the JAX package:
`entry` gives the batched alignment step and example inputs;
`dryrun_multichip` runs the step over an n-device mesh
(`parallel.mesh`) in five configurations and asserts what the reference's
dry run asserts. Devices are the card's by default; `device="cpu"` runs
the plain torch versions over n CPU "devices" (the tests do).

    python -m pywfa_tpu_torch.parallel.dryrun [n_devices] [cuda|cpu]
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch


def _example_inputs(B, Lp, Lt, score_only=False):
    """(cfg, (pat, txt, plen, tlen, frees, max_steps)): B seeded pairs of
    the given lengths, a mismatch every 17 bases, end to end, as host
    tensors."""
    from ..align import WavefrontAligner
    from ..batch import PATTERN_SENTINEL, TEXT_SENTINEL, encode_batch
    from ..ops.config import full_config

    rng = np.random.default_rng(0)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    pats = []
    txts = []
    for _ in range(B):
        p = alphabet[rng.integers(0, 4, Lp)].tobytes()
        t = bytearray(p[:Lt])
        for j in range(0, Lt, 17):  # sprinkle mismatches
            t[j] = alphabet[(np.frombuffer(t, np.uint8)[j] + 1) % 4]
        pats.append(p)
        txts.append(bytes(t))

    attr = WavefrontAligner(backend="numpy",
                            scope=("score" if score_only else "full"),
                            span="end-to-end")._attributes()
    cfg = full_config(attr, Lp, Lt, record_choices=not score_only)
    C = cfg.extend_chunk
    pat = torch.from_numpy(encode_batch(pats, cfg.Lp, C, PATTERN_SENTINEL))
    txt = torch.from_numpy(encode_batch(txts, cfg.Lt, C, TEXT_SENTINEL))
    plen = torch.full((B,), Lp, dtype=torch.int32)
    tlen = torch.full((B,), Lt, dtype=torch.int32)
    frees = torch.zeros((B, 4), dtype=torch.int32)
    return cfg, (pat, txt, plen, tlen, frees, 2**31 - 1)


def entry(device="cuda"):
    """(fn, example_args): the batched wavefront-alignment step on
    `device`, 64 pairs of 150 bp; fn returns (status, final_s, end_k,
    end_off)."""
    from ..batch import _resolve_device
    from ..ops import engine as E

    dev = _resolve_device(device)
    cfg, args = _example_inputs(B=64, Lp=150, Lt=150)

    def fn(pat, txt, plen, tlen, frees, max_steps):
        out = E.align_batch(cfg, pat.to(dev), txt.to(dev), plen.to(dev),
                            tlen.to(dev), frees.to(dev), max_steps)
        return out["status"], out["final_s"], out["end_k"], out["end_off"]

    return fn, args


def _require(ok, msg):
    if not ok:
        raise AssertionError(msg)


def _cat(shards) -> np.ndarray:
    return torch.cat([s.cpu() for s in shards]).numpy()


def _shard_and_run(mesh, cfg, args, walk=False):
    """Run the sharded step (and optionally each shard's traceback walk,
    on its own device, which must not fall back); returns the host meta
    dict of the whole batch."""
    from ..ops import engine as E
    from .mesh import META, sharded_align_batch

    out = sharded_align_batch(cfg, mesh)(*args)
    if walk:
        for choices, final_s, end_k, status in zip(
                out["choices"], out["final_s"], out["end_k"],
                out["status"]):
            fb = E.traceback_walk(cfg, choices, final_s, end_k,
                                  status == E.ST_END_REACHED)[3]
            _require(not bool(fb.any()), "the sharded walk fell back")
    return {k: _cat(out[k]) for k in META}


def _segmented_under_mesh(mesh, cfg, host) -> dict:
    """The segmented run with the shards' inputs (batch._align_pairs_remat's
    engine sequence): the forward loop of `cfg` (no record) in S_cap-sized
    segments with host snapshots of each shard's state, then each shard's
    traceback by running its segments again with the record on its
    device, highest first, walking the pairs that reached their end.
    `host` holds the whole batch's (pat, txt, plen, tlen, frees). Returns
    the segments, and over the whole batch the status, final_s, the walked
    op streams of the segments side by side in forward order and the
    pairs whose walk fell back."""
    from ..batch import _restore, _snapshot
    from ..ops import engine as E
    from .mesh import make_global_batch

    ms = 2**31 - 1
    g = make_global_batch(mesh, dict(zip(
        ("pat", "txt", "plen", "tlen", "frees"), host)))
    shards = list(zip(g["plen"], g["tlen"], g["frees"]))
    exts = [E.build_extension(cfg, p, t) for p, t in zip(g["pat"],
                                                         g["txt"])]
    runs = [E.align_batch_start(cfg, ext, *sh, ms)
            for ext, sh in zip(exts, shards)]
    snaps = []
    for _ in range(32):
        if not any(bool((out["status"] == E.ST_OVERFLOW_S).any())
                   for out, _ in runs):
            break
        snaps.append([_snapshot(state) for _, state in runs])
        runs = [E.align_batch_resume(cfg, ext, *sh, ms, state)
                for ext, sh, (_, state) in zip(exts, shards, runs)]
    cfg_rec = dataclasses.replace(cfg, record_choices=True)
    ops, fallback = [], []
    for d, (dev, ext, sh, (out, _)) in enumerate(zip(
            mesh.devices, exts, shards, runs)):
        carry = E.walk_carry_init(out["final_s"], out["end_k"],
                                  out["status"] == E.ST_END_REACHED)
        blocks = []
        for i in range(len(snaps), -1, -1):
            if i == 0:
                seg, carry = E.align_batch_start_walk(cfg_rec, ext, *sh, ms,
                                                      carry)
            else:
                seg, carry = E.align_batch_replay_walk(
                    cfg_rec, ext, *sh, ms, _restore(snaps[i - 1][d], dev),
                    carry)
            blocks.insert(0, seg)
        ops.append(torch.cat(blocks, dim=1))
        fallback.append(carry[4] | carry[3])
    return dict(segments=len(snaps) + 1,
                status=_cat([out["status"] for out, _ in runs]),
                final_s=_cat([out["final_s"] for out, _ in runs]),
                ops=_cat(ops), fallback=_cat(fallback))


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the full alignment step over an n_devices-wide data-parallel
    mesh (the first n CUDA devices, or n CPU "devices") in FIVE configs:
    (1) end-to-end full scope with each shard's traceback walk, (2)
    ends-free with varied PER-PAIR free ends (WF0 multi-cell seeding under
    sharding), (3) the wf-adaptive heuristic in-loop, (4) mixed lengths
    under deliberately tight caps, so that pairs overflow and re-run at 4x
    the score cap, still sharded (the escalation ladder's mesh path), (5)
    the segmented run (forward segments, host snapshots, replays and
    walks) with sharded inputs. Raises AssertionError on any config that
    does not hold."""
    from ..align import WavefrontAligner
    from ..batch import PATTERN_SENTINEL, TEXT_SENTINEL, encode_batch
    from ..ops import engine as E
    from ..ops.config import full_config
    from .mesh import make_mesh

    if torch.device(device).type == "cuda":
        _require(torch.cuda.is_available()
                 and torch.cuda.device_count() >= n_devices,
                 f"need {n_devices} CUDA devices")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devices = [torch.device(device)] * n_devices
    mesh = make_mesh(devices)
    B = 8 * n_devices

    # (1) end-to-end, full scope, sharded walk
    cfg, args = _example_inputs(B=B, Lp=48, Lt=48)
    res1 = _shard_and_run(mesh, cfg, args, walk=True)
    _require((res1["status"] == E.ST_END_REACHED).all(), res1["status"])

    # (2) ends-free with varied per-pair frees (multi-cell WF0 seeds)
    attr_ef = WavefrontAligner(
        backend="numpy", span="ends-free", pattern_begin_free=8,
        pattern_end_free=8, text_begin_free=8,
        text_end_free=8)._attributes()
    cfg_ef = full_config(attr_ef, 48, 48)
    pat, txt, plen, tlen, _, ms = args
    frees_v = np.zeros((B, 4), dtype=np.int32)
    frees_v[:, 0] = np.arange(B) % 9       # pattern_begin_free 0..8
    frees_v[:, 1] = 8
    frees_v[:, 2] = (np.arange(B) * 3) % 9  # text_begin_free varied
    frees_v[:, 3] = 8
    res2 = _shard_and_run(mesh, cfg_ef, (pat, txt, plen, tlen,
                                         torch.from_numpy(frees_v), ms),
                          walk=True)
    _require((res2["status"] == E.ST_END_REACHED).all(), res2["status"])

    # (3) wfadaptive heuristic inside the sharded loop
    attr_h = WavefrontAligner(backend="numpy", span="end-to-end",
                              heuristic="adaptive")._attributes()
    cfg_h = full_config(attr_h, 48, 48)
    res3 = _shard_and_run(mesh, cfg_h, args, walk=True)
    # heuristic drops allowed, not expected here
    _require((res3["status"] == E.ST_END_REACHED).sum() >= B - 2,
             res3["status"])

    # (4) mixed lengths under tight caps -> escalate under the mesh
    rng = np.random.default_rng(1)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    pats, txts, lens = [], [], []
    for i in range(B):
        L = 32 if i % 2 == 0 else 96
        p = alphabet[rng.integers(0, 4, L)]
        t = p.copy()
        idx = rng.choice(L, 6, replace=False)  # 6 subs: score 24 > S_cap 16
        t[idx] = alphabet[(t[idx] + 1) % 4]
        pats.append(p.tobytes())
        txts.append(t.tobytes())
        lens.append(L)
    attr = WavefrontAligner(backend="numpy",
                            span="end-to-end")._attributes()
    cfg_small = full_config(attr, 96, 96, S_cap=16)
    C = cfg_small.extend_chunk
    pa = encode_batch(pats, 96, C, PATTERN_SENTINEL)
    ta = encode_batch(txts, 96, C, TEXT_SENTINEL)
    la = np.array(lens, dtype=np.int32)
    fr = np.zeros((B, 4), np.int32)
    ms = 2**31 - 1
    res4 = _shard_and_run(mesh, cfg_small, (pa, ta, la, la, fr, ms))
    over = res4["status"] == E.ST_OVERFLOW_S
    _require(over.any(), "tight caps should overflow some pairs")
    # escalation rung, still sharded: overflowed pairs re-dispatch at 4x
    # the score cap, padded back to a full device multiple
    idx = np.flatnonzero(over)
    take = np.resize(idx, B)  # pad the re-run batch to B with repeats
    cfg_big = full_config(attr, 96, 96, S_cap=cfg_small.S_cap * 4)
    res5 = _shard_and_run(mesh, cfg_big, (pa[take], ta[take], la[take],
                                          la[take], fr[take], ms))
    _require((res5["status"] == E.ST_END_REACHED).all(), res5["status"])

    # (5) segmented long-read path under the mesh
    cfg5_full, host5 = _example_inputs(B=B, Lp=64, Lt=64)
    cfg5 = dataclasses.replace(cfg5_full, S_cap=8, record_choices=False)
    seg5 = _segmented_under_mesh(mesh, cfg5, host5[:5])
    _require((seg5["status"] == E.ST_END_REACHED).all(), seg5["status"])
    _require(seg5["segments"] >= 2, "the segmented config must span "
             "several segments")
    _require(not seg5["fallback"].any(), "the segmented walk fell back "
             "under the mesh")
    n_walked = int((seg5["ops"] != 0).sum())
    _require(n_walked > 0, "the segmented walk emitted no op")
    print(f"segmented-under-mesh ok ({seg5['segments']} segments, "
          f"{n_walked} walked ops)")

    print(f"dryrun_multichip: {n_devices} devices, B={B}: OK "
          f"(e2e scores {res1['final_s'].min()}..{res1['final_s'].max()}; "
          f"ends-free ok; wfadaptive ok; "
          f"escalated {len(idx)}/{B} under mesh ok; "
          "segmented-under-mesh ok)")


if __name__ == "__main__":
    fn, args = entry(*sys.argv[2:3])
    out = fn(*args)
    print("entry OK:", [o[:4].tolist() for o in out])
    if len(sys.argv) > 1:
        dryrun_multichip(int(sys.argv[1]), *sys.argv[2:3])
