"""The port's mesh across processes (multi-host simulation on the CPU).

Launches 2 OS processes of tools/mp_worker_torch.py, each with 2 CPU
"devices", joined by a gloo process group into one 4-device mesh; the
gathered meta must be the same on both processes, equal to a
single-process run of the same corpus (no process group), and equal to
the reference's `pywfa_tpu.ops.engine.align_batch` run here on the same
corpus (the twin of tests/test_multiprocess.py).
"""
import importlib.util
import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from pywfa_tpu.align import WavefrontAligner
from pywfa_tpu.batch import PATTERN_SENTINEL, TEXT_SENTINEL, encode_batch
from pywfa_tpu.ops import engine as E

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "mp_worker_torch.py")

B, L = 16, 64


def _free_port():
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(nproc, port, tmp_path):
    procs = []
    outs = []
    for pid in range(nproc):
        out = tmp_path / f"mp_torch_{nproc}_{pid}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(nproc), str(port),
             str(B), str(L), str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    try:
        for p in procs:
            _, se = p.communicate(timeout=300)
            assert p.returncode == 0, se.decode()[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [json.loads(out.read_text()) for out in outs]


def _reference_meta():
    spec = importlib.util.spec_from_file_location("mp_worker_torch", WORKER)
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    pats, txts = worker.make_corpus(B, L)
    attr = WavefrontAligner(backend="numpy", span="end-to-end",
                            scope="score")._attributes()
    cfg = E.full_config(attr, L, L, record_choices=False)
    C = cfg.extend_chunk
    out = E.align_batch(
        cfg, jnp.asarray(encode_batch(pats, cfg.Lp, C, PATTERN_SENTINEL)),
        jnp.asarray(encode_batch(txts, cfg.Lt, C, TEXT_SENTINEL)),
        jnp.full((B,), L, jnp.int32), jnp.full((B,), L, jnp.int32),
        jnp.zeros((B, 4), jnp.int32), jnp.int32(2**31 - 1))
    return {k: np.asarray(out[k]).tolist()
            for k in ("status", "final_s", "end_k", "end_off")}


def test_two_process_matches_single(tmp_path):
    # port probing is racy (another process can bind between probe and
    # the group's rendezvous); retry once on a fresh port
    try:
        recs2 = _launch(2, _free_port(), tmp_path)
    except (AssertionError, subprocess.TimeoutExpired):
        recs2 = _launch(2, _free_port(), tmp_path)
    assert all(r["global_devices"] == 4 for r in recs2)
    assert all(r["local_devices"] == 2 for r in recs2)
    # both processes must see the SAME gathered results
    assert recs2[0]["meta"] == recs2[1]["meta"]
    assert recs2[0]["steps"] == recs2[1]["steps"]
    # and they must equal a single-process run of the same corpus
    recs1 = _launch(1, _free_port(), tmp_path)
    assert recs1[0]["global_devices"] == 2
    assert recs1[0]["meta"] == recs2[0]["meta"]
    assert recs1[0]["steps"] == recs2[0]["steps"] == max(
        recs2[0]["meta"]["final_s"])
    # and the reference's unsharded engine on the same corpus
    assert recs2[0]["meta"] == _reference_meta()
    assert all(s == 1 for s in recs2[0]["meta"]["status"])  # ST_END_REACHED
