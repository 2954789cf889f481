"""Multi-process alignment worker of the PyTorch port, on the CPU.

The twin of tools/mp_worker.py. One OS process per simulated host, each
with LOCAL_DEVICES CPU "devices"; `parallel.mesh.distributed_init` joins
the processes into one gloo process group, and
`parallel.mesh.sharded_align_batch` runs the batch data-parallel across
the global mesh, the per-pair meta all_gathered to every process.
Launched by tests/test_torch_multiprocess.py:

    python tools/mp_worker_torch.py <pid> <nproc> <port> <B> <L> <out.json>

Every process builds the identical seeded corpus and contributes its
local shards; each writes its own JSON (the launcher checks that the
processes agree). Imports no jax.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

LOCAL_DEVICES = 2


def make_corpus(B, L, seed=7):
    """B pairs of L bp, three substitutions a text (the corpus of
    tools/mp_worker.py)."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    pats = alpha[rng.integers(0, 4, (B, L))]
    txts = pats.copy()
    for i in range(B):
        idx = rng.choice(L, 3, replace=False)
        txts[i, idx] = alpha[rng.integers(0, 4, 3)]
    return ([pats[i].tobytes() for i in range(B)],
            [txts[i].tobytes() for i in range(B)])


def main():
    pid, nproc, port, B, L = (int(a) for a in sys.argv[1:6])
    out_path = sys.argv[6]
    torch.set_num_threads(1)

    import torch.distributed as dist

    from pywfa_tpu_torch.align import WavefrontAligner
    from pywfa_tpu_torch.batch import (PATTERN_SENTINEL, TEXT_SENTINEL,
                                       encode_batch)
    from pywfa_tpu_torch.ops.config import full_config
    from pywfa_tpu_torch.parallel.mesh import (META, distributed_init,
                                               make_global_batch, make_mesh,
                                               sharded_align_batch)

    distributed_init(coordinator_address=f"localhost:{port}",
                     num_processes=nproc, process_id=pid, device="cpu")
    try:
        mesh = make_mesh([torch.device("cpu")] * LOCAL_DEVICES)
        pats, txts = make_corpus(B, L)
        attr = WavefrontAligner(backend="numpy", span="end-to-end",
                                scope="score")._attributes()
        cfg = full_config(attr, L, L, record_choices=False)
        C = cfg.extend_chunk
        g = make_global_batch(mesh, dict(
            pat=encode_batch(pats, cfg.Lp, C, PATTERN_SENTINEL),
            txt=encode_batch(txts, cfg.Lt, C, TEXT_SENTINEL),
            plen=np.full((B,), L, np.int32),
            tlen=np.full((B,), L, np.int32),
            frees=np.zeros((B, 4), np.int32)))
        fn = sharded_align_batch(cfg, mesh, gather_results=True)
        out = fn(g["pat"], g["txt"], g["plen"], g["tlen"], g["frees"],
                 2**31 - 1)
        rec = dict(process_id=pid, num_processes=nproc,
                   local_devices=len(mesh.devices),
                   global_devices=mesh.size, B=B, L=L,
                   steps=int(out["steps"]),
                   meta={k: out[k].tolist() for k in META})
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(rec, f)
    print(f"proc {pid}/{nproc}: {B} pairs over {rec['global_devices']} "
          "global devices", flush=True)


if __name__ == "__main__":
    main()
