"""Data-parallel alignment over a mesh of devices, on torch.distributed.

The twin of `pywfa_tpu/parallel/mesh.py`. Read pairs are cut along the
batch axis into contiguous equal shards, one a device of the mesh, and
every device runs the same `ops.engine.align_batch` on its shard: every
tensor of the engine carries the batch axis, so the shards never talk to
each other. The reference compiles this as one SPMD program over a
`jax.sharding.Mesh`; here it is a loop over this process's devices that
enqueues each device's work before it waits on any, and across processes
a `torch.distributed` process group (NCCL between cards, one rank a card;
gloo on the CPU). With `gather_results` the small per-pair meta comes back
whole on every process through one `all_gather`, the design's only
collective; the choice record stays on the device of its shard.

Every process holds the full host copy of the batch and takes its own rows
out of it (`make_global_batch`): inputs are not exchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..batch import _resolve_device
from ..ops import engine as E
from ..ops.config import EngineConfig

# the per-pair meta that gather_results brings back whole
META = ("status", "final_s", "end_k", "end_off")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: this process's devices in shard order,
    and the process group that joins it to the other processes (None in a
    single process). Every process gives the same number of devices;
    shard p * len(devices) + i lies on device i of process p."""

    devices: Tuple[torch.device, ...]
    process_index: int = 0
    process_count: int = 1
    group: Optional[object] = None

    @property
    def size(self) -> int:
        """Devices of the whole mesh, over every process."""
        return len(self.devices) * self.process_count


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D data-parallel mesh over every CUDA device of this process (or
    the given devices, `[torch.device("cpu")] * n` on the host), joined to
    the default process group where `distributed_init` made one. Raises
    where CUDA is absent and no devices are given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass the devices, "
                               "[torch.device('cpu')] * n, to run on the "
                               "host")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(_resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if dist.is_available() and dist.is_initialized():
        return Mesh(devs, dist.get_rank(), dist.get_world_size(),
                    dist.group.WORLD)
    return Mesh(devs)


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> None:
    """Multi-process bring-up (`torch.distributed.init_process_group`);
    a no-op for a single process. The backend follows `device`: NCCL for
    "cuda" (one rank a card; raises where CUDA is absent), gloo for "cpu".
    `coordinator_address` is "host:port" or a URL such as
    "tcp://localhost:29500"."""
    if num_processes is None or num_processes <= 1:
        return
    dev = _resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is not None and "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)


def _local_shards(mesh: Mesh, a) -> list:
    """This process's shards of one batch input, each on its device: `a`
    itself where it is already a list of them (make_global_batch's), else
    the process's rows of `a`, the whole batch (a tensor or an array)."""
    if isinstance(a, (list, tuple)):
        if len(a) != len(mesh.devices):
            raise ValueError(f"{len(a)} shards for {len(mesh.devices)} "
                             "devices")
        return [torch.as_tensor(s).to(d) for s, d in zip(a, mesh.devices)]
    t = torch.as_tensor(a)
    B = t.shape[0]
    if B % mesh.size:
        raise ValueError(f"a batch of {B} pairs does not divide over "
                         f"{mesh.size} devices")
    per = B // mesh.size
    first = mesh.process_index * len(mesh.devices)
    return [t[(first + i) * per:(first + i + 1) * per].to(d)
            for i, d in enumerate(mesh.devices)]


def _gather(mesh: Mesh, outs: list) -> dict:
    """The meta of every shard of every process, whole, on this process's
    first device: one int32 vector a process (its shards' META rows and
    its steps), all_gathered over the group; steps is the max."""
    dev = mesh.devices[0]
    local = torch.cat([torch.stack([o[k] for k in META]).to(dev, torch.int32)
                       for o in outs], dim=1)
    steps = torch.stack([o["steps"].to(dev, torch.int32) for o in outs])
    vec = torch.cat([local.reshape(-1), steps.max().reshape(1)])
    parts = [vec]
    if mesh.group is not None:
        parts = [torch.empty_like(vec) for _ in range(mesh.process_count)]
        dist.all_gather(parts, vec, group=mesh.group)
    n = local.shape[1]
    meta = torch.cat([p[:-1].view(len(META), n) for p in parts], dim=1)
    out = {k: meta[i] for i, k in enumerate(META)}
    out["steps"] = torch.stack([p[-1] for p in parts]).max()
    return out


def sharded_align_batch(cfg: EngineConfig, mesh: Mesh,
                        gather_results: bool = False):
    """`engine.align_batch` over the mesh, as a callable with its
    arguments (pat, txt, plen, tlen, frees, max_steps).

    Each batch input is the whole batch (B divisible by mesh.size; each
    process takes its rows) or this process's shards from
    make_global_batch. The call enqueues every local device's shard
    before it waits on any. It returns a dict whose values are lists of
    this process's shards in mesh order, each on its device (the choice
    record [S_cap, B / mesh.size, W] per shard: the reference's
    P(None, "data", None)). With gather_results the META entries are
    instead the whole batch's [B] int32 on the first local device and
    `steps` the max over every shard, all_gathered over the process
    group; the choices stay where they are.
    """
    def fn(pat, txt, plen, tlen, frees, max_steps):
        shards = [_local_shards(mesh, a) for a in (pat, txt, plen, tlen,
                                                   frees)]
        outs = [E.align_batch(cfg, *args, max_steps)
                for args in zip(*shards)]
        out = {k: [o[k] for o in outs] for k in outs[0]}
        if gather_results:
            out.update(_gather(mesh, outs))
        return out

    return fn


def make_global_batch(mesh: Mesh, host_arrays: dict) -> dict:
    """This process's shards of full host copies of the batch inputs:
    {name: array} (batch axis first; every process holds the same full
    copy) -> {name: [tensor on each local device]}. No input crosses
    between processes, as in the reference's replicated-input design."""
    return {name: _local_shards(mesh, a) for name, a in host_arrays.items()}
