"""Data-parallel layer of the port: devices, ranks and process groups.

Counterpart of abcnet_tpu/parallel/mesh.py. The JAX package runs one
SPMD program over a 1-D `data` mesh: the batch sharded, parameters
replicated, BatchNorm statistics over the global batch, several hosts
joined by `jax.distributed.initialize`. PyTorch's idiom for the same
is one process per GPU:

  * `init_distributed()` (the counterpart of jax.distributed.initialize)
    joins the process group that `torchrun` describes in the
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT): NCCL for CUDA, gloo for an explicit CPU run (tests);
  * `make_mesh` describes the devices this process drives, its rank and
    the group. Training takes one device per rank. Serving
    (infer/decode.py) takes either kind: in one process without a group,
    N local GPUs (`img2smiles --mesh N`), a row block each; in a process
    group, one GPU per rank, each rank serving its own rows (the JAX
    package's multi-host inference);
  * `local_rows` is a rank's contiguous slice of a global batch, and
    `shard_batch` gives a rank those rows of a global host batch, which
    every rank draws in the same seeded order, so W ranks see exactly
    what one process at the global batch sees;
  * `replicate_tree` broadcasts rank 0's parameters and buffers;
  * `sync_batchnorm` hands the group to every BatchNorm of a model, which
    then normalizes over the global batch (ops/bn_act.py:bn_act with
    `group`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh as one process sees it: the devices it drives, its
    rank among `world` processes, and their process group (None in a
    single process)."""
    devices: Tuple[torch.device, ...]
    rank: int = 0
    world: int = 1
    group: Any = None

    @property
    def device(self) -> torch.device:
        """This process's device (training drives one)."""
        return self.devices[0]


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def init_distributed(device="cuda") -> Mesh:
    """Join the process group described by the environment (as torchrun
    sets it) and return this rank's mesh. The backend is NCCL for CUDA
    and gloo for device="cpu". A CUDA rank takes GPU LOCAL_RANK. Without
    WORLD_SIZE in the environment this is a single process: no group."""
    dev = resolve_device(device)
    if "WORLD_SIZE" not in os.environ:
        return make_mesh(1, device)
    if dev.type == "cuda":
        torch.cuda.set_device(_env_int("LOCAL_RANK", 0))
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                rank=_env_int("RANK", 0),
                                world_size=_env_int("WORLD_SIZE", 1))
    return make_mesh(device=device)


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The data mesh. Inside a process group: this rank and its one device
    (GPU LOCAL_RANK, or the CPU), across all ranks; `n_devices`, if
    given, must be the world size. In a single process: the first
    `n_devices` GPUs (all visible ones by default), or `n_devices` copies
    of the CPU for device="cpu" (the tests' stand-in for several
    devices)."""
    dev = resolve_device(device)
    if dist.is_initialized():
        world = dist.get_world_size()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"make_mesh({n_devices}) inside a process group "
                             f"of {world} ranks: one device per rank")
        local = (torch.device("cuda", _env_int("LOCAL_RANK", 0))
                 if dev.type == "cuda" else dev)
        return Mesh((local,), dist.get_rank(), world, dist.group.WORLD)
    if dev.type == "cpu":
        return Mesh((dev,) * (n_devices or 1))
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"make_mesh({n_devices}): {count} GPUs visible")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def local_rows(n_global: int, mesh: Mesh) -> slice:
    """This rank's rows [r·B/W, (r+1)·B/W) of a global batch of B rows,
    the process-local slice of the JAX package's multi-process
    shard_batch. B must divide by the world size (mesh.py:51-52 of the
    JAX package)."""
    if n_global % mesh.world:
        raise ValueError(f"batch {n_global} does not divide over "
                         f"{mesh.world} ranks")
    n = n_global // mesh.world
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows (`local_rows`) of a global host batch dict."""
    rows = local_rows(len(next(iter(batch.values()))), mesh)
    return {k: v[rows] for k, v in batch.items()}


def replicate_tree(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place
    (the reference ships rank 0's initial state the same way,
    multi_gpu_train2.py:91-96)."""
    if mesh.world > 1:
        with torch.no_grad():
            for t in module.state_dict().values():
                dist.broadcast(t, src=0, group=mesh.group)
    return module


def sync_batchnorm(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every BatchNorm of `module` normalizes over the global batch of the
    mesh's ranks in train mode: its `group` goes to ops/bn_act.py:bn_act,
    which all-gathers the ranks' statistics in the forward and all-reduces
    the two sums of the backward."""
    from ..models.unet import BatchNorm
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = mesh.group if mesh.world > 1 else None
    return module


def all_reduce_sum(tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the mesh's ranks (in place; the tensor itself in a
    single process)."""
    if mesh.world > 1:
        dist.all_reduce(tensor, group=mesh.group)
    return tensor
