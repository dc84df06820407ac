"""Data parallelism over torch.distributed: the port of
shasta_tpu/parallel/mesh.py.

The reference trains single-node data parallel over NCCL
(tools/nusc_shasta/train.py:92-156); the JAX package shards the batch over
a 1-D 'data' mesh and pmeans the grads. The port runs one process per card,
started by torchrun, each with its own share of the data (the loader's
shard_id=rank, num_shards=world: the JAX per-host sharded loading with one
device per host); grads and loss are all-reduced as means before each
update (train/loop.py). One process per card also keeps each process's
kernel libraries to one device.

    torchrun --nproc_per_node 4 -m shasta_tpu_torch.tools.train --config ...

Nothing here runs at import; without WORLD_SIZE > 1 in the environment no
process group is made and every helper is a no-op.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


def init_from_env(device_type: str) -> torch.device:
    """Join the process group torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL for "cuda", each process on
    card LOCAL_RANK; gloo for "cpu". Returns this process's device."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if device_type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    else:
        device = torch.device(device_type)
    if world > 1 and not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                rank=int(os.environ["RANK"]), world_size=world)
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if world_size() > 1 else 0


def all_reduce_mean(tensors: list[torch.Tensor]) -> None:
    """Each tensor becomes its mean over the ranks, in place, through one
    all-reduce of their concatenation."""
    n = world_size()
    if n == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= n
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `module` from rank `src`."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src)


def shutdown() -> None:
    if world_size() > 1:
        dist.destroy_process_group()
