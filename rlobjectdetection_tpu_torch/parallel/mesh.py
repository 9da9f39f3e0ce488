"""The device of a rank and the replicated model (counterpart of
`rlobjectdetection_tpu/parallel/mesh.py`).

The JAX package shards the global batch over a 1-D `data` mesh with
replicated parameters, and XLA adds the gradient all-reduce. Here each
process holds one device and its rows of the batch, and
`DistributedDataParallel` broadcasts rank 0's parameters once and
all-reduces the gradients over NCCL (gloo on the CPU). `make_hybrid_mesh`,
which orders a multi-host mesh so that the all-reduce crosses hosts once,
has no counterpart: NCCL builds its rings and trees over the ranks itself.
"""

from __future__ import annotations

import torch
from torch.nn.parallel import DistributedDataParallel


def rank_device(device: torch.device, backend: str, local_rank: int) -> torch.device:
    """The device a rank computes on: `cuda:local_rank` under NCCL, which
    takes one GPU a rank and raises where the host has fewer GPUs than that
    (as `make_mesh` raises on too few devices); under gloo several ranks may
    share a GPU (`cuda:local_rank % count`); the CPU as it is. Sets the
    current CUDA device."""
    if device.type != "cuda":
        return device
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("CUDA is not available; pass device='cpu' for a gloo group")
    if backend == "nccl" and local_rank >= count:
        raise ValueError(f"local rank {local_rank} needs GPU {local_rank}, but this host has "
                         f"{count}: NCCL takes one GPU a rank")
    dev = torch.device("cuda", local_rank % count)
    torch.cuda.set_device(dev)
    return dev


def replicate(model: torch.nn.Module, device: torch.device) -> DistributedDataParallel:
    """`model` under DDP: rank 0's parameters and buffers are broadcast to
    every rank now, so call it after the weights are loaded and before the
    first forward (no rank's packed-kernel-operand cache is then built from
    other weights). Frozen BN needs no SyncBN, and the frozen buffers no
    broadcast each step. Every trainable parameter of the detectors and the
    RL net takes a gradient each step, so no unused-parameter search runs."""
    ids = [device.index] if device.type == "cuda" else None
    return DistributedDataParallel(model, device_ids=ids, broadcast_buffers=False)
