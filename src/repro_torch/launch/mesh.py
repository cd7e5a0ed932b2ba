"""The expert-parallel process group (counterpart of
``repro/launch/mesh.py``): one rank per process, as ``torchrun`` starts
them.

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh 2 ...

``make_group`` initialises the default process group (NCCL on ``cuda``,
gloo on ``cpu``) and returns the ``ParallelContext`` the model threads to
its MoE layers: expert parallelism over every rank (the EP group is the
data-parallel group). Only that one axis is ported: a model axis (tensor
parallelism inside the experts, or experts over data x model) is not.
"""
from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.moe import ParallelContext


def parse_mesh(spec: str) -> int:
    """``--mesh N`` (or ``N,1``) -> N. A model axis larger than one raises:
    tensor parallelism inside experts is not ported."""
    dims = [int(d) for d in spec.split(",")]
    if len(dims) > 2 or any(d < 1 for d in dims):
        raise ValueError(f"--mesh {spec!r}: N or N,M")
    if len(dims) == 2 and dims[1] > 1:
        raise NotImplementedError(
            f"--mesh {spec}: a model axis (tensor parallelism inside the "
            "experts, experts over data x model) is not ported; see "
            "ROADMAP.md A.5")
    return dims[0]


def make_group(ep: int, device, *, init_method: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None) -> ParallelContext:
    """Initialise the default process group over ``ep`` ranks and return
    this rank's context (expert parallelism over the whole group, active
    even at ep = 1). Rank and world size come from the environment
    ``torchrun`` sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT)
    unless given; a ``file://`` ``init_method`` needs no port, and a
    one-rank group started without ``torchrun`` takes a free localhost
    port. On ``cuda`` each rank takes the card LOCAL_RANK."""
    device = torch.device(device)
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    if world_size != ep:
        raise ValueError(f"--mesh {ep} under a world of {world_size} processes")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    if init_method is None:
        init_method = ("env://" if "MASTER_ADDR" in os.environ or world_size > 1
                       else f"tcp://localhost:{_free_port()}")
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=init_method, rank=rank, world_size=world_size)
    return ParallelContext(group=dist.group.WORLD, rank=dist.get_rank(),
                           ep=dist.get_world_size())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def close_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
