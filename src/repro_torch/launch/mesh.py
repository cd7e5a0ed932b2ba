"""The (data, model) mesh of process groups (counterpart of
``repro/launch/mesh.py``): one rank per process, as ``torchrun`` starts
them.

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2,2 ...

``--mesh d,m`` is d * m ranks; rank r has data index r // m and model
index r % m, so the m ranks of a model group are consecutive (a node's
cards, the hierarchical substrates' intra tier). ``make_group``
initialises the default process group (NCCL on ``cuda``, gloo on ``cpu``,
unless ``backend`` names one), builds the data groups (the ranks of one
model index) and the model groups (the ranks of one data index) and
returns the ``ParallelContext`` the model threads to its MoE layers. The
experts' layout on a model axis m > 1 is ``MoEConfig.ep_on_model``'s:
tensor parallelism inside the experts with expert parallelism over the
data group, or whole experts over data x model (``core/moe.py``).

``MeshShape`` describes a mesh by axis names and sizes alone, with no
device and no process group: ``production_mesh`` gives the reference's
production meshes, (data 16, model 16) and, with ``multi_pod``, (pod 2,
data 16, model 16), which the sharding rules (``parallel/sharding.py``)
and the meta-device dry run (``launch/dryrun.py``) read.
"""
from __future__ import annotations

import math
import os
import socket
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.moe import ParallelContext

EP_AXIS = "data"     # batch sharding AND expert parallelism (EP == DP)
TP_AXIS = "model"    # tensor parallelism: heads, d_ff, vocab
POD_AXIS = "pod"     # extra pure data parallelism (multi-pod)


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes (no devices): ``shape`` maps name to
    size as ``jax.sharding.Mesh.shape`` does. Batches shard over the data
    axes (``POD_AXIS`` then ``EP_AXIS``), experts over ``EP_AXIS`` (the
    paper's layout), heads, d_ff and vocab over ``TP_AXIS``."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or min(self.sizes, default=1) < 1:
            raise ValueError(f"mesh {self.axis_names} x {self.sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        if POD_AXIS in self.axis_names:
            return (POD_AXIS, EP_AXIS)
        return (EP_AXIS,)

    @property
    def name(self) -> str:
        """The artifact's mesh tag: pod256 / pod512 for the production
        meshes, else the sizes joined by "x"."""
        known = {(("data", "model"), (16, 16)): "pod256",
                 (("pod", "data", "model"), (2, 16, 16)): "pod512"}
        return known.get((self.axis_names, self.sizes),
                         "x".join(str(n) for n in self.sizes))


def production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """One pod: (data 16, model 16) = 256 devices; multi-pod: (pod 2,
    data 16, model 16) = 512 (the reference's ``make_production_mesh``)."""
    if multi_pod:
        return MeshShape((POD_AXIS, EP_AXIS, TP_AXIS), (2, 16, 16))
    return MeshShape((EP_AXIS, TP_AXIS), (16, 16))


def parse_mesh(spec: str) -> Tuple[int, int]:
    """``--mesh d`` or ``d,m`` -> (d, m)."""
    dims = [int(d) for d in spec.split(",")]
    if len(dims) > 2 or any(d < 1 for d in dims):
        raise ValueError(f"--mesh {spec!r}: d or d,m")
    return dims[0], dims[1] if len(dims) == 2 else 1


def make_group(mesh: Tuple[int, int], device, *, init_method: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               backend: Optional[str] = None,
               ep_on_model: bool = False) -> ParallelContext:
    """Initialise the default process group over the d * m ranks of
    ``mesh`` = (d, m) and return this rank's context (active even at one
    rank), laid out by ``ep_on_model``. Rank and world size come from the
    environment ``torchrun`` sets (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR/PORT) unless given; a ``file://`` ``init_method`` needs no
    port, and a one-rank group started without ``torchrun`` takes a free
    localhost port. On ``cuda`` each rank takes the card LOCAL_RANK.
    ``backend`` overrides NCCL / gloo (gloo on ``cuda`` runs the model
    axis of several ranks on one card: NCCL refuses two ranks of a group
    on one device). ``dist.new_group`` is collective: every rank builds
    every data and model group, in the same order."""
    dp, tp = mesh
    device = torch.device(device)
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    if world_size != dp * tp:
        raise ValueError(f"--mesh {dp},{tp} is {dp * tp} ranks, under a world of "
                         f"{world_size} processes")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    if init_method is None:
        init_method = ("env://" if "MASTER_ADDR" in os.environ or world_size > 1
                       else f"tcp://localhost:{_free_port()}")
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"),
            init_method=init_method, rank=rank, world_size=world_size)
    rank = dist.get_rank()
    data_group = model_group = None        # one axis: the whole group
    if dp > 1 and tp > 1:
        for k in range(tp):
            g = dist.new_group([j * tp + k for j in range(dp)])
            if rank % tp == k:
                data_group = g
        for j in range(dp):
            g = dist.new_group([j * tp + k for k in range(tp)])
            if rank // tp == j:
                model_group = g
    return ParallelContext(group=dist.group.WORLD, rank=rank, dp=dp, tp=tp,
                           data_group=data_group, model_group=model_group,
                           ep_on_model=ep_on_model)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def close_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
