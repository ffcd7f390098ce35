"""Device mesh over a process group.

Counterpart of ``mocca_envs_tpu/parallel/mesh.py``. JAX runs one controller
over global arrays and shards them over a mesh of devices; PyTorch runs one
process per device. So the port's mesh is the process group: a 1-D mesh
named ``env`` whose rank r holds, of every batch of B slots, its own shard
``[r·B/W, (r+1)·B/W)`` (:func:`env_sharding`), and a copy of everything
replicated (:func:`replicated`: the learner's network, optimizer and running
norms, kept equal by averaging every reduction over the group,
``harness/ppo.py``). Env stepping needs no collective.

The group's backend is NCCL on CUDA and gloo on the CPU. ``env_mesh`` joins
the group that ``parallel/multihost.py::initialize`` (or ``torchrun``)
started; a process that started none gets a group of one.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from mocca_envs_tpu_torch.utils.device import resolve_device

ENV_AXIS = "env"


def default_backend(device: torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def local_device(device=None) -> torch.device:
    """This process's device: the CPU where asked for, else the CUDA card of
    its local rank (``LOCAL_RANK`` under a launcher, else the global rank
    modulo the cards on the host); raises where there is no card."""
    device = resolve_device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True)
class EnvMesh:
    """A 1-D ``env`` mesh: ``size`` ranks, this process's ``rank`` and
    ``device``, and the process ``group`` its collectives run on."""

    device_mesh: object   # torch.distributed.device_mesh.DeviceMesh
    device: torch.device

    @property
    def size(self) -> int:
        return self.device_mesh.size()

    @property
    def rank(self) -> int:
        return self.device_mesh.get_local_rank(ENV_AXIS)

    @property
    def group(self):
        return self.device_mesh.get_group(ENV_AXIS)


def env_mesh(num_devices: int | None = None, device=None) -> EnvMesh:
    """1-D mesh over every rank of the process group, one device each
    (``device``: None is this rank's CUDA card, ``"cpu"`` the CPU). Without
    a group, a group of one starts here (NCCL on the card, gloo on the
    CPU). ``num_devices``, where given, must be the group's size: a mesh of
    the first N devices would leave the other processes out of every
    collective."""
    from torch.distributed.device_mesh import init_device_mesh

    device = local_device(device)
    if not dist.is_initialized():
        dist.init_process_group(default_backend(device), store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"a mesh of {num_devices} devices over a group of {world} processes: "
                         "start one process per device")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = init_device_mesh(device.type, (world,), mesh_dim_names=(ENV_AXIS,))
    return EnvMesh(mesh, device)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a batch axis lies over a mesh: split (rank r holds slots
    ``[r·B/W, (r+1)·B/W)``) or replicated (every rank holds all B)."""

    rank: int
    size: int
    split: bool = True

    def slots(self, num_envs: int) -> slice:
        """The slots of ``num_envs`` that this rank holds."""
        if not self.split:
            return slice(0, num_envs)
        if num_envs % self.size != 0:
            raise ValueError(f"num_envs={num_envs} must divide evenly over {self.size} devices")
        n = num_envs // self.size
        return slice(self.rank * n, (self.rank + 1) * n)

    def local(self, tree):
        """This rank's part of a batched tree (dataclasses, tuples, lists and
        dicts of tensors whose leading axis is the batch; None passes)."""
        if tree is None:
            return None
        if isinstance(tree, torch.Tensor):
            if tree.dim() == 0:
                raise ValueError("a 0-d tensor has no batch axis to shard")
            return tree[self.slots(tree.shape[0])]
        if dataclasses.is_dataclass(tree):
            return dataclasses.replace(tree, **{f.name: self.local(getattr(tree, f.name))
                                                for f in dataclasses.fields(tree)})
        if isinstance(tree, (tuple, list)):
            return type(tree)(self.local(x) for x in tree)
        if isinstance(tree, dict):
            return {k: self.local(v) for k, v in tree.items()}
        raise TypeError(f"cannot shard a {type(tree).__name__}")


def env_sharding(mesh: EnvMesh) -> Sharding:
    """Leading-axis sharding: the env batch split over the mesh."""
    return Sharding(mesh.rank, mesh.size, True)


def replicated(mesh: EnvMesh) -> Sharding:
    """Every rank holds the whole."""
    return Sharding(mesh.rank, mesh.size, False)

