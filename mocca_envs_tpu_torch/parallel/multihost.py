"""Multi-process bring-up and the replica divergence check.

Counterpart of ``mocca_envs_tpu/parallel/multihost.py``. A multi-device run
is one process per device joined in one ``torch.distributed`` process group
(NCCL on CUDA, gloo on the CPU), the env batch sharded over the ``env``
mesh (``parallel/mesh.py``) and the learner's reductions averaged over the
group (``harness/ppo.py``).

:func:`check_replica_divergence` is the engine's stand-in for race
detection: every rank holds its own copy of the learner's parameters, kept
equal by averaging each gradient over the group; a fault or an update left
out on one rank would let the copies part silently, so each rank's
fingerprint of them is gathered and compared.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from mocca_envs_tpu_torch.parallel.mesh import default_backend
from mocca_envs_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

# the variables a launcher (torchrun) sets for the env:// rendezvous
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device=None) -> None:
    """Join the process group (a no-op for one process).

    ``coordinator_address`` (``host:port`` of process 0), ``num_processes``
    and ``process_id`` join over ``tcp://``; with none of them, a launcher's
    environment (``torchrun``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) joins over ``env://``, and without one the run is a
    single process, logged as such. The backend is NCCL for the CUDA card
    (``device=None``) and gloo for ``device="cpu"``. A join that was asked
    for and fails raises. Touches no CUDA device: call it before anything
    else does.
    """
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        return
    launched = all(k in os.environ for k in LAUNCHER_ENV)
    if coordinator_address is None and num_processes is None and not launched:
        logger.info("single-process run (no coordinator and no launcher environment)")
        return
    backend = default_backend(resolve_device(device))
    if coordinator_address is None:
        if not launched:
            raise ValueError(f"num_processes={num_processes} needs a coordinator address or a "
                             "launcher's environment")
        dist.init_process_group(backend, init_method="env://")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    logger.info("distributed: process %d/%d, backend %s", dist.get_rank(),
                dist.get_world_size(), backend)


def fingerprint(tree) -> np.ndarray:
    """Order-independent digest of a tree's values on the host: the float64
    sum and absolute sum over every tensor (modules and optimizers by their
    state dicts, dataclasses, tuples, lists and dicts walked, numbers
    counted), as the JAX package sums a pytree's leaves."""
    acc = np.zeros(2, dtype=np.float64)
    for leaf in _leaves(tree):
        a = np.asarray(leaf, dtype=np.float64).ravel()
        acc[0] += float(a.sum())
        acc[1] += float(np.abs(a).sum())
    return acc


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree.detach().to("cpu", torch.float64).numpy()
    elif isinstance(tree, np.ndarray) or (isinstance(tree, (int, float))
                                          and not isinstance(tree, bool)):
        yield tree
    elif isinstance(tree, (torch.nn.Module, torch.optim.Optimizer)):
        yield from _leaves(tree.state_dict())
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def check_replica_divergence(tree, mesh=None) -> bool:
    """True if ``tree`` is the same on every rank of the mesh's group (the
    default group without a mesh; always true for one process): each rank's
    :func:`fingerprint` is all-gathered and the rows compared at
    ``rtol=1e-6``."""
    group = None if mesh is None else mesh.group
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return True
    device = (torch.device("cuda", torch.cuda.current_device())
              if "nccl" in str(dist.get_backend(group)) else torch.device("cpu"))
    local = torch.as_tensor(fingerprint(tree), device=device)
    rows = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(rows, local, group=group)
    gathered = torch.stack(rows).cpu().numpy()
    return bool(np.allclose(gathered, gathered[0:1], rtol=1e-6, atol=0.0))
