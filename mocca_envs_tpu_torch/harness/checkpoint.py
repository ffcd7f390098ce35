"""Checkpoint and resume over ``torch.save``.

Counterpart of ``mocca_envs_tpu/harness/checkpoint.py`` (orbax there), with
the same API. A checkpoint holds a whole train state: the network's and the
optimizer's state dicts (its step count included), the env state, the
carried observations, the generators' states, the update count and the
running norms, so a resume on the same device continues the run exactly;
a rollout provider's state (the mixed suite's) holds a tuple of each per
family. The state is written as a tree of dicts, lists, numbers and tensors
(no pickled objects) and read back with ``weights_only=True`` into a
template of the same structure (``restore(state_like)``): tensors land on
the template's device; a template whose structure differs (a field, a
shape, a dtype, or a tuple of another length) raises
:class:`CheckpointMismatch`.

Over a mesh (``parallel/mesh.py``) every rank holds its own env shard and
generators: a save gathers each rank's state to rank 0, which writes them
all in one file with the world size, and a restore gives each rank its own.
A checkpoint restores only at the world size that wrote it (a plain one at
one device); another raises :class:`CheckpointMismatch` naming both.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any

import torch
import torch.distributed as dist

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointMismatch(ValueError):
    """The checkpoint's structure is not the template's."""


def to_tree(x) -> Any:
    """A train state (dataclasses of tensors, modules, optimizers and
    generators, and tuples of them) as a tree of plain containers and
    tensors."""
    if x is None or isinstance(x, (bool, int, float, str, torch.Tensor)):
        return x
    if isinstance(x, torch.Generator):
        return {"generator": x.get_state()}
    if isinstance(x, torch.nn.Module):
        return {"module": x.state_dict()}
    if isinstance(x, torch.optim.Optimizer):
        return {"optimizer": x.state_dict()}
    if dataclasses.is_dataclass(x):
        return {"fields": {f.name: to_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}}
    if isinstance(x, dict):
        return {"dict": {k: to_tree(v) for k, v in x.items()}}
    if isinstance(x, (tuple, list)):
        return {"list": [to_tree(v) for v in x]}
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def from_tree(like, tree, path: str = "state"):
    """``like`` with the values of ``tree`` (from :func:`to_tree` of a state
    of the same structure): modules, optimizers and generators are loaded in
    place, tensors moved to ``like``'s device."""
    if like is None or tree is None:
        if like is not None or tree is not None:
            raise CheckpointMismatch(f"{path}: the checkpoint has {type(tree).__name__}, "
                                     f"the template {type(like).__name__}")
        return None
    if isinstance(like, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or tree.shape != like.shape \
                or tree.dtype != like.dtype:
            raise CheckpointMismatch(f"{path}: the checkpoint's {_describe(tree)} does not fit "
                                     f"the template's {_describe(like)}")
        return tree.to(like.device)
    if isinstance(like, (bool, int, float, str)):
        return type(like)(tree)
    if isinstance(like, (tuple, list)):
        if not isinstance(tree, dict) or not isinstance(tree.get("list"), list):
            raise CheckpointMismatch(f"{path}: the checkpoint holds no list here")
        if len(tree["list"]) != len(like):
            raise CheckpointMismatch(f"{path}: the checkpoint has {len(tree['list'])} entries, "
                                     f"the template {len(like)}")
        return type(like)(from_tree(a, b, f"{path}[{i}]")
                          for i, (a, b) in enumerate(zip(like, tree["list"])))
    key = ("generator" if isinstance(like, torch.Generator) else
           "module" if isinstance(like, torch.nn.Module) else
           "optimizer" if isinstance(like, torch.optim.Optimizer) else
           "fields" if dataclasses.is_dataclass(like) else "dict")
    if not isinstance(tree, dict) or key not in tree:
        raise CheckpointMismatch(f"{path}: the checkpoint holds no {key} here")
    tree = tree[key]
    if key in ("generator", "module", "optimizer"):
        try:
            like.set_state(tree.cpu()) if key == "generator" else like.load_state_dict(tree)
        except (RuntimeError, ValueError, KeyError) as e:
            raise CheckpointMismatch(f"{path}: {e}") from e
        return like
    names = ([f.name for f in dataclasses.fields(like)] if key == "fields" else list(like))
    if set(names) != set(tree):
        raise CheckpointMismatch(f"{path}: the checkpoint has {sorted(tree)}, the template "
                                 f"{sorted(names)}")
    values = {k: from_tree(getattr(like, k) if key == "fields" else like[k], tree[k],
                           f"{path}.{k}") for k in names}
    return dataclasses.replace(like, **values) if key == "fields" else values


def _describe(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"tensor {tuple(x.shape)} {x.dtype}"
    return type(x).__name__


def _to_cpu(tree):
    """A :func:`to_tree` tree with every tensor on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    """Numbered checkpoints in one directory, the newest ``max_to_keep``
    kept. Saves are written to a temporary file and renamed, so a cut save
    leaves the previous checkpoint whole. With a ``mesh`` every rank calls
    :meth:`save` and :meth:`restore`; the directory is shared."""

    def __init__(self, directory: str, max_to_keep: int = 3, mesh=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def save(self, step: int, state: Any) -> None:
        """Save a train state (e.g. ``harness/ppo.TrainState``) at ``step``."""
        if self.mesh is None:
            self._write(step, {"step": step, "state": to_tree(state)})
            return
        group, world = self.mesh.group, self.mesh.size
        trees = [None] * world if self.mesh.rank == 0 else None
        dist.gather_object(_to_cpu(to_tree(state)), trees, dst=dist.get_global_rank(group, 0),
                           group=group)
        if self.mesh.rank == 0:
            self._write(step, {"step": step, "world": world, "ranks": trees})
        dist.barrier(group=group)

    def _write(self, step: int, payload: dict) -> None:
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.unlink(self._path(old))

    def restore(self, state_like: Any, step: int | None = None) -> Any:
        """Restore the latest (or given) step into ``state_like``'s structure."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        saved = torch.load(self._path(step), map_location="cpu", weights_only=True)
        world = saved.get("world", 1)
        want = 1 if self.mesh is None else self.mesh.size
        if world != want:
            raise CheckpointMismatch(f"the checkpoint was written at world size {world}, this "
                                     f"run has world size {want}")
        tree = saved["state"] if "state" in saved else saved["ranks"][
            0 if self.mesh is None else self.mesh.rank]
        return from_tree(state_like, tree)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """No resources are held between calls."""
