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
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any

import torch

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


class CheckpointManager:
    """Numbered checkpoints in one directory, the newest ``max_to_keep``
    kept. Saves are written to a temporary file and renamed, so a cut save
    leaves the previous checkpoint whole."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def save(self, step: int, state: Any) -> None:
        """Save a train state (e.g. ``harness/ppo.TrainState``) at ``step``."""
        tmp = self._path(step) + ".tmp"
        torch.save({"step": step, "state": to_tree(state)}, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.unlink(self._path(old))

    def restore(self, state_like: Any, step: int | None = None) -> Any:
        """Restore the latest (or given) step into ``state_like``'s structure."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        saved = torch.load(self._path(step), map_location="cpu", weights_only=True)
        return from_tree(state_like, saved["state"])

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """No resources are held between calls."""
