"""Debug modes: NaN hunting and state validation.

Counterpart of ``mocca_envs_tpu/utils/debug.py``. The hazards of a batched
engine are NaN propagation through a batch and silent divergence; the tools:

- ``nan_debug()``: a context manager under which every PyTorch op whose
  floating output holds a NaN or an infinity raises ``FloatingPointError``
  naming the op (a ``TorchDispatchMode``: one check and one host read per
  op — slow, opt-in only, as the JAX package's ``jax_debug_nans``);
- ``finite_fraction``: the share of finite scalars over a state tree, a
  cheap health metric;
- ``validate_state``: raises ``FloatingPointError`` naming the field path of
  the first non-finite leaf of a state tree (the JAX package's checkify
  assertion);
- production runs instead rely on the health mask of envs/env.make_fn_env:
  blow-ups force an auto-reset and are counted.

A state tree is a dataclass, dict, list or tuple of tensors (``None`` for an
absent field), as the env states are.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def _leaves(tree, path: str = ""):
    """(path, tensor) for every tensor leaf, in field order; the path in the
    JAX package's ``keystr`` form (``.field``, ``['key']``, ``[i]``)."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")


class _NonFiniteCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and not bool(torch.isfinite(t).all())):
                raise FloatingPointError(f"non-finite output of {func}")
        return out


@contextlib.contextmanager
def nan_debug():
    """Raise at the first op inside the block whose floating output is not
    finite (debug runs only)."""
    with _NonFiniteCheck():
        yield


def finite_fraction(tree) -> torch.Tensor:
    """Fraction of finite scalars across the floating leaves of a state tree
    (a 0-d f32 tensor on the first leaf's device; 0 where there is none)."""
    total = 0
    finite = None
    for _, leaf in _leaves(tree):
        if leaf.is_floating_point():
            total += leaf.numel()
            part = torch.isfinite(leaf).to(torch.float32).sum()
            finite = part if finite is None else finite + part.to(finite.device)
    if finite is None:
        return torch.zeros(())
    # a tensor divisor: CUDA divides by a Python number as a multiply by its
    # reciprocal, which puts an all-finite tree one ulp under 1
    return finite / torch.full((), float(max(total, 1)), device=finite.device)


def validate_state(state, name: str = "state"):
    """Raise ``FloatingPointError`` naming the first floating leaf of
    ``state`` that holds a non-finite value (``state.q``,
    ``state.task.target``, ...); returns ``state`` otherwise. One host read
    per leaf."""
    for path, leaf in _leaves(state):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(f"non-finite values in {name}{path}")
    return state
