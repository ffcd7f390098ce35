"""Env registry: the public entry point.

Counterpart of ``mocca_envs_tpu/envs/registry.py``: :func:`make` takes the
reference's gym IDs (with or without ``-v0``) and returns a batched
functional env bound to a device.
"""

from __future__ import annotations

from typing import Callable

from mocca_envs_tpu_torch.utils.device import pin_fp32, resolve_device

_REGISTRY: dict[str, Callable] = {}


def register(env_id: str, factory: Callable) -> None:
    if env_id in _REGISTRY:
        raise ValueError(f"env id {env_id!r} already registered")
    _REGISTRY[env_id] = factory


def registered_envs() -> tuple[str, ...]:
    _ensure_populated()
    return tuple(sorted(_REGISTRY))


def make(env_id: str, device=None, **kwargs):
    """Build the env ``env_id`` on ``device``. ``device=None`` means the
    CUDA card and raises where there is none; pass ``device="cpu"`` for the
    plain PyTorch path. Matmuls run in full fp32 (TF32 off)."""
    _ensure_populated()
    pin_fp32()
    key = env_id if env_id in _REGISTRY else env_id.removesuffix("-v0")
    if key not in _REGISTRY:
        raise KeyError(f"unknown env id {env_id!r}; known: {', '.join(sorted(_REGISTRY))}")
    return _REGISTRY[key](device=resolve_device(device), **kwargs)


def _ensure_populated() -> None:
    if _REGISTRY:
        return
    from mocca_envs_tpu_torch.envs import families  # noqa: F401
