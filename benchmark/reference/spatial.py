"""Small rigid-body helpers: a frozen copy of the port's ``core/spatial.py``."""

from __future__ import annotations

import torch

__all__ = ["skew", "cross", "transform_point", "inertia_world", "rotate_inertia"]


def skew(v: torch.Tensor) -> torch.Tensor:
    """3-vector → skew matrix with ``skew(v) @ u == v × u``."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


def transform_point(rot: torch.Tensor, pos: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply rigid transform (rot 3×3, pos 3) to local point ``p``."""
    return pos + torch.einsum("...ij,...j->...i", rot, p)


def rotate_inertia(rot: torch.Tensor, inertia: torch.Tensor) -> torch.Tensor:
    """Body-frame inertia into the world frame: R I Rᵀ."""
    return torch.einsum("...ij,...jk,...lk->...il", rot, inertia, rot)


def inertia_world(rot: torch.Tensor, inertia_diag: torch.Tensor) -> torch.Tensor:
    """World-frame inertia from a principal-axis (diagonal) body inertia."""
    return torch.einsum("...ij,...j,...kj->...ik", rot, inertia_diag, rot)
