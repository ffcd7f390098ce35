"""Small-matrix batched linear algebra, unrolled over the static size.

Frozen copy of the port's ``ops/linalg.py``. Every function takes a
batch of matrices (B, n, n); the recurrences run over the static dimension
n in Python, each step one batched op.
"""

from __future__ import annotations

import torch

_JITTER = 1e-9


def chol_factor(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of SPD ``M`` (B, n, n), left-looking. The diagonal is
    clamped at ``_JITTER`` so a marginally non-PD input degrades gracefully
    instead of producing NaNs."""
    n = M.shape[-1]
    L = torch.zeros_like(M)
    rows = torch.arange(n, device=M.device)
    for j in range(n):
        s = M[:, :, j]
        if j:
            s = s - torch.einsum("bik,bk->bi", L[:, :, :j], L[:, j, :j])
        d = torch.sqrt(torch.clamp(s[:, j], min=_JITTER))
        L[:, :, j] = torch.where(rows >= j, s / d[:, None], 0.0)
    return L


def solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Forward substitution ``L y = b``; ``b`` is (B, n) or (B, n, k)."""
    n = L.shape[-1]
    y = torch.zeros_like(b)
    for i in range(n):
        s = b[:, i]
        if i:
            s = s - torch.einsum("bk,bk...->b...", L[:, i, :i], y[:, :i])
        y[:, i] = s / (L[:, i, i] if b.dim() == 2 else L[:, i, i, None])
    return y


def solve_upper_from_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Back substitution ``Lᵀ x = b`` using the lower factor."""
    n = L.shape[-1]
    x = torch.zeros_like(b)
    for i in range(n - 1, -1, -1):
        s = b[:, i]
        if i < n - 1:
            s = s - torch.einsum("bk,bk...->b...", L[:, i + 1:, i], x[:, i + 1:])
        x[:, i] = s / (L[:, i, i] if b.dim() == 2 else L[:, i, i, None])
    return x


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``M x = b`` given ``L = chol_factor(M)``."""
    return solve_upper_from_lower(L, solve_lower(L, b))


def chol_inverse(L: torch.Tensor) -> torch.Tensor:
    """Explicit ``M⁻¹ = L⁻ᵀ L⁻¹`` from the Cholesky factor."""
    n = L.shape[-1]
    eye = torch.eye(n, dtype=L.dtype, device=L.device).expand_as(L).contiguous()
    Linv = solve_lower(L, eye)
    return Linv.transpose(-1, -2) @ Linv
