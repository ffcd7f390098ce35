"""Impulse-space constraint solver: projected Gauss–Seidel over the Delassus
operator, batch-first.

Frozen copy of the port's ``ops/solver.py``: fixed row count, fixed
sweep count, box friction, the explicit ``A = J M⁻¹ Jᵀ``. Row layout:

    [ equality rows (ne) | joint-limit rows (nlim) | contacts (nc × [n, t1, t2]) ]

The sweep visits rows in order (Gauss–Seidel is serial over rows); each
visit is one batched update over all envs.
"""

from __future__ import annotations

import torch


def delassus(Minv: torch.Tensor, J: torch.Tensor, cfm: float):
    """``A = J M⁻¹ Jᵀ + cfm·I`` (B, nr, nr) and ``M⁻¹ Jᵀ`` (B, nv, nr)."""
    MinvJT = Minv @ J.transpose(-1, -2)
    A = J @ MinvJT
    A = A + cfm * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return A, MinvJT


def pgs_solve(
    A: torch.Tensor,        # (B, nr, nr) Delassus + regularization
    c: torch.Tensor,        # (B, nr) J v_free − target (residual at λ = 0)
    active: torch.Tensor,   # (B, nr) 1.0 = row participates
    mu: torch.Tensor,       # (B, nc) per-contact friction coefficient
    ne: int,
    nc: int,
    iters: int,
    nlim: int = 0,
    block: bool = False,
    lam0: torch.Tensor | None = None,   # (B, nr) warm-start impulses
) -> torch.Tensor:
    """Impulses λ (B, nr). Equality rows unbounded, limit and normal rows
    λ ≥ 0, friction rows |λ_t| ≤ μ λ_n. ``block=True`` solves each contact's
    two friction rows as one coupled 2×2 system, then box-clamps them."""
    diag = torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), min=1e-9)
    # columns of A, contiguous per row index: Acol[:, i] == A[:, :, i]
    Acol = A.transpose(-1, -2).contiguous()

    if block and nc:
        tb = ne + nlim + 3 * torch.arange(nc, device=A.device)
        a11 = torch.clamp(A[:, tb + 1, tb + 1], min=1e-9)
        a22 = torch.clamp(A[:, tb + 2, tb + 2], min=1e-9)
        a12 = A[:, tb + 1, tb + 2]
        det = torch.clamp(a11 * a22 - a12 * a12, min=1e-12)
        fi11, fi22, fi12 = a22 / det, a11 / det, -a12 / det

    if lam0 is None:
        lam = torch.zeros_like(c)
        r = c.clone()
    else:
        # warm start: masked rows start at 0, else their stale impulse leaks
        # into the residual
        lam = lam0 * active
        r = c + torch.einsum("bij,bj->bi", A, lam)

    def update(i, new):
        new = new * active[:, i]
        d = new - lam[:, i]
        lam[:, i] = new
        r.add_(Acol[:, i] * d[:, None])

    for _ in range(iters):
        for i in range(ne):
            update(i, lam[:, i] - r[:, i] / diag[:, i])
        for i in range(ne, ne + nlim):
            update(i, torch.clamp(lam[:, i] - r[:, i] / diag[:, i], min=0.0))
        for k in range(nc):
            b = ne + nlim + 3 * k
            update(b, torch.clamp(lam[:, b] - r[:, b] / diag[:, b], min=0.0))
            bound = mu[:, k] * lam[:, b]
            if block:
                d1 = -(fi11[:, k] * r[:, b + 1] + fi12[:, k] * r[:, b + 2])
                d2 = -(fi12[:, k] * r[:, b + 1] + fi22[:, k] * r[:, b + 2])
                n1 = torch.clamp(lam[:, b + 1] + d1, -bound, bound) * active[:, b + 1]
                n2 = torch.clamp(lam[:, b + 2] + d2, -bound, bound) * active[:, b + 2]
                e1 = n1 - lam[:, b + 1]
                e2 = n2 - lam[:, b + 2]
                lam[:, b + 1] = n1
                lam[:, b + 2] = n2
                r.add_(Acol[:, b + 1] * e1[:, None] + Acol[:, b + 2] * e2[:, None])
            else:
                for t in (b + 1, b + 2):
                    update(t, torch.clamp(lam[:, t] - r[:, t] / diag[:, t], -bound, bound))
    return lam


def tangent_basis(n: torch.Tensor):
    """Two unit tangents orthogonal to normal ``n`` (…, 3), branchless
    (revised-ONB construction, stable for all normals)."""
    nx, ny, nz = n.unbind(-1)
    sign = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t1 = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    t2 = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t1, t2
