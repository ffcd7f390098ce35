"""Articulated rigid-body dynamics: mass matrix + bias forces, batch-first.

Frozen copy of the port's ``ops/dynamics.py``:

- ``mass_matrix``: CRBA through per-link COM Jacobians,
  ``M = Σ_l m_l Jv_lᵀ Jv_l + Jw_lᵀ I_l Jw_l + diag(armature)``;
- ``bias_forces``: world-frame recursive Newton–Euler with ``q̈ = 0`` and the
  base carrying ``−g``, giving ``C(q, q̇)q̇ + g(q)``; a revolute joint takes
  the moment about its axis, a prismatic one the force along it.
"""

from __future__ import annotations

import torch

from benchmark.reference.spatial import cross
from benchmark.reference.schema import PRISMATIC, RobotModel
from benchmark.reference import linalg
from benchmark.reference.kinematics import FrameData, joint_qd, link_jacobians

GRAVITY = (0.0, 0.0, -9.8)


def _with_base_zeros(model: RobotModel, joint_vec: torch.Tensor) -> torch.Tensor:
    if not model.floating:
        return joint_vec
    return torch.cat([joint_vec.new_zeros(6), joint_vec])


def mass_matrix(model: RobotModel, fd: FrameData) -> torch.Tensor:
    """Joint-space inertia matrix (B, nv, nv), armature on the joint diagonal."""
    Jv, Jw = link_jacobians(model, fd)
    Mv = torch.einsum("l,nlak,nlam->nkm", model.mass, Jv, Jv)
    IwJw = torch.einsum("nlab,nlbk->nlak", fd.inertia_w, Jw)
    Mw = torch.einsum("nlak,nlam->nkm", Jw, IwJw)
    return Mv + Mw + torch.diag(_with_base_zeros(model, model.armature))


def bias_forces(model: RobotModel, fd: FrameData, qd: torch.Tensor,
                gravity=GRAVITY) -> torch.Tensor:
    """Generalized bias (B, nv); the equation of motion is
    ``M q̈ + bias = τ_applied``."""
    qdj = joint_qd(model, qd)
    B = qd.shape[0]
    g = torch.as_tensor(gravity, dtype=qd.dtype, device=qd.device)

    # forward pass: accelerations with q̈ = 0, base acceleration −g
    alpha = [qd.new_zeros(B, 3)]
    acc = [(-g).expand(B, 3)]
    for i in range(1, model.nl):
        j = i - 1
        p = model.parent[i]
        r = fd.pos[:, i] - fd.pos[:, p]
        wp = fd.omega[:, p]
        conv = acc[p] + cross(alpha[p], r) + cross(wp, cross(wp, r))
        if model.jtype[j] == PRISMATIC:
            # the Coriolis term of a link sliding in a turning frame
            alpha.append(alpha[p])
            acc.append(conv + 2.0 * cross(wp, fd.ja[:, j] * qdj[:, j:j + 1]))
        else:
            alpha.append(alpha[p] + cross(wp, fd.ja[:, j] * qdj[:, j:j + 1]))
            acc.append(conv)

    # per-link inertial wrench about its COM, then up the tree
    f, n = [], []
    for i in range(model.nl):
        rc = fd.com_w[:, i] - fd.pos[:, i]
        w = fd.omega[:, i]
        a_com = acc[i] + cross(alpha[i], rc) + cross(w, cross(w, rc))
        F = model.mass[i] * a_com
        Iw = fd.inertia_w[:, i]
        N = torch.einsum("bij,bj->bi", Iw, alpha[i]) + cross(
            w, torch.einsum("bij,bj->bi", Iw, w)
        )
        f.append(F)
        n.append(N + cross(rc, F))
    for i in range(model.nl - 1, 0, -1):
        p = model.parent[i]
        f[p] = f[p] + f[i]
        n[p] = n[p] + n[i] + cross(fd.pos[:, i] - fd.pos[:, p], f[i])

    tau = [(fd.ja[:, j] * (f if model.jtype[j] == PRISMATIC else n)[j + 1]).sum(-1)
           for j in range(model.nj)]
    tau = torch.stack(tau, dim=1) if tau else qd.new_zeros(B, 0)
    if not model.floating:
        return tau
    return torch.cat([f[0], n[0], tau], dim=1)


def forward_dynamics(model: RobotModel, fd: FrameData, qd: torch.Tensor,
                     tau: torch.Tensor, gravity=GRAVITY,
                     joint_diag: torch.Tensor | None = None):
    """Unconstrained ``q̈`` (B, nv) and the explicit ``M⁻¹`` (B, nv, nv).

    ``joint_diag`` (nj,) adds the implicit damper/spring diagonal
    ``dt·c + dt²·k`` on the joint block of M.
    """
    M = mass_matrix(model, fd)
    b = bias_forces(model, fd, qd, gravity)
    if joint_diag is not None:
        M = M + torch.diag(_with_base_zeros(model, joint_diag))
    Minv = linalg.chol_inverse(linalg.chol_factor(M))
    qdd = torch.einsum("bij,bj->bi", Minv, tau - b)
    return qdd, Minv
