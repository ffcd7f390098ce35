"""Semi-implicit Euler integration with the joint-limit backstop.

Frozen copy of the port's ``ops/integrate.py``: velocities come from the
solver, positions advance with the new velocities, the base orientation
integrates on the quaternion manifold.
"""

from __future__ import annotations

import torch

from benchmark.reference import quat as quat_ops
from benchmark.reference.schema import RobotModel

MAX_VEL = 100.0     # hard cap on any generalized velocity [rad/s | m/s]
LIMIT_SLOP = 5e-3   # joint-limit violation tolerated before the backstop [rad|m]


def _limit_backstop(model: RobotModel, joints: torch.Tensor, qd_j: torch.Tensor):
    """Clamp past ``LIMIT_SLOP`` beyond a limit and zero only the outward
    velocity (the limit rows of the solver do the real work)."""
    lo = model.limit_lo - LIMIT_SLOP
    hi = model.limit_hi + LIMIT_SLOP
    clamped = torch.maximum(torch.minimum(joints, hi), lo)
    qd_out = torch.where((joints > hi) & (qd_j > 0.0), 0.0, qd_j)
    qd_out = torch.where((joints < lo) & (qd_out < 0.0), 0.0, qd_out)
    return clamped, qd_out


def integrate(model: RobotModel, q: torch.Tensor, qd_new: torch.Tensor, dt: float,
              qd_pos: torch.Tensor | None = None):
    """Advance positions (B, nq) with updated velocities (B, nv), capped at
    ±MAX_VEL, then apply the backstop. Returns ``(q', qd')``.

    ``qd_pos`` (B, nv) is split impulse's pseudo-velocity: it is added to
    the capped velocity for the position advance only and never enters the
    returned velocity; the backstop clamps the advanced position and zeroes
    only the real outward velocity."""
    qd_new = torch.clamp(qd_new, -MAX_VEL, MAX_VEL)
    qd_int = qd_new if qd_pos is None else qd_new + qd_pos
    if not model.floating:
        return _limit_backstop(model, q + dt * qd_int, qd_new)
    pos = q[:, 0:3] + dt * qd_int[:, 0:3]
    quat = quat_ops.integrate(q[:, 3:7], qd_int[:, 3:6], dt)
    clamped, qd_j = _limit_backstop(model, q[:, 7:] + dt * qd_int[:, 6:], qd_new[:, 6:])
    return torch.cat([pos, quat, clamped], dim=1), torch.cat([qd_new[:, :6], qd_j], dim=1)
