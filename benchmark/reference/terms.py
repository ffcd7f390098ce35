"""Observation pieces and reward terms shared by the walker and Cassie tasks.

Frozen copy of the terms of the port's ``tasks/base.py``. ``q`` is (B, nq),
``qd`` (B, nv).
"""

from __future__ import annotations

import torch

from benchmark.reference import quat as quat_ops
from benchmark.reference.kinematics import joint_q, joint_qd
from benchmark.reference.schema import RobotModel


def heading_yaw(q: torch.Tensor) -> torch.Tensor:
    """Base yaw angle (B,): the heading frame of the observations."""
    return quat_ops.to_rpy(q[:, 3:7])[:, 2]


def to_heading_frame(yaw: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate world vectors (B, 3) into the yaw-aligned frame."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([c * v[:, 0] + s * v[:, 1], -s * v[:, 0] + c * v[:, 1], v[:, 2]], dim=1)


def joint_obs(model: RobotModel, q: torch.Tensor, qd: torch.Tensor):
    """(q_scaled, 0.1·q̇): angles as ``2 (q − mid) / range`` ∈ [−1, 1]."""
    qj = joint_q(model, q)
    qdj = joint_qd(model, qd)
    mid = 0.5 * (model.limit_lo + model.limit_hi)
    rng = torch.clamp(model.limit_hi - model.limit_lo, min=1e-6)
    return 2.0 * (qj - mid) / rng, 0.1 * qdj


def body_obs(model: RobotModel, q: torch.Tensor, qd: torch.Tensor, initial_z: float,
             angle_to_target: torch.Tensor) -> torch.Tensor:
    """The 8-dim body block (B, 8):
    [Δz, sin(α), cos(α), 0.3·v_heading(3), roll, pitch]."""
    rpy = quat_ops.to_rpy(q[:, 3:7])
    v_head = to_heading_frame(rpy[:, 2], qd[:, 0:3])
    return torch.cat(
        [
            torch.stack([q[:, 2] - initial_z, torch.sin(angle_to_target),
                         torch.cos(angle_to_target)], dim=1),
            0.3 * v_head,
            rpy[:, 0:2],
        ],
        dim=1,
    )


def energy_costs(model: RobotModel, action: torch.Tensor, qd: torch.Tensor,
                 w_electricity: float, w_stall: float) -> torch.Tensor:
    """``w_e · mean|a · 0.1 q̇| + w_s · mean(a²)`` per env (B,)."""
    a = torch.clamp(action, -1.0, 1.0)
    qdj = joint_qd(model, qd)
    elec = w_electricity * torch.mean(torch.abs(a * 0.1 * qdj), dim=1)
    stall = w_stall * torch.mean(a * a, dim=1)
    return elec + stall


def joints_at_limit_cost(model: RobotModel, q: torch.Tensor, w: float) -> torch.Tensor:
    """Weighted count of joints within 1% of their limits (B,)."""
    q_scaled, _ = joint_obs(model, q, torch.zeros_like(q))
    return w * torch.sum((torch.abs(q_scaled) > 0.99).to(q.dtype), dim=1)
