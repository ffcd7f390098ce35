"""Shared task machinery: observation pieces and reward terms, batch-first.

Counterpart of ``mocca_envs_tpu/tasks/base.py`` for the terms the walker
and Cassie tasks use. ``q`` is (B, nq), ``qd`` (B, nv).
"""

from __future__ import annotations

import numpy as np
import torch

from mocca_envs_tpu_torch.core import quat as quat_ops
from mocca_envs_tpu_torch.models.schema import RobotModel
from mocca_envs_tpu_torch.ops.kinematics import joint_q, joint_qd


def heading_yaw(q: torch.Tensor) -> torch.Tensor:
    """Base yaw angle (B,) — the heading frame of the observations."""
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


def reset_foot_flags(model: RobotModel, contact_margin: float, state) -> torch.Tensor:
    """Foot-contact flags (B, nfeet) of a state outside a step, from the same
    narrowphase predicate the in-step flags use, so that the observation of
    frame 0 and of later frames share one contact semantics."""
    from mocca_envs_tpu_torch.ops.collide import collide, foot_contact_flags
    from mocca_envs_tpu_torch.ops.kinematics import forward_kinematics

    fd = forward_kinematics(model, state.q, state.qd)
    contacts = collide(model, fd, state.scene, contact_margin)
    return foot_contact_flags(model, contacts)


def mirror_spec(model: RobotModel, extra_obs_perm=None, extra_obs_sign=None) -> dict:
    """Left/right mirror maps for the layout
    ``[body(8), q_scaled(nj), 0.1·q̇(nj), feet(nfeet), extra…]``; apply as
    ``obs[..., obs_perm] * obs_sign``."""
    nj = model.nj
    nfeet = len(model.foot_links)
    jp = model.mirror_act_perm.cpu().numpy()
    js = model.mirror_act_sign.cpu().numpy()

    perm = list(range(8))
    sign = [1.0, -1.0, 1.0, 1.0, -1.0, 1.0, -1.0, 1.0]  # sinα, vy, roll flip
    base = 8
    perm += list(base + jp)
    sign += list(js)
    base += nj
    perm += list(base + jp)
    sign += list(js)
    base += nj
    foot_perm = list(range(nfeet))
    for i, name in enumerate(model.foot_links):
        if name.startswith("right_"):
            other = name.replace("right_", "left_")
        elif name.startswith("left_"):
            other = name.replace("left_", "right_")
        else:
            other = name
        if other in model.foot_links:
            foot_perm[i] = model.foot_links.index(other)
    perm += [base + p for p in foot_perm]
    sign += [1.0] * nfeet
    base += nfeet
    if extra_obs_perm is not None:
        perm += [base + p for p in extra_obs_perm]
        sign += list(extra_obs_sign)
    dev = model.device
    return {
        "obs_perm": torch.as_tensor(np.array(perm, dtype=np.int64), device=dev),
        "obs_sign": torch.as_tensor(np.array(sign, dtype=np.float32), device=dev),
        "act_perm": model.mirror_act_perm,
        "act_sign": model.mirror_act_sign,
    }
