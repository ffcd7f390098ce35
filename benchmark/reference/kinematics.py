"""Forward kinematics and Jacobians, world-frame, batch-first.

Frozen copy of the port's ``ops/kinematics.py``. Every function takes a
batch of envs: ``q`` (B, nq), ``qd`` (B, nv). The link loop runs in Python
over the static topology; a joint is revolute or prismatic (a prismatic
joint slides its link along the axis and leaves its rotation alone).

Generalized coordinates (floating base):
    q  = [base_pos(3), base_quat_wxyz(4), joint_q(nj)]
    qd = [base_linvel(3), base_angvel_world(3), joint_qd(nj)]
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference import quat as quat_ops
from benchmark.reference.spatial import cross, skew
from benchmark.reference.schema import PRISMATIC, RobotModel


@dataclasses.dataclass
class FrameData:
    """World-frame per-link / per-joint quantities for a batch of envs."""

    pos: torch.Tensor        # (B, nl, 3) link frame origins
    rot: torch.Tensor        # (B, nl, 3, 3) link orientations
    omega: torch.Tensor      # (B, nl, 3) angular velocities
    vel: torch.Tensor        # (B, nl, 3) linear velocities of link origins
    com_w: torch.Tensor      # (B, nl, 3) world COM positions
    jp: torch.Tensor         # (B, nj, 3) world joint anchors
    ja: torch.Tensor         # (B, nj, 3) world joint axes
    inertia_w: torch.Tensor  # (B, nl, 3, 3) world inertia about the COM


def joint_q(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    return q[..., 7:] if model.floating else q


def joint_qd(model: RobotModel, qd: torch.Tensor) -> torch.Tensor:
    return qd[..., 6:] if model.floating else qd


def _base_state(model: RobotModel, q: torch.Tensor, qd: torch.Tensor):
    if model.floating:
        return q[:, 0:3], q[:, 3:7], qd[:, 0:3], qd[:, 3:6]
    z = q.new_zeros(q.shape[0], 3)
    ident = quat_ops.identity(q.dtype, q.device).expand(q.shape[0], 4)
    return z, ident, z, z


def forward_kinematics(model: RobotModel, q: torch.Tensor, qd: torch.Tensor) -> FrameData:
    """World-frame link states; the parent→child chain carries quaternions,
    rotation matrices are formed once for all links at the end."""
    qj = joint_q(model, q)
    qdj = joint_qd(model, qd)
    bp, bq, bv, bw = _base_state(model, q, qd)

    pos, quats, omega, vel = [bp], [bq], [bw], [bv]
    jp_list, ja_list = [], []
    for i in range(1, model.nl):
        j = i - 1
        p = model.parent[i]
        qp, pp, wp, vp = quats[p], pos[p], omega[p], vel[p]
        axis = model.joint_axis[j]
        q_pre = quat_ops.mul(qp, model.joint_quat[j].expand_as(qp))
        a_w = quat_ops.rotate(q_pre, axis)
        anchor = pp + quat_ops.rotate(qp, model.joint_pos[j])
        if model.jtype[j] == PRISMATIC:
            p_i = anchor + a_w * qj[:, j:j + 1]
            pos.append(p_i)
            quats.append(q_pre)
            omega.append(wp)
            vel.append(vp + cross(wp, p_i - pp) + a_w * qdj[:, j:j + 1])
        else:
            q_i = quat_ops.mul(q_pre, quat_ops.from_axis_angle(axis, qj[:, j]))
            pos.append(anchor)
            quats.append(q_i)
            omega.append(wp + a_w * qdj[:, j:j + 1])
            vel.append(vp + cross(wp, anchor - pp))
        jp_list.append(anchor)
        ja_list.append(a_w)

    pos = torch.stack(pos, dim=1)
    rot = quat_ops.to_matrix(torch.stack(quats, dim=1))
    com_w = pos + torch.einsum("blij,lj->bli", rot, model.com)
    inertia_w = torch.einsum(
        "blij,ljk,blmk->blim", rot, model.inertia, rot
    )
    B = q.shape[0]
    empty = q.new_zeros(B, 0, 3)
    return FrameData(
        pos=pos, rot=rot, omega=torch.stack(omega, dim=1), vel=torch.stack(vel, dim=1),
        com_w=com_w,
        jp=torch.stack(jp_list, dim=1) if jp_list else empty,
        ja=torch.stack(ja_list, dim=1) if ja_list else empty,
        inertia_w=inertia_w,
    )


def make_link_poses(model: RobotModel, links: tuple):
    """Build ``poses(q) → (origins (B, K, 3), orientations (B, K, 3, 3))`` of
    the links ``links`` (static indices), for task-side queries of a few
    points, where the whole :func:`forward_kinematics` would issue more
    small launches than the rest of a step. The chain is walked over the
    links' ancestors only, positions and rotation matrices alone: a revolute
    joint's rotation is its fixed frame times Rodrigues' ``I + sin θ K + (1 −
    cos θ) K²`` about its axis, which agrees with the quaternion chain of the
    full FK up to rounding; a prismatic joint's is its fixed frame, and it
    moves its link by ``q`` along the rotated axis."""
    need = set()
    for link in links:
        while link > 0 and link not in need:
            need.add(link)
            link = model.parent[link]
    order = sorted(need)
    # per-joint constants, made once
    frame = quat_ops.to_matrix(model.joint_quat)           # (nj, 3, 3)
    K = skew(model.joint_axis)
    K2 = K @ K
    eye = torch.eye(3, dtype=K.dtype, device=K.device)

    def poses(q: torch.Tensor):
        qj = joint_q(model, q)
        bp, bq, _, _ = _base_state(model, q, q[:, :0])
        pos, rot = {0: bp}, {0: quat_ops.to_matrix(bq)}
        for i in order:
            j, p = i - 1, model.parent[i]
            pos[i] = pos[p] + rot[p] @ model.joint_pos[j]
            if model.jtype[j] == PRISMATIC:
                rot[i] = rot[p] @ frame[j]
                pos[i] = pos[i] + (rot[i] @ model.joint_axis[j]) * qj[:, j, None]
                continue
            s, c = torch.sin(qj[:, j, None, None]), torch.cos(qj[:, j, None, None])
            rot[i] = rot[p] @ frame[j] @ (eye + s * K[j] + (1.0 - c) * K2[j])
        return (torch.stack([pos[k] for k in links], dim=1),
                torch.stack([rot[k] for k in links], dim=1))

    return poses


def _prismatic(model: RobotModel):
    """(nj, 1) bool mask of the prismatic joints, or None where there are
    none (the all-revolute models keep the revolute columns alone)."""
    if PRISMATIC not in model.jtype:
        return None
    mask = [t == PRISMATIC for t in model.jtype]
    return torch.tensor(mask, device=model.device)[:, None]


def point_jacobian(model: RobotModel, fd: FrameData, link: torch.Tensor,
                   point: torch.Tensor) -> torch.Tensor:
    """Translational Jacobians (B, K, 3, nv) of K world points ``point``
    (B, K, 3), point k fixed to link ``link[k]`` (a static (K,) index). A
    revolute joint's column is ``a × (p − anchor)``, a prismatic one's ``a``."""
    anc_rows = model.anc[link]                                   # (K, nj)
    rev = cross(fd.ja[:, None], point[:, :, None] - fd.jp[:, None])   # (B,K,nj,3)
    prism = _prismatic(model)
    if prism is not None:
        rev = torch.where(prism, fd.ja[:, None], rev)
    Jj = (anc_rows[None, :, :, None] * rev).transpose(-1, -2)    # (B,K,3,nj)
    if not model.floating:
        return Jj
    B, K = point.shape[:2]
    Jlin = torch.eye(3, dtype=point.dtype, device=point.device).expand(B, K, 3, 3)
    Jang = -skew(point - fd.pos[:, None, 0])
    return torch.cat([Jlin, Jang, Jj], dim=-1)


def link_jacobians(model: RobotModel, fd: FrameData):
    """COM translational + angular Jacobians of every link: (B, nl, 3, nv);
    a prismatic joint moves a link without turning it."""
    diff = fd.com_w[:, :, None] - fd.jp[:, None]                  # (B,nl,nj,3)
    rev = cross(fd.ja[:, None], diff)
    ja = fd.ja[:, None]
    prism = _prismatic(model)
    if prism is not None:
        rev = torch.where(prism, ja, rev)
        ja = torch.where(prism, torch.zeros_like(ja), ja)
    anc = model.anc[None, :, :, None]
    Jvj = (anc * rev).transpose(-1, -2)                           # (B,nl,3,nj)
    Jwj = (anc * ja).transpose(-1, -2)
    if not model.floating:
        return Jvj, Jwj
    B, nl = fd.pos.shape[:2]
    eye = torch.eye(3, dtype=fd.pos.dtype, device=fd.pos.device).expand(B, nl, 3, 3)
    Jv = torch.cat([eye, -skew(fd.com_w - fd.pos[:, :1]), Jvj], dim=-1)
    Jw = torch.cat([torch.zeros_like(eye), eye, Jwj], dim=-1)
    return Jv, Jw
