"""Quaternion algebra, scalar-first ``(w, x, y, z)``.

Frozen copy of the port's ``core/quat.py``: the same functions over
tensors with any leading batch dimensions.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "identity", "normalize", "mul", "conj", "rotate", "inv_rotate",
    "to_matrix", "from_matrix", "from_axis_angle", "from_rpy", "to_rpy",
    "integrate", "from_angular_velocity", "to_xyzw", "from_xyzw",
]

_EPS = 1e-12


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def normalize(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion along ``q`` (safe at ‖q‖ → 0)."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=_EPS)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``a ⊗ b`` (applies ``b``'s rotation first)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate ``v`` by unit ``q``: ``v + 2 q_v × (q_v × v + q_w v)``."""
    qv = q[..., 1:]
    qw = q[..., :1]
    qv, v = torch.broadcast_tensors(qv, v)
    t = torch.linalg.cross(qv, torch.linalg.cross(qv, v) + qw * v)
    return v + 2.0 * t


def inv_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return rotate(conj(q), v)


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion → 3×3 rotation matrix (acts on columns)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """3×3 rotation matrix → unit quaternion (branchless Shepperd variant)."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp(1.0 + tr, min=0.0)) / 2.0
    qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=0.0)) / 2.0
    qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=0.0)) / 2.0
    qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=0.0)) / 2.0
    qx = torch.copysign(qx, m[..., 2, 1] - m[..., 1, 2])
    qy = torch.copysign(qy, m[..., 0, 2] - m[..., 2, 0])
    qz = torch.copysign(qz, m[..., 1, 0] - m[..., 0, 1])
    return normalize(torch.stack([qw, qx, qy, qz], dim=-1))


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit ``axis`` + ``angle`` [rad] → quaternion. Broadcasts over batch."""
    half = 0.5 * torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)[..., None]
    s = torch.sin(half)
    return torch.cat([torch.cos(half), axis * s], dim=-1)


def from_rpy(rpy: torch.Tensor) -> torch.Tensor:
    """URDF fixed-axis roll/pitch/yaw → quaternion, ``R = Rz Ry Rx``."""
    r, p, y = (0.5 * rpy).unbind(-1)
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ],
        dim=-1,
    )


def to_rpy(q: torch.Tensor) -> torch.Tensor:
    """Quaternion → (roll, pitch, yaw), inverse of :func:`from_rpy`."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def from_angular_velocity(omega: torch.Tensor, dt) -> torch.Tensor:
    """Exact exponential map of world ``ω`` over ``dt`` (sinc form)."""
    half_theta_vec = 0.5 * dt * omega
    half_theta = torch.linalg.vector_norm(half_theta_vec, dim=-1, keepdim=True)
    s = torch.sinc(half_theta / math.pi)
    return torch.cat([torch.cos(half_theta), half_theta_vec * s], dim=-1)


def integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """``q(t+dt) = exp(dt/2 · [0, ω]) ⊗ q(t)``, renormalized."""
    return normalize(mul(from_angular_velocity(omega_world, dt), q))


def to_xyzw(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 1:], q[..., :1]], dim=-1)


def from_xyzw(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 3:], q[..., :3]], dim=-1)
