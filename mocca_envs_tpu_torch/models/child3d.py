"""Child3D: the scaled-down Walker3D.

Counterpart of ``mocca_envs_tpu/models/child3d.py``: the walker's tree with
a geometric scale s on lengths, s³ on masses, s⁵ on inertias and armature,
and s³ on joint power (muscle cross-section × moment arm).
"""

from __future__ import annotations

import torch

from mocca_envs_tpu_torch.models import walker3d
from mocca_envs_tpu_torch.models.schema import RobotModel

SCALE = 0.5
INITIAL_Z = walker3d.INITIAL_Z * SCALE


def make_model(device="cpu", scale: float = SCALE) -> RobotModel:
    m = walker3d.make_model(device)
    s = torch.tensor(scale, dtype=torch.float32, device=device)
    return m.replace(
        joint_pos=m.joint_pos * s,
        mass=m.mass * s**3,
        com=m.com * s,
        inertia=m.inertia * s**5,
        power_coef=m.power_coef * s**3,
        armature=m.armature * s**5,
        sph_pos=m.sph_pos * s,
        sph_radius=m.sph_radius * s,
    )
