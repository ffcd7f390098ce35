"""Walker2D and Crab2D: the planar walkers.

Counterpart of ``mocca_envs_tpu/models/walker2d.py``. Planarity comes from
the solver's planar rows (``ops/step.py::ConstraintSpec.planar``), not from a
3-DoF base: the same 3D engine runs every family.

Walker2D: torso + 2 × (thigh, shin, foot), 6 hinges about y.
Crab2D: a low wide body + 2 × (upper leg, lower leg, foot) set apart
sideways, walking along x with hinges about y.
"""

from __future__ import annotations

import functools

import torch

from mocca_envs_tpu_torch.models.schema import ModelBuilder, RobotModel, model_from_numpy
from mocca_envs_tpu_torch.ops.step import ConstraintSpec

WALKER2D_INITIAL_Z = 1.25
CRAB2D_INITIAL_Z = 0.45


def _leg2d(b, side, sign, torso_h):
    s = side
    b.add_link(
        f"{s}_thigh", "base",
        joint_pos=(0.0, sign * 0.05, -torso_h), joint_axis=(0, 1, 0),
        limit=(-1.0, 1.9), mass=3.0, com=(0, 0, -0.225),
        inertia_diag=(0.02, 0.02, 0.004), power_coef=90.0, armature=0.01,
    )
    b.add_link(
        f"{s}_shin", f"{s}_thigh",
        joint_pos=(0.0, 0.0, -0.45), joint_axis=(0, 1, 0),
        limit=(-2.6, -0.03), mass=2.0, com=(0, 0, -0.25),
        inertia_diag=(0.015, 0.015, 0.003), power_coef=60.0, armature=0.01,
    )
    b.add_link(
        f"{s}_foot", f"{s}_shin",
        joint_pos=(0.0, 0.0, -0.5), joint_axis=(0, 1, 0),
        limit=(-0.78, 0.78), mass=1.0, com=(0.06, 0, -0.03),
        inertia_diag=(0.002, 0.004, 0.004), power_coef=30.0, armature=0.005,
    )
    b.add_sphere(f"{s}_foot", (-0.04, 0.0, -0.045), 0.04, foot=f"{s}_foot")
    b.add_sphere(f"{s}_foot", (0.14, 0.0, -0.045), 0.04, foot=f"{s}_foot")


@functools.lru_cache(maxsize=1)
def walker2d_fields() -> dict:
    b = ModelBuilder("walker2d", floating=True)
    b.base_inertial(10.0, (0.0, 0.0, 0.15), inertia_diag=(0.1, 0.1, 0.05))
    _leg2d(b, "right", -1.0, 0.2)
    _leg2d(b, "left", 1.0, 0.2)
    b.add_sphere("base", (0.0, 0.0, 0.2), 0.12)
    return b.build_numpy()


def make_walker2d(device="cpu") -> RobotModel:
    return model_from_numpy(walker2d_fields(), device=device, dtype=torch.float32)


def _crab_leg(b, side, sign):
    s = side
    b.add_link(
        f"{s}_upper", "base",
        joint_pos=(0.0, sign * 0.22, 0.0), joint_axis=(0, 1, 0),
        limit=(-1.3, 1.3), mass=1.5, com=(0, 0, -0.12),
        inertia_diag=(0.008, 0.008, 0.002), power_coef=60.0, armature=0.01,
    )
    b.add_link(
        f"{s}_lower", f"{s}_upper",
        joint_pos=(0.0, 0.0, -0.25), joint_axis=(0, 1, 0),
        limit=(-2.0, 0.0), mass=1.0, com=(0, 0, -0.12),
        inertia_diag=(0.005, 0.005, 0.001), power_coef=40.0, armature=0.008,
    )
    b.add_link(
        f"{s}_foot", f"{s}_lower",
        joint_pos=(0.0, 0.0, -0.25), joint_axis=(0, 1, 0),
        limit=(-0.9, 0.9), mass=0.5, com=(0.04, 0, -0.02),
        inertia_diag=(0.001, 0.002, 0.002), power_coef=20.0, armature=0.004,
    )
    b.add_sphere(f"{s}_foot", (-0.03, 0.0, -0.03), 0.035, foot=f"{s}_foot")
    b.add_sphere(f"{s}_foot", (0.1, 0.0, -0.03), 0.035, foot=f"{s}_foot")


@functools.lru_cache(maxsize=1)
def crab2d_fields() -> dict:
    b = ModelBuilder("crab2d", floating=True)
    b.base_inertial(8.0, (0.0, 0.0, 0.0), inertia_diag=(0.08, 0.05, 0.08))
    _crab_leg(b, "right", -1.0)
    _crab_leg(b, "left", 1.0)
    b.add_sphere("base", (0.0, 0.0, 0.05), 0.14)
    return b.build_numpy()


def make_crab2d(device="cpu") -> RobotModel:
    return model_from_numpy(crab2d_fields(), device=device, dtype=torch.float32)


def planar_spec() -> ConstraintSpec:
    """Lock y-translation, roll and yaw: the 2D families' constraint."""
    return ConstraintSpec(planar=True)
