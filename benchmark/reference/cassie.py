"""Cassie: closed-chain biped with spring joints.

Frozen copy of the port's ``models/cassie.py``: 10 motors (hip roll /
yaw / pitch, knee, toe × 2 legs), 3 passive joints per leg (shin spring,
tarsus, heel spring), and one achilles rod per leg tying the heel-spring tip
back to the thigh, realised as point-to-point rows in the solver
(``step.py::ConstraintSpec``). The tables are the benchmark's own copy of
the port's; its tests hold the built model equal to the port's.

The rod's anchor on the heel-spring link and the standing pelvis height are
solved from a forward kinematics of the stand pose, so that the chain starts
closed and the feet touch the ground whatever the segment dimensions. That
FK runs lazily, once, in float32 on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.reference.schema import ModelBuilder, RobotModel, model_from_numpy
from benchmark.reference.step import ConstraintSpec

FOOT_HALF_LEN = 0.09
FOOT_RADIUS = 0.025

# per-leg motor PD gains (hip_roll, hip_yaw, hip_pitch, knee, toe)
_KP = (100.0, 100.0, 88.0, 96.0, 50.0)
_KD = (10.0, 10.0, 8.0, 9.6, 5.0)
_SHIN_K = 1500.0    # leaf-spring stiffness [N·m/rad]
_HEEL_K = 1250.0
# reflected rotor inertia (gearbox)
_ARM = (0.038, 0.038, 0.09, 0.09, 0.036)

# canonical stand pose: slight crouch, both springs relaxed
STAND_POSE = {
    "hip_roll": 0.0,
    "hip_yaw": 0.0,
    "hip_pitch": 0.2,    # thigh pitched slightly forward
    "knee": -0.4,        # knee slightly flexed
    "shin": 0.0,         # spring at rest
    "tarsus": 0.2,       # compensates the knee so the foot lands under the hip
    "heel_spring": 0.0,  # spring at rest
    "toe": 0.0,          # foot plate level
}

# rod anchor on the hip-pitch (thigh) link, behind the leg plane; the anchor
# on the heel-spring link is solved at build time
_ACHILLES_THIGH_ANCHOR = (-0.05, 0.0, -0.06)

ACTION_DIM = 10  # position targets for the 10 motors


def _leg(b: ModelBuilder, side: str, sign: float) -> None:
    s = side
    b.add_link(
        f"{s}_hip_roll", "base",
        joint_pos=(0.021, sign * 0.135, 0.0), joint_axis=(1, 0, 0),
        limit=(-0.26, 0.39) if s == "right" else (-0.39, 0.26),
        mass=1.82, com=(-0.01, sign * 0.03, 0.0),
        inertia_diag=(0.004, 0.004, 0.004), actuated=True,
        kp=_KP[0], kd=_KD[0], damping=1.0, armature=_ARM[0],
    )
    b.add_link(
        f"{s}_hip_yaw", f"{s}_hip_roll",
        joint_pos=(0.0, sign * 0.09, -0.05), joint_axis=(0, 0, 1),
        limit=(-0.39, 0.39),
        mass=1.17, com=(0.0, 0.0, -0.04),
        inertia_diag=(0.002, 0.002, 0.002), actuated=True,
        kp=_KP[1], kd=_KD[1], damping=1.0, armature=_ARM[1],
    )
    # thigh: hip pitch motor; segments extend down −z
    b.add_link(
        f"{s}_hip_pitch", f"{s}_hip_yaw",
        joint_pos=(0.0, 0.0, -0.07), joint_axis=(0, 1, 0),
        limit=(-0.87, 1.40),
        mass=5.52, com=(0.0, 0.0, -0.15),
        inertia_diag=(0.06, 0.06, 0.01), actuated=True,
        kp=_KP[2], kd=_KD[2], damping=1.0, armature=_ARM[2],
    )
    b.add_link(
        f"{s}_knee", f"{s}_hip_pitch",
        joint_pos=(0.0, 0.0, -0.30), joint_axis=(0, 1, 0),
        limit=(-2.0, 0.4),
        mass=0.76, com=(0.0, 0.0, -0.03),
        inertia_diag=(0.003, 0.003, 0.001), actuated=True,
        kp=_KP[3], kd=_KD[3], damping=1.0, armature=_ARM[3],
    )
    # passive leaf-spring joint between the knee output and the shin tube
    b.add_link(
        f"{s}_shin", f"{s}_knee",
        joint_pos=(0.0, 0.0, -0.06), joint_axis=(0, 1, 0),
        limit=(-0.35, 0.35),
        mass=0.58, com=(0.0, 0.0, -0.21),
        inertia_diag=(0.01, 0.01, 0.002), actuated=False,
        stiffness=_SHIN_K, damping=0.3,
    )
    b.add_link(
        f"{s}_tarsus", f"{s}_shin",
        joint_pos=(0.0, 0.0, -0.43), joint_axis=(0, 1, 0),
        limit=(-0.8, 1.8),
        mass=0.78, com=(0.0, 0.0, -0.2),
        inertia_diag=(0.02, 0.02, 0.002), actuated=False, damping=0.3,
    )
    # heel leaf spring at the top of the tarsus; the achilles rod ties its
    # tip back to the thigh, closing the four-bar
    b.add_link(
        f"{s}_heel_spring", f"{s}_tarsus",
        joint_pos=(-0.02, 0.0, -0.02), joint_axis=(0, 1, 0),
        limit=(-0.3, 0.3),
        mass=0.12, com=(0.0, 0.0, -0.04),
        inertia_diag=(4e-4, 4e-4, 1e-4), actuated=False,
        stiffness=_HEEL_K, damping=0.1,
    )
    b.add_link(
        f"{s}_toe", f"{s}_tarsus",
        joint_pos=(0.0, 0.0, -0.41), joint_axis=(0, 1, 0),
        limit=(-1.2, 1.2),
        mass=0.15, com=(0.02, 0.0, -0.01),
        inertia_diag=(2e-4, 4e-4, 4e-4), actuated=True,
        kp=_KP[4], kd=_KD[4], damping=0.5, armature=_ARM[4],
    )
    # foot collision: heel and toe spheres on the foot plate
    b.add_sphere(f"{s}_toe", (-FOOT_HALF_LEN, 0.0, -0.02), FOOT_RADIUS, foot=f"{s}_foot")
    b.add_sphere(f"{s}_toe", (FOOT_HALF_LEN, 0.0, -0.02), FOOT_RADIUS, foot=f"{s}_foot")


@functools.lru_cache(maxsize=1)
def model_fields() -> dict:
    """Every RobotModel field of Cassie, as numpy (built once)."""
    b = ModelBuilder("cassie", floating=True)
    b.base_inertial(10.33, (0.05, 0.0, 0.04), inertia_diag=(0.09, 0.11, 0.12))
    _leg(b, "right", -1.0)
    _leg(b, "left", 1.0)
    b.add_sphere("base", (0.0, 0.0, 0.0), 0.13)
    return b.build_numpy()


def make_model(device="cpu") -> RobotModel:
    return model_from_numpy(model_fields(), device=device, dtype=torch.float32)


def stand_q(model: RobotModel) -> np.ndarray:
    """Neutral standing joint vector (nj,) from STAND_POSE."""
    qj = np.zeros(model.nj)
    for j, name in enumerate(model.joint_names):
        suffix = name.split("_", 1)[1]  # strip the side prefix
        if suffix in STAND_POSE:
            qj[j] = STAND_POSE[suffix]
    return qj


@functools.lru_cache(maxsize=1)
def _stand_fk():
    """FK of the stand pose with the base at the origin: the model, link
    positions (nl, 3), rotations (nl, 3, 3) and the lowest sphere bottom."""
    from benchmark.reference.collide import sphere_centers
    from benchmark.reference.kinematics import forward_kinematics

    model = make_model()
    q = torch.zeros(1, model.nq)
    q[0, 3] = 1.0
    q[0, 7:] = torch.as_tensor(stand_q(model), dtype=torch.float32)
    fd = forward_kinematics(model, q, torch.zeros(1, model.nv))
    centers = sphere_centers(model, fd)
    lowest = float(torch.min(centers[0, :, 2] - model.sph_radius))
    return model, fd.pos[0].numpy(), fd.rot[0].numpy(), lowest


def initial_z() -> float:
    """Standing pelvis height: feet exactly on the ground at the stand pose."""
    return -_stand_fk()[3]


@functools.lru_cache(maxsize=1)
def constraints() -> ConstraintSpec:
    """The achilles rods, one per leg. End A is a fixed anchor on the thigh;
    end B's local coordinates on the heel-spring link are solved from the
    stand pose's FK, so that the chain starts exactly closed (a zero-length
    rod)."""
    model, pos, rot, _ = _stand_fk()
    link_a, link_b, anch_a, anch_b = [], [], [], []
    for s in ("right", "left"):
        la = model.link_names.index(f"{s}_hip_pitch")
        lb = model.link_names.index(f"{s}_heel_spring")
        aa = np.asarray(_ACHILLES_THIGH_ANCHOR)
        xa = pos[la] + rot[la] @ aa
        ab = rot[lb].T @ (xa - pos[lb])
        link_a.append(la)
        link_b.append(lb)
        anch_a.append(tuple(float(v) for v in aa))
        anch_b.append(tuple(float(v) for v in ab))
    return ConstraintSpec(
        p2p_link_a=tuple(link_a), p2p_link_b=tuple(link_b),
        p2p_anchor_a=tuple(anch_a), p2p_anchor_b=tuple(anch_b),
    )
