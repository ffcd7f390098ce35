"""Walker3D: the flagship biped (21 hinge DoF).

The tables below are
the benchmark's own copy of the port's joint, segment and sphere tables; its
tests hold the built model equal to the port's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.reference.schema import ModelBuilder, RobotModel, model_from_numpy

POWER = 1.0

# (name, parent, joint_pos, axis, limit_lo, limit_hi, power_coef)
_JOINTS = [
    # abdomen (3 hinges): pelvis → torso
    ("abdomen_z", "pelvis", (0.0, 0.0, 0.10), (0, 0, 1), -0.79, 0.79, 60.0),
    ("abdomen_y", "abdomen_z", (0.0, 0.0, 0.0), (0, 1, 0), -1.31, 0.52, 80.0),
    ("abdomen_x", "abdomen_y", (0.0, 0.0, 0.0), (1, 0, 0), -0.61, 0.61, 60.0),
    # right leg
    ("right_hip_x", "pelvis", (0.0, -0.08, -0.04), (1, 0, 0), -0.44, 0.61, 80.0),
    ("right_hip_z", "right_hip_x", (0.0, 0.0, 0.0), (0, 0, 1), -1.05, 0.61, 60.0),
    ("right_hip_y", "right_hip_z", (0.0, 0.0, 0.0), (0, 1, 0), -1.92, 0.77, 100.0),
    ("right_knee", "right_hip_y", (0.0, 0.0, -0.40), (0, 1, 0), -2.79, -0.03, 90.0),
    ("right_ankle_y", "right_knee", (0.0, 0.0, -0.39), (0, 1, 0), -0.87, 0.87, 60.0),
    ("right_ankle_x", "right_ankle_y", (0.0, 0.0, 0.0), (1, 0, 0), -0.44, 0.44, 40.0),
    # left leg
    ("left_hip_x", "pelvis", (0.0, 0.08, -0.04), (1, 0, 0), -0.61, 0.44, 80.0),
    ("left_hip_z", "left_hip_x", (0.0, 0.0, 0.0), (0, 0, 1), -0.61, 1.05, 60.0),
    ("left_hip_y", "left_hip_z", (0.0, 0.0, 0.0), (0, 1, 0), -1.92, 0.77, 100.0),
    ("left_knee", "left_hip_y", (0.0, 0.0, -0.40), (0, 1, 0), -2.79, -0.03, 90.0),
    ("left_ankle_y", "left_knee", (0.0, 0.0, -0.39), (0, 1, 0), -0.87, 0.87, 60.0),
    ("left_ankle_x", "left_ankle_y", (0.0, 0.0, 0.0), (1, 0, 0), -0.44, 0.44, 40.0),
    # right arm
    ("right_shoulder_x", "torso_ref", (0.0, -0.17, 0.22), (1, 0, 0), -1.48, 1.05, 30.0),
    ("right_shoulder_y", "right_shoulder_x", (0.0, 0.0, 0.0), (0, 1, 0), -1.57, 1.22, 30.0),
    ("right_elbow", "right_shoulder_y", (0.0, 0.0, -0.27), (0, 1, 0), -1.57, 0.0, 25.0),
    # left arm
    ("left_shoulder_x", "torso_ref", (0.0, 0.17, 0.22), (1, 0, 0), -1.05, 1.48, 30.0),
    ("left_shoulder_y", "left_shoulder_x", (0.0, 0.0, 0.0), (0, 1, 0), -1.57, 1.22, 30.0),
    ("left_elbow", "left_shoulder_y", (0.0, 0.0, -0.27), (0, 1, 0), -1.57, 0.0, 25.0),
]

# inertial properties per moving segment: (mass, com, inertia_diag)
_SEGMENTS = {
    "abdomen_z": (0.5, (0, 0, 0), (1e-3, 1e-3, 1e-3)),
    "abdomen_y": (0.5, (0, 0, 0), (1e-3, 1e-3, 1e-3)),
    "abdomen_x": (14.0, (0.0, 0.0, 0.17), (0.18, 0.16, 0.08)),  # torso proper
    "right_hip_x": (0.5, (0, 0, 0), (1e-3, 1e-3, 1e-3)),
    "right_hip_z": (0.5, (0, 0, 0), (1e-3, 1e-3, 1e-3)),
    "right_hip_y": (4.5, (0.0, 0.0, -0.20), (0.06, 0.06, 0.012)),  # thigh
    "right_knee": (2.8, (0.0, 0.0, -0.19), (0.035, 0.035, 0.006)),  # shin
    "right_ankle_y": (0.2, (0, 0, 0), (5e-4, 5e-4, 5e-4)),
    "right_ankle_x": (1.0, (0.05, 0.0, -0.04), (0.002, 0.004, 0.004)),  # foot
    "left_hip_x": (0.5, (0, 0, 0), (1e-3, 1e-3, 1e-3)),
    "left_hip_z": (0.5, (0, 0, 0), (1e-3, 1e-3, 1e-3)),
    "left_hip_y": (4.5, (0.0, 0.0, -0.20), (0.06, 0.06, 0.012)),
    "left_knee": (2.8, (0.0, 0.0, -0.19), (0.035, 0.035, 0.006)),
    "left_ankle_y": (0.2, (0, 0, 0), (5e-4, 5e-4, 5e-4)),
    "left_ankle_x": (1.0, (0.05, 0.0, -0.04), (0.002, 0.004, 0.004)),
    "right_shoulder_x": (0.3, (0, 0, 0), (5e-4, 5e-4, 5e-4)),
    "right_shoulder_y": (1.6, (0.0, 0.0, -0.14), (0.01, 0.01, 0.002)),  # upper arm
    "right_elbow": (1.0, (0.0, 0.0, -0.15), (0.008, 0.008, 0.0015)),  # forearm+hand
    "left_shoulder_x": (0.3, (0, 0, 0), (5e-4, 5e-4, 5e-4)),
    "left_shoulder_y": (1.6, (0.0, 0.0, -0.14), (0.01, 0.01, 0.002)),
    "left_elbow": (1.0, (0.0, 0.0, -0.15), (0.008, 0.008, 0.0015)),
}

INITIAL_Z = 0.94      # standing pelvis height above the support surface
FOOT_RADIUS = 0.042
FOOT_HALF_W = 0.025   # lateral half-spread of the foot corner spheres

ACTION_DIM = 21


@functools.lru_cache(maxsize=1)
def model_fields() -> dict:
    """Every RobotModel field of the walker, as numpy (built once)."""
    b = ModelBuilder("walker3d", floating=True)
    b.base_inertial(8.0, (0.0, 0.0, 0.0), inertia_diag=(0.05, 0.04, 0.05))
    for (name, parent, jpos, axis, lo, hi, pc) in _JOINTS:
        parent_resolved = {"pelvis": "base", "torso_ref": "abdomen_x"}.get(parent, parent)
        mass, com, inertia = _SEGMENTS[name]
        b.add_link(
            name, parent_resolved, joint_pos=jpos, joint_axis=axis, limit=(lo, hi),
            mass=mass, com=com, inertia_diag=inertia, power_coef=pc, actuated=True,
            damping=0.0,
            # reflected rotor inertia: conditions the mass matrix (the dummy
            # stacked-hinge links are near-singular in f32 otherwise)
            armature=0.01,
        )
    # feet as 2×2 corner sets (heel/toe × inner/outer edge), plus elbows,
    # knees, pelvis and torso for ground interaction and termination
    for side in ("right", "left"):
        foot = f"{side}_ankle_x"
        for fx in (-0.05, 0.12):
            for fy in (-FOOT_HALF_W, FOOT_HALF_W):
                b.add_sphere(foot, (fx, fy, -0.05), FOOT_RADIUS, foot=f"{side}_foot")
        b.add_sphere(f"{side}_elbow", (0.0, 0.0, -0.26), 0.04)
        b.add_sphere(f"{side}_knee", (0.0, 0.0, -0.2), 0.05)
    b.add_sphere("base", (0.0, 0.0, 0.0), 0.11)
    b.add_sphere("abdomen_x", (0.0, 0.0, 0.2), 0.12)

    fields = b.build_numpy()
    names = fields["joint_names"]
    fields["mirror_act_perm"] = _mirror_action_permutation(names)
    fields["mirror_act_sign"] = _mirror_action_signs(names)
    return fields


def make_model(device="cpu") -> RobotModel:
    return model_from_numpy(model_fields(), device=device, dtype=torch.float32)


def _mirror_action_permutation(joint_names) -> np.ndarray:
    """Swap left/right joint slots."""
    perm = []
    for n in joint_names:
        if n.startswith("right_"):
            perm.append(joint_names.index("left_" + n[len("right_"):]))
        elif n.startswith("left_"):
            perm.append(joint_names.index("right_" + n[len("left_"):]))
        else:
            perm.append(joint_names.index(n))
    return np.array(perm, dtype=np.int64)


def _mirror_action_signs(joint_names) -> np.ndarray:
    """Negate roll(x)/yaw(z) hinge actions under left-right reflection."""
    return np.array(
        [-1.0 if (n.endswith("_x") or n.endswith("_z")) else 1.0 for n in joint_names],
        dtype=np.float32,
    )


def terminal_links(model: RobotModel) -> tuple:
    """Links whose ground contact ends the episode (torso/pelvis falling)."""
    bad = ("base", "abdomen_x", "abdomen_y", "abdomen_z")
    return tuple(model.link_names.index(n) for n in bad if n in model.link_names)
