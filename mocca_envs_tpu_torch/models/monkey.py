"""Monkey3D: the brachiating gibbon-like model.

Counterpart of ``mocca_envs_tpu/models/monkey.py``: a light torso with two
3-DoF arms ending in grabbing palms and two short legs. The hands hold bars
through the two maskable world-anchor grab rows of :func:`constraints`
(whether a hand holds, and where, is per-env data, not structure); the palm
spheres are excluded from the bar narrowphase (``no_bar``), since a hand
that wraps a bar must not be pushed out of it.
"""

from __future__ import annotations

import functools

import torch

from mocca_envs_tpu_torch.models.schema import ModelBuilder, RobotModel, model_from_numpy
from mocca_envs_tpu_torch.ops.step import ConstraintSpec

PALM_OFFSET = (0.0, 0.0, -0.24)   # the grab anchor at the end of the forearm
GRAB_RADIUS = 0.16   # palm-to-bar distance within which a grab engages [m]
INITIAL_Z = 0.0      # the hands start at bar height; the body hangs below
BAR_RADIUS = 0.03    # handhold capsule radius [m]
BAR_HALF_LEN = 0.4   # handhold half length [m]


def _arm(b: ModelBuilder, side: str, sign: float) -> None:
    s = side
    b.add_link(
        f"{s}_shoulder_x", "base",
        joint_pos=(0.0, sign * 0.12, 0.2), joint_axis=(1, 0, 0),
        limit=(-2.6, 2.6), mass=0.3, com=(0, 0, 0),
        inertia_diag=(5e-4, 5e-4, 5e-4), power_coef=30.0, armature=0.008,
    )
    # the shoulder circumducts fully: its range is past the limit-row cap,
    # so no limit row fights the grab
    b.add_link(
        f"{s}_shoulder_y", f"{s}_shoulder_x",
        joint_pos=(0.0, 0.0, 0.0), joint_axis=(0, 1, 0),
        limit=(-6.3, 6.3), mass=0.9, com=(0, 0, -0.13),
        inertia_diag=(0.006, 0.006, 0.001), power_coef=30.0, armature=0.008,
    )
    b.add_link(
        f"{s}_elbow", f"{s}_shoulder_y",
        joint_pos=(0.0, 0.0, -0.26), joint_axis=(0, 1, 0),
        limit=(-2.9, 0.3), mass=0.7, com=(0, 0, -0.13),
        inertia_diag=(0.005, 0.005, 8e-4), power_coef=25.0, armature=0.006,
    )
    b.add_sphere(f"{s}_elbow", PALM_OFFSET, 0.035, foot=f"{s}_hand", no_bar=True)


def _leg(b: ModelBuilder, side: str, sign: float) -> None:
    s = side
    b.add_link(
        f"{s}_hip", "base",
        joint_pos=(0.0, sign * 0.08, -0.25), joint_axis=(0, 1, 0),
        limit=(-2.0, 1.2), mass=0.8, com=(0, 0, -0.12),
        inertia_diag=(0.005, 0.005, 0.001), power_coef=30.0, armature=0.008,
    )
    b.add_link(
        f"{s}_knee", f"{s}_hip",
        joint_pos=(0.0, 0.0, -0.24), joint_axis=(0, 1, 0),
        limit=(-0.1, 2.3), mass=0.5, com=(0, 0, -0.1),
        inertia_diag=(0.003, 0.003, 5e-4), power_coef=20.0, armature=0.005,
    )
    b.add_sphere(f"{s}_knee", (0.0, 0.0, -0.2), 0.04, foot=f"{s}_foot")


@functools.lru_cache(maxsize=1)
def model_fields() -> dict:
    b = ModelBuilder("monkey3d", floating=True)
    b.base_inertial(4.5, (0.0, 0.0, -0.02), inertia_diag=(0.05, 0.04, 0.03))
    _arm(b, "right", -1.0)
    _arm(b, "left", 1.0)
    _leg(b, "right", -1.0)
    _leg(b, "left", 1.0)
    b.add_sphere("base", (0.0, 0.0, 0.0), 0.1)
    return b.build_numpy()


def make_model(device="cpu") -> RobotModel:
    """11 links, 10 hinges, 5 spheres (two palms, two feet, the torso)."""
    return model_from_numpy(model_fields(), device=device, dtype=torch.float32)


def constraints() -> ConstraintSpec:
    """Two maskable grab rows, one per hand, anchored at the palm."""
    names = model_fields()["link_names"]
    return ConstraintSpec(
        num_grabs=2,
        grab_links=(names.index("right_elbow"), names.index("left_elbow")),
        grab_anchors=(PALM_OFFSET, PALM_OFFSET),
    )
