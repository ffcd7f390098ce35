"""Trajectory visualization dumps (host-side, the render path's replacement).

Counterpart of ``mocca_envs_tpu/harness/viz.py``: link poses per frame as a
JSON document that an external viewer (harness/viewer.py's page, a
three.js snippet, a blender script, matplotlib) can replay, key for key the
JAX package's. Uses only FK — no dependency on the solver. The frames of a
trajectory go through one batched FK on the model's device.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from mocca_envs_tpu_torch.models.schema import RobotModel
from mocca_envs_tpu_torch.ops.collide import sphere_centers
from mocca_envs_tpu_torch.ops.kinematics import forward_kinematics
from mocca_envs_tpu_torch.terrain.scene import NO_GROUND_Z


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rows(x, n: int, device) -> torch.Tensor:
    """Frames (numpy, a list or a tensor) as an (T, n) f32 tensor."""
    return torch.as_tensor(x, dtype=torch.float32, device=device).reshape(-1, n)


def link_poses(model: RobotModel, q, qd=None):
    """World link positions (nl, 3) and rotation matrices (nl, 3, 3) of one
    frame, as numpy."""
    q = _rows(q, model.nq, model.device)
    qd = q.new_zeros(1, model.nv) if qd is None else _rows(qd, model.nv, model.device)
    fd = forward_kinematics(model, q, qd)
    return _host(fd.pos[0]), _host(fd.rot[0])


def scene_to_desc(scene) -> dict:
    """Serialize slot 0 of a batched terrain/scene.Scene for the replay doc
    (static geometry: ground plane, stone boxes, bar capsules, heightfield
    grid, mesh faces). A scene whose plane is sunk to ``NO_GROUND_Z`` has no
    ground, as a JAX scene with ``has_ground=False``."""
    desc: dict = {}
    at = lambda x: _host(x[0])  # noqa: E731
    ground_z = float(scene.ground_z[0])
    if ground_z > NO_GROUND_Z / 2:
        desc["ground_z"] = ground_z
    if scene.has_stones:
        desc["stones"] = {
            "pos": np.round(at(scene.stone_pos), 4).tolist(),
            "quat": np.round(at(scene.stone_quat), 4).tolist(),
            "half": np.round(at(scene.stone_half), 4).tolist(),
            "active": at(scene.stone_active).tolist(),
        }
    if scene.has_bars:
        desc["bars"] = {
            "a": np.round(at(scene.bar_a), 4).tolist(),
            "b": np.round(at(scene.bar_b), 4).tolist(),
            "r": np.round(at(scene.bar_r), 4).tolist(),
        }
    if scene.has_hf:
        desc["heightfield"] = {
            "xy0": at(scene.hf_xy0).tolist(),
            "cell": float(scene.hf_cell[0]),
            "height": np.round(at(scene.hf_height), 3).tolist(),
        }
    if scene.has_tris:
        desc["tris"] = {
            "a": np.round(at(scene.tri_a), 4).tolist(),
            "b": np.round(at(scene.tri_b), 4).tolist(),
            "c": np.round(at(scene.tri_c), 4).tolist(),
        }
    return desc


def trajectory_doc(
    model: RobotModel,
    qs,                              # (T, nq) numpy or tensor
    every: int = 1,
    scene_desc: dict | None = None,
    markers=None,                    # (T, M, 3) live marker positions
    marker_desc: list[dict] | None = None,   # M dicts: {name, radius, color}
) -> dict:
    """The replay document of :func:`dump_trajectory`, in memory."""
    qs = _rows(qs, model.nq, model.device)
    sel = list(range(0, qs.shape[0], every))
    q = qs[sel]
    fd = forward_kinematics(model, q, q.new_zeros(q.shape[0], model.nv))
    pos, centers = _host(fd.pos), _host(sphere_centers(model, fd))
    doc = {
        "link_names": list(model.link_names),
        "parent": list(model.parent),
        "spheres": {
            "link": _host(model.sph_link).tolist(),
            "pos": np.round(_host(model.sph_pos), 4).tolist(),
            "radius": np.round(_host(model.sph_radius), 4).tolist(),
        },
        "scene": scene_desc or {},
        "fps": None,
        "frames": [np.round(p, 4).tolist() for p in pos],
        # exact world sphere centers per frame (link rotation applied) —
        # what the interactive viewer (harness/viewer.py) draws
        "sphere_frames": [np.round(c, 4).tolist() for c in centers],
    }
    if markers is not None:
        m = _host(markers)
        doc["markers"] = {
            "desc": marker_desc
            or [{"name": f"m{i}", "radius": 0.05} for i in range(m.shape[1])],
            "frames": np.round(m[sel], 4).tolist(),
        }
    return doc


def dump_trajectory(
    model: RobotModel,
    qs,
    path: str,
    every: int = 1,
    scene_desc: dict | None = None,
    markers=None,
    marker_desc: list[dict] | None = None,
) -> None:
    """Write a JSON replay: per frame, per link, [x, y, z] positions, and the
    world sphere centers.

    ``markers`` are debug spheres drawn beside the robot (walk targets, the
    current stone or bar, grab anchors): a per-frame array of M points;
    ``marker_desc`` names and styles them."""
    doc = trajectory_doc(model, qs, every, scene_desc, markers, marker_desc)
    with open(path, "w") as f:
        json.dump(doc, f)
