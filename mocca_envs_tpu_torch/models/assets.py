"""The shipped robot asset files: URDF / MJCF documents of the port's models.

Counterpart of ``mocca_envs_tpu/models/assets.py``. The canonical robots are
the hand-built models in models/{walker3d,cassie,monkey,child3d,walker2d};
this module writes them as URDF files (and the walker also as MJCF) under
the port's own ``mocca_envs_tpu_torch/data/`` (models/urdf_export.py) and
loads them back through the URDF compiler (models/urdf.parse_urdf), so a
user can build an env on a file: ``make(env_id, model=assets.load(name))``.
The files are byte for byte the JAX package's.

``load(name)`` is the ``loadURDF`` equivalent: file → RobotModel on a
device, equal to the hand-built model on every field.

    python -m mocca_envs_tpu_torch.models.assets    # rewrite data/
"""

from __future__ import annotations

import os

import torch

from mocca_envs_tpu_torch.models.schema import RobotModel
from mocca_envs_tpu_torch.utils.device import resolve_device

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "data")


def _families():
    from mocca_envs_tpu_torch.models import cassie, child3d, monkey, walker2d, walker3d

    return {
        "walker3d": walker3d.make_model,
        "child3d": child3d.make_model,
        "cassie": cassie.make_model,
        "monkey3d": monkey.make_model,
        "walker2d": walker2d.make_walker2d,
        "crab2d": walker2d.make_crab2d,
    }


def names() -> tuple:
    return tuple(_families())


def asset_path(name: str, data_dir: str = DATA_DIR) -> str:
    return os.path.abspath(os.path.join(data_dir, f"{name}.urdf"))


def generate(name: str, data_dir: str = DATA_DIR) -> str:
    """Export the hand-built model for ``name`` to ``data_dir/<name>.urdf``."""
    from mocca_envs_tpu_torch.models.urdf_export import export_urdf

    text = export_urdf(_families()[name](), name=name)
    path = asset_path(name, data_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


def generate_all(data_dir: str = DATA_DIR) -> list:
    """Write every URDF and the walker's plain MJCF into ``data_dir``."""
    from mocca_envs_tpu_torch.models.mjcf_export import export_mjcf
    from mocca_envs_tpu_torch.models.walker3d import make_model as _walker

    out = [generate(n, data_dir) for n in names()]
    xml_path = os.path.abspath(os.path.join(data_dir, "walker3d.xml"))
    with open(xml_path, "w") as f:
        f.write(export_mjcf(_walker(), name="walker3d"))
    out.append(xml_path)
    return out


def load(name: str, device=None) -> RobotModel:
    """Compile ``data/<name>.urdf`` into a RobotModel on ``device`` (None =
    the CUDA card; raises where there is none). The mirror arrays are
    derived from the joint names (not URDF vocabulary), so they are
    re-attached as the hand-built walker and child derive them."""
    from mocca_envs_tpu_torch.models.urdf import parse_urdf

    device = resolve_device(device)
    # vendor attributes carry the foot grouping; the link-name heuristic is
    # off so that non-foot links named *ankle* grow no foot groups
    model = parse_urdf(asset_path(name), foot_link_keywords=(), device=device)
    if name in ("walker3d", "child3d"):
        from mocca_envs_tpu_torch.models.walker3d import (
            _mirror_action_permutation,
            _mirror_action_signs,
        )

        model = model.replace(
            mirror_act_perm=torch.as_tensor(_mirror_action_permutation(model.joint_names),
                                            device=device),
            mirror_act_sign=torch.as_tensor(_mirror_action_signs(model.joint_names),
                                            device=device),
        )
    return model


if __name__ == "__main__":
    for p in generate_all():
        print("wrote", p)
