"""Scene: the world geometry the robot collides with — plane subset.

Counterpart of ``mocca_envs_tpu/terrain/scene.py`` for the flat scene only:
one infinite plane per env with its friction coefficient. Stones,
heightfields, bars and meshes (and their culling) come with later slices.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Scene:
    ground_z: torch.Tensor   # (B,) plane height z = ground_z
    friction: torch.Tensor   # (B,) Coulomb coefficient of the box friction


def flat(batch: int, device="cpu", ground_z: float = 0.0, friction: float = 0.8) -> Scene:
    """Flat infinite plane for ``batch`` envs."""
    return Scene(
        ground_z=torch.full((batch,), ground_z, dtype=torch.float32, device=device),
        friction=torch.full((batch,), friction, dtype=torch.float32, device=device),
    )
