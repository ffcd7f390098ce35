"""Narrowphase of the collision spheres against a flat plane.

Frozen copy of the port's ``ops/collide.py``, cut to the one feature the
benchmark's configurations have: an infinite plane at ``ground_z`` (B,) with
its normal +z. One candidate contact per sphere, so the contact count is
static.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.kinematics import FrameData
from benchmark.reference.schema import RobotModel


@dataclasses.dataclass
class Contacts:
    """Static-shape contact set: one row per collision sphere."""

    pos: torch.Tensor     # (B, ns, 3) world contact point (on the surface)
    normal: torch.Tensor  # (B, ns, 3) world normal, pointing into the robot
    depth: torch.Tensor   # (B, ns) penetration depth (> 0 ⇒ touching)
    link: torch.Tensor    # (ns,) owning robot link
    active: torch.Tensor  # (B, ns) 1.0 where depth > −margin


def sphere_centers(model: RobotModel, fd: FrameData) -> torch.Tensor:
    """World positions of all collision spheres: (B, ns, 3)."""
    R = fd.rot[:, model.sph_link]
    p = fd.pos[:, model.sph_link]
    return p + torch.einsum("bsij,sj->bsi", R, model.sph_pos)


def collide(model: RobotModel, fd: FrameData, ground_z: torch.Tensor,
            margin: float) -> Contacts:
    """Every sphere against the plane z = ``ground_z``."""
    centers = sphere_centers(model, fd)                         # (B, ns, 3)
    gz = ground_z[:, None]
    depth = model.sph_radius - (centers[..., 2] - gz)
    normal = torch.zeros_like(centers)
    normal[..., 2] = 1.0
    pos = centers.clone()
    pos[..., 2] = pos[..., 2] - (centers[..., 2] - gz)
    return Contacts(
        pos=pos, normal=normal, depth=depth, link=model.sph_link,
        active=(depth > -margin).to(centers.dtype),
    )


def foot_contact_flags(model: RobotModel, contacts: Contacts) -> torch.Tensor:
    """Binary per-foot contact flags (B, nfeet): any sphere of the foot
    penetrates."""
    touching = (contacts.depth > 0.0).to(contacts.depth.dtype)
    per_foot = torch.einsum("bs,sf->bf", touching * contacts.active, model.sph_foot)
    return (per_foot > 0.0).to(contacts.depth.dtype)


def link_contact_mask(model: RobotModel, contacts: Contacts) -> torch.Tensor:
    """Per-link any-contact flags (B, nl): feeds the termination tests."""
    touching = ((contacts.depth > 0.0) & (contacts.active > 0.5)).to(contacts.depth.dtype)
    B = touching.shape[0]
    out = touching.new_zeros(B, model.nl)
    return out.scatter_reduce(
        1, contacts.link.expand(B, -1), touching, reduce="amax", include_self=True
    )
