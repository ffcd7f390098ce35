"""Narrowphase: robot collision spheres vs the scene (plane, heightfield,
stones, mesh triangles, bars).

Counterpart of ``mocca_envs_tpu/ops/collide.py``. One candidate
contact per sphere (the deepest across the scene's features, merged in that
order, each taking over only where strictly deeper), so the contact count
is static.
"""

from __future__ import annotations

import dataclasses

import torch

from mocca_envs_tpu_torch.models.schema import RobotModel
from mocca_envs_tpu_torch.ops.kinematics import FrameData
from mocca_envs_tpu_torch.terrain.scene import (
    Scene,
    hf_normal,
    hf_sample,
    sphere_box_depth,
    sphere_capsule_depth,
    sphere_triangle_depth,
)


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


def collide(model: RobotModel, fd: FrameData, scene: Scene, margin: float) -> Contacts:
    centers = sphere_centers(model, fd)                         # (B, ns, 3)
    gz = scene.ground_z[:, None]
    depth = model.sph_radius - (centers[..., 2] - gz)
    normal = torch.zeros_like(centers)
    normal[..., 2] = 1.0
    pos = centers.clone()
    pos[..., 2] = pos[..., 2] - (centers[..., 2] - gz)

    def merge(d, n, p, active, exclude=None):
        # the deepest active feature per sphere (the first of equals)
        # replaces the contact so far where strictly deeper
        nonlocal depth, normal, pos
        d = torch.where(active[:, None, :] > 0.5, d, torch.full_like(d, -1e9))
        k = torch.argmax(d, dim=2, keepdim=True)
        k3 = k[..., None].expand(-1, -1, -1, 3)
        d_k = torch.gather(d, 2, k)[..., 0]
        take = d_k > depth
        if exclude is not None:
            take = take & ~exclude
        depth = torch.where(take, d_k, depth)
        normal = torch.where(take[..., None], torch.gather(n, 2, k3)[:, :, 0], normal)
        pos = torch.where(take[..., None], torch.gather(p, 2, k3)[:, :, 0], pos)

    if scene.has_hf:
        # the surface point under the center; the depth along the surface
        # normal there
        xy = centers[..., :2]
        h = hf_sample(scene, xy)
        n = hf_normal(scene, xy)
        d = model.sph_radius - (centers[..., 2] - h) * n[..., 2]
        take = d > depth
        depth = torch.where(take, d, depth)
        normal = torch.where(take[..., None], n, normal)
        pos = torch.where(take[..., None], torch.cat([xy, h[..., None]], dim=-1), pos)
    if scene.has_stones:
        # every sphere against every stone: (B, ns, K[, 3])
        merge(*sphere_box_depth(
            centers[:, :, None, :], model.sph_radius[None, :, None],
            scene.stone_pos[:, None], scene.stone_quat[:, None], scene.stone_half[:, None],
        ), scene.stone_active)
    if scene.has_tris:
        # every sphere against every face; of equally deep faces the first
        # wins (tread and riser share the nosing edge, a quad's two
        # triangles its diagonal)
        merge(*sphere_triangle_depth(
            centers[:, :, None, :], model.sph_radius[None, :, None],
            scene.tri_a[:, None], scene.tri_b[:, None], scene.tri_c[:, None],
        ), scene.tri_active)
    if scene.has_bars:
        # every sphere against every bar; the palms are left out, since a
        # grabbing hand wraps the bar it holds
        merge(*sphere_capsule_depth(
            centers[:, :, None, :], model.sph_radius[None, :, None],
            scene.bar_a[:, None], scene.bar_b[:, None], scene.bar_r[:, None],
        ), scene.bar_active, exclude=model.sph_no_bar > 0.5)

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
    """Per-link any-contact flags (B, nl) — feeds termination tests."""
    touching = ((contacts.depth > 0.0) & (contacts.active > 0.5)).to(contacts.depth.dtype)
    B = touching.shape[0]
    out = touching.new_zeros(B, model.nl)
    return out.scatter_reduce(
        1, contacts.link.expand(B, -1), touching, reduce="amax", include_self=True
    )
