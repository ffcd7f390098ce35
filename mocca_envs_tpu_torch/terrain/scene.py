"""Scene: the world geometry the robot collides with, batch-first.

Counterpart of ``mocca_envs_tpu/terrain/scene.py`` for the plane, the
oriented stone boxes and the bar capsules: one infinite plane per env with
its friction coefficient; for stepping-stone scenes ``K`` boxes per env with
the sphere-vs-box narrowphase and the per-control-step culling of the stones
nearest the root; for monkey-bar scenes ``KB`` capsules per env (handholds)
with the sphere-vs-capsule narrowphase, never culled. Heightfields and
meshes come with later slices.
"""

from __future__ import annotations

import dataclasses

import torch

from mocca_envs_tpu_torch.core import quat as quat_ops

STONE_FIELDS = ("stone_pos", "stone_quat", "stone_half", "stone_active")
BAR_FIELDS = ("bar_a", "bar_b", "bar_r", "bar_active")


@dataclasses.dataclass
class Scene:
    ground_z: torch.Tensor   # (B,) plane height z = ground_z
    friction: torch.Tensor   # (B,) Coulomb coefficient of the box friction
    # oriented stone boxes; all four are None in a scene without stones
    stone_pos: torch.Tensor | None = None      # (B, K, 3) box centers
    stone_quat: torch.Tensor | None = None     # (B, K, 4) wxyz
    stone_half: torch.Tensor | None = None     # (B, K, 3) half extents
    stone_active: torch.Tensor | None = None   # (B, K) 1.0 = solid
    # bar capsules (handholds); all four are None in a scene without bars
    bar_a: torch.Tensor | None = None          # (B, KB, 3) segment start
    bar_b: torch.Tensor | None = None          # (B, KB, 3) segment end
    bar_r: torch.Tensor | None = None          # (B, KB) capsule radius
    bar_active: torch.Tensor | None = None     # (B, KB) 1.0 = solid

    @property
    def has_stones(self) -> bool:
        return self.stone_pos is not None

    @property
    def has_bars(self) -> bool:
        return self.bar_a is not None


def flat(batch: int, device="cpu", ground_z: float = 0.0, friction: float = 0.8) -> Scene:
    """Flat infinite plane for ``batch`` envs."""
    return Scene(
        ground_z=torch.full((batch,), ground_z, dtype=torch.float32, device=device),
        friction=torch.full((batch,), friction, dtype=torch.float32, device=device),
    )


def with_stones(stone_pos, stone_quat, stone_half, stone_active=None,
                ground_z: float = -1e3, friction: float = 0.8) -> Scene:
    """Stepping-stone world: a union of oriented boxes (B, K, ·) over a plane
    far below, which stands in for "falling between stones ends the episode"."""
    B, K = stone_pos.shape[:2]
    if stone_active is None:
        stone_active = stone_pos.new_ones(B, K)
    base = flat(B, stone_pos.device, ground_z, friction)
    return dataclasses.replace(base, stone_pos=stone_pos, stone_quat=stone_quat,
                               stone_half=stone_half, stone_active=stone_active)


def with_bars(bar_a, bar_b, bar_r, bar_active=None, ground_z: float = -8.0,
              friction: float = 0.8) -> Scene:
    """Monkey-bar world: capsules (B, KB, ·) over a plane far below, which
    ends the episode of a body that falls."""
    B, KB = bar_a.shape[:2]
    if bar_active is None:
        bar_active = bar_a.new_ones(B, KB)
    base = flat(B, bar_a.device, ground_z, friction)
    return dataclasses.replace(base, bar_a=bar_a, bar_b=bar_b, bar_r=bar_r,
                               bar_active=bar_active)


def cull_stones(scene: Scene, root_xy: torch.Tensor, window: int) -> Scene:
    """Keep only the ``window`` stones nearest each root ``(B, 2)``.

    The score is the xy distance to the stone's center minus its bounding
    radius ‖half‖; inactive stones rank last. A stable sort keeps the lower
    index on ties and the kept stones in order of score, so the result does
    not depend on the device. Exact whenever every stone within contact
    range of a collision sphere ranks inside the window."""
    if not scene.has_stones or window <= 0 or window >= scene.stone_pos.shape[1]:
        return scene
    d = torch.linalg.vector_norm(scene.stone_pos[..., :2] - root_xy[:, None, :], dim=-1)
    score = d - torch.linalg.vector_norm(scene.stone_half, dim=-1)
    score = torch.where(scene.stone_active > 0.5, score, torch.full_like(score, 1e9))
    idx = torch.sort(score, dim=1, stable=True).indices[:, :window]          # (B, W)

    def take(x):
        if x.dim() == 2:
            return torch.gather(x, 1, idx)
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

    return dataclasses.replace(scene, **{f: take(getattr(scene, f)) for f in STONE_FIELDS})


def sphere_box_depth(center, radius, box_pos, box_quat, box_half):
    """Sphere vs oriented box: ``(depth, normal, contact_point)``; every
    argument broadcasts over leading dimensions (vectors on the last one).

    Outside the box the contact is at the closest point; with the center
    inside, the sphere is pushed out through the nearest face (the first of
    equally near faces)."""
    d = quat_ops.inv_rotate(box_quat, center - box_pos)        # center in the box frame
    closest = torch.maximum(torch.minimum(d, box_half), -box_half)
    delta = d - closest
    dist = torch.linalg.vector_norm(delta, dim=-1)
    outside = dist > 1e-9
    n_out = delta / torch.clamp(dist, min=1e-9)[..., None]
    face_d = box_half - d.abs()
    k = torch.argmin(face_d, dim=-1, keepdim=True)
    face_k = torch.gather(face_d, -1, k)                        # (..., 1)
    n_in = torch.sign(d) * torch.zeros_like(d).scatter_(-1, k, 1.0)
    n_local = torch.where(outside[..., None], n_out, n_in)
    depth = torch.where(outside, radius - dist, radius + face_k[..., 0])
    surf_local = torch.where(outside[..., None], closest, d + n_local * face_k)
    n_world = quat_ops.rotate(box_quat, n_local)
    p_world = box_pos + quat_ops.rotate(box_quat, surf_local)
    return depth, n_world, p_world


def sphere_capsule_depth(center, radius, seg_a, seg_b, cap_r):
    """Sphere vs capsule: ``(depth, normal, contact_point)``; every argument
    broadcasts over leading dimensions (vectors on the last one).

    The closest point of the segment to the center; the depth is measured to
    the capsule's surface. A center on the axis (distance ≤ 1e-9) takes the
    normal +z, so that its row stays solvable."""
    ab = seg_b - seg_a
    t = ((center - seg_a) * ab).sum(-1) / torch.clamp((ab * ab).sum(-1), min=1e-12)
    closest = seg_a + torch.clamp(t, 0.0, 1.0)[..., None] * ab
    delta = center - closest
    dist = torch.linalg.vector_norm(delta, dim=-1)
    up = torch.zeros_like(delta)
    up[..., 2] = 1.0
    n = torch.where((dist > 1e-9)[..., None], delta / torch.clamp(dist, min=1e-9)[..., None], up)
    depth = radius + cap_r - dist
    return depth, n, closest + n * cap_r[..., None]
