"""Scene: the world geometry the robot collides with, batch-first.

Counterpart of ``mocca_envs_tpu/terrain/scene.py`` for the plane, the
oriented stone boxes, the bar capsules and the heightfields: one infinite
plane per env with its friction coefficient; for stepping-stone scenes
``K`` boxes per env with the sphere-vs-box narrowphase and the
per-control-step culling of the stones nearest the root; for monkey-bar
scenes ``KB`` capsules per env (handholds) with the sphere-vs-capsule
narrowphase, never culled; for terrain scenes an ``H×W`` height grid per env
with its bilinear sample, analytic normal and the ``P×P`` window around the
root that the physics and the observations read once per control step; for
mesh scenes ``Kt`` triangles per env (world-space vertices per face) with
the sphere-vs-triangle narrowphase, the support height under a point and the
per-control-step culling of the faces nearest the root.

The JAX package switches the plane off with a static ``has_ground=False``;
here the plane is always evaluated, so a scene without one sinks it to
``NO_GROUND_Z``, where it never wins a contact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mocca_envs_tpu_torch.core import quat as quat_ops

STONE_FIELDS = ("stone_pos", "stone_quat", "stone_half", "stone_active")
BAR_FIELDS = ("bar_a", "bar_b", "bar_r", "bar_active")
TRI_FIELDS = ("tri_a", "tri_b", "tri_c", "tri_active")
NO_GROUND_Z = -1e9   # the plane's height in a scene without one
HF_PATCH = 16        # side (cells) of the per-env heightfield window


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
    # heightfield grid; all three are None in a scene without one
    hf_height: torch.Tensor | None = None      # (B, H, W) heights, row-major
    hf_xy0: torch.Tensor | None = None         # (B, 2) world xy of grid[0, 0]
    hf_cell: torch.Tensor | None = None        # (B,) cell size [m]
    # triangle mesh, per face; all four are None in a scene without one
    tri_a: torch.Tensor | None = None          # (B, Kt, 3) vertex 0 per face
    tri_b: torch.Tensor | None = None          # (B, Kt, 3) vertex 1
    tri_c: torch.Tensor | None = None          # (B, Kt, 3) vertex 2
    tri_active: torch.Tensor | None = None     # (B, Kt) 1.0 = solid

    @property
    def has_stones(self) -> bool:
        return self.stone_pos is not None

    @property
    def has_bars(self) -> bool:
        return self.bar_a is not None

    @property
    def has_hf(self) -> bool:
        return self.hf_height is not None

    @property
    def has_tris(self) -> bool:
        return self.tri_a is not None


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


def with_trimesh(vertices, faces, ground_z: float = -1e3, friction: float = 0.8,
                 device="cpu") -> Scene:
    """Static triangle-mesh world over a plane at ``ground_z``, for one env
    (:func:`broadcast_scene` lets a batch view it): ``vertices`` (V, 3) in
    world space, ``faces`` (F, 3) vertex indices, stored per face."""
    v = torch.as_tensor(np.asarray(vertices, dtype=np.float32), device=device)
    f = torch.as_tensor(np.asarray(faces, dtype=np.int64), device=device)
    return dataclasses.replace(
        flat(1, device, ground_z, friction), tri_a=v[f[:, 0]][None], tri_b=v[f[:, 1]][None],
        tri_c=v[f[:, 2]][None], tri_active=torch.ones(1, f.shape[0], device=device))


def stairs_trimesh(n_steps: int = 6, rise: float = 0.15, run: float = 0.3, width: float = 2.0,
                   start_x: float = 0.5, ground_z: float = 0.0, friction: float = 0.8,
                   device="cpu") -> Scene:
    """A staircase as a triangle mesh over the plane at ``ground_z``, for
    one env (:func:`with_trimesh`): per step a horizontal tread and a riser
    facing −x, each an axis-aligned quad split into two triangles along its
    diagonal (4·n_steps faces). The vertices are computed in double
    precision and stored as float32, as the JAX package stores them."""
    verts, faces = [], []

    def quad(p0, p1, p2, p3):
        i = len(verts)
        verts.extend([p0, p1, p2, p3])
        faces.append((i, i + 1, i + 2))
        faces.append((i, i + 2, i + 3))

    y0, y1 = -width / 2.0, width / 2.0
    for k in range(n_steps):
        x0 = start_x + k * run
        x1 = x0 + run
        z_top = ground_z + (k + 1) * rise
        z_bot = ground_z + k * rise
        quad((x0, y0, z_top), (x1, y0, z_top), (x1, y1, z_top), (x0, y1, z_top))
        quad((x0, y0, z_bot), (x0, y0, z_top), (x0, y1, z_top), (x0, y1, z_bot))
    return with_trimesh(np.asarray(verts, dtype=np.float32), np.asarray(faces, dtype=np.int64),
                        ground_z, friction, device)


def broadcast_scene(scene: Scene, batch: int) -> Scene:
    """A one-env scene for ``batch`` envs: the per-env scalars (plane
    height, friction) made ``(batch,)``, the geometry expanded along its
    leading dimension, not copied."""
    def widen(x):
        x = x.expand(batch, *x.shape[1:])
        return x.contiguous() if x.dim() == 1 else x

    return dataclasses.replace(scene, **{
        f.name: widen(getattr(scene, f.name))
        for f in dataclasses.fields(scene) if getattr(scene, f.name) is not None})


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


def cull_tris(scene: Scene, root_xy: torch.Tensor, window: int) -> Scene:
    """Keep only the ``window`` mesh faces nearest each root ``(B, 2)``.

    The score is the xy distance to the face's centroid minus its bounding
    radius (the farthest vertex from the centroid); inactive faces rank
    last. As in :func:`cull_stones`, a stable sort keeps the lower index on
    ties and the kept faces in order of score, which decides which of two
    equally deep faces the narrowphase takes. Exact whenever every face
    within contact range of a collision sphere ranks inside the window."""
    if not scene.has_tris or window <= 0 or window >= scene.tri_a.shape[1]:
        return scene
    centroid = (scene.tri_a + scene.tri_b + scene.tri_c) / 3.0
    d = torch.linalg.vector_norm(centroid[..., :2] - root_xy[:, None, :], dim=-1)
    bound = torch.maximum(
        torch.linalg.vector_norm(scene.tri_a - centroid, dim=-1),
        torch.maximum(torch.linalg.vector_norm(scene.tri_b - centroid, dim=-1),
                      torch.linalg.vector_norm(scene.tri_c - centroid, dim=-1)))
    score = torch.where(scene.tri_active > 0.5, d - bound, torch.full_like(d, 1e9))
    idx = torch.sort(score, dim=1, stable=True).indices[:, :window]          # (B, W)

    def take(x):
        if x.dim() == 2:
            return torch.gather(x, 1, idx)
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

    return dataclasses.replace(scene, **{f: take(getattr(scene, f)) for f in TRI_FIELDS})


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


def _dot(x, y):
    return (x * y).sum(-1)


def sphere_triangle_depth(center, radius, a, b, c):
    """Sphere vs triangle: ``(depth, normal, contact_point)``; every argument
    broadcasts over leading dimensions (vectors on the last one).

    The closest point of the triangle by Ericson's barycentric region walk
    (Real-Time Collision Detection §5.1.5), the first listed region winning:
    vertex a, b, c, edge ab, ac, bc, else the interior. The normal points
    from the closest point to the center; a center on the face (distance ≤
    1e-9) takes the face normal turned toward the center's side, so that its
    row stays solvable."""
    ab, ac, ap = b - a, c - a, center - a
    bp, cp = center - b, center - c
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    eps = 1e-12
    p_ab = a + (d1 / torch.clamp(d1 - d3, min=eps))[..., None] * ab
    p_ac = a + (d2 / torch.clamp(d2 - d6, min=eps))[..., None] * ac
    w_bc = (d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6), min=eps)
    p_bc = b + w_bc[..., None] * (c - b)
    denom = 1.0 / torch.clamp(va + vb + vc, min=eps)
    p = a + ab * (vb * denom)[..., None] + ac * (vc * denom)[..., None]
    regions = [
        ((d1 <= 0.0) & (d2 <= 0.0), a),
        ((d3 >= 0.0) & (d4 <= d3), b),
        ((d6 >= 0.0) & (d5 <= d6), c),
        ((vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0), p_ab),
        ((vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0), p_ac),
        ((va <= 0.0) & (d4 - d3 >= 0.0) & (d5 - d6 >= 0.0), p_bc),
    ]
    for cond, cand in reversed(regions):      # applied last to first: the first wins
        p = torch.where(cond[..., None], cand, p)
    delta = center - p
    dist = torch.linalg.vector_norm(delta, dim=-1)
    face_n = torch.cross(ab, ac, dim=-1)
    face_n = face_n / torch.clamp(torch.linalg.vector_norm(face_n, dim=-1), min=1e-12)[..., None]
    side = torch.where(_dot(ap, face_n) >= 0.0, 1.0, -1.0).to(face_n.dtype)
    n = torch.where((dist > 1e-9)[..., None], delta / torch.clamp(dist, min=1e-9)[..., None],
                    side[..., None] * face_n)
    return radius - dist, n, p


def tri_surface_z(scene: Scene, xy: torch.Tensor) -> torch.Tensor:
    """Support height of the mesh under ``xy (B, 2)`` → (B,): the highest
    active face whose xy projection holds the point (a barycentric test with
    1e-6 of slack), the plane's height where none does. Vertical faces (a
    degenerate projection) are left out by the area guard."""
    a2, b2, c2 = scene.tri_a[..., :2], scene.tri_b[..., :2], scene.tri_c[..., :2]
    v0, v1 = b2 - a2, c2 - a2
    p = xy[:, None, :] - a2
    den = v0[..., 0] * v1[..., 1] - v0[..., 1] * v1[..., 0]
    ok = den.abs() > 1e-9
    inv = 1.0 / torch.where(ok, den, torch.ones_like(den))
    u = (p[..., 0] * v1[..., 1] - p[..., 1] * v1[..., 0]) * inv
    v = (v0[..., 0] * p[..., 1] - v0[..., 1] * p[..., 0]) * inv
    inside = ok & (u >= -1e-6) & (v >= -1e-6) & (u + v <= 1.0 + 1e-6) & (scene.tri_active > 0.5)
    za = scene.tri_a[..., 2]
    z = za + u * (scene.tri_b[..., 2] - za) + v * (scene.tri_c[..., 2] - za)
    return torch.where(inside, z, scene.ground_z[:, None].expand_as(z)).amax(dim=1)


def _cells(scene: Scene, xy: torch.Tensor):
    """Grid coordinates of world points ``xy (B, ..., 2)``: the fractional
    (u, v), clamped inside the grid as the JAX package clamps them."""
    H, W = scene.hf_height.shape[1:]
    extra = (1,) * (xy.dim() - 2)
    xy0 = scene.hf_xy0.reshape(-1, *extra, 2)
    cell = scene.hf_cell.reshape(-1, *extra, 1)
    uv = (xy - xy0) / cell
    return uv, torch.clamp(uv[..., 0], 0.0, H - 1.001), torch.clamp(uv[..., 1], 0.0, W - 1.001)


def _gather(grid: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``grid (B, H, W)`` at flat indices ``index (B, ...)``."""
    flat = grid.reshape(grid.shape[0], -1)
    return torch.gather(flat, 1, index.reshape(index.shape[0], -1)).reshape(index.shape)


def hf_corners(scene: Scene, xy: torch.Tensor):
    """Bilinear cell lookup at world ``xy (B, ..., 2)``: the four corner
    heights and the in-cell fractions ``(h00, h10, h01, h11, fu, fv)``, each
    (B, ...); clamped at the borders. Direct gathers (the JAX package's
    one-hot contractions select the same values). The cell indices are
    clamped into the grid too, which changes nothing for a finite point and
    keeps a non-finite one (a blown-up state) from indexing out of it."""
    H, W = scene.hf_height.shape[1:]
    _, u, v = _cells(scene, xy)
    i0f, j0f = torch.floor(u), torch.floor(v)
    i0 = i0f.long().clamp(0, H - 2)
    j0 = j0f.long().clamp(0, W - 2)
    fu, fv = u - i0f, v - j0f
    k = i0 * W + j0
    grid = scene.hf_height
    return (_gather(grid, k), _gather(grid, k + W), _gather(grid, k + 1),
            _gather(grid, k + W + 1), fu, fv)


def hf_sample(scene: Scene, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear height at world ``xy (B, ..., 2)`` → (B, ...)."""
    h00, h10, h01, h11, fu, fv = hf_corners(scene, xy)
    return h00 * (1 - fu) * (1 - fv) + h10 * fu * (1 - fv) + h01 * (1 - fu) * fv + h11 * fu * fv


def hf_normal(scene: Scene, xy: torch.Tensor) -> torch.Tensor:
    """Unit surface normal at ``xy (B, ..., 2)`` → (B, ..., 3): the exact
    in-cell gradient of :func:`hf_sample` (not a finite difference)."""
    h00, h10, h01, h11, fu, fv = hf_corners(scene, xy)
    cell = scene.hf_cell.reshape(-1, *(1,) * (fu.dim() - 1))
    dhdx = ((h10 - h00) * (1 - fv) + (h11 - h01) * fv) / cell
    dhdy = ((h01 - h00) * (1 - fu) + (h11 - h10) * fu) / cell
    n = torch.stack([-dhdx, -dhdy, torch.ones_like(dhdx)], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def extract_patch(scene: Scene, xy: torch.Tensor, P: int = HF_PATCH) -> Scene:
    """The ``P×P`` window of each env's grid around world ``xy (B, 2)``, as a
    Scene. Its corner cell is ``clip(floor(uv) − P/2, 0, H − P)``, so the
    window is pinned to the grid's edge exactly when the point is near it,
    and samples of the window equal samples of the grid for points within
    ``(P/2 − 2)·cell`` of ``xy``. A grid no larger than the window passes
    through unchanged."""
    H, W = scene.hf_height.shape[1:]
    if H <= P and W <= P:
        return scene
    uv, _, _ = _cells(scene, xy)
    base = torch.floor(uv).long() - P // 2
    si = base[:, 0].clamp(0, H - P)
    sj = base[:, 1].clamp(0, W - P)
    ar = torch.arange(P, device=xy.device)
    index = (si[:, None, None] + ar[None, :, None]) * W + (sj[:, None, None] + ar[None, None, :])
    xy0 = scene.hf_xy0 + torch.stack([si, sj], dim=1).to(xy.dtype) * scene.hf_cell[:, None]
    return dataclasses.replace(scene, hf_height=_gather(scene.hf_height, index), hf_xy0=xy0)
