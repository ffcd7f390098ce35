"""PyTorch port vs the JAX package: the triangle-mesh narrowphase, the mesh
scenes, the face cull and one walker control step over the stairs (CPU).

Tolerances: the primitive and the support height to 1e-5 (float32, the same
formulas in another order); the scene builders and the cull bit-equal; the
control step at the kernel-vs-oracle gates of tests/test_pallas_engine.py
(per-env medians within q 2e-4, qd 5e-3, depth 2e-4, normal impulse 5e-3),
the largest single-env error within ten times those over the envs with no
contact on a vertical face (there the branchless tangent basis turns its
first tangent with the sign of a rounded n_z while the warm-started friction
impulse keeps the last substep's sign, so two roundings of one state part:
chip_smoke.py::vertical_contacts), and the JAX package's own mesh gate, 97%
of the q entries within 1e-3 (tests/test_trimesh.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from mocca_envs_tpu.models import walker3d as jwalker
from mocca_envs_tpu.ops.step import make_control_step as jcontrol
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu.utils.config import EngineConfig as JConfig
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.models import walker3d as twalker
from mocca_envs_tpu_torch.ops import collide as tcollide
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.ops.kinematics import forward_kinematics
from mocca_envs_tpu_torch.ops.step import make_control_step as tcontrol
from mocca_envs_tpu_torch.ops.step import make_substep as tsubstep
from mocca_envs_tpu_torch.terrain import scene as tscene
from mocca_envs_tpu_torch.utils.config import EngineConfig as TConfig

from tests import torch_workers  # noqa: F401
from tests.models_util import ball, free_q, free_qd

TOL = {"q": 2e-4, "qd": 5e-3, "depth": 2e-4, "nimp": 5e-3}
T = torch.as_tensor
STAIRS = dict(n_steps=6, rise=0.12, run=0.35, width=4.0, start_x=0.6)


def _port_model(jmodel):
    fields = {f.name: getattr(jmodel, f.name) for f in dataclasses.fields(jmodel)}
    return convert.robot_model_from_numpy(
        {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in fields.items()})


def _regions(center, a, b, c):
    """Index of the region that holds each center (a, b, c, ab, ac, bc,
    interior): the operation table of the kernel's walk names them."""
    ops = engine.tri_walk_ops(T(center), T(a), T(b), T(c)).numpy() - engine.TRI_TAIL_OPS
    return np.searchsorted(engine.TRI_WALK_OPS, ops)


def test_sphere_triangle_regions_match_jax():
    """The cases of tests/test_trimesh.py (interior above and below, a
    vertex, an edge, a center on the face), then every region of random
    triangles, against the JAX primitive."""
    a, b, c = np.array([0.0, 0.0, 0.0]), np.array([2.0, 0.0, 0.0]), np.array([0.0, 2.0, 0.0])
    cases = np.array([[0.5, 0.5, 0.05], [-1.0, -1.0, 0.0], [1.0, -0.5, 0.0], [0.5, 0.5, -0.05],
                      [0.5, 0.5, 0.0]], np.float32)
    got = tscene.sphere_triangle_depth(T(cases), 0.1, *(T(np.float32(v)) for v in (a, b, c)))
    want = jax.jit(jax.vmap(lambda x: jscene.sphere_triangle_depth(x, 0.1, a, b, c)))(cases)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    d, n, p = (x.numpy() for x in got)
    np.testing.assert_allclose(p[0], [0.5, 0.5, 0.0], atol=1e-6)
    np.testing.assert_allclose(n[0], [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(p[1], a, atol=1e-6)
    np.testing.assert_allclose(p[2], [1.0, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(n[3], [0, 0, -1], atol=1e-6)       # below: toward the center
    np.testing.assert_allclose(d[4], 0.1, atol=1e-6)              # on the face: depth = radius
    np.testing.assert_allclose(np.linalg.norm(n[4]), 1.0, atol=1e-5)

    rng = np.random.default_rng(0)
    m = 4096
    tri = rng.uniform(-1.0, 1.0, (3, m, 3)).astype(np.float32)
    center = (tri.mean(axis=0) + rng.uniform(-1.5, 1.5, (m, 3))).astype(np.float32)
    radius = rng.uniform(0.05, 0.5, m).astype(np.float32)
    got = [x.numpy() for x in tscene.sphere_triangle_depth(T(center), T(radius), *map(T, tri))]
    want = [np.asarray(x) for x in jax.jit(jax.vmap(jscene.sphere_triangle_depth))(
        center, radius, *tri)]
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)             # depth
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)             # closest point
    # the normal is the offset to the center over its length: the offsets
    # agree to 1e-5 (a short one turns its direction further)
    dist = (radius - want[0])[:, None]
    assert (np.abs(got[1] - want[1]) * dist).max() <= 1e-5
    counts = np.bincount(_regions(center, *tri), minlength=7)
    assert (counts > 20).all(), counts


def test_stairs_and_trimesh_fields_are_bit_equal():
    """The staircase (the family's and the builder's defaults) and a mesh
    from given vertices and faces: every field as the JAX package builds
    it, viewed by each env of the batch."""
    for kw in (STAIRS, {}):
        want = jscene.stairs_trimesh(**kw)
        got = tscene.broadcast_scene(tscene.stairs_trimesh(**kw), 3)
        assert got.tri_a.shape == (3, 4 * kw.get("n_steps", 6), 3)
        for f in tscene.TRI_FIELDS + ("ground_z", "friction"):
            g = getattr(got, f).numpy()
            for env in range(3):
                np.testing.assert_array_equal(g[env], np.asarray(getattr(want, f)))
        assert got.tri_a.stride(0) == 0          # one mesh, expanded
    rng = np.random.default_rng(1)
    verts = rng.standard_normal((9, 3)).astype(np.float32)
    faces = rng.integers(0, 9, (7, 3))
    want = jscene.with_trimesh(verts, faces, ground_z=-2.0, friction=0.6)
    got = tscene.with_trimesh(verts, faces, ground_z=-2.0, friction=0.6)
    for f in tscene.TRI_FIELDS + ("ground_z", "friction"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[0], np.asarray(getattr(want, f)))


def test_tri_surface_z_matches_jax():
    """0 in front of the stairs, 0.48 over the fourth tread (x = 1.8 m),
    the plane beside them, and random points over and around them."""
    jsc = jscene.stairs_trimesh(**STAIRS)
    rng = np.random.default_rng(2)
    xy = np.concatenate([np.array([[0.0, 0.0], [1.8, 0.0], [1.8, 2.5], [3.5, 0.0]]),
                         rng.uniform([-0.5, -2.5], [3.2, 2.5], (252, 2))]).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda p: jscene.tri_surface_z(jsc, p)))(xy))
    got = tscene.tri_surface_z(tscene.broadcast_scene(tscene.stairs_trimesh(**STAIRS), len(xy)),
                               T(xy)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got[:4], [0.0, 0.48, 0.0, 0.0], atol=1e-5)
    assert len(np.unique(got.round(4))) == 7      # the plane and the six treads


def test_cull_tris_is_the_jax_window():
    """The window the JAX package keeps, in its order, bit for bit: the
    stairs with three faces listed twice (exact ties, where the lower index
    must come first) and some faces inactive, roots over and around them."""
    B, W = 48, 16
    jsc = jscene.stairs_trimesh(**STAIRS)
    dup = [3, 10, 17]
    fields = {f: np.concatenate([np.asarray(getattr(jsc, f)), np.asarray(getattr(jsc, f))[dup]])
              for f in tscene.TRI_FIELDS}
    rng = np.random.default_rng(3)
    active = np.tile(fields["tri_active"], (B, 1))
    active[rng.random(active.shape) < 0.15] = 0.0
    root = rng.uniform([-0.5, -2.5], [3.2, 2.5], (B, 2)).astype(np.float32)
    per_env = {f: np.broadcast_to(v, (B,) + v.shape).copy() for f, v in fields.items()}
    per_env["tri_active"] = active

    def jax_path(ta, tb, tc, act, xy):
        sc = jsc.replace(tri_a=ta, tri_b=tb, tri_c=tc, tri_active=act)
        w = jscene.cull_tris(sc, xy, W)
        return w.tri_a, w.tri_b, w.tri_c, w.tri_active

    want = jax.jit(jax.vmap(jax_path))(*(per_env[f] for f in tscene.TRI_FIELDS), root)
    scene = convert.scene_from_numpy(B, **{f: per_env[f] for f in tscene.TRI_FIELDS})
    got = tscene.cull_tris(scene, T(root), W)
    for f, w in zip(tscene.TRI_FIELDS, want):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(w), err_msg=f)
    # a duplicated face and its twin are both kept, next to each other
    face = torch.cat([got.tri_a, got.tri_b, got.tri_c], dim=2)
    kept_twins = [(face[b] == T(np.concatenate([fields[f][d] for f in tscene.TRI_FIELDS[:3]])))
                  .all(dim=1).sum() for b in range(B) for d in dup]
    assert max(int(k) for k in kept_twins) == 2
    assert tscene.cull_tris(scene, T(root), 27) is scene and tscene.cull_tris(scene, T(root), 0) \
        is scene


def test_cull_tris_keeps_trajectories_exact():
    """A ball dropped on the stairs (16 faces) runs the same trajectory over
    the full mesh and over an 8-face window re-culled each substep, bit for
    bit (tests/test_trimesh.py::test_cull_tris_exact_on_stairs), and rests
    on its tread."""
    model = _port_model(ball(radius=0.08))
    sub = tsubstep(model, TConfig(solver_iters=20))
    scene = tscene.stairs_trimesh(n_steps=4, rise=0.15, run=0.3, start_x=0.5)
    tau = torch.zeros(1, 0)

    def run(window):
        q, qd = T(free_q(pos=(0.95, 0.1, 0.8)))[None], T(free_qd())[None]
        out = []
        for _ in range(300):
            q, qd, _, _ = sub(q, qd, tau, tscene.cull_tris(scene, q[:, 0:2], window))
            out.append(q)
        return torch.cat(out)

    full, window = run(0), run(8)
    torch.testing.assert_close(full, window, atol=0, rtol=0)
    assert abs(float(full[-1, 2]) - 0.38) < 8e-3       # on tread 2: 0.30 + radius


def test_mesh_contacts_match_jax():
    """Walker spheres against the culled stairs over the plane: the deepest
    feature per sphere, the first of equal faces (the nosing edge, a quad's
    diagonal), against ops/collide.py."""
    B = 48
    jm, tm = jwalker.make_model(), twalker.make_model()
    q, qd, _, _, _, _ = chip_smoke.stairs_states(tm, np.random.default_rng(4), B)
    jsc = jscene.stairs_trimesh(**STAIRS)

    def jax_path(q1, qd1):
        from mocca_envs_tpu.ops import collide as jcollide
        from mocca_envs_tpu.ops import kinematics as jkin

        c = jcollide.collide(jm, jkin.forward_kinematics(jm, q1, qd1),
                             jscene.cull_tris(jsc, q1[0:2], 16), 0.02)
        return c.pos, c.normal, c.depth, c.active

    want = [np.asarray(x) for x in jax.jit(jax.vmap(jax_path))(q, qd)]
    scene = tscene.cull_tris(tscene.broadcast_scene(tscene.stairs_trimesh(**STAIRS), B),
                             T(q[:, 0:2]), 16)
    c = tcollide.collide(tm, forward_kinematics(tm, T(q), T(qd)), scene, 0.02)
    touching = want[3] > 0.5
    np.testing.assert_allclose(c.depth.numpy(), want[2], atol=1e-5)
    np.testing.assert_array_equal(c.active.numpy(), want[3])
    # the closest point on a face is a ratio of differences of products of
    # metre-scale coordinates: 5e-5 (depths, along the normal, agree to 1e-5)
    np.testing.assert_allclose(c.pos.numpy()[touching], want[0][touching], atol=5e-5)
    # a normal is the offset from that point to the center over its length
    # (radius − depth, 1–6 cm here): its error times that length stays within
    # the points' 5e-5; on a vertical face up to the sign of a rounded n_z
    dist = (tm.sph_radius.numpy() - want[2])[touching][:, None]
    gn, wn = c.normal.numpy()[touching], want[1][touching]
    assert (np.abs(gn[:, :2] - wn[:, :2]) * dist).max() <= 5e-5
    assert (np.abs(np.abs(gn[:, 2]) - np.abs(wn[:, 2]))[:, None] * dist).max() <= 5e-5
    on_mesh = touching & (np.abs(want[1][..., 0]) > 0.5)     # riser contacts
    assert on_mesh.any() and (touching & (want[0][..., 2] > 0.1)).any()   # risers, treads


def test_walker_control_step_over_stairs_matches_jax():
    """One control step (torque actuation, shipped config, 16-face window
    culled by each package itself from the 24 faces) at B = 48 on states at
    treads, nosings and risers, against ops/step.py."""
    jm, tm = jwalker.make_model(), twalker.make_model()
    B = 48
    arrays = chip_smoke.stairs_states(tm, np.random.default_rng(5), B)
    q, qd = arrays[0], arrays[1]
    action = np.random.default_rng(6).uniform(-1, 1, (B, 21)).astype(np.float32)
    gain = np.array(jm.power_coef * jm.actuated)
    jstep = jcontrol(jm, JConfig(), actuation=lambda q_, qd_, a: gain * jnp.clip(a, -1, 1))
    jsc = jscene.stairs_trimesh(**STAIRS)

    def jax_path(q1, qd1, a):
        qq, dd, info = jstep(q1, qd1, a, jsc)
        return qq, dd, info.contacts.depth, info.normal_impulse

    want = [np.asarray(x) for x in jax.jit(jax.vmap(jax_path))(q, qd, action)]
    tgain = T(gain)
    tstep = tcontrol(tm, TConfig(), actuation=lambda q_, qd_, a: tgain * torch.clamp(a, -1, 1))
    tq, tqd, info = tstep(T(q), T(qd), T(action),
                          tscene.broadcast_scene(tscene.stairs_trimesh(**STAIRS), B))
    got = [x.numpy() for x in (tq, tqd, info.contacts.depth, info.normal_impulse)]
    # the torques of the step, as the unit's kernel case takes them
    kernel_args = [T(x) for x in arrays]
    kernel_args[2] = tgain * T(action)
    vertical = chip_smoke.vertical_contacts(engine.K1g(tm, TConfig()), kernel_args).numpy()
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        per_env = np.abs(g - w).max(axis=1)
        assert np.median(per_env) <= TOL[name], (name, float(np.median(per_env)))
        assert per_env[~vertical].max() <= 10 * TOL[name], (name, float(per_env[~vertical].max()))
    assert (np.abs(got[0] - want[0]) < 1e-3).mean() >= 0.97
    assert 0.1 < vertical.mean() < 0.9 and (got[3] > 0).mean() > 0.05
