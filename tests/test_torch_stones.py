"""PyTorch port vs the JAX package: stone boxes, culling, the stone sampler
and one walker control step over stones (CPU).

The same inputs, made from numpy seeds, go through the JAX function (its XLA
path on the CPU) and the port's counterpart on ``device="cpu"``. Geometry
agrees to 1e-5. The control step is gated like the plane's
(tests/test_torch_physics.py): per-env medians within q 2e-4, qd 5e-3,
depth 2e-4, normal impulse 5e-3 and the largest single-env error within ten
times that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocca_envs_tpu.core import rng as jrng
from mocca_envs_tpu.models import walker3d as jwalker
from mocca_envs_tpu.ops import collide as jcollide
from mocca_envs_tpu.ops import kinematics as jkin
from mocca_envs_tpu.ops.step import make_control_step as jcontrol
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu.terrain import stones as jstones
from mocca_envs_tpu.utils.config import EngineConfig as JConfig
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.models import walker3d as twalker
from mocca_envs_tpu_torch.ops import collide as tcollide
from mocca_envs_tpu_torch.ops import kinematics as tkin
from mocca_envs_tpu_torch.ops.step import make_control_step as tcontrol
from mocca_envs_tpu_torch.terrain import scene as tscene
from mocca_envs_tpu_torch.terrain import stones as tstones
from mocca_envs_tpu_torch.utils.config import EngineConfig as TConfig

from tests import torch_workers  # noqa: F401

TOL = {"q": 2e-4, "qd": 5e-3, "depth": 2e-4, "nimp": 5e-3}
T = torch.as_tensor


def _gate(name, got, want):
    per_env = np.abs(np.asarray(got) - np.asarray(want)).reshape(len(got), -1).max(axis=1)
    assert np.median(per_env) <= TOL[name], (name, float(np.median(per_env)))
    assert per_env.max() <= 10 * TOL[name], (name, float(per_env.max()))


def _unit_quats(rng, shape, spread):
    q = np.array([1.0, 0.0, 0.0, 0.0]) + spread * rng.standard_normal(shape + (4,))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _stone_chains(B, seed, window=None):
    """Chains at stages spread over 0–9 from the port's deterministic
    sampler, as numpy scene fields (B, K, ·)."""
    rng = np.random.default_rng(seed)
    params = tstones.StoneParams()
    stage = T((np.arange(B) % 10).astype(np.float32))
    top, quat = tstones.stones_from_draws(
        params, stage, T(rng.random((B, 5, params.num_steps)).astype(np.float32)),
        torch.zeros(B, 3))
    center, half = tstones.stones_to_scene_boxes(params, top, quat)
    return top.numpy(), center.numpy(), quat.numpy(), half.numpy()


def _walker_over_stones(B, seed):
    """Walker states with the feet in or near contact with (tilted) stone
    tops, within the contact margin of them: root 0.9 m above one of the
    first stones, small scatter."""
    rng = np.random.default_rng(seed)
    top, center, quat, half = _stone_chains(B, seed + 1)
    under = top[np.arange(B), rng.integers(0, 6, B)]
    q = np.zeros((B, 28), np.float32)
    q[:, 0:2] = under[:, :2] + 0.1 * rng.standard_normal((B, 2))
    q[:, 2] = under[:, 2] + 0.9 + 0.04 * rng.standard_normal(B)
    q[:, 3:7] = _unit_quats(rng, (B,), 0.03)
    q[:, 7:] = 0.1 * rng.standard_normal((B, 21))
    qd = (0.3 * rng.standard_normal((B, 27))).astype(np.float32)
    active = np.ones((B, 20), np.float32)
    active[:, 15:] = (rng.random((B, 5)) < 0.5)
    return q, qd, (center, quat, half, active)


def test_sphere_box_depth_matches_jax():
    """Outside (faces, edges, corners) and inside the box, tilted boxes."""
    rng = np.random.default_rng(0)
    n = 512
    half = rng.uniform(0.1, 0.5, (n, 3)).astype(np.float32)
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    quat = _unit_quats(rng, (n,), 0.4)
    local = (rng.uniform(-1.6, 1.6, (n, 3)) * half).astype(np.float32)    # ~a quarter inside
    center = pos + np.asarray(jax.vmap(jscene.quat_ops.rotate)(jnp.asarray(quat),
                                                                jnp.asarray(local)))
    radius = rng.uniform(0.03, 0.12, n).astype(np.float32)
    want = jax.vmap(jscene.sphere_box_depth)(center, radius, pos, quat, half)
    got = tscene.sphere_box_depth(T(center), T(radius), T(pos), T(quat), T(half))
    inside = (np.abs(local) < half).all(axis=1)
    assert 0.1 < inside.mean() < 0.5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    # inside, the depth exceeds the radius; the first of equally near faces wins
    assert (got[0].numpy()[inside] >= radius[inside]).all()
    tie = tscene.sphere_box_depth(T([0.0, 0.0, 0.0]), T(0.1), T([0.0, 0.0, 0.0]),
                                  T([1.0, 0.0, 0.0, 0.0]), T([0.2, 0.2, 0.2]))
    jtie = jscene.sphere_box_depth(jnp.zeros(3), 0.1, jnp.zeros(3),
                                   jnp.array([1.0, 0.0, 0.0, 0.0]), jnp.full(3, 0.2))
    for g, w in zip(tie, jtie):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_collide_with_stones_matches_jax():
    """Spheres vs the plane and 20 stones (some inactive): the deepest
    feature per sphere, the plane kept unless a stone is strictly deeper."""
    B = 16
    jm, tm = jwalker.make_model(), twalker.make_model()
    q, qd, (center, quat, half, active) = _walker_over_stones(B, 3)
    q[:4, 2] -= 0.25    # some bodies sunk into the stones: inside-the-box branch

    def jax_path(q1, qd1, sp, sq, sh, sa):
        fd = jkin.forward_kinematics(jm, q1, qd1)
        sc = jscene.with_stones(sp, sq, sh, sa, ground_z=-20.0)
        c = jcollide.collide(jm, fd, sc, 0.02)
        return c.pos, c.normal, c.depth, c.active

    want = jax.jit(jax.vmap(jax_path))(q, qd, center, quat, half, active)
    scene = tscene.with_stones(T(center), T(quat), T(half), T(active), ground_z=-20.0)
    c = tcollide.collide(tm, tkin.forward_kinematics(tm, T(q), T(qd)), scene, 0.02)
    touching = np.asarray(want[3]) > 0.5
    assert touching.mean() > 0.1 and (np.asarray(want[2]) > 0.1).any()
    np.testing.assert_allclose(c.depth.numpy(), np.asarray(want[2]), atol=1e-5)
    np.testing.assert_array_equal(c.active.numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(c.pos.numpy()[touching], np.asarray(want[0])[touching], atol=1e-5)
    np.testing.assert_allclose(c.normal.numpy()[touching], np.asarray(want[1])[touching],
                               atol=1e-5)
    # tilted stones give normals off +z; the plane at −20 m never wins here
    assert (c.normal.numpy()[touching][:, 2] < 0.999).any()


def test_cull_stones_selects_the_same_set():
    B, W = 32, 6
    rng = np.random.default_rng(7)
    top, center, quat, half = _stone_chains(B, 8)
    active = (rng.random((B, 20)) < 0.8).astype(np.float32)
    root = top[np.arange(B), rng.integers(0, 20, B), :2] + 0.3 * rng.standard_normal((B, 2))
    root = root.astype(np.float32)

    def jax_path(sp, sq, sh, sa, xy):
        sc = jscene.cull_stones(jscene.with_stones(sp, sq, sh, sa), xy, W)
        return sc.stone_pos, sc.stone_quat, sc.stone_half, sc.stone_active

    want = [np.asarray(x) for x in jax.vmap(jax_path)(center, quat, half, active, root)]
    scene = tscene.with_stones(T(center), T(quat), T(half), T(active))
    got = tscene.cull_stones(scene, T(root), W)
    assert got.stone_pos.shape == (B, W, 3) and got.stone_active.shape == (B, W)
    for b in range(B):
        rows = lambda p, q_, h, a: sorted(  # noqa: E731
            map(tuple, np.concatenate([p, q_, h, a[:, None]], axis=1).round(6).tolist()))
        assert rows(got.stone_pos[b].numpy(), got.stone_quat[b].numpy(),
                    got.stone_half[b].numpy(), got.stone_active[b].numpy()) \
            == rows(want[0][b], want[1][b], want[2][b], want[3][b]), b
        # inactive stones rank last
        a = got.stone_active[b].numpy()
        assert (np.diff(a) <= 0).all()
    # a window that covers the set, or none, leaves the scene as it is
    assert tscene.cull_stones(scene, T(root), 20) is scene
    assert tscene.cull_stones(scene, T(root), 0) is scene
    flat = tscene.flat(B)
    assert tscene.cull_stones(flat, T(root), W) is flat


@pytest.mark.parametrize("stage", [0.0, 9.0])
def test_stone_sampler_matches_jax_on_its_draws(stage):
    """The deterministic part of the sampler, fed the unit draws behind the
    JAX package's own five uniform draws, and the boxes built from it."""
    B = 8
    jp = jstones.StoneParams().set_stage(stage)
    fields = {f.name: np.asarray(getattr(jp, f.name)) for f in dataclasses.fields(jp)}
    tp = convert.stone_params_from_numpy(fields)
    # the JAX package holds f32 scalars, the port python floats
    assert dataclasses.asdict(tp) == pytest.approx(
        dataclasses.asdict(tstones.StoneParams().set_stage(stage)), rel=1e-6)
    keys = jrng.env_keys(jrng.root_key(int(stage) + 1), B)
    start = np.random.default_rng(1).standard_normal((B, 3)).astype(np.float32)
    want_pos, want_quat = jax.vmap(lambda k, s: jstones.sample_stones(jp, k, s))(keys, start)
    draws = jax.vmap(lambda k: jnp.stack(
        [jax.random.uniform(ki, (jp.num_steps,)) for ki in jax.random.split(k, 5)]))(keys)
    pos, quat = tstones.stones_from_draws(
        tp, torch.full((B,), stage), T(np.asarray(draws)), T(start))
    np.testing.assert_allclose(pos.numpy(), np.asarray(want_pos), atol=1e-5)
    np.testing.assert_allclose(quat.numpy(), np.asarray(want_quat), atol=1e-5)
    want_c, want_h = jax.vmap(lambda p, q_: jstones.stones_to_scene_boxes(jp, p, q_))(
        want_pos, want_quat)
    center, half = tstones.stones_to_scene_boxes(tp, pos, quat)
    np.testing.assert_allclose(center.numpy(), np.asarray(want_c), atol=1e-5)
    np.testing.assert_allclose(half.numpy(), np.asarray(want_h), atol=0)
    if stage == 0.0:
        assert float(pos[..., 2].std(dim=1).max()) < 1e-5      # a level walkway
    else:
        assert float(pos[..., 2].std(dim=1).min()) > 0.05      # pitched, tilted stones
        assert float(quat[:, 2:, 1:3].abs().max()) > 0.05


def test_port_sampler_draws_its_own_chains():
    """The port's own draws: same generator seed ⇒ same chains; stages per
    env; spacing inside the stage's range."""
    p = tstones.StoneParams()
    stage = T([0.0, 0.0, 9.0, 9.0])
    a = tstones.sample_stones(p, torch.Generator().manual_seed(3), stage, torch.zeros(4, 3))
    b = tstones.sample_stones(p, torch.Generator().manual_seed(3), stage, torch.zeros(4, 3))
    torch.testing.assert_close(a[0], b[0], atol=0, rtol=0)
    assert a[0].shape == (4, 20, 3) and a[1].shape == (4, 20, 4)
    d = torch.linalg.vector_norm(a[0][:, 1:] - a[0][:, :-1], dim=-1)
    assert float(d[:2].min()) >= 0.35 - 1e-6 and float(d[:2].max()) <= 0.45 + 1e-6
    assert 0.8 < float(d[2:].max()) < 1.36
    assert not torch.allclose(a[0][0], a[0][1])


def test_walker_control_step_over_stones_matches_jax():
    """One control step (torque actuation, shipped config, 6-stone window)
    over stones tilted up to 25°, B = 32, against ops/step.py."""
    jm, tm = jwalker.make_model(), twalker.make_model()
    B = 32
    q, qd, (center, quat, half, active) = _walker_over_stones(B, 11)
    action = np.random.default_rng(12).uniform(-1, 1, (B, 21)).astype(np.float32)
    gain = np.array(jm.power_coef * jm.actuated)
    jstep = jcontrol(jm, JConfig(), actuation=lambda q_, qd_, a: gain * jnp.clip(a, -1, 1))

    def jax_path(q1, qd1, a, sp, sq, sh, sa):
        sc = jscene.with_stones(sp, sq, sh, sa, ground_z=-20.0)
        qq, dd, info = jstep(q1, qd1, a, sc)
        return (qq, dd, info.contacts.depth, info.normal_impulse, info.foot_contact,
                info.link_contact)

    want = jax.jit(jax.vmap(jax_path))(q, qd, action, center, quat, half, active)
    tgain = T(gain)
    tstep = tcontrol(tm, TConfig(), actuation=lambda q_, qd_, a: tgain * torch.clamp(a, -1, 1))
    scene = tscene.with_stones(T(center), T(quat), T(half), T(active), ground_z=-20.0)
    tq, tqd, info = tstep(T(q), T(qd), T(action), scene)
    _gate("q", tq.numpy(), want[0])
    _gate("qd", tqd.numpy(), want[1])
    _gate("depth", info.contacts.depth.numpy(), want[2])
    _gate("nimp", info.normal_impulse.numpy(), want[3])
    np.testing.assert_array_equal(info.foot_contact.numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(info.link_contact.numpy(), np.asarray(want[5]))
    # the gate means something: stones carry load, on normals off +z
    loaded = info.normal_impulse.numpy() > 0
    assert loaded.mean() > 0.05
    assert (info.contacts.normal.numpy()[loaded][:, 2] < 0.999).any()
    assert scene.stone_pos.shape[1] == 20 and info.contacts.depth.shape == (B, 14)


def test_scene_with_stones_crosses_the_numpy_seam():
    B = 3
    _, center, quat, half = _stone_chains(B, 2)
    active = np.ones((B, 20), np.float32)
    scene = convert.scene_from_numpy(B, -20.0, 0.8, center, quat, half, active)
    assert scene.has_stones and scene.ground_z.shape == (B,)
    back = convert.scene_from_numpy(B, **convert.scene_to_numpy(scene))
    for f in dataclasses.fields(scene):
        torch.testing.assert_close(getattr(back, f.name), getattr(scene, f.name), atol=0, rtol=0)
    flat = convert.scene_from_numpy(B)
    assert not flat.has_stones and set(convert.scene_to_numpy(flat)) == {"ground_z", "friction"}
