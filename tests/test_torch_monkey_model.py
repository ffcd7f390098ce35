"""PyTorch port vs the JAX package: the monkey model, the bar capsules and
the bar sampler (CPU).

- every array and the static topology of the Monkey3D model, both as the
  port builds it and as it crosses the numpy seam from the JAX model; the
  sizes the K1d instance is built for; the constants and the grab spec;
- ``sphere_capsule_depth`` and the bar branch of ``collide`` (the deepest
  bar per sphere, the first of equally deep bars, the palms left out)
  within 1e-5, an exact tie between two bars and a palm inside a bar
  included;
- the deterministic bar sampler fed the unit draws behind the JAX
  package's own draws at stages 0, 4.5 and 9, within 1e-5;
- the scene with its bars crosses the numpy seam unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocca_envs_tpu.core import rng as jrng
from mocca_envs_tpu.models import monkey as jmonkey
from mocca_envs_tpu.ops import collide as jcollide
from mocca_envs_tpu.ops import kinematics as jkin
from mocca_envs_tpu.tasks import monkey_stepper as jtask
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.models import monkey as tmonkey
from mocca_envs_tpu_torch.models.schema import ARRAY_FIELDS, STATIC_FIELDS
from mocca_envs_tpu_torch.ops import collide as tcollide
from mocca_envs_tpu_torch.ops import kinematics as tkin
from mocca_envs_tpu_torch.ops.cuda.engine import make_scene
from mocca_envs_tpu_torch.ops.step import limited_joints
from mocca_envs_tpu_torch.tasks import monkey_stepper as ttask
from mocca_envs_tpu_torch.terrain import scene as tscene

from tests import torch_workers  # noqa: F401

T = torch.as_tensor


def _jax_fields(obj) -> dict:
    return {f.name: (np.asarray(getattr(obj, f.name)) if hasattr(getattr(obj, f.name), "shape")
                     else getattr(obj, f.name)) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("route", ["built", "converted"])
def test_model_matches_jax(route):
    jm = jmonkey.make_model()
    tm = (tmonkey.make_model() if route == "built"
          else convert.robot_model_from_numpy(_jax_fields(jm)))
    for f in STATIC_FIELDS:
        assert getattr(tm, f) == getattr(jm, f), f
    for f in ARRAY_FIELDS:
        np.testing.assert_allclose(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                   rtol=1e-6, atol=0, err_msg=f)
    # the sizes the K1d instance is built for: the shoulders' full
    # circumduction leaves them without a limit row
    assert (tm.nl, tm.nj, tm.nq, tm.nv, tm.ns) == (11, 10, 17, 16, 5)
    assert len(limited_joints(tm)) == 8
    np.testing.assert_array_equal(tm.sph_no_bar.numpy(), [1, 1, 0, 0, 0])   # the palms


def test_link_poses_match_the_full_fk():
    """The palms' own chains (rotation matrices, ancestors only) against the
    full quaternion FK, on random poses: to rounding."""
    tm = tmonkey.make_model()
    rng = np.random.default_rng(2)
    B = 32
    q = rng.standard_normal((B, tm.nq)).astype(np.float32)
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q[:, 7:] *= 2.0
    links = (tmonkey.constraints().grab_links[1], 8, 3)
    pos, rot = tkin.make_link_poses(tm, links)(T(q))
    fd = tkin.forward_kinematics(tm, T(q), torch.zeros(B, tm.nv))
    np.testing.assert_allclose(pos.numpy(), fd.pos[:, list(links)].numpy(), atol=2e-6)
    np.testing.assert_allclose(rot.numpy(), fd.rot[:, list(links)].numpy(), atol=2e-6)
    palms = ttask.make_palm_positions(tm, tmonkey.constraints())(T(q))
    hands = torch.tensor(tmonkey.constraints().grab_links)
    want = fd.pos[:, hands] + fd.rot[:, hands] @ torch.tensor(tmonkey.PALM_OFFSET)
    np.testing.assert_allclose(palms.numpy(), want.numpy(), atol=2e-6)


def test_constants_and_grab_spec():
    for name in ("PALM_OFFSET", "GRAB_RADIUS", "INITIAL_Z", "BAR_RADIUS", "BAR_HALF_LEN"):
        assert getattr(tmonkey, name) == getattr(jmonkey, name), name
    jspec, tspec = jmonkey.constraints(), tmonkey.constraints()
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert tspec.num_grabs == 2 and tspec.ne == 6 and tspec.num_p2p == 0
    names = tmonkey.make_model().link_names
    assert [names[i] for i in tspec.grab_links] == ["right_elbow", "left_elbow"]
    assert dataclasses.asdict(convert.constraint_spec_from_numpy(dataclasses.asdict(jspec))) \
        == dataclasses.asdict(jspec)


def test_sphere_capsule_depth_matches_jax():
    """Centers along the segment, past its ends, inside the capsule and on
    its axis (the +z fallback)."""
    rng = np.random.default_rng(0)
    n = 512
    a = rng.standard_normal((n, 3)).astype(np.float32)
    b = (a + rng.uniform(-0.5, 0.5, (n, 3))).astype(np.float32)
    t = rng.uniform(-0.3, 1.3, (n, 1))
    center = (a + t * (b - a) + 0.08 * rng.standard_normal((n, 3))).astype(np.float32)
    # exactly on the axis: ends and midpoint on a grid of powers of two
    a[:8] = np.round(8 * a[:8]) / 8
    b[:8] = a[:8] + np.array([0.25, 0.5, 0.125], np.float32)
    center[:8] = a[:8] + 0.5 * (b[:8] - a[:8])
    radius = rng.uniform(0.03, 0.1, n).astype(np.float32)
    cap_r = rng.uniform(0.02, 0.06, n).astype(np.float32)
    want = jax.vmap(jscene.sphere_capsule_depth)(center, radius, a, b, cap_r)
    got = tscene.sphere_capsule_depth(T(center), T(radius), T(a), T(b), T(cap_r))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    depth, normal, _ = (x.numpy() for x in got)
    assert 0.1 < (depth > 0).mean() < 0.9
    np.testing.assert_allclose(normal[:8], np.tile([0.0, 0.0, 1.0], (8, 1)), atol=0)


def _bar_case(kind, B, seed):
    """Monkey states and bars: ``random`` (the chip smoke's mix: bars moved
    next to the feet and torso), ``tie`` (two identical bars under the left
    foot) and ``palm_inside`` (a bar through the right palm and the torso)."""
    import chip_smoke

    tm = tmonkey.make_model()
    q, qd, _, gz, fric, bars, _ = chip_smoke.monkey_states(
        tm, np.random.default_rng(seed), B, near_bar=0.8)
    scene = make_scene(T(gz), T(fric), bars=T(bars))
    a, b = scene.bar_a.numpy().copy(), scene.bar_b.numpy().copy()
    if kind == "tie":
        a[:, 5], b[:, 5] = a[:, 15], b[:, 15]          # bar 5 = bar 15, under the left foot
    if kind == "palm_inside":
        # the base on a grid of powers of two, so that a bar along x through
        # the torso's center has it exactly on its axis
        q[:, 0:3] = np.round(64 * q[:, 0:3]) / 64
        c = tcollide.sphere_centers(tm, tkin.forward_kinematics(tm, T(q), T(qd))).numpy()
        axis = b[:, 3] - a[:, 3]
        a[:, 3] = c[:, 0] - 0.5 * axis                 # through the right palm
        b[:, 3] = c[:, 0] + 0.5 * axis
        half = np.array([0.25, 0.0, 0.0], np.float32)
        a[:, 4], b[:, 4] = c[:, 4] - half, c[:, 4] + half
    active = scene.bar_active.numpy().copy()
    active[:, 10] = 0.0                                # an inactive bar
    return tm, q, qd, (a, b, scene.bar_r.numpy(), active)


@pytest.mark.parametrize("kind", ["random", "tie", "palm_inside"])
def test_collide_with_bars_matches_jax(kind):
    B = 16
    tm, q, qd, (a, b, r, act) = _bar_case(kind, B, 3)
    jm = jmonkey.make_model()

    def jax_path(q1, qd1, a1, b1, r1, act1):
        fd = jkin.forward_kinematics(jm, q1, qd1)
        sc = jscene.Scene(has_ground=True, has_bars=True, ground_z=jnp.asarray(-8.0),
                          bar_a=a1, bar_b=b1, bar_r=r1, bar_active=act1)
        c = jcollide.collide(jm, fd, sc, 0.02)
        return c.pos, c.normal, c.depth, c.active

    want = [np.asarray(w) for w in jax.jit(jax.vmap(jax_path))(q, qd, a, b, r, act)]
    scene = tscene.with_bars(T(a), T(b), T(r), T(act), ground_z=-8.0)
    c = tcollide.collide(tm, tkin.forward_kinematics(tm, T(q), T(qd)), scene, 0.02)
    np.testing.assert_allclose(c.depth.numpy(), want[2], atol=1e-5)
    np.testing.assert_array_equal(c.active.numpy(), want[3])
    np.testing.assert_allclose(c.pos.numpy(), want[0], atol=1e-5)
    np.testing.assert_allclose(c.normal.numpy(), want[1], atol=1e-5)
    touching = c.active.numpy() > 0.5
    assert touching[:, 2:].mean() > 0.2          # feet and torso meet bars
    assert not touching[:, :2].any()             # the palms never do, nor the plane at −8 m
    if kind == "palm_inside":
        # the torso is pushed out of the bar through its center: +z fallback,
        # depth = both radii; the palm inside its bar is left out
        np.testing.assert_allclose(c.depth.numpy()[:, 4], 0.1 + tmonkey.BAR_RADIUS, atol=1e-5)
        np.testing.assert_allclose(c.normal.numpy()[:, 4], np.tile([0, 0, 1.0], (B, 1)))


def test_collide_tie_takes_the_first_bar():
    """Of two equally deep bars the first wins, the port like the oracle's
    argmax: the contact point is the first bar's even though the two bars
    lie on opposite sides of the sphere."""
    tm = tmonkey.make_model()
    B = 2
    q = np.zeros((B, tm.nq), np.float32)
    q[:, 3] = 1.0
    fd = tkin.forward_kinematics(tm, T(q), torch.zeros(B, tm.nv))
    foot = tcollide.sphere_centers(tm, fd)[:, 2].numpy()          # the right foot
    off = 0.04 + tmonkey.BAR_RADIUS - 0.005                        # 5 mm deep either side
    ends = np.array([[-0.4, 0.0, 0.0], [0.4, 0.0, 0.0]], np.float32)
    a = np.zeros((B, 3, 3), np.float32)
    b = np.zeros((B, 3, 3), np.float32)
    for k, dz in enumerate((-off, off, 5.0)):                      # below, above, far away
        a[:, k] = foot + ends[0] + [0, 0, dz]
        b[:, k] = foot + ends[1] + [0, 0, dz]
    r = np.full((B, 3), tmonkey.BAR_RADIUS, np.float32)
    act = np.ones((B, 3), np.float32)
    c = tcollide.collide(tm, fd, tscene.with_bars(T(a), T(b), T(r), T(act)), 0.02)
    jm = jmonkey.make_model()

    @jax.jit
    def jax_path(q1, a1, b1, r1, act1):
        sc = jscene.Scene(has_ground=True, has_bars=True, ground_z=jnp.asarray(-8.0),
                          bar_a=a1, bar_b=b1, bar_r=r1, bar_active=act1)
        return jcollide.collide(jm, jkin.forward_kinematics(jm, q1, jnp.zeros(tm.nv)), sc, 0.02)

    jc = jax_path(q[0], a[0], b[0], r[0], act[0])
    np.testing.assert_allclose(c.depth.numpy()[0, 2], 0.005, atol=1e-6)
    np.testing.assert_allclose(c.normal.numpy()[:, 2], np.tile([0, 0, 1.0], (B, 1)), atol=1e-6)
    np.testing.assert_allclose(c.normal.numpy()[0], np.asarray(jc.normal), atol=1e-6)
    np.testing.assert_allclose(c.pos.numpy()[0], np.asarray(jc.pos), atol=1e-6)


@pytest.mark.parametrize("stage", [0.0, 4.5, 9.0])
def test_bar_sampler_matches_jax_on_its_draws(stage):
    """The deterministic part of the sampler, fed the unit draws behind the
    JAX package's own three uniform draws."""
    B = 8
    jp = jtask.MonkeyParams().set_curriculum(stage)
    tp = convert.monkey_params_from_numpy(_jax_fields(jp))
    # the JAX package holds f32 scalars, the port python floats
    assert dataclasses.asdict(tp) == pytest.approx(
        dataclasses.asdict(ttask.MonkeyParams().set_curriculum(stage)), rel=1e-6)
    keys = jrng.env_keys(jrng.root_key(int(2 * stage) + 1), B)
    want_pos, want_dir = jax.vmap(lambda k: jtask._sample_bars(jp, k))(keys)
    draws = jax.vmap(lambda k: jnp.stack(
        [jax.random.uniform(ki, (jp.num_bars,)) for ki in jax.random.split(k, 3)]))(keys)
    pos, axis = ttask.bars_from_draws(tp, torch.full((B,), stage), T(np.array(draws)))
    np.testing.assert_allclose(pos.numpy(), np.asarray(want_pos), atol=1e-5)
    np.testing.assert_allclose(axis.numpy(), np.asarray(want_dir), atol=1e-5)
    step = np.linalg.norm(np.diff(pos.numpy(), axis=1), axis=2)
    frac = stage / 9.0
    lo, hi = 0.35 + frac * 0.2, 0.45 + frac * 0.65
    assert (step >= lo - 1e-5).all() and (step <= hi + 1e-5).all()
    if stage == 0.0:
        assert float(pos[..., 2].abs().max()) < 1e-6                 # a level, straight chain
        np.testing.assert_allclose(axis.numpy(), np.tile([0, 1.0, 0], (B, 16, 1)), atol=1e-6)
    else:
        assert float(pos[..., 2].std(dim=1).min()) > 0.02            # pitched and turning
    # the port's own draws: same seed, same chains
    gen = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    one = ttask.sample_bars(tp, gen(), torch.full((B,), stage))
    two = ttask.sample_bars(tp, gen(), torch.full((B,), stage))
    torch.testing.assert_close(one[0], two[0], atol=0, rtol=0)


def test_scene_with_bars_crosses_the_numpy_seam():
    B = 3
    pos, axis = ttask.sample_bars(ttask.MonkeyParams(), torch.Generator().manual_seed(1),
                                  torch.zeros(B))
    scene = ttask.bar_scene(pos, axis)
    assert scene.has_bars and not scene.has_stones and scene.bar_a.shape == (B, 16, 3)
    np.testing.assert_allclose(scene.ground_z.numpy(), -8.0)
    torch.testing.assert_close(0.5 * (scene.bar_a + scene.bar_b), pos)
    back = convert.scene_from_numpy(B, **convert.scene_to_numpy(scene))
    for f in dataclasses.fields(scene):
        if getattr(scene, f.name) is None:
            assert getattr(back, f.name) is None
        else:
            torch.testing.assert_close(getattr(back, f.name), getattr(scene, f.name),
                                       atol=0, rtol=0)
