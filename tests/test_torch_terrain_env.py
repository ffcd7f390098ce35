"""PyTorch port vs the JAX package: the batched terrain families
Walker3DTerrainEnv and Walker3DTerrainLidarEnv (CPU).

Both packages get the same states, each slot's grid included, and actions
each step: the port is re-synced from the JAX state through numpy, on the
JAX state's own terrain. The JAX side is one 30-step run of the LIDAR
family, against which both port families step: the JAX terrain family is
the same function without the ray tail of the observation (its step, done,
reward and first 60 observations are the LIDAR family's), and compiling it
once saves the test a minute. Done flags must be equal on every step, rewards
agree to 1e-4 and observations to 1e-4 on the per-env median (a LIDAR ray
whose march point lies within an ulp of the surface may end one step apart:
the JAX package samples by one-hot contractions, the port by gathers).
Targets are placed out of reach, so no random target resample happens. The
fresh episodes and the terrain pick come from different generators
(threefry vs torch) and are compared in distribution.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mocca_envs_tpu
import mocca_envs_tpu_torch
from mocca_envs_tpu.core import rng as jrng
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.core import rng as trng
from mocca_envs_tpu_torch.tasks import walker_terrain as tterrain
from mocca_envs_tpu_torch.terrain.scene import NO_GROUND_Z, hf_sample

from tests import torch_workers  # noqa: F401

B = 8
STEPS = 30
AHEAD = 3.0
SPAWN_DZ = 0.96   # initial_z + 0.02 over the surface
FAMILIES = ["Walker3DTerrainEnv-v0", "Walker3DTerrainLidarEnv-v0"]


@pytest.fixture(scope="module", params=FAMILIES)
def envs(request):
    jenv = mocca_envs_tpu.make(request.param)
    penv = mocca_envs_tpu_torch.make(request.param, device="cpu")
    return jenv, penv, jax.jit(jax.vmap(jenv.init))


@pytest.fixture(scope="module")
def jax_run():
    """``STEPS`` steps of the JAX LIDAR family from targets out of reach,
    under uniform random actions: ``(env, [(state, action, transition)])``."""
    jenv = mocca_envs_tpu.make("Walker3DTerrainLidarEnv-v0")
    jstep = jax.jit(jax.vmap(jenv.step))
    js = _targets_ahead(jenv, jax.jit(jax.vmap(jenv.init))(jrng.env_keys(jrng.root_key(0), B)))
    rng = np.random.default_rng(0)
    run = []
    for _ in range(STEPS):
        a = rng.uniform(-1, 1, (B, jenv.act_dim)).astype(np.float32)
        jtr = jstep(js, jnp.asarray(a))
        run.append((js, a, jtr))
        js = jtr.state
    return jenv, run


def _to_port(js):
    n = np.asarray
    sc = js.scene
    return convert.env_state_from_numpy(
        q=n(js.q), qd=n(js.qd), steps=n(js.steps), reset_count=n(js.reset_count),
        done=n(js.done), blowup_count=n(js.blowup_count), target=n(js.task.target),
        potential=n(js.task.potential), ground_z=n(sc.ground_z), friction=n(sc.friction),
        hf_height=n(sc.hf_height), hf_xy0=n(sc.hf_xy0), hf_cell=n(sc.hf_cell),
        has_ground=sc.has_ground)


def _targets_ahead(jenv, state):
    target = state.q[:, :3].at[:, 0].add(AHEAD).at[:, 2].set(0.0)
    dist = jnp.linalg.norm(target[:, :2] - state.q[:, :2], axis=1)
    return state.replace(task=state.task.replace(
        target=target, potential=-dist / jenv.control_dt))


def _check_on_surface(state, mask):
    """Spawn and target of the ``mask`` slots stand on their grid's surface."""
    q, tgt = state.q[mask], state.task.target[mask]
    scene = dataclasses.replace(state.scene, **{
        k: getattr(state.scene, k)[mask] for k in ("hf_height", "hf_xy0", "hf_cell")})
    torch.testing.assert_close(q[:, 2] - hf_sample(scene, q[:, 0:2]),
                               torch.full((len(q),), SPAWN_DZ), atol=2e-6, rtol=0)
    torch.testing.assert_close(tgt[:, 2], hf_sample(scene, tgt[:, 0:2]), atol=1e-6, rtol=0)
    assert bool((state.steps[mask] == 0).all()) and bool((state.qd[mask] == 0).all())


@pytest.mark.parametrize("family", FAMILIES)
def test_env_matches_jax_step_by_step(jax_run, family):
    jenv, run = jax_run
    penv = mocca_envs_tpu_torch.make(family, device="cpu")
    width = penv.obs_dim
    assert (width, penv.act_dim) == (68 if "Lidar" in family else 60, 21)
    grids = np.asarray(run[0][0].scene.hf_height).copy()
    gen = trng.generator(0, "cpu")
    resets = 0
    for t, (js, a, jtr) in enumerate(run):
        ps = _to_port(js)
        ptr = penv.step(ps, torch.as_tensor(a), gen)
        jdone = np.array(jtr.done)
        np.testing.assert_array_equal(ptr.done.numpy(), jdone, err_msg=f"step {t}")
        np.testing.assert_allclose(ptr.reward.numpy(), np.asarray(jtr.reward), atol=1e-4,
                                   err_msg=f"step {t}")
        live = ~jdone
        diff = np.abs(ptr.obs.numpy() - np.asarray(jtr.obs)[:, :width])[live]
        assert np.median(diff.max(axis=1)) <= 1e-4, (t, diff.max(axis=1))
        # the body, joints and probes to 1e-2 in every env: 0.1·q̇ carries
        # the contact solver's fp-order noise, gated at qd 1e-2 over terrain
        assert diff[:, :60].max() <= 1e-2, (t, diff[:, :60].max(axis=1))
        np.testing.assert_allclose(ptr.state.task.target.numpy()[live],
                                   np.asarray(jtr.state.task.target)[live], atol=1e-5)
        # the full grid is carried, never the window
        assert ptr.state.scene.hf_height is ps.scene.hf_height
        if jdone.any():
            _check_on_surface(ptr.state, torch.as_tensor(jdone))
            fresh_obs = ptr.obs.numpy()[jdone]
            np.testing.assert_allclose(fresh_obs[:, 50:52], 0.0)        # zero foot flags
            # Δz is the base's height over initial_z, not over the surface
            np.testing.assert_allclose(fresh_obs[:, 0],
                                       ptr.state.q[jdone, 2].numpy() - (SPAWN_DZ - 0.02),
                                       atol=1e-6)
            resets += int(jdone.sum())
        assert not np.asarray(jtr.metrics["reached_target"]).any()
    assert resets >= 3, "the horizon should see several auto-resets"
    # each slot kept its terrain through its resets, in both packages
    np.testing.assert_array_equal(np.asarray(run[-1][2].state.scene.hf_height), grids)


def test_exact_obs_mirror_and_seam(envs):
    """``obs_fn`` on the full grid agrees with the JAX package's on the same
    states; the mirror maps are the JAX package's; the state round-trips
    through the numpy seam."""
    jenv, penv, jinit = envs
    js = jinit(jrng.env_keys(jrng.root_key(5), 6))
    q = np.array(js.q)
    q[:3, 2] -= 0.08          # half the slots with the feet in the ground
    js = js.replace(q=jnp.asarray(q))
    ps = _to_port(js)
    assert float(ps.scene.ground_z.max()) == NO_GROUND_Z
    want = np.asarray(jax.jit(jax.vmap(jenv.obs_fn))(js))
    got = penv.obs_fn(ps).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got[:3, 50:52].sum() > 0 and got[3:, 50:52].sum() == 0
    np.testing.assert_allclose(penv.reset_obs_fn(ps).numpy()[3:], got[3:], atol=0)
    for key in ("obs_perm", "obs_sign", "act_perm", "act_sign"):
        np.testing.assert_array_equal(penv.mirror[key].numpy(), np.asarray(jenv.mirror[key]))
    # probes pair up under the mirror, the fan reverses
    perm = penv.mirror["obs_perm"].numpy()
    assert list(perm[52:60]) == [52 + p for p in tterrain.PROBE_MIRROR]
    if "Lidar" in jenv.name:
        assert list(perm[60:]) == list(range(67, 59, -1))
    back = convert.env_state_from_numpy(**convert.env_state_to_numpy(ps))
    for a, b in zip(convert.env_state_to_numpy(back).values(),
                    convert.env_state_to_numpy(ps).values()):
        np.testing.assert_array_equal(a, b)


def test_terrain_pick_and_spawn_in_distribution():
    """Each slot's grid is one of the bank's 16, picked uniformly, in both
    packages; spawn and target stand on the surface."""
    n = 1024
    jenv = mocca_envs_tpu.make("Walker3DTerrainEnv-v0")
    penv = mocca_envs_tpu_torch.make("Walker3DTerrainEnv-v0", device="cpu")
    bank = tterrain.terrain_bank()
    js = jax.jit(jax.vmap(jenv.init))(jrng.env_keys(jrng.root_key(3), n))
    ps = penv.init(trng.generator(3, "cpu"), n)
    _check_on_surface(ps, torch.ones(n, dtype=torch.bool))
    flat = bank.reshape(len(bank), -1)
    for label, grids in (("jax", np.asarray(js.scene.hf_height)),
                         ("port", ps.scene.hf_height.numpy())):
        match = (grids.reshape(n, 1, -1) == flat[None]).all(axis=2)
        assert (match.sum(axis=1) == 1).all(), label          # exactly one bank grid each
        counts = np.bincount(match.argmax(axis=1), minlength=len(bank))
        # 64 expected per grid; a binomial's 5 standard deviations is ±39
        assert counts.min() > 25 and counts.max() < 103, (label, counts)
    jq, jt = np.array(js.q), np.array(js.task.target)
    pscene = _to_port(js).scene
    np.testing.assert_allclose(jq[:, 2] - hf_sample(pscene, torch.as_tensor(jq[:, :2])).numpy(),
                               SPAWN_DZ, atol=1e-4)
    np.testing.assert_allclose(jt[:, 2], hf_sample(pscene, torch.as_tensor(jt[:, :2])).numpy(),
                               atol=1e-4)


def test_terrain_kept_across_resets():
    """Every slot forced into a fresh episode keeps its grid: the same
    tensor, uncopied."""
    env = mocca_envs_tpu_torch.make("Walker3DTerrainEnv-v0", device="cpu")
    batch = mocca_envs_tpu_torch.BatchedEnv(env, 6, seed=2, device="cpu")
    state = batch.init()
    grids = state.scene.hf_height
    state = dataclasses.replace(state, steps=state.steps + 999)
    tr = batch.step(state, torch.zeros(6, env.act_dim))
    assert bool(tr.done.all()) and bool((tr.state.reset_count == 1).all())
    assert tr.state.scene.hf_height is grids
    _check_on_surface(tr.state, torch.ones(6, dtype=torch.bool))


def test_lidar_on_flat_ground_hits_at_the_analytic_parameter():
    """On flat terrain every ray hits within one march step past
    t = (z0 + 0.3) / sin 45°; a ray that never reaches the ground gives 1."""
    env = tterrain.make_walker3d_terrain(name="LidarFlat", amplitude=0.0, lidar=True,
                                         device="cpu")
    plain = mocca_envs_tpu_torch.make("Walker3DTerrainEnv-v0", device="cpu")
    assert env.obs_dim == plain.obs_dim + 8 and env.mirror["obs_perm"].shape == (env.obs_dim,)
    state = env.init(trng.generator(0, "cpu"), 4)
    rays = env.obs_fn(state)[:, -8:].numpy() * tterrain.LIDAR_MAX_T
    t_true = (state.q[:, 2].numpy() + 0.3) / np.sin(np.pi / 4)
    dt = tterrain.LIDAR_MAX_T / tterrain.LIDAR_STEPS
    np.testing.assert_allclose(rays, rays[:, :1].repeat(8, axis=1), atol=1e-6)
    assert ((t_true <= rays[:, 0]) & (rays[:, 0] <= t_true + dt + 1e-6)).all(), (rays, t_true)
    high = dataclasses.replace(state, q=state.q.clone())
    high.q[:, 2] += 2.0
    np.testing.assert_array_equal(env.obs_fn(high)[:, -8:].numpy(), 1.0)
