"""PyTorch port vs the JAX package: the Cassie families, batched (CPU).

``CassieEnv``, ``Cassie2DEnv`` and ``CassiePhaseEnv`` step by step from
shared states and actions, the port re-synced from the JAX states through
numpy each step: done flags equal, rewards within 1e-3, observations within
3e-3 on the per-env median and 5e-3 for every env but at most one per step,
which stays within 5e-2 (they carry 0.1·q̇ and joint angles scaled by up to
3; the spawn drops 1 cm onto its feet in the first step and rests at depth
≈ 0 in the next, where a contact may switch between the two roundings:
measured 1e-4 to 2.4e-3, and 2.8e-2 for the one env whose foot flag flips),
at most one foot flag apart per step, ``phase`` and ``prev_action`` equal,
the metrics within 2e-2; auto-reset fires on the same steps (one slot
runs into the step cap, one starts below the fall height) and a fresh
episode has the spawn height, zeroed counters and joints within the noise
band of the stand pose. The JAX side steps one env per call (the unit runs
slower per env under ``vmap`` on the CPU backend), the calls side by side on
threads.

Port only: ``obs_dim`` is 8 + 2·16 + 2 (+ 2 with the phase clock);
``reset_obs="zero"`` and ``"exact"`` give the same step but for the foot
flags of a fresh episode's observation; resets are reproducible from the
seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mocca_envs_tpu
import mocca_envs_tpu_torch
from mocca_envs_tpu.tasks.cassie_task import CassieParams as JParams
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.core import rng as trng
from mocca_envs_tpu_torch.models import cassie as tcassie
from mocca_envs_tpu_torch.tasks.cassie_task import CassieParams, make_cassie

from tests import torch_workers  # noqa: F401
from tests.test_torch_cassie_step import run_per_env


def _stack(states, get):
    return np.stack([np.asarray(get(s)) for s in states])


def states_to_port(states):
    """A list of unbatched JAX EnvStates → one batched port EnvState."""
    return convert.cassie_state_from_numpy(
        q=_stack(states, lambda s: s.q), qd=_stack(states, lambda s: s.qd),
        steps=_stack(states, lambda s: s.steps),
        reset_count=_stack(states, lambda s: s.reset_count),
        done=_stack(states, lambda s: s.done),
        blowup_count=_stack(states, lambda s: s.blowup_count),
        prev_action=_stack(states, lambda s: s.task.prev_action),
        phase=_stack(states, lambda s: s.task.phase),
        ground_z=_stack(states, lambda s: s.scene.ground_z),
        friction=_stack(states, lambda s: s.scene.friction))


# (family, slots, steps): the JAX side costs ~3 s per env and step here
FAMILIES = [("CassieEnv", 4, 3), ("Cassie2DEnv", 3, 2), ("CassiePhaseEnv", 3, 2)]


@pytest.mark.parametrize("env_id, slots, steps", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_cassie_env_matches_jax_step_by_step(env_id, slots, steps):
    jenv = mocca_envs_tpu.make(env_id + "-v0")
    penv = mocca_envs_tpu_torch.make(env_id + "-v0", device="cpu")
    assert (penv.obs_dim, penv.act_dim, penv.name) == (jenv.obs_dim, jenv.act_dim, jenv.name)
    assert penv.control_dt == pytest.approx(jenv.control_dt) == pytest.approx(1 / 30)
    stand_z = tcassie.initial_z() + 0.01
    stand = tcassie.stand_q(penv.model)
    js = [jenv.init(jax.random.key(10 + i)) for i in range(slots)]
    # slot 1 runs into the step cap on the second step, slot 2 starts under
    # the fall height (0.65 m) and is done on the first
    js[1] = js[1].replace(steps=jnp.asarray(998, jnp.int32),
                          task=js[1].task.replace(phase=jnp.asarray(38.0)))
    js[2] = js[2].replace(q=js[2].q.at[2].set(0.6))
    jstep = jax.jit(jenv.step).lower(js[0], jnp.zeros(jenv.act_dim, jnp.float32)).compile()
    gen = trng.generator(0, "cpu")
    rng = np.random.default_rng(2)
    resets = 0
    for t in range(steps):
        a = rng.uniform(-0.1, 0.1, (slots, jenv.act_dim)).astype(np.float32)
        a[0, :2] = (1.5, -1.2)     # beyond the ±1 clip of the targets
        ps = states_to_port(js)
        jtrs = run_per_env(jstep, js, jnp.asarray(a))
        ptr = penv.step(ps, torch.as_tensor(a), gen)
        jdone = _stack(jtrs, lambda tr: tr.done)
        np.testing.assert_array_equal(ptr.done.numpy(), jdone, err_msg=f"step {t}")
        np.testing.assert_allclose(ptr.reward.numpy(), _stack(jtrs, lambda tr: tr.reward),
                                   atol=1e-3, err_msg=f"step {t}")
        assert set(ptr.metrics) == set(jtrs[0].metrics)
        for name, value in ptr.metrics.items():
            np.testing.assert_allclose(value.numpy(), _stack(jtrs, lambda tr: tr.metrics[name]),
                                       atol=2e-2, err_msg=f"step {t} {name}")
        live = ~jdone
        diff = np.abs(ptr.obs.numpy() - _stack(jtrs, lambda tr: tr.obs))[live]
        flags = slice(40, 42)       # 0 / 1: a foot resting at depth ≈ 0 may flip one
        assert (diff[:, flags] > 0.5).sum() <= 1, (t, diff[:, flags])
        diff[:, flags] = 0.0
        per_env = np.sort(diff.max(axis=1))
        assert np.median(per_env) <= 3e-3 and per_env[-1] <= 5e-2, (t, per_env)
        assert (per_env[:-1] <= 5e-3).all(), (t, per_env)
        want_state = states_to_port([tr.state for tr in jtrs])
        got = ptr.state
        np.testing.assert_allclose(got.task.phase.numpy()[live],
                                   want_state.task.phase.numpy()[live], atol=1e-6)
        np.testing.assert_allclose(got.task.prev_action.numpy()[live],
                                   want_state.task.prev_action.numpy()[live], atol=0)
        np.testing.assert_array_equal(got.steps.numpy()[live], want_state.steps.numpy()[live])
        if jdone.any():
            fresh_q = got.q.numpy()[jdone]
            np.testing.assert_allclose(fresh_q[:, 2], stand_z, atol=1e-6)
            np.testing.assert_allclose(want_state.q.numpy()[jdone][:, 2], stand_z, atol=1e-6)
            assert (np.abs(fresh_q[:, 7:] - stand) <= 0.02 + 1e-6).all()
            assert (got.steps.numpy()[jdone] == 0).all()
            assert (got.task.phase.numpy()[jdone] == 0).all()
            assert (got.task.prev_action.numpy()[jdone] == 0).all()
            assert (got.reset_count.numpy()[jdone] == ps.reset_count.numpy()[jdone] + 1).all()
            np.testing.assert_array_equal(got.reset_count.numpy(),
                                          want_state.reset_count.numpy())
            # a fresh observation: no foot flags, the clock at phase 0
            fresh_obs = ptr.obs.numpy()[jdone]
            assert (fresh_obs[:, 40:42] == 0).all()
            if penv.obs_dim == 44:
                np.testing.assert_allclose(fresh_obs[:, 42:], [[0.0, 1.0]] * len(fresh_obs),
                                           atol=1e-6)
            resets += int(jdone.sum())
        js = [tr.state for tr in jtrs]
    assert resets >= 2, "the horizon should see the fall and the step cap"


@pytest.mark.parametrize("env_id, obs_dim", [
    ("CassieEnv", 42), ("Cassie2DEnv", 42), ("CassiePhaseEnv", 44), ("CassiePhase2DEnv", 44)])
def test_cassie_family_shapes_and_seeded_resets(env_id, obs_dim):
    env = mocca_envs_tpu_torch.make(env_id + "-v0", device="cpu")
    assert (env.obs_dim, env.act_dim, env.name) == (obs_dim, 10, env_id)
    assert obs_dim == 8 + 2 * env.model.nj + 2 + (2 if "Phase" in env_id else 0)
    a, b = (mocca_envs_tpu_torch.BatchedEnv(env, 64, seed=5, device="cpu").init()
            for _ in range(2))
    assert torch.equal(a.q, b.q)
    # joint noise: uniform in ±init_noise around the stand pose
    dev = (a.q[:, 7:] - torch.as_tensor(tcassie.stand_q(env.model), dtype=torch.float32)).numpy()
    assert np.abs(dev).max() <= 0.02 + 1e-6 and np.abs(dev).max() > 0.015
    assert abs(dev.mean()) < 2e-3 and 0.009 < dev.std() < 0.014     # 0.02 / √3 = 0.0115
    assert torch.all(a.q[:, 2] == a.q[0, 2]) and bool((a.qd == 0).all())
    other = mocca_envs_tpu_torch.BatchedEnv(env, 64, seed=6, device="cpu").init()
    assert not torch.equal(a.q, other.q)


def test_params_cross_the_seam_and_defaults_match():
    jp = JParams.default()
    fields = {f.name: np.asarray(getattr(jp, f.name)) for f in dataclasses.fields(jp)}
    assert dataclasses.asdict(convert.cassie_params_from_numpy(fields)) == pytest.approx(
        dataclasses.asdict(CassieParams.default()), rel=1e-6)
    state = mocca_envs_tpu_torch.BatchedEnv(
        mocca_envs_tpu_torch.make("CassieEnv", device="cpu"), 3, device="cpu").init()
    back = convert.cassie_state_from_numpy(**convert.cassie_state_to_numpy(state))
    assert torch.equal(back.q, state.q) and torch.equal(back.task.phase, state.task.phase)
    assert back.task.prev_action.shape == (3, 10)


def test_reset_obs_zero_equals_exact_but_for_the_foot_flags():
    """The two modes run the same step; they differ only in the foot flags
    of a fresh episode's observation, which "exact" takes from the
    narrowphase (a spawn is 1 cm above the ground, so there they agree) and
    "zero" sets to 0 (which differs once the feet are pressed down)."""
    zero = make_cassie(device="cpu", reset_obs="zero")
    exact = make_cassie(device="cpu", reset_obs="exact")
    with pytest.raises(ValueError, match="reset_obs"):
        make_cassie(device="cpu", reset_obs="nearest")
    assert zero.reset_obs_fn is not None and exact.reset_obs_fn is None
    state = zero.init(trng.generator(1, "cpu"), 4)
    state.q[1, 2] = 0.5                       # a fallen slot: done at once
    actions = torch.zeros(4, 10)
    tz = zero.step(state, actions, trng.generator(2, "cpu"))
    te = exact.step(state, actions, trng.generator(2, "cpu"))
    assert bool(tz.done[1]) and not bool(tz.done[0])
    assert torch.equal(tz.obs, te.obs) and torch.equal(tz.state.q, te.state.q)
    # pressed 1 cm into the ground, the exact flags are set
    low = dataclasses.replace(tz.state, q=tz.state.q.clone())
    low.q[:, 2] = tcassie.initial_z() - 0.01
    low.q[:, 7:] = torch.as_tensor(tcassie.stand_q(zero.model), dtype=torch.float32)
    oz, oe = zero.reset_obs_fn(low), exact.obs_fn(low)
    assert torch.equal(oz[:, :40], oe[:, :40])
    assert bool((oz[:, 40:] == 0).all()) and bool((oe[:, 40:] == 1).all())
