"""PyTorch port vs the JAX package: the batched Walker3DCustomEnv (CPU).

Both packages get the same states and actions each step (the port is
re-synced from the JAX state through numpy), with targets placed out of
reach so that no random target resample happens. Rewards must agree to
1e-4 and done flags exactly, so auto-reset fires on the same steps.
Observations must agree to 1e-4 on the per-env median and 1e-3 on the max:
the joint-velocity terms inherit the contact solver's fp-order noise on
light links, gated the same way as the physics (tests/test_torch_physics.py). The fresh episodes themselves come from different generators
(threefry vs torch) and are compared in distribution.
"""

import math

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

from tests import torch_workers  # noqa: F401

B = 8
STEPS = 30
AHEAD = 3.0  # target [m] ahead of the start: out of reach within the horizon


@pytest.fixture(scope="module")
def envs():
    return (mocca_envs_tpu.make("Walker3DCustomEnv-v0"),
            mocca_envs_tpu_torch.make("Walker3DCustomEnv-v0", device="cpu"))


def _targets_ahead(jenv, state):
    # near enough that the potential (−dist/control_dt) keeps f32 precision
    target = state.q[:, :3].at[:, 0].add(AHEAD).at[:, 2].set(0.0)
    dist = jnp.linalg.norm(target[:, :2] - state.q[:, :2], axis=1)
    return state.replace(task=state.task.replace(
        target=target, potential=-dist / jenv.control_dt))


def _to_port(js):
    n = np.asarray
    return convert.env_state_from_numpy(
        q=n(js.q), qd=n(js.qd), steps=n(js.steps), reset_count=n(js.reset_count),
        done=n(js.done), blowup_count=n(js.blowup_count), target=n(js.task.target),
        potential=n(js.task.potential), ground_z=n(js.scene.ground_z),
        friction=n(js.scene.friction),
    )


def _check_fresh(penv, state, prev_count, mask):
    """Fresh episodes in the ``mask`` slots: the reset distribution's support."""
    model = penv.model
    q = state.q[mask]
    assert torch.allclose(q[:, :7], torch.tensor([0, 0, 0.96, 1, 0, 0, 0.0]).expand_as(q[:, :7]))
    qj = q[:, 7:]
    assert bool((qj.abs() <= 0.1 + 1e-6).all())
    assert bool(((qj >= model.limit_lo) & (qj <= model.limit_hi)).all())
    assert bool((state.qd[mask] == 0).all()) and bool((state.steps[mask] == 0).all())
    assert bool((state.reset_count[mask] == prev_count[mask] + 1).all())
    dist = torch.linalg.vector_norm(state.task.target[mask, :2], dim=1)
    assert bool(((dist >= 3.0) & (dist < 7.0)).all())
    torch.testing.assert_close(state.task.potential[mask], -dist / penv.control_dt)


def test_env_matches_jax_step_by_step(envs):
    jenv, penv = envs
    keys = jrng.env_keys(jrng.root_key(0), B)
    js = _targets_ahead(jenv, jax.jit(jax.vmap(jenv.init))(keys))
    jstep = jax.jit(jax.vmap(jenv.step))
    gen = trng.generator(0, "cpu")
    rng = np.random.default_rng(0)
    resets = 0
    for t in range(STEPS):
        a = rng.uniform(-1, 1, (B, jenv.act_dim)).astype(np.float32)
        ps = _to_port(js)
        jtr = jstep(js, jnp.asarray(a))
        ptr = penv.step(ps, torch.as_tensor(a), gen)
        jdone = np.array(jtr.done)
        np.testing.assert_array_equal(ptr.done.numpy(), jdone, err_msg=f"step {t}")
        np.testing.assert_allclose(ptr.reward.numpy(), np.asarray(jtr.reward), atol=1e-4,
                                   err_msg=f"step {t}")
        live = ~jdone
        per_env = np.abs(ptr.obs.numpy() - np.asarray(jtr.obs))[live].max(axis=1)
        assert np.median(per_env) <= 1e-4 and per_env.max() <= 1e-3, (t, per_env)
        if jdone.any():
            _check_fresh(penv, ptr.state, ps.reset_count, torch.as_tensor(jdone))
            # frame-0 obs of a fresh episode: zero foot flags, Δz = 0.02
            fresh_obs = ptr.obs.numpy()[jdone]
            np.testing.assert_allclose(fresh_obs[:, -2:], 0.0)
            np.testing.assert_allclose(fresh_obs[:, 0], 0.02, atol=1e-6)
            resets += int(jdone.sum())
        assert not np.asarray(jtr.metrics["reached_target"]).any()
        js = jtr.state
    assert resets >= 3, "the horizon should see several auto-resets"


def test_reset_distribution_matches_jax(envs):
    """Fresh episodes: joint noise U(−0.1, 0.1) clipped to the limits,
    target distance U[3, 7), bearing U(−π/2, π/2) — same moments as the
    JAX package's threefry draws."""
    jenv, penv = envs
    n = 4096
    js = jax.jit(jax.vmap(jenv.init))(jrng.env_keys(jrng.root_key(3), n))
    ps = penv.init(trng.generator(3, "cpu"), n)
    for state, qj, tgt in (
        ("jax", np.asarray(js.q)[:, 7:], np.asarray(js.task.target)),
        ("port", ps.q[:, 7:].numpy(), ps.task.target.numpy()),
    ):
        lo = penv.model.limit_lo.numpy()
        hi = penv.model.limit_hi.numpy()
        assert (np.abs(qj) <= 0.1 + 1e-6).all() and (qj >= lo).all() and (qj <= hi).all(), state
        dist = np.linalg.norm(tgt[:, :2], axis=1)
        bearing = np.arctan2(tgt[:, 1], tgt[:, 0])
        assert (dist >= 3.0).all() and (dist < 7.0).all(), state
        assert np.abs(bearing).max() <= math.pi / 2 + 1e-5, state
        # moments of U(3, 7) and U(−π/2, π/2) with n = 4096 (≈5 standard errors)
        assert abs(dist.mean() - 5.0) < 0.1 and abs(dist.std() - 4 / math.sqrt(12)) < 0.05, state
        assert abs(bearing.mean()) < 0.08, state
        # unclipped joints: U(−0.1, 0.1) has mean 0 and std 0.0577
        free = (lo < -0.1) & (hi > 0.1)
        assert abs(qj[:, free].mean()) < 0.002 and abs(qj[:, free].std() - 0.1 / math.sqrt(3)) < 0.002
    # clipped joint (knees: hi = −0.03): both pile P(U > −0.03) = 0.65 at the bound
    knee = penv.model.joint_names.index("right_knee")
    j_at = np.mean(np.asarray(js.q)[:, 7 + knee] == np.float32(-0.03))
    p_at = float((ps.q[:, 7 + knee] == np.float32(-0.03)).float().mean())
    assert abs(j_at - 0.65) < 0.05 and abs(p_at - 0.65) < 0.05, (j_at, p_at)


def test_exact_obs_and_state_roundtrip(envs):
    """``obs_fn`` (exact frame-0 foot flags from the narrowphase) agrees with
    the JAX package's on the same states; the numpy seam round-trips."""
    jenv, penv = envs
    js = jax.jit(jax.vmap(jenv.init))(jrng.env_keys(jrng.root_key(5), 6))
    q = np.array(js.q)
    q[:3, 2] = 0.9          # half the slots with the feet in the ground
    js = js.replace(q=jnp.asarray(q))
    ps = _to_port(js)
    want = np.asarray(jax.jit(jax.vmap(jenv.obs_fn))(js))
    got = penv.obs_fn(ps).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got[:3, -2:].sum() > 0 and got[3:, -2:].sum() == 0
    back = convert.env_state_from_numpy(**convert.env_state_to_numpy(ps))
    for a, b in zip(convert.env_state_to_numpy(back).values(),
                    convert.env_state_to_numpy(ps).values()):
        np.testing.assert_array_equal(a, b)


def test_batched_env_seeding():
    """Same seed ⇒ same episodes; different seeds ⇒ different targets."""
    env = mocca_envs_tpu_torch.make("Walker3DCustomEnv-v0", device="cpu")
    a = torch.zeros(4, env.act_dim)

    def first(seed):
        batch = mocca_envs_tpu_torch.BatchedEnv(env, 4, seed=seed, device="cpu")
        tr = batch.step(batch.init(), a)
        return tr.obs, tr.state.task.target

    o1, t1 = first(7)
    o2, t2 = first(7)
    _, t3 = first(8)
    torch.testing.assert_close(o1, o2, atol=0, rtol=0)
    torch.testing.assert_close(t1, t2, atol=0, rtol=0)
    assert not torch.allclose(t1, t3)
    assert not torch.allclose(t1[0], t1[1])   # slots are independent
    assert env.obs_dim == 52 and env.act_dim == 21
