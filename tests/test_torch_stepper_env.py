"""PyTorch port vs the JAX package: the batched Walker3DStepperEnv (CPU).

Both packages get the same states (stones included) and actions each step:
the port is re-synced from the JAX state through numpy. ``done``,
``next_step`` and ``stone_hit`` must be equal on every step, rewards agree
to 1e-4 and observations to 1e-4 on the per-env median and 1e-3 on the max
(tests/test_torch_walker_env.py explains the two-level gate). Fresh episodes
come from different generators (threefry vs torch) and are compared in
distribution; the stage an env restarts at is deterministic and compared
exactly.
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
from mocca_envs_tpu.tasks import walker_stepper as jstepper
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.core import rng as trng
from mocca_envs_tpu_torch.tasks import walker_stepper as tstepper

from tests import torch_workers  # noqa: F401

B = 8
STEPS = 30
T = torch.as_tensor


@pytest.fixture(scope="module")
def envs():
    jenv = mocca_envs_tpu.make("Walker3DStepperEnv-v0")
    penv = mocca_envs_tpu_torch.make("Walker3DStepperEnv-v0", device="cpu")
    return jenv, penv, jax.jit(jax.vmap(jenv.step)), jax.jit(jax.vmap(jenv.init))


def _to_port(js):
    n = np.asarray
    t, sc = js.task, js.scene
    return convert.stepper_state_from_numpy(
        q=n(js.q), qd=n(js.qd), steps=n(js.steps), reset_count=n(js.reset_count),
        done=n(js.done), blowup_count=n(js.blowup_count), stone_top=n(t.stone_top),
        task_stone_quat=n(t.stone_quat), next_step=n(t.next_step), potential=n(t.potential),
        foot_potential=n(t.foot_potential), stage=n(t.stage), ground_z=n(sc.ground_z),
        friction=n(sc.friction), stone_pos=n(sc.stone_pos), stone_quat=n(sc.stone_quat),
        stone_half=n(sc.stone_half), stone_active=n(sc.stone_active),
    )


def _on_target(js, slots):
    """Drop the walker of each slot onto its target stone, a little short
    of its center (right over it the bearing to the target is ill-conditioned)."""
    tgt = js.task.stone_top[:, 1]
    q = js.q
    for b in slots:
        q = q.at[b, 0].set(tgt[b, 0] - 0.12).at[b, 1].set(tgt[b, 1]).at[b, 2].set(tgt[b, 2] + 0.95)
    return js.replace(q=q)


def _check_fresh(penv, state, mask, want_stage):
    """Fresh episodes in the ``mask`` slots: the reset's support and the
    chain's fixed start."""
    q = state.q[mask]
    assert torch.allclose(q[:, :7], torch.tensor([0, 0, 0.96, 1, 0, 0, 0.0]).expand_as(q[:, :7]))
    assert bool((q[:, 7:].abs() <= 0.1 + 1e-6).all())
    assert bool((state.qd[mask] == 0).all()) and bool((state.steps[mask] == 0).all())
    task = state.task
    assert bool((task.next_step[mask] == 1).all())
    np.testing.assert_array_equal(task.stage[mask].numpy(), want_stage)
    top = task.stone_top[mask]
    assert bool((top[:, 0] == 0).all())                       # stone 0 under the start
    np.testing.assert_allclose(top[:, 1, 1:].numpy(), 0.0, atol=1e-6)   # straight, level
    dist = torch.linalg.vector_norm(top[:, 1, :2], dim=1)
    torch.testing.assert_close(task.potential[mask], -dist / penv.control_dt)
    sc = state.scene
    assert bool((sc.ground_z[mask] == -20.0).all()) and bool((sc.stone_active[mask] == 1).all())
    # the boxes hang half_z below their tops along the stones' own z
    torch.testing.assert_close(sc.stone_pos[mask][:, 0], T([0.0, 0.0, -0.5]).expand(len(q), 3))


def test_env_matches_jax_step_by_step(envs):
    jenv, penv, jstep, jinit = envs
    assert (penv.obs_dim, penv.act_dim) == (jenv.obs_dim, jenv.act_dim) == (62, 21)
    js = _on_target(jinit(jrng.env_keys(jrng.root_key(0), B)), (0, 1))
    js = js.replace(steps=js.steps.at[2].set(996))            # runs into the step cap
    gen = trng.generator(0, "cpu")
    rng = np.random.default_rng(0)
    resets = hits = 0
    for t in range(STEPS):
        a = rng.uniform(-1, 1, (B, jenv.act_dim)).astype(np.float32)
        a[:2] = 0.0                                           # the dropped walkers stand
        ps = _to_port(js)
        jtr = jstep(js, jnp.asarray(a))
        ptr = penv.step(ps, T(a), gen)
        jdone = np.array(jtr.done)
        np.testing.assert_array_equal(ptr.done.numpy(), jdone, err_msg=f"step {t}")
        for key in ("stone_hit", "success", "fallen", "curriculum_stage"):
            np.testing.assert_array_equal(ptr.metrics[key].numpy(), np.asarray(jtr.metrics[key]),
                                          err_msg=f"{key} step {t}")
        np.testing.assert_array_equal(ptr.metrics["steps_reached"].numpy(),
                                      np.asarray(jtr.metrics["steps_reached"]))
        np.testing.assert_allclose(ptr.reward.numpy(), np.asarray(jtr.reward), atol=1e-4,
                                   err_msg=f"step {t}")
        live = ~jdone
        np.testing.assert_array_equal(ptr.state.task.next_step.numpy()[live],
                                      np.asarray(jtr.state.task.next_step)[live])
        for key in ("potential", "foot_potential"):
            np.testing.assert_allclose(getattr(ptr.state.task, key).numpy()[live],
                                       np.asarray(getattr(jtr.state.task, key))[live], atol=2e-3)
        per_env = np.abs(ptr.obs.numpy() - np.asarray(jtr.obs))[live].max(axis=1)
        assert np.median(per_env) <= 1e-4 and per_env.max() <= 1e-3, (t, per_env)
        if jdone.any():
            _check_fresh(penv, ptr.state, T(jdone), np.asarray(jtr.state.task.stage)[jdone])
            fresh_obs = ptr.obs.numpy()[jdone]
            np.testing.assert_allclose(fresh_obs[:, 50:52], 0.0)     # zero foot flags
            np.testing.assert_allclose(fresh_obs[:, 0], 0.02, atol=1e-6)
            np.testing.assert_allclose(fresh_obs[:, -4:], 0.0, atol=1e-6)   # flat first stones
            resets += int(jdone.sum())
        hits += int(np.asarray(jtr.metrics["stone_hit"]).sum())
        js = jtr.state
    assert hits >= 1, "the step-advance machine should fire for a walker dropped on its target"
    assert resets >= 3, "the horizon should see several auto-resets"


def test_stage_advances_at_auto_reset(envs):
    """An env that ends an episode at or past adv_threshold stones restarts
    one stage higher, capped at the last stage; the others keep theirs."""
    jenv, penv, jstep, jinit = envs
    js = jinit(jrng.env_keys(jrng.root_key(2), B))
    next_step = jnp.asarray([18, 19, 17, 18, 1, 18, 5, 19], jnp.int32)
    stage = jnp.asarray([0, 3, 4, 9, 2, 8.5, 0, 0], jnp.float32)
    js = js.replace(task=js.task.replace(next_step=next_step, stage=stage),
                    steps=js.steps.at[:].set(999))
    a = np.zeros((B, jenv.act_dim), np.float32)
    jtr = jstep(js, jnp.asarray(a))
    ptr = penv.step(_to_port(js), T(a), trng.generator(1, "cpu"))
    assert bool(ptr.done.all()) and bool(np.asarray(jtr.done).all())
    want = np.asarray(jtr.state.task.stage)
    np.testing.assert_array_equal(want, [1, 4, 4, 9, 2, 9, 0, 1])
    _check_fresh(penv, ptr.state, ptr.done, want)
    # the new chains come from the new stages: stage 9 pitches its stones,
    # stages 0 and 1 barely
    z_spread = ptr.state.task.stone_top[..., 2].std(dim=1).numpy()
    assert z_spread[3] > 0.05 and z_spread[5] > 0.05 and z_spread[6] < 1e-5


def test_set_stage(envs):
    jenv, penv, jstep, jinit = envs
    js = jinit(jrng.env_keys(jrng.root_key(3), B))
    ps = _to_port(js)
    per_env = np.arange(B, dtype=np.float32)
    for stage in (9, 4.5, per_env):
        got = tstepper.set_stage(ps, stage)
        want = jstepper.set_stage(js, stage)
        np.testing.assert_array_equal(got.task.stage.numpy(), np.asarray(want.task.stage))
        # nothing else moves until the next reset
        torch.testing.assert_close(got.task.stone_top, ps.task.stone_top, atol=0, rtol=0)
    assert float(ps.task.stage.abs().max()) == 0.0            # the input state is untouched
    # it takes effect at each env's next reset
    staged = dataclasses.replace(tstepper.set_stage(ps, per_env), steps=ps.steps + 999)
    tr = penv.step(staged, torch.zeros(B, penv.act_dim), trng.generator(2, "cpu"))
    assert bool(tr.done.all())
    np.testing.assert_array_equal(tr.state.task.stage.numpy(), per_env)
    z_spread = tr.state.task.stone_top[..., 2].std(dim=1)
    assert float(z_spread[0]) < 1e-5 and float(z_spread[-1]) > float(z_spread[1])


@pytest.mark.parametrize("stage", [0.0, 9.0])
def test_reset_distribution_matches_jax(stage):
    """Fresh episodes at a fixed stage: joint noise and the chain's
    increments have the same moments under both generators."""
    n = 2048
    jenv = jstepper.make_walker3d_stepper(
        params=jstepper.StepperParams.default().set_curriculum(stage), name=f"JStepper{stage}")
    penv = tstepper.make_walker3d_stepper(
        params=tstepper.StepperParams.default().set_curriculum(stage), device="cpu")
    js = jax.jit(jax.vmap(jenv.init))(jrng.env_keys(jrng.root_key(5), n))
    ps = penv.init(trng.generator(5, "cpu"), n)
    stats = []
    for qj, top, quat, st in (
        (np.asarray(js.q)[:, 7:], np.asarray(js.task.stone_top), np.asarray(js.task.stone_quat),
         np.asarray(js.task.stage)),
        (ps.q[:, 7:].numpy(), ps.task.stone_top.numpy(), ps.task.stone_quat.numpy(),
         ps.task.stage.numpy()),
    ):
        assert (st == stage).all() and top.shape == (n, 20, 3)
        assert (np.abs(qj) <= 0.1 + 1e-6).all()
        step = np.diff(top, axis=1)[:, 1:]                    # the sampled increments
        r = np.linalg.norm(step, axis=2)
        pitch = np.arcsin(step[..., 2] / r)
        tilt = 2 * np.arcsin(np.abs(quat[:, 2:, 1]))          # ~|tilt about x| for small angles
        stats.append([r.mean(), r.std(), r.min(), r.max(), pitch.std(), np.abs(pitch).max(),
                      tilt.mean(), top[:, -1, 0].mean(), top[:, -1, 1].std()])
    j, p = np.array(stats)
    np.testing.assert_allclose(p, j, rtol=0.05, atol=0.02)
    lo, hi = (0.35, 0.45) if stage == 0.0 else (0.65, 1.35)
    assert lo - 1e-5 <= p[2] and p[3] <= hi + 1e-5
    assert (p[5] < 1e-3) if stage == 0.0 else (0.8 < p[5] <= np.deg2rad(50) + 1e-4)


def test_obs_modes_mirror_and_params_seam(envs):
    jenv, penv, _, jinit = envs
    js = jinit(jrng.env_keys(jrng.root_key(7), 6))
    js = _on_target(js, (0, 1, 2))
    js = js.replace(q=js.q.at[:3, 2].add(-0.06))              # feet into the target stone
    ps = _to_port(js)
    want = np.asarray(jax.jit(jax.vmap(jenv.obs_fn))(js))
    got = penv.obs_fn(ps).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got[:3, 50:52].sum() > 0 and got[3:, 50:52].sum() == 0
    # reset_obs="zero" is the exact predicate on the airborne spawn pose
    np.testing.assert_allclose(penv.reset_obs_fn(ps).numpy()[3:], got[3:], atol=0)
    exact = tstepper.make_walker3d_stepper(device="cpu", reset_obs="exact")
    assert exact.reset_obs_fn is None
    with pytest.raises(ValueError, match="reset_obs"):
        tstepper.make_walker3d_stepper(device="cpu", reset_obs="none")
    blind = tstepper.make_walker3d_stepper(device="cpu", orient_obs=False)
    assert blind.obs_dim == penv.obs_dim - 4
    np.testing.assert_allclose(blind.obs_fn(ps).numpy(), got[:, :-4], atol=0)
    for key in ("obs_perm", "obs_sign", "act_perm", "act_sign"):
        np.testing.assert_array_equal(penv.mirror[key].numpy(), np.asarray(jenv.mirror[key]))
    # the state and the parameters cross the numpy seam both ways
    back = convert.stepper_state_from_numpy(**convert.stepper_state_to_numpy(ps))
    for a, b in zip(convert.stepper_state_to_numpy(back).values(),
                    convert.stepper_state_to_numpy(ps).values()):
        np.testing.assert_array_equal(a, b)
    jp = jstepper.StepperParams.default()
    as_np = lambda x: {f.name: np.asarray(getattr(x, f.name))  # noqa: E731
                       for f in dataclasses.fields(x)}
    fields = {**as_np(jp), "walker": as_np(jp.walker), "stones": as_np(jp.stones)}
    got_p, want_p = convert.stepper_params_from_numpy(fields), tstepper.StepperParams.default()
    for g, w in ((got_p.walker, want_p.walker), (got_p.stones, want_p.stones),
                 (dataclasses.replace(got_p, walker=None, stones=None),
                  dataclasses.replace(want_p, walker=None, stones=None))):
        assert dataclasses.asdict(g) == pytest.approx(dataclasses.asdict(w), rel=1e-6)
