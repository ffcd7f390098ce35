"""PyTorch port vs the JAX package: the batched Monkey3DStepperEnv (CPU).

Both packages get the same states (bars and grab state included) and the
same actions, grab signals included, each step: the port is re-synced from
the JAX state through numpy. ``done``, the grab state (``attached``,
``hold_bar``, ``next_bar``) and the discrete metrics must be equal on every
step, rewards agree to 1e-4 and observations to 1e-4 on the per-env median
and 1e-3 on the max (tests/test_torch_walker_env.py explains the two-level
gate). Fresh episodes come from different generators (threefry vs torch):
their deterministic part (the hang solved onto bar 0, the grab state, the
stage) is compared exactly or to 1e-5. The hang test is in
tests/test_torch_monkey_step.py.
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
from mocca_envs_tpu.ops import kinematics as jkin
from mocca_envs_tpu.tasks import monkey_stepper as jtask
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.core import rng as trng
from mocca_envs_tpu_torch.models import monkey as tmonkey
from mocca_envs_tpu_torch.tasks import monkey_stepper as ttask

from tests import torch_workers  # noqa: F401

B = 8
STEPS = 30
T = torch.as_tensor


@pytest.fixture(scope="module")
def envs():
    jenv = mocca_envs_tpu.make("Monkey3DStepperEnv-v0")
    penv = mocca_envs_tpu_torch.make("Monkey3DStepperEnv-v0", device="cpu")
    return jenv, penv, jax.jit(jax.vmap(jenv.step)), jax.jit(jax.vmap(jenv.init))


def _to_port(js):
    n = np.asarray
    task = {f.name: n(getattr(js.task, f.name)) for f in dataclasses.fields(js.task)}
    sc = js.scene
    return convert.monkey_state_from_numpy(
        q=n(js.q), qd=n(js.qd), steps=n(js.steps), reset_count=n(js.reset_count),
        done=n(js.done), blowup_count=n(js.blowup_count), **task, ground_z=n(sc.ground_z),
        friction=n(sc.friction), bar_a=n(sc.bar_a), bar_b=n(sc.bar_b), bar_r=n(sc.bar_r),
        bar_active=n(sc.bar_active))


def _left_palms(js):
    jm = mocca_envs_tpu.models.monkey.make_model()
    link = jm.link_names.index("left_elbow")

    def one(q):
        fd = jkin.forward_kinematics(jm, q, jnp.zeros(jm.nv))
        return fd.pos[link] + fd.rot[link] @ jnp.asarray(tmonkey.PALM_OFFSET)

    return np.asarray(jax.jit(jax.vmap(one))(js.q))


def _staged(js):
    """Slots 0, 1: the target bar moved through the left palm (a grab there
    hits it); slot 2 runs into the step cap; slot 3 lets go, low enough to
    fall out of the episode."""
    palm = _left_palms(js)
    pos, axis = np.array(js.task.bar_pos), np.array(js.task.bar_dir)
    pos[:2, 1] = palm[:2] + np.array([0.0, 0.0, 0.01])
    ext = tmonkey.BAR_HALF_LEN * axis
    q, attached = np.array(js.q), np.array(js.task.attached)
    q[3, 2] = -1.7
    attached[3] = 0.0
    return js.replace(
        q=jnp.asarray(q), steps=js.steps.at[2].set(996),
        task=js.task.replace(bar_pos=jnp.asarray(pos), attached=jnp.asarray(attached)),
        scene=js.scene.replace(bar_a=jnp.asarray(pos - ext), bar_b=jnp.asarray(pos + ext)))


def _check_fresh(state, mask, want_stage):
    """Fresh episodes in the ``mask`` slots: hanging by the right hand from
    bar 0, at rest, the target bar 1."""
    model = tmonkey.make_model()
    task = state.task
    np.testing.assert_array_equal(task.stage[mask].numpy(), want_stage)
    assert bool((task.next_bar[mask] == 1).all()) and bool((state.steps[mask] == 0).all())
    n = len(want_stage)
    np.testing.assert_array_equal(task.attached[mask].numpy(), np.tile([1.0, 0.0], (n, 1)))
    np.testing.assert_array_equal(task.hold_bar[mask].numpy(), np.tile([0, -1], (n, 1)))
    assert bool((state.qd[mask] == 0).all())
    palm = ttask.make_palm_positions(model, tmonkey.constraints())(state.q[mask])[:, 0]
    np.testing.assert_allclose(palm.numpy(), task.anchor[mask][:, 0].numpy(), atol=1e-5)
    on_bar = ttask.closest_on_bar(task.bar_pos[mask][:, 0], task.bar_dir[mask][:, 0], palm)
    np.testing.assert_allclose(on_bar.numpy(), palm.numpy(), atol=1e-5)
    assert bool((state.scene.ground_z[mask] == -8.0).all())


def test_env_matches_jax_step_by_step(envs):
    jenv, penv, jstep, jinit = envs
    assert (penv.obs_dim, penv.act_dim) == (jenv.obs_dim, jenv.act_dim) == (36, 12)
    js = _staged(jinit(jrng.env_keys(jrng.root_key(0), B)))
    gen = trng.generator(0, "cpu")
    rng = np.random.default_rng(0)
    resets = hits = grabs = releases = 0
    for t in range(STEPS):
        a = rng.uniform(-1, 1, (B, jenv.act_dim)).astype(np.float32)
        a[:2, -2:] = [1.0, 1.0]                     # slots 0, 1 hold and grab the target
        a[3, -2:] = -1.0                            # slot 3 stays free
        ps = _to_port(js)
        jtr = jstep(js, jnp.asarray(a))
        ptr = penv.step(ps, T(a), gen)
        jdone = np.array(jtr.done)
        np.testing.assert_array_equal(ptr.done.numpy(), jdone, err_msg=f"step {t}")
        for key in ("bar_hit", "success", "fell", "bars_reached", "holding", "blowup"):
            np.testing.assert_array_equal(ptr.metrics[key].numpy(), np.asarray(jtr.metrics[key]),
                                          err_msg=f"{key} step {t}")
        np.testing.assert_allclose(ptr.reward.numpy(), np.asarray(jtr.reward), atol=1e-4,
                                   err_msg=f"step {t}")
        live = ~jdone
        pt, jt = ptr.state.task, jtr.state.task
        for key in ("next_bar", "attached", "hold_bar", "since_hit"):
            np.testing.assert_array_equal(getattr(pt, key).numpy()[live],
                                          np.asarray(getattr(jt, key))[live], err_msg=key)
        np.testing.assert_allclose(pt.anchor.numpy()[live], np.asarray(jt.anchor)[live],
                                   atol=1e-5)
        np.testing.assert_allclose(pt.potential.numpy()[live], np.asarray(jt.potential)[live],
                                   atol=2e-3)
        per_env = np.abs(ptr.obs.numpy() - np.asarray(jtr.obs))[live].max(axis=1)
        assert np.median(per_env) <= 1e-4 and per_env.max() <= 1e-3, (t, per_env)
        if jdone.any():
            _check_fresh(ptr.state, T(jdone), np.asarray(jt.stage)[jdone])
            resets += int(jdone.sum())
        was = np.asarray(js.task.attached) > 0.5
        now = np.asarray(jt.attached) > 0.5
        grabs += int((now & ~was)[live].sum())
        releases += int((was & ~now)[live].sum())
        hits += int(np.asarray(jtr.metrics["bar_hit"]).sum())
        js = jtr.state
    assert hits >= 2, "a grab on the target bar should hit it"
    assert resets >= 2, "the step cap and the fall should end episodes"
    assert grabs >= 1 and releases >= 3, (grabs, releases)


def test_reset_hangs_like_jax(envs):
    """The deterministic part of the reset on the JAX package's own draws:
    its joint angles and bars give the same base position and anchor; the
    observation of the fresh state agrees."""
    jenv, penv, _, jinit = envs
    js = jinit(jrng.env_keys(jrng.root_key(4), B))
    ps = _to_port(js)
    palms = ttask.make_palm_positions(penv.model, tmonkey.constraints())
    q, on_bar = ttask.hang_from(palms, ps.q[:, 7:], ps.task.bar_pos[:, 0],
                                ps.task.bar_dir[:, 0])
    np.testing.assert_allclose(q.numpy(), np.asarray(js.q), atol=1e-5)
    np.testing.assert_allclose(on_bar.numpy(), np.asarray(js.task.anchor)[:, 0], atol=1e-5)
    want = np.asarray(jax.jit(jax.vmap(jenv.obs_fn))(js))
    np.testing.assert_allclose(penv.obs_fn(ps).numpy(), want, atol=1e-5)
    # the port's own fresh episodes: same structure, its own draws
    fresh = penv.init(trng.generator(4, "cpu"), B)
    _check_fresh(fresh, torch.ones(B, dtype=torch.bool), np.zeros(B, np.float32))
    hang = ttask.hang_qj(penv.model)
    assert float((fresh.q[:, 7:] - hang).abs().max()) <= 0.05 + 1e-6
    torch.testing.assert_close(fresh.task.potential, -torch.linalg.vector_norm(
        fresh.task.bar_pos[:, 1] - fresh.q[:, 0:3], dim=1) / penv.control_dt)


def test_stage_advances_at_auto_reset(envs):
    """An env that ends an episode at or past adv_threshold bars restarts
    one stage higher, capped at the last stage; the others keep theirs."""
    jenv, penv, jstep, jinit = envs
    js = jinit(jrng.env_keys(jrng.root_key(2), B))
    next_bar = jnp.asarray([14, 15, 13, 14, 1, 14, 5, 15], jnp.int32)
    stage = jnp.asarray([0, 3, 4, 9, 2, 8.5, 0, 0], jnp.float32)
    js = js.replace(task=js.task.replace(next_bar=next_bar, stage=stage),
                    steps=js.steps.at[:].set(999))
    a = np.zeros((B, jenv.act_dim), np.float32)
    a[:, -2] = 1.0
    jtr = jstep(js, jnp.asarray(a))
    ptr = penv.step(_to_port(js), T(a), trng.generator(1, "cpu"))
    assert bool(ptr.done.all()) and bool(np.asarray(jtr.done).all())
    want = np.asarray(jtr.state.task.stage)
    np.testing.assert_array_equal(want, [1, 4, 4, 9, 2, 9, 0, 1])
    _check_fresh(ptr.state, ptr.done, want)
    # the new chains come from the new stages: stage 9 pitches its bars,
    # stage 0 keeps them level
    z_spread = ptr.state.task.bar_pos[..., 2].std(dim=1).numpy()
    assert z_spread[3] > 0.02 and z_spread[6] < 1e-6


def test_set_stage(envs):
    jenv, penv, _, jinit = envs
    js = jinit(jrng.env_keys(jrng.root_key(3), B))
    ps = _to_port(js)
    per_env = np.arange(B, dtype=np.float32)
    for stage in (9, 4.5, per_env):
        got = ttask.set_stage(ps, stage)
        want = jtask.set_stage(js, stage)
        np.testing.assert_array_equal(got.task.stage.numpy(), np.asarray(want.task.stage))
        torch.testing.assert_close(got.task.bar_pos, ps.task.bar_pos, atol=0, rtol=0)
    assert float(ps.task.stage.abs().max()) == 0.0            # the input state is untouched
    # the state and the parameters cross the numpy seam both ways
    back = convert.monkey_state_from_numpy(**convert.monkey_state_to_numpy(ps))
    for a, b in zip(convert.monkey_state_to_numpy(back).values(),
                    convert.monkey_state_to_numpy(ps).values()):
        np.testing.assert_array_equal(a, b)
