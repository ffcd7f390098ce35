"""PyTorch port vs the JAX package: PD actuation and the child model (CPU).

- the child model's arrays against ``mocca_envs_tpu/models/child3d.py``;
- one PD control step of the walker (``pd_targets``, ``extra_damping``) at
  one and at two llc frames against ``ops/step.py``, gated like the torque
  step (tests/test_torch_physics.py): per-env medians within q 2e-4,
  qd 5e-3, depth 2e-4, normal impulse 5e-3, the largest single-env error
  within ten times that; at two llc frames the generic warp-per-env K1
  instance of that key (``csrc/engine_k1w.cu`` built by g++ under
  ``-DK1W_HOST_CHECK``) on the same states and targets, at the same gate;
- ``Walker3DPDCustomEnv`` step by step from shared states and actions with
  resync, as tests/test_torch_walker_env.py does for the walker: done flags
  equal, rewards within 1e-4, observations within 1e-4 (median) / 1e-3
  (max). ``check_family_step_by_step`` does this for any walk-to-target
  family; the child pair runs it from tests/test_torch_child_env.py.
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
from mocca_envs_tpu.envs import families as jfamilies
from mocca_envs_tpu.models import child3d as jchild
from mocca_envs_tpu.models import walker3d as jwalker
from mocca_envs_tpu.ops.step import make_control_step as jcontrol
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu.utils.config import EngineConfig as JConfig
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.core import rng as trng
from mocca_envs_tpu_torch.envs import families as tfamilies
from mocca_envs_tpu_torch.models import child3d as tchild
from mocca_envs_tpu_torch.models import walker3d as twalker
from mocca_envs_tpu_torch.models.schema import ARRAY_FIELDS, STATIC_FIELDS
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.ops.step import make_control_step as tcontrol
from mocca_envs_tpu_torch.terrain import scene as tscene
from mocca_envs_tpu_torch.utils.config import EngineConfig as TConfig

from tests import torch_workers  # noqa: F401
from tests.torch_k1_host import build_host, run_on_host

TOL = {"q": 2e-4, "qd": 5e-3, "depth": 2e-4, "nimp": 5e-3}
T = torch.as_tensor


def _gate(name, got, want):
    per_env = np.abs(np.asarray(got) - np.asarray(want)).reshape(len(got), -1).max(axis=1)
    assert np.median(per_env) <= TOL[name], (name, float(np.median(per_env)))
    assert per_env.max() <= 10 * TOL[name], (name, float(per_env.max()))


ENV_B = 8
AHEAD = 3.0  # target [m] ahead of the start: out of reach within the horizon


def walker_state_to_port(js):
    n = np.asarray
    return convert.env_state_from_numpy(
        q=n(js.q), qd=n(js.qd), steps=n(js.steps), reset_count=n(js.reset_count),
        done=n(js.done), blowup_count=n(js.blowup_count), target=n(js.task.target),
        potential=n(js.task.potential), ground_z=n(js.scene.ground_z),
        friction=n(js.scene.friction),
    )


def check_family_step_by_step(env_id: str, steps: int, action_scale: float = 1.0):
    """Both packages step a walk-to-target family from the same states and
    actions, the port re-synced from the JAX state through numpy each step.
    Done flags equal every step, rewards within 1e-4 (plus 2e-5 of their
    size: a flailing child's reward reaches ±12, where f32 and the 60× of the
    progress term leave no more), observations within 1e-4 on the per-env
    median and 1e-3 on the max; two slots run into the step cap, so
    auto-reset fires in both packages on the same steps. Actions are
    uniform in ±``action_scale``."""
    jenv = mocca_envs_tpu.make(env_id + "-v0")
    penv = mocca_envs_tpu_torch.make(env_id + "-v0", device="cpu")
    assert (penv.obs_dim, penv.act_dim, penv.name) == (jenv.obs_dim, jenv.act_dim, jenv.name)
    np.testing.assert_allclose(penv.model.kp.numpy(), np.asarray(jenv.model.kp), rtol=1e-6)
    js = jax.jit(jax.vmap(jenv.init))(jrng.env_keys(jrng.root_key(0), ENV_B))
    target = js.q[:, :3].at[:, 0].add(AHEAD).at[:, 2].set(0.0)
    dist = jnp.linalg.norm(target[:, :2] - js.q[:, :2], axis=1)
    js = js.replace(task=js.task.replace(target=target, potential=-dist / jenv.control_dt),
                    steps=js.steps.at[0].set(997).at[1].set(994))
    z0 = float(js.q[0, 2])
    jstep = jax.jit(jax.vmap(jenv.step))
    gen = trng.generator(0, "cpu")
    rng = np.random.default_rng(1)
    resets = 0
    for t in range(steps):
        a = (action_scale * rng.uniform(-1, 1, (ENV_B, jenv.act_dim))).astype(np.float32)
        ps = walker_state_to_port(js)
        jtr = jstep(js, jnp.asarray(a))
        ptr = penv.step(ps, torch.as_tensor(a), gen)
        jdone = np.array(jtr.done)
        np.testing.assert_array_equal(ptr.done.numpy(), jdone, err_msg=f"step {t}")
        np.testing.assert_allclose(ptr.reward.numpy(), np.asarray(jtr.reward), atol=1e-4,
                                   rtol=2e-5, err_msg=f"step {t}")
        live = ~jdone
        per_env = np.abs(ptr.obs.numpy() - np.asarray(jtr.obs))[live].max(axis=1)
        assert np.median(per_env) <= 1e-4 and per_env.max() <= 1e-3, (t, per_env)
        if jdone.any():
            fresh = ptr.state.q.numpy()[jdone]
            np.testing.assert_allclose(fresh[:, 2], z0, atol=1e-6)
            assert (ptr.state.steps.numpy()[jdone] == 0).all()
            assert (ptr.state.reset_count.numpy()[jdone] == ps.reset_count.numpy()[jdone] + 1).all()
            resets += int(jdone.sum())
        assert not np.asarray(jtr.metrics["reached_target"]).any()
        js = jtr.state
    assert resets >= 2, "the horizon should see the two step-cap resets"


def test_child_model_matches_jax():
    jm, tm = jchild.make_model(), tchild.make_model()
    for f in STATIC_FIELDS:
        assert getattr(tm, f) == getattr(jm, f), f
    for f in ARRAY_FIELDS:
        np.testing.assert_allclose(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                   rtol=1e-6, atol=0, err_msg=f)
    assert tchild.INITIAL_Z == jchild.INITIAL_Z == 0.5 * twalker.INITIAL_Z
    adult = twalker.make_model()
    torch.testing.assert_close(tm.mass, adult.mass / 8)
    torch.testing.assert_close(tm.inertia, adult.inertia / 32)
    # the child task parameters cross the seam unchanged
    jp = jfamilies._child3d_params()
    fields = {f.name: np.asarray(getattr(jp, f.name)) for f in dataclasses.fields(jp)}
    assert dataclasses.asdict(convert.walker_params_from_numpy(fields)) == pytest.approx(
        dataclasses.asdict(tfamilies._child3d_params()), rel=1e-6)


@pytest.mark.parametrize("llc_frames", [1, 2])
def test_pd_control_step_matches_jax(llc_frames):
    """The whole control step as one PD unit: torque refreshed from the
    state at each llc frame, λ carried across frames, kp / 20 implicit. At
    two llc frames the K1b warp-per-env host build runs the same states and
    targets too."""
    jm, tm = jwalker.make_model(), twalker.make_model()
    B = 32
    rng = np.random.default_rng(20 + llc_frames)
    q = np.zeros((B, 28), np.float32)
    q[:, 2] = 0.9 + 0.04 * rng.standard_normal(B)
    q[:, 3:7] = np.array([1.0, 0, 0, 0]) + 0.03 * rng.standard_normal((B, 4))
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q[:, 7:] = 0.1 * rng.standard_normal((B, 21))
    qd = (0.3 * rng.standard_normal((B, 27))).astype(np.float32)
    action = rng.uniform(-1, 1, (B, 21)).astype(np.float32)

    kp = np.asarray(jm.power_coef * jm.actuated)
    mid = np.asarray(0.5 * (jm.limit_lo + jm.limit_hi))
    amp = np.asarray(0.5 * (jm.limit_hi - jm.limit_lo))
    jstep = jcontrol(jm.replace(kp=jnp.asarray(kp)), JConfig(llc_frames=llc_frames),
                     pd_targets=lambda a: mid + amp * jnp.clip(a, -1, 1),
                     extra_damping=jnp.asarray(kp / 20.0))
    wq, wqd, winfo = jax.jit(jax.vmap(lambda a, b, c: jstep(a, b, c, jscene.flat())))(
        q, qd, action)
    tstep = tcontrol(tm.replace(kp=T(kp)), TConfig(llc_frames=llc_frames),
                     pd_targets=lambda a: T(mid) + T(amp) * torch.clamp(a, -1, 1),
                     extra_damping=T(kp / 20.0))
    tq, tqd, tinfo = tstep(T(q), T(qd), T(action), tscene.flat(B))
    _gate("q", tq.numpy(), wq)
    _gate("qd", tqd.numpy(), wqd)
    _gate("depth", tinfo.contacts.depth.numpy(), winfo.contacts.depth)
    _gate("nimp", tinfo.normal_impulse.numpy(), winfo.normal_impulse)
    np.testing.assert_array_equal(tinfo.foot_contact.numpy(), np.asarray(winfo.foot_contact))
    # the servo moved the joints: this is not the zero-torque trajectory
    assert float(np.abs(tq.numpy()[:, 7:] - q[:, 7:]).max()) > 0.02
    if llc_frames == 2:
        kernel = engine.K1b(tm.replace(kp=T(kp)), TConfig(llc_frames=2),
                            extra_damping=T(kp / 20.0))
        assert kernel.instance == engine.warp_instance(kernel.key)
        targets = (mid + amp * np.clip(action, -1, 1)).astype(np.float32)
        inputs = [q, qd, targets, np.zeros(B, np.float32), np.full(B, 0.8, np.float32)]
        outs = run_on_host(build_host([kernel])[kernel.name], kernel, inputs)
        for name, got, want in zip(("q", "qd", "depth", "nimp"), outs,
                                   (wq, wqd, winfo.contacts.depth, winfo.normal_impulse)):
            _gate(name, got, want)


def test_pd_walker_env_matches_jax_step_by_step():
    check_family_step_by_step("Walker3DPDCustomEnv", 10)
