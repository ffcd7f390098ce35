"""PyTorch port vs the JAX package: the planar walkers, batched (CPU).

``Walker2DCustomEnv`` and ``Crab2DCustomEnv`` (the walk-to-target task over a
7-link model, the planar rows locking y, roll and yaw) step by step from
shared states and actions with resync, as the other walk-to-target families
(``check_family_step_by_step``): done flags equal every step, rewards within
1e-4, observations within 1e-4 on the per-env median and 1e-3 on the max,
auto-reset on the same steps. Besides: the port's own trajectory stays in
the plane, and the crab's spawn pose is not terminal.

One control step of each (one torque llc frame with the planar lock) on
chip_smoke.py's planar states at B = 16, through the JAX package's
``make_control_step`` (its XLA path), the port's, and the planar K1e's
warp-per-env instance of ``csrc/engine_k1w.cu`` (what ``make`` launches on
the card) built by g++ under ``-DK1W_HOST_CHECK``: per-env medians within
K1e's gate (q 5e-4, qd 2e-2, depth 5e-4, impulse 5e-3, the tolerances the
JAX package holds its own kernel to over equality rows), the largest env
within ten times.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import mocca_envs_tpu
import mocca_envs_tpu_torch
from mocca_envs_tpu.models import walker2d as jwalker2d
from mocca_envs_tpu.ops.step import make_control_step as jcontrol
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu.utils.config import EngineConfig as JConfig
from mocca_envs_tpu_torch.envs import families as tfamilies
from mocca_envs_tpu_torch.models import walker2d
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.ops.step import make_control_step as tcontrol
from mocca_envs_tpu_torch.tasks.walker_custom import WalkerParams
from mocca_envs_tpu_torch.terrain import scene as tscene
from mocca_envs_tpu_torch.utils.config import EngineConfig

from tests import torch_workers  # noqa: F401
from tests.test_torch_pd_child import check_family_step_by_step
from tests.torch_k1_host import build_host, run_on_host

PLANAR = ["Walker2DCustomEnv", "Crab2DCustomEnv"]
# each family's models in both packages and its stand height (chip_smoke.py's)
MODELS = {"Walker2DCustomEnv": (jwalker2d.make_walker2d, walker2d.make_walker2d, 1.22),
          "Crab2DCustomEnv": (jwalker2d.make_crab2d, walker2d.make_crab2d, 0.42)}


@pytest.mark.parametrize("env_id", PLANAR)
def test_planar_env_matches_jax_step_by_step(env_id):
    check_family_step_by_step(env_id, 10)


@pytest.mark.parametrize("env_id", PLANAR)
def test_planar_env_stays_in_the_plane(env_id):
    """40 control steps of random torques from the spawn: y within 2 cm and
    the lock's own roll and yaw measures, 2(wx+yz) and 2(wz+xy), within 0.1
    (the JAX package holds Cassie2D under gentle actions to 0.05; full random
    torques scuff a foot now and then, and the lock pulls back at no more
    than ``max_push_vel``. Euler angles would jump to π when a toppled walker
    pitches past 90°), while the free coordinates move."""
    env = mocca_envs_tpu_torch.make(env_id + "-v0", device="cpu")
    assert (env.obs_dim, env.act_dim) == (8 + 2 * 6 + 2, 6)
    batch = mocca_envs_tpu_torch.BatchedEnv(env, 8, seed=3, device="cpu")
    state = batch.init()
    x0 = state.q[:, 0].clone()
    rng = np.random.default_rng(4)
    worst = torch.zeros(3)
    for _ in range(40):
        actions = torch.as_tensor(rng.uniform(-1, 1, (8, 6)).astype(np.float32))
        state = batch.step(state, actions).state
        w, x, y, z = state.q[:, 3:7].unbind(dim=1)
        now = torch.stack([state.q[:, 1].abs().max(), (2 * (w * x + y * z)).abs().max(),
                           (2 * (w * z + x * y)).abs().max()])
        worst = torch.maximum(worst, now)
    assert float(worst[0]) < 0.02 and float(worst[1]) < 0.1 and float(worst[2]) < 0.1, worst
    assert bool(torch.isfinite(state.q).all())
    assert float((state.q[:, 0] - x0).abs().max()) > 0.01
    assert int(state.blowup_count.sum()) == 0


def test_crab_spawn_pose_is_not_terminal():
    """The crab's base spawns at z = 0.45, under the walkers' terminal height
    of 0.7: its family sets 0.2, in both packages."""
    jenv = mocca_envs_tpu.make("Crab2DCustomEnv-v0")
    env = mocca_envs_tpu_torch.make("Crab2DCustomEnv-v0", device="cpu")
    assert walker2d.CRAB2D_INITIAL_Z < 0.7
    batch = mocca_envs_tpu_torch.BatchedEnv(env, 4, seed=0, device="cpu")
    tr = batch.step(batch.init(), torch.zeros(4, env.act_dim))
    assert not bool(tr.done.any()) and float(tr.metrics["fallen"].sum()) == 0.0
    assert jenv.name == env.name == "Crab2DCustomEnv"
    # the walker's default would have ended every episode at its first step
    strict = tfamilies._make_crab2d_custom(
        device=torch.device("cpu"), params=dataclasses.replace(
            WalkerParams.default(), terminal_height=0.7))
    assert bool(strict.step(strict.init(batch.generator, 4), torch.zeros(4, 6),
                            batch.generator).done.all())


@pytest.mark.parametrize("env_id", PLANAR)
def test_planar_control_step_matches_jax(env_id):
    """One control step on the same arrays through both packages, and the
    warp-per-env K1e planar's host build held to the same JAX outputs."""
    jmake, tmake, stand_z = MODELS[env_id]
    tm = tmake()
    B = 16
    arrays = [np.ascontiguousarray(x) for x in chip_smoke.planar_walker_states(
        tm, stand_z, np.random.default_rng(85), B)]
    q, qd, tau = arrays[:3]
    jstep = jcontrol(jmake(), JConfig(), constraints=jwalker2d.planar_spec())

    def one(q1, qd1, tau1):
        qq, dd, info = jstep(q1, qd1, tau1, jscene.flat())
        return qq, dd, info.contacts.depth, info.normal_impulse

    want = [np.asarray(w) for w in jax.jit(jax.vmap(one))(q, qd, tau)]
    tq, tqd, info = tcontrol(tm, EngineConfig(), constraints=walker2d.planar_spec())(
        *map(torch.as_tensor, (q, qd, tau)), tscene.flat(B))
    got = [x.numpy() for x in (tq, tqd, info.contacts.depth, info.normal_impulse)]
    kernel = engine.K1e(tm, EngineConfig(), walker2d.planar_spec())
    assert kernel.instance.source == engine.SOURCE_W
    outs = run_on_host(build_host([kernel])[kernel.name], kernel, arrays)
    for result in (got, outs):
        assert all(np.isfinite(o).all() for o in result)
        for name, g, w in zip(("q", "qd", "depth", "nimp"), result, want):
            per_env = np.abs(g - w).max(axis=1)
            assert np.median(per_env) <= chip_smoke.TOL_EQ[name], (name, np.median(per_env))
            assert per_env.max() <= 10 * chip_smoke.TOL_EQ[name], (name, per_env.max())
    assert (want[3] > 0).mean() > 0.05                       # contacts carry load
