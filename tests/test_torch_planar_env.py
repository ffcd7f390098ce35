"""PyTorch port vs the JAX package: the planar walkers, batched (CPU).

``Walker2DCustomEnv`` and ``Crab2DCustomEnv`` (the walk-to-target task over a
7-link model, the planar rows locking y, roll and yaw) step by step from
shared states and actions with resync, as the other walk-to-target families
(``check_family_step_by_step``): done flags equal every step, rewards within
1e-4, observations within 1e-4 on the per-env median and 1e-3 on the max,
auto-reset on the same steps. Besides: the port's own trajectory stays in
the plane, and the crab's spawn pose is not terminal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import mocca_envs_tpu
import mocca_envs_tpu_torch
from mocca_envs_tpu_torch.envs import families as tfamilies
from mocca_envs_tpu_torch.models import walker2d
from mocca_envs_tpu_torch.tasks.walker_custom import WalkerParams

from tests.test_torch_pd_child import check_family_step_by_step

PLANAR = ["Walker2DCustomEnv", "Crab2DCustomEnv"]


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
