"""Rollout generation: a loop over the horizon on the batched env step.

Counterpart of ``mocca_envs_tpu/harness/rollout.py`` (``lax.scan`` there):
the observation is carried alongside the state, so each one is computed
once (the env returns post-step observations), and the trajectory is
written time-major into buffers allocated once per rollout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from mocca_envs_tpu_torch.core import rng as rng_mod
from mocca_envs_tpu_torch.envs.env import EnvState, FnEnv


@dataclasses.dataclass
class Trajectory:
    """Time-major (T, B, …) trajectory slices for the learner."""

    obs: torch.Tensor        # (T, B, obs_dim) obs BEFORE each step
    action: torch.Tensor     # (T, B, act_dim)
    log_prob: torch.Tensor   # (T, B)
    value: torch.Tensor      # (T, B)
    reward: torch.Tensor     # (T, B)
    done: torch.Tensor       # (T, B) bool
    last_obs: torch.Tensor   # (B, obs_dim) for bootstrap
    # per-step env metric channels, {name: (T, B)}: surfaced by the learner
    # as batch means and done-masked episode-end means
    env_metrics: Any = None


def make_batched_rollout(env: FnEnv, horizon: int, policy: Callable):
    """Build ``rollout(params, env_state, obs, gen, env_gen) → (env_state,
    obs, traj)``. ``policy(params, obs, gen) → (action, log_prob, value)``
    draws its noise from ``gen``; the env's own draws come from
    ``env_gen``. Runs without autograd."""

    @torch.no_grad()
    def rollout(params, env_state: EnvState, obs: torch.Tensor, gen: torch.Generator,
                env_gen: torch.Generator):
        bufs: dict = {}
        env_metrics: dict = {}
        for t in range(horizon):
            action, log_prob, value = policy(params, obs, gen)
            tr = env.step(env_state, action, env_gen)
            out = {"obs": obs, "action": action, "log_prob": log_prob, "value": value,
                   "reward": tr.reward, "done": tr.done}
            if t == 0:
                bufs = {k: v.new_empty((horizon,) + tuple(v.shape)) for k, v in out.items()}
                env_metrics = {k: v.new_empty((horizon,) + tuple(v.shape))
                               for k, v in tr.metrics.items()}
            for k, v in out.items():
                bufs[k][t] = v
            for k, v in tr.metrics.items():
                env_metrics[k][t] = v
            env_state, obs = tr.state, tr.obs
        return env_state, obs, Trajectory(**bufs, last_obs=obs, env_metrics=env_metrics)

    return rollout


@torch.no_grad()
def random_rollout(env: FnEnv, num_envs: int, horizon: int, seed: int = 0):
    """Uniform random actions in [-1, 1) for ``horizon`` steps from fresh
    episodes: the env draws from ``seed``, the actions from ``seed + 1``.
    Returns ``(final state, rewards (T, B))``."""
    env_gen = rng_mod.generator(seed, env.device)
    act_gen = rng_mod.generator(seed + 1, env.device)
    state = env.init(env_gen, num_envs)
    rewards = []
    for _ in range(horizon):
        actions = rng_mod.uniform(act_gen, (num_envs, env.act_dim), -1.0, 1.0)
        tr = env.step(state, actions, env_gen)
        state = tr.state
        rewards.append(tr.reward)
    return state, torch.stack(rewards)
