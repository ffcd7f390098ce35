"""Functional environment core, batch-first.

Counterpart of ``mocca_envs_tpu/envs/env.py``. An env family is a set of
functions over a batch of states (the JAX package writes them for one env
and vmaps; here the batch dimension is written out):

    reset(gen, reset_count, prev=None) → EnvState   (fresh episodes, all slots)
    step(state, action, gen)           → Transition (physics + task + auto-reset)

Auto-reset happens inside ``step``: a done slot (episode end or non-finite
state) takes a fresh episode, and a non-finite state is counted in
``blowup_count``. Random draws come from the ``torch.Generator`` passed in;
core/rng.py documents the order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from mocca_envs_tpu_torch.core import rng as rng_mod
from mocca_envs_tpu_torch.harness.profile import span
from mocca_envs_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class EnvState:
    """Complete batched state: everything the next step needs except the
    generator, which the caller owns."""

    q: torch.Tensor             # (B, nq)
    qd: torch.Tensor            # (B, nv)
    reset_count: torch.Tensor   # (B,) int32 episodes started in this slot
    steps: torch.Tensor         # (B,) int32 steps in the current episode
    task: Any                   # task-family state (targets, potentials…)
    scene: Any                  # terrain/scene.Scene
    done: torch.Tensor          # (B,) bool: the last step ended the episode
    blowup_count: torch.Tensor  # (B,) int32 resets forced by non-finite state


@dataclasses.dataclass
class Transition:
    state: EnvState
    obs: torch.Tensor           # (B, obs_dim)
    reward: torch.Tensor        # (B,)
    done: torch.Tensor          # (B,) bool
    metrics: dict


@dataclasses.dataclass(frozen=True)
class FnEnv:
    """An env family bound to one device: functions plus metadata."""

    name: str
    obs_dim: int
    act_dim: int
    reset: Callable
    step: Callable
    step_no_reset: Callable     # without auto-reset (terminal frames)
    obs_fn: Callable
    control_dt: float
    device: torch.device
    mirror: Any = None
    model: Any = None
    reset_obs_fn: Callable | None = None   # obs of a fresh state at auto-reset

    def init(self, gen: torch.Generator, num_envs: int) -> EnvState:
        zeros = torch.zeros(num_envs, dtype=torch.int32, device=self.device)
        return self.reset(gen, zeros)


def tree_where(mask: torch.Tensor, a, b):
    """Per-slot select over a state tree (dataclasses of tensors, with
    ``None`` for an absent field): ``a`` where ``mask`` (B,) is true, else
    ``b``. A leaf the two trees share is returned as it is, uncopied: the
    terrain families carry each slot's grid (4096 × 65² floats) into its
    fresh episodes, and a select would copy all of it every step."""
    if a is b:
        return a
    if isinstance(a, torch.Tensor):
        m = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
        return torch.where(m, a, b)
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: tree_where(mask, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)
        })
    raise TypeError(f"tree_where: unsupported leaf {type(a).__name__}")


def make_fn_env(*, name: str, obs_dim: int, act_dim: int, reset: Callable,
                raw_step: Callable, obs_fn: Callable, control_dt: float,
                device: torch.device, mirror=None, model=None,
                reset_obs_fn: Callable | None = None) -> FnEnv:
    """Assemble a family: wrap ``raw_step`` with done / non-finite auto-reset.
    The step is one ``env.step`` span while a profiler records
    (``harness/profile.py::span``)."""
    fresh_obs = reset_obs_fn or obs_fn

    def step(state: EnvState, action: torch.Tensor, gen: torch.Generator) -> Transition:
        with span("env.step"):
            tr = raw_step(state, action, gen)
            finite = (
                torch.isfinite(tr.state.q).all(dim=1)
                & torch.isfinite(tr.state.qd).all(dim=1)
                & torch.isfinite(tr.reward)
            )
            blowup = ~finite
            done = tr.done | blowup
            reward = torch.where(finite, tr.reward, torch.full_like(tr.reward, -1.0))

            fresh = reset(gen, state.reset_count + 1, tr.state)
            fresh.blowup_count = state.blowup_count + blowup.to(torch.int32)
            next_state = tree_where(done, fresh, tr.state)
            obs = torch.where(done[:, None], fresh_obs(next_state), tr.obs)
            next_state.done = done
            return Transition(
                state=next_state, obs=obs, reward=reward, done=done,
                metrics={**tr.metrics, "blowup": blowup.to(torch.float32)},
            )

    return FnEnv(
        name=name, obs_dim=obs_dim, act_dim=act_dim, reset=reset, step=step,
        step_no_reset=raw_step, obs_fn=obs_fn, control_dt=control_dt,
        device=device, mirror=mirror, model=model, reset_obs_fn=reset_obs_fn,
    )


class BatchedEnv:
    """A batch of ``num_envs`` slots of one family, with its generator.

    ``device=None`` means the CUDA card (raises where there is none); the
    env must have been made for the same device.
    """

    def __init__(self, env: FnEnv, num_envs: int, seed: int = 0, device=None):
        device = resolve_device(device)
        if device.type != env.device.type or (
            device.index is not None and env.device.index is not None
            and device.index != env.device.index
        ):
            raise ValueError(f"env was made for {env.device}, BatchedEnv asked for {device}")
        self.env = env
        self.num_envs = num_envs
        self.seed = seed
        self.device = device
        self.generator = rng_mod.generator(seed, env.device)

    def init(self) -> EnvState:
        return self.env.init(self.generator, self.num_envs)

    def step(self, state: EnvState, actions: torch.Tensor) -> Transition:
        return self.env.step(state, actions, self.generator)
