"""Walker3DStepperEnv — the stepping-stone curriculum (ALLSTEPS), batch-first.

Counterpart of ``mocca_envs_tpu/tasks/walker_stepper.py``.

- a chain of stones is sampled at reset (terrain/stones.py) at each env's
  own curriculum stage; the stones are boxes of the scene and the robot
  starts over stone 0, with the plane far below (z = −20);
- the env tracks the index of the current target stone; the observation
  appends the next two targets in the heading frame and, with
  ``orient_obs``, the xy of their top normals;
- a target counts as hit when the swing foot (the feet alternate) touches
  within a radius of the stone's top center; a hit pays a bonus, advances
  the target and shifts the two-target window;
- the episode ends on a fall (relative to the target stone), after the last
  stone (success) or at the step cap; an env that ends an episode at or
  past ``adv_threshold`` stones starts its next one a stage higher.
"""

from __future__ import annotations

import dataclasses

import torch

from mocca_envs_tpu_torch.core import quat as quat_ops
from mocca_envs_tpu_torch.core import rng as rng_mod
from mocca_envs_tpu_torch.envs.env import EnvState, FnEnv, Transition, make_fn_env
from mocca_envs_tpu_torch.models import walker3d
from mocca_envs_tpu_torch.models.schema import RobotModel
from mocca_envs_tpu_torch.ops.collide import collide, foot_contact_flags
from mocca_envs_tpu_torch.ops.kinematics import forward_kinematics
from mocca_envs_tpu_torch.ops.step import make_control_step
from mocca_envs_tpu_torch.tasks import base as T
from mocca_envs_tpu_torch.tasks.walker_custom import WalkerParams
from mocca_envs_tpu_torch.terrain import scene as scene_mod
from mocca_envs_tpu_torch.terrain.stones import (
    StoneParams,
    sample_stones,
    stones_to_scene_boxes,
)
from mocca_envs_tpu_torch.utils.config import EngineConfig
from mocca_envs_tpu_torch.utils.device import resolve_device

GROUND_Z = -20.0   # the plane under the stones: a fall between them ends the episode


@dataclasses.dataclass(frozen=True)
class StepperParams:
    """Task parameters, the same names and defaults as the JAX package's."""

    walker: WalkerParams = WalkerParams()
    stones: StoneParams = StoneParams()
    step_radius: float = 0.3        # xy radius counting a stone as hit
    step_bonus: float = 6.0         # reward per stone hit
    success_bonus: float = 20.0     # completing the chain
    # per-env adaptive curriculum: stones reached at the episode's end that
    # advance the env's own stage at its auto-reset (≥ num_steps disables it)
    adv_threshold: float = 18.0
    # weight of the near-miss shaping on the swing foot's 3-D distance to
    # the target (0 = off)
    w_nearmiss: float = 0.0

    @classmethod
    def default(cls) -> "StepperParams":
        stones = StoneParams()
        return cls(stones=stones, adv_threshold=float(stones.num_steps - 2))

    def set_curriculum(self, stage) -> "StepperParams":
        return dataclasses.replace(self, stones=self.stones.set_stage(stage))


@dataclasses.dataclass
class StepperTaskState:
    stone_top: torch.Tensor        # (B, K, 3) top-center positions
    stone_quat: torch.Tensor       # (B, K, 4)
    next_step: torch.Tensor        # (B,) int32 index of the current target stone
    potential: torch.Tensor        # (B,) −dist(root → target) / control_dt
    foot_potential: torch.Tensor   # (B,) −dist3(swing foot → target) / control_dt
    stage: torch.Tensor            # (B,) curriculum stage, carried across auto-resets


def set_stage(state: EnvState, stage) -> EnvState:
    """Curriculum setter on a batched env state: a scalar or a per-env array;
    it takes effect at each env's next reset."""
    old = state.task.stage
    new = torch.broadcast_to(torch.as_tensor(stage, dtype=old.dtype, device=old.device),
                             old.shape).clone()
    return dataclasses.replace(state, task=dataclasses.replace(state.task, stage=new))


def make_walker3d_stepper(
    config: EngineConfig | None = None,
    params: StepperParams | None = None,
    model: RobotModel | None = None,
    device=None,
    name: str = "Walker3DStepperEnv",
    initial_z: float | None = None,
    orient_obs: bool = True,
    reset_obs: str = "zero",
) -> FnEnv:
    """Build the stepping-stone family on ``device`` (None = the CUDA card)."""
    device = resolve_device(device)
    model = (model or walker3d.make_model()).to(device)
    config = config or EngineConfig()
    params = params or StepperParams.default()
    initial_z = walker3d.INITIAL_Z if initial_z is None else initial_z
    # index tensors on the device: indexing with a list would copy it over,
    # and wait for the device, every step
    terminal_links = torch.as_tensor(list(walker3d.terminal_links(model)), dtype=torch.long,
                                     device=device)
    K = params.stones.num_steps
    wp = params.walker
    nfeet = len(model.foot_links)
    foot_link_idx = torch.as_tensor(
        [model.link_names.index(n) for n in ("right_ankle_x", "left_ankle_x")
         if n in model.link_names], dtype=torch.long, device=device)
    gain = wp.power * model.power_coef * model.actuated
    up = torch.tensor([0.0, 0.0, 1.0], device=device)

    def actuation(q, qd, a):
        return gain * torch.clamp(a, -1.0, 1.0)

    control = make_control_step(model, config, actuation=actuation)
    # walker block + two lookahead targets (Δxyz in the heading frame) + with
    # orient_obs the two stones' top-normal xy, appended at the tail
    obs_dim = 8 + 2 * model.nj + nfeet + 6 + (4 if orient_obs else 0)

    def _row(arr, idx):
        """arr[b, idx[b]] for (B, K, D) ``arr`` and (B,) ``idx``."""
        return torch.gather(arr, 1, idx.long()[:, None, None].expand(-1, 1, arr.shape[-1]))[:, 0]

    def targets_obs(q, task: StepperTaskState) -> torch.Tensor:
        yaw = T.heading_yaw(q)
        idx0 = torch.clamp(task.next_step, max=K - 1)
        idx1 = torch.clamp(task.next_step + 1, max=K - 1)
        parts = [T.to_heading_frame(yaw, _row(task.stone_top, idx0) - q[:, 0:3]),
                 T.to_heading_frame(yaw, _row(task.stone_top, idx1) - q[:, 0:3])]
        if orient_obs:
            n0 = quat_ops.rotate(_row(task.stone_quat, idx0), up)
            n1 = quat_ops.rotate(_row(task.stone_quat, idx1), up)
            parts.append(T.to_heading_frame(yaw, n0)[:, 0:2])
            parts.append(T.to_heading_frame(yaw, n1)[:, 0:2])
        return torch.cat(parts, dim=1)

    def full_obs(state: EnvState, foot_contact) -> torch.Tensor:
        q, qd = state.q, state.qd
        tgt = _row(state.task.stone_top, torch.clamp(state.task.next_step, max=K - 1))
        to_t = tgt[:, :2] - q[:, 0:2]
        angle = torch.atan2(to_t[:, 1], to_t[:, 0]) - T.heading_yaw(q)
        body = T.body_obs(model, q, qd, initial_z, angle)
        q_s, qd_s = T.joint_obs(model, q, qd)
        return torch.cat([body, q_s, qd_s, foot_contact, targets_obs(q, state.task)], dim=1)

    def obs_fn(state: EnvState) -> torch.Tensor:
        # exact frame-0 contact flags from the narrowphase predicate
        fd = forward_kinematics(model, state.q, state.qd)
        contacts = collide(model, fd, state.scene, config.contact_margin)
        return full_obs(state, foot_contact_flags(model, contacts))

    # reset_obs="zero": frame-0 contact flags are zeros, which is what the
    # narrowphase gives for the airborne spawn pose; "exact" runs it anyway
    if reset_obs == "zero":
        def reset_obs_fn(state: EnvState) -> torch.Tensor:
            return full_obs(state, state.q.new_zeros(state.q.shape[0], nfeet))
    elif reset_obs == "exact":
        reset_obs_fn = None
    else:
        raise ValueError(f"unknown reset_obs mode {reset_obs!r}")

    def reset(gen: torch.Generator, reset_count: torch.Tensor, prev=None) -> EnvState:
        B = reset_count.shape[0]
        noise = wp.init_joint_noise * rng_mod.uniform(gen, (B, model.nj), -1.0, 1.0)
        qj = torch.maximum(torch.minimum(noise, model.limit_hi), model.limit_lo)
        # the stage is per-env data carried across episodes; a finished
        # episode that reached adv_threshold stones advances its env's stage
        if prev is None:
            stage = torch.full((B,), params.stones.stage, dtype=torch.float32, device=device)
        else:
            adv = (prev.task.next_step.to(torch.float32) >= params.adv_threshold)
            stage = torch.clamp(prev.task.stage + adv.to(torch.float32),
                                max=params.stones.max_stage)
        stone_top, stone_quat = sample_stones(
            params.stones, gen, stage, torch.zeros(B, 3, device=device))
        center, half = stones_to_scene_boxes(params.stones, stone_top, stone_quat)
        scene = scene_mod.with_stones(center, stone_quat, half, ground_z=GROUND_Z)
        q = torch.zeros(B, model.nq, device=device)
        q[:, 2] = initial_z + 0.02
        q[:, 3] = 1.0
        q[:, 7:] = qj
        dist = torch.linalg.vector_norm(stone_top[:, 1, :2] - q[:, 0:2], dim=1)
        zeros_i = torch.zeros(B, dtype=torch.int32, device=device)
        task = StepperTaskState(
            stone_top=stone_top,
            stone_quat=stone_quat,
            next_step=torch.ones(B, dtype=torch.int32, device=device),
            potential=-dist / config.control_dt,
            # the real basis needs FK at the reset pose; the first step's
            # near-miss term is gated (steps == 0), so the placeholder never
            # reaches the reward
            foot_potential=torch.zeros(B, device=device),
            stage=stage,
        )
        return EnvState(
            q=q,
            qd=torch.zeros(B, model.nv, device=device),
            reset_count=reset_count.to(torch.int32),
            steps=zeros_i,
            task=task,
            scene=scene,
            done=torch.zeros(B, dtype=torch.bool, device=device),
            blowup_count=zeros_i.clone(),
        )

    def raw_step(state: EnvState, action: torch.Tensor, gen: torch.Generator) -> Transition:
        q, qd, info = control(state.q, state.qd, action, state.scene)
        task = state.task
        tgt = _row(task.stone_top, torch.clamp(task.next_step, max=K - 1))

        # ---- step-advance state machine
        fd = forward_kinematics(model, q, qd)
        swing_right = (task.next_step % 2 == 0)           # the feet alternate
        foot_pos = fd.pos[:, foot_link_idx]                # (B, 2, 3)
        foot_contact = info.foot_contact[:, : len(foot_link_idx)]
        swing_pos = torch.where(swing_right[:, None], foot_pos[:, 0], foot_pos[:, 1])
        swing_touch = torch.where(swing_right, foot_contact[:, 0], foot_contact[:, 1]) > 0.5
        close = (
            torch.linalg.vector_norm(swing_pos[:, :2] - tgt[:, :2], dim=1) < params.step_radius
        ) & ((swing_pos[:, 2] - tgt[:, 2]).abs() < 0.25)
        hit = swing_touch & close
        success = hit & (task.next_step >= K - 1)
        next_step = torch.where(hit, torch.clamp(task.next_step + 1, max=K - 1), task.next_step)

        # ---- reward: progress toward the current target + stone bonuses
        new_tgt = _row(task.stone_top, next_step)
        dist = torch.linalg.vector_norm(new_tgt[:, :2] - q[:, 0:2], dim=1)
        potential = -dist / config.control_dt
        zero = torch.zeros_like(dist)
        # a hit changes the potential's basis: progress counts on same-target steps
        progress = torch.where(hit, zero, wp.w_progress * (potential - task.potential))

        # near-miss shaping: Δ of −dist3(swing foot → target) / dt, gated to
        # steps where neither the target nor the swing foot changed and past
        # the placeholder of the first step
        foot_pot_old_basis = -torch.linalg.vector_norm(swing_pos - tgt, dim=1) / config.control_dt
        fresh = state.steps == 0
        nearmiss = torch.where(
            hit | fresh, zero, params.w_nearmiss * (foot_pot_old_basis - task.foot_potential))
        new_swing_pos = torch.where((next_step % 2 == 0)[:, None], foot_pos[:, 0], foot_pos[:, 1])
        foot_potential = -torch.linalg.vector_norm(new_swing_pos - new_tgt, dim=1) \
            / config.control_dt

        tall = q[:, 2] - tgt[:, 2] > wp.terminal_height
        body_touch = info.link_contact[:, terminal_links].amax(dim=1)
        fallen = (~tall) | (body_touch > 0.5)

        alive = torch.where(fallen, torch.full_like(dist, -wp.fall_penalty),
                            torch.full_like(dist, wp.tall_bonus))
        costs = T.energy_costs(model, action, qd, wp.w_electricity, wp.w_stall) \
            + T.joints_at_limit_cost(model, q, wp.w_limit)
        reward = (progress + nearmiss + alive - costs
                  + params.step_bonus * hit.to(q.dtype)
                  + params.success_bonus * success.to(q.dtype))

        steps = state.steps + 1
        done = fallen | success | (steps >= wp.max_steps)
        new_state = dataclasses.replace(
            state, q=q, qd=qd, steps=steps,
            task=dataclasses.replace(task, next_step=next_step, potential=potential,
                                     foot_potential=foot_potential),
        )
        obs = full_obs(new_state, info.foot_contact)
        metrics = {
            "progress": progress,
            "nearmiss": nearmiss,
            "steps_reached": next_step.to(torch.float32),
            "stone_hit": hit.to(q.dtype),
            "success": success.to(q.dtype),
            "fallen": fallen.to(q.dtype),
            "curriculum_stage": task.stage,
        }
        return Transition(state=new_state, obs=obs, reward=reward, done=done, metrics=metrics)

    extra = 6 + (4 if orient_obs else 0)
    return make_fn_env(
        name=name, obs_dim=obs_dim, act_dim=model.nj, reset=reset, raw_step=raw_step,
        obs_fn=obs_fn, control_dt=config.control_dt, device=device,
        # lookahead targets: the y components negate; normal tail: n_y negates
        mirror=T.mirror_spec(
            model, extra_obs_perm=list(range(extra)),
            extra_obs_sign=[1.0, -1.0, 1.0, 1.0, -1.0, 1.0]
            + ([1.0, -1.0, 1.0, -1.0] if orient_obs else []),
        ),
        model=model, reset_obs_fn=reset_obs_fn,
    )
