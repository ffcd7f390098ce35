"""CassieEnv family — PD-servoed closed-chain biped walking, batch-first.

Counterpart of ``mocca_envs_tpu/tasks/cassie_task.py``: the policy outputs
10 motor position targets around the stand pose; a PD servo recomputes the
proportional torque every llc frame (300 Hz) with its derivative gain
handled implicitly, while the passive spring joints and the achilles rods
act inside the solver every substep (600 Hz). Control runs at 30 Hz.

Families:
- ``CassieEnv``: 3D, walk forward at a target speed;
- ``Cassie2DEnv``: the sagittal-plane variant through the planar rows;
- ``CassiePhaseEnv`` / ``CassiePhase2DEnv``: a cyclic phase in the
  observation and a reward that tracks a reference gait table (motor-space
  tracking plus a contact clock), or a bare alternating contact clock when
  no table is given.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mocca_envs_tpu_torch.core import quat as quat_ops
from mocca_envs_tpu_torch.core import rng as rng_mod
from mocca_envs_tpu_torch.envs.env import EnvState, FnEnv, Transition, make_fn_env
from mocca_envs_tpu_torch.models import cassie
from mocca_envs_tpu_torch.ops.step import make_control_step
from mocca_envs_tpu_torch.tasks import base as T
from mocca_envs_tpu_torch.terrain import scene as scene_mod
from mocca_envs_tpu_torch.utils.config import EngineConfig
from mocca_envs_tpu_torch.utils.device import resolve_device

# three-rate timing: physics 600 Hz × 2 substeps per llc frame, PD servo at
# 300 Hz, control at 30 Hz; the shipped solver options otherwise
CASSIE_CONFIG = EngineConfig(dt=1.0 / 600.0, sim_substeps=2, llc_frames=10)


@dataclasses.dataclass(frozen=True)
class CassieParams:
    """Task parameters, the same names and defaults as the JAX package's
    (one value for the whole batch)."""

    target_speed: float = 0.8       # m/s forward
    init_noise: float = 0.02
    terminal_height: float = 0.65
    w_speed: float = 2.0            # speed-tracking weight
    tall_bonus: float = 2.0
    fall_penalty: float = 1.0
    w_action_rate: float = 0.1      # smoothness cost on Δtargets
    w_torque: float = 5e-5
    w_orientation: float = 1.0      # pelvis upright cost
    max_steps: int = 1000
    # phase variants
    phase_period: float = 40.0      # control steps per gait cycle
    w_phase: float = 0.5            # weight of the contact-clock reward
    w_imitation: float = 1.0        # weight of the reference-motion tracking

    @classmethod
    def default(cls) -> "CassieParams":
        return cls()


@dataclasses.dataclass
class CassieTaskState:
    prev_action: torch.Tensor   # (B, 10) for the action-rate cost
    phase: torch.Tensor         # (B,) cyclic phase counter (phase variants)


def make_cassie(
    config: EngineConfig | None = None,
    params: CassieParams | None = None,
    device=None,
    name: str = "CassieEnv",
    planar: bool = False,
    phase_obs: bool = False,
    ref_gait=None,
    reset_obs: str = "zero",
    model=None,
) -> FnEnv:
    """Build a Cassie family on ``device`` (None = the CUDA card), on the
    hand-built Cassie or on ``model`` (the same robot, e.g. loaded from its
    URDF by ``models/assets.load``).
    ``ref_gait`` (``models/cassie_gait.py::GaitTable``) turns a phase variant
    into a reference-motion tracking env: the phase indexes the table, the
    reward adds motor-space tracking of its row and a contact clock that
    follows its stance pattern. ``reset_obs`` picks the foot flags of a fresh
    episode's observation: "zero", or "exact" from the narrowphase."""
    device = resolve_device(device)
    model = (model or cassie.make_model()).to(device)
    initial_z = cassie.initial_z()
    config = config or CASSIE_CONFIG
    params = params or CassieParams.default()
    spec = cassie.constraints()
    if planar:
        spec = dataclasses.replace(spec, planar=True)
    if ref_gait is not None:
        ref_gait = ref_gait.to(device)

    # index tensors made once on the device (a list index would be copied
    # over, and waited for, every step)
    motors = np.nonzero(model.actuated.cpu().numpy() > 0.5)[0]
    motor_idx = torch.as_tensor(motors, dtype=torch.long, device=device)
    n_motors = len(motors)
    stand = torch.as_tensor(cassie.stand_q(model), dtype=torch.float32, device=device)
    pelvis_idx = 0
    nfeet = len(model.foot_links)
    obs_dim = 8 + 2 * model.nj + nfeet + (2 if phase_obs else 0)
    torque_scale = params.w_torque * float(torch.sum(torch.square(model.kp * model.actuated)))

    # motor slot → joint, as a 0 / 1 matrix: one exact product scatters the action
    to_joints = torch.zeros(n_motors, model.nj, device=device)
    to_joints[torch.arange(n_motors, device=device), motor_idx] = 1.0

    def pd_targets(action):
        """action = Δtargets around the stand pose, on the motor joints."""
        return stand + torch.clamp(action, -1.0, 1.0) @ to_joints

    control = make_control_step(
        model, config, constraints=spec, pd_targets=pd_targets,
        extra_damping=model.actuated * model.kd,
    )

    def full_obs(state: EnvState, foot_contact) -> torch.Tensor:
        q, qd = state.q, state.qd
        # walk forward: the "target" is straight ahead (+x), angle 0
        body = T.body_obs(model, q, qd, initial_z, torch.zeros_like(q[:, 0]))
        q_s, qd_s = T.joint_obs(model, q, qd)
        parts = [body, q_s, qd_s, foot_contact]
        if phase_obs:
            ph = 2 * math.pi * state.task.phase / params.phase_period
            parts.append(torch.stack([torch.sin(ph), torch.cos(ph)], dim=1))
        return torch.cat(parts, dim=1)

    def obs_fn(state: EnvState) -> torch.Tensor:
        return full_obs(state, T.reset_foot_flags(model, config.contact_margin, state))

    if reset_obs == "zero":
        def reset_obs_fn(state: EnvState) -> torch.Tensor:
            return full_obs(state, state.q.new_zeros(state.q.shape[0], nfeet))
    elif reset_obs == "exact":
        reset_obs_fn = None
    else:
        raise ValueError(f"unknown reset_obs mode {reset_obs!r}")

    def reset(gen: torch.Generator, reset_count: torch.Tensor, prev=None) -> EnvState:
        B = reset_count.shape[0]
        qj = stand + params.init_noise * rng_mod.uniform(gen, (B, model.nj), -1.0, 1.0)
        qj = torch.maximum(torch.minimum(qj, model.limit_hi), model.limit_lo)
        q = torch.zeros(B, model.nq, device=device)
        q[:, 2] = initial_z + 0.01
        q[:, 3] = 1.0
        q[:, 7:] = qj
        zeros_i = torch.zeros(B, dtype=torch.int32, device=device)
        return EnvState(
            q=q,
            qd=torch.zeros(B, model.nv, device=device),
            reset_count=reset_count.to(torch.int32),
            steps=zeros_i,
            task=CassieTaskState(prev_action=torch.zeros(B, n_motors, device=device),
                                 phase=torch.zeros(B, device=device)),
            scene=scene_mod.flat(B, device),
            done=torch.zeros(B, dtype=torch.bool, device=device),
            blowup_count=zeros_i.clone(),
        )

    def raw_step(state: EnvState, action: torch.Tensor, gen: torch.Generator) -> Transition:
        q, qd, info = control(state.q, state.qd, action, state.scene)

        vx = qd[:, 0]
        speed_err = torch.abs(vx - params.target_speed)
        speed_reward = params.w_speed * torch.exp(-2.0 * torch.square(speed_err))

        rpy = quat_ops.to_rpy(q[:, 3:7])
        orient_cost = params.w_orientation * (torch.square(rpy[:, 0]) + torch.square(rpy[:, 1]))

        rate_cost = params.w_action_rate * torch.mean(
            torch.square(action - state.task.prev_action), dim=1)
        torque_proxy = torque_scale * torch.mean(torch.square(action), dim=1)

        tall = q[:, 2] - state.scene.ground_z > params.terminal_height
        fallen = (~tall) | (info.link_contact[:, pelvis_idx] > 0.5)
        alive = torch.where(
            fallen, torch.full_like(vx, -params.fall_penalty),
            torch.full_like(vx, params.tall_bonus),
        )
        reward = speed_reward + alive - orient_cost - rate_cost - torque_proxy

        phase = torch.remainder(state.task.phase + 1.0, params.phase_period)
        metrics = {}
        if ref_gait is not None:
            # track the table's motor-space row and its stance pattern
            q_ref_dev, stance_ref = ref_gait.at_phase(state.task.phase)
            q_ref = stand[motor_idx] + q_ref_dev
            track_err = torch.mean(torch.square(q[:, 7:][:, motor_idx] - q_ref), dim=1)
            fc = info.foot_contact[:, :2]
            clock_match = torch.mean(torch.where(stance_ref > 0.5, fc, 1.0 - fc), dim=1)
            reward = reward + params.w_imitation * torch.exp(-8.0 * track_err) \
                + params.w_phase * clock_match
            metrics = {"track_err": track_err, "clock_match": clock_match}
        elif phase_obs:
            # clock-only shaping: alternate-foot contact
            ph = 2 * math.pi * state.task.phase / params.phase_period
            fc = info.foot_contact
            match = torch.where(torch.sin(ph) > 0, fc[:, 0], fc[:, 1])
            reward = reward + params.w_phase * match

        steps = state.steps + 1
        done = fallen | (steps >= params.max_steps)
        new_state = dataclasses.replace(
            state, q=q, qd=qd, steps=steps,
            task=CassieTaskState(prev_action=action, phase=phase),
        )
        obs = full_obs(new_state, info.foot_contact)
        metrics = {
            "speed": vx,
            "speed_reward": speed_reward,
            "fallen": fallen.to(q.dtype),
            "pelvis_height": q[:, 2],
            **metrics,
        }
        return Transition(state=new_state, obs=obs, reward=reward, done=done, metrics=metrics)

    return make_fn_env(
        name=name, obs_dim=obs_dim, act_dim=n_motors, reset=reset, raw_step=raw_step,
        obs_fn=obs_fn, control_dt=config.control_dt, device=device, model=model,
        reset_obs_fn=reset_obs_fn,
    )
