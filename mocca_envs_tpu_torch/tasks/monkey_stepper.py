"""Monkey3DStepperEnv — brachiation along a chain of handholds, batch-first.

Counterpart of ``mocca_envs_tpu/tasks/monkey_stepper.py``.

- a chain of overhead bars is sampled at reset (:func:`bars_from_draws`)
  at each env's own curriculum stage; the bars are solid capsules of the
  scene over a plane far below (z = −8), and the body starts hanging by its
  right hand from bar 0;
- the action is ``[joint torques (nj), grab_right, grab_left]``: a grab
  signal > 0 attaches a free hand whose palm is within ``GRAB_RADIUS`` of a
  bar, at the closest point of the nearest bar, < 0 releases a holding hand.
  An attached hand is a maskable world-anchor grab row of the engine
  (models/monkey.py::constraints), its activity and anchor per-env data;
- a bar counts as reached when a hand newly attaches to the target bar: a
  hit pays a bonus and advances the target; the episode ends on a fall,
  after the last bar (success), at the step cap or after
  ``progress_timeout`` steps without a hit; an env that ends an episode at
  or past ``adv_threshold`` bars starts its next one a stage higher.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mocca_envs_tpu_torch.core import rng as rng_mod
from mocca_envs_tpu_torch.envs.env import EnvState, FnEnv, Transition, make_fn_env
from mocca_envs_tpu_torch.models import monkey
from mocca_envs_tpu_torch.models.schema import RobotModel
from mocca_envs_tpu_torch.ops.kinematics import make_link_poses
from mocca_envs_tpu_torch.ops.step import ConstraintSpec, make_control_step
from mocca_envs_tpu_torch.tasks import base as T
from mocca_envs_tpu_torch.terrain import scene as scene_mod
from mocca_envs_tpu_torch.utils.config import EngineConfig
from mocca_envs_tpu_torch.utils.device import resolve_device

DEG = math.pi / 180.0
GROUND_Z = -8.0   # the plane far under the bars: a body that falls ends its episode

# the hanging pose: the grabbing arm overhead, the other reaching, legs tucked
HANG_POSE = {
    "right_shoulder_y": 3.0, "left_shoulder_y": 2.6,
    "right_elbow": -0.1, "left_elbow": -0.3,
    "right_hip": 0.4, "left_hip": 0.4,
    "right_knee": 0.6, "left_knee": 0.6,
}


@dataclasses.dataclass(frozen=True)
class MonkeyParams:
    """Task parameters, the same names and defaults as the JAX package's
    (one value for the whole batch; the stage itself is per-env data)."""

    num_bars: int = 16
    stage: float = 0.0              # the stage fresh batches start at
    max_stage: float = 9.0
    # bar spacing ramps with the stage: stage-0 bars sit within reach of
    # both arms, the last stages force a release, a swing and a regrasp
    r_lo_start: float = 0.35
    r_lo_end: float = 0.55
    r_hi_start: float = 0.45
    r_hi_end: float = 1.1
    yaw_max_end: float = 20.0 * DEG
    pitch_max_end: float = 30.0 * DEG
    power: float = 1.0
    init_noise: float = 0.05
    w_progress: float = 1.0
    alive_bonus: float = 1.0
    w_electricity: float = 1.0
    w_stall: float = 0.05
    bar_bonus: float = 6.0
    success_bonus: float = 20.0
    fall_z: float = -1.8
    # bars reached at the episode's end that advance the env's own stage at
    # its auto-reset (≥ num_bars disables it)
    adv_threshold: float = 14.0
    max_steps: int = 1000
    # control steps after the last hit for which the alive bonus still pays
    hold_grace: int = 10_000
    # weight of the horizontal speed toward the next bar while holding
    w_swing: float = 0.0
    # control steps without a hit that end the episode
    progress_timeout: int = 1_000_000

    def set_curriculum(self, stage) -> "MonkeyParams":
        return dataclasses.replace(self, stage=float(stage))


@dataclasses.dataclass
class MonkeyTaskState:
    bar_pos: torch.Tensor     # (B, K, 3) bar centers
    bar_dir: torch.Tensor     # (B, K, 3) unit bar axes (horizontal)
    next_bar: torch.Tensor    # (B,) int32 index of the target bar
    attached: torch.Tensor    # (B, 2) 1.0 = the hand holds
    anchor: torch.Tensor      # (B, 2, 3) world anchor of each hand
    hold_bar: torch.Tensor    # (B, 2) int32 bar each hand holds (−1: none)
    potential: torch.Tensor   # (B,) −dist(root → target) / control_dt
    stage: torch.Tensor       # (B,) curriculum stage, carried across auto-resets
    since_hit: torch.Tensor   # (B,) int32 control steps since the last hit


def set_stage(state: EnvState, stage) -> EnvState:
    """Curriculum setter on a batched env state: a scalar or a per-env array;
    it takes effect at each env's next reset."""
    old = state.task.stage
    new = torch.broadcast_to(torch.as_tensor(stage, dtype=old.dtype, device=old.device),
                             old.shape).clone()
    return dataclasses.replace(state, task=dataclasses.replace(state.task, stage=new))


def bars_from_draws(params: MonkeyParams, stage: torch.Tensor, draws: torch.Tensor):
    """The bar chain from unit-uniform ``draws`` (B, 3, K) — rows spacing,
    heading change, pitch — at per-env ``stage`` (B,). Bar 0 sits at the
    origin; the first two increments are level and straight ahead. Returns
    ``(centers (B, K, 3), unit horizontal axes (B, K, 3))``."""
    K = params.num_bars
    frac = torch.clamp(stage / max(params.max_stage, 1.0), 0.0, 1.0)[:, None]   # (B, 1)
    r_lo = params.r_lo_start + frac * (params.r_lo_end - params.r_lo_start)
    r_hi = params.r_hi_start + frac * (params.r_hi_end - params.r_hi_start)
    yaw_max = frac * params.yaw_max_end
    pitch_max = frac * params.pitch_max_end
    r = r_lo + (r_hi - r_lo) * draws[:, 0]
    dyaw = -yaw_max + (2.0 * yaw_max) * draws[:, 1]
    pitch = -pitch_max + (2.0 * pitch_max) * draws[:, 2]
    easy = torch.arange(K, device=draws.device) < 2
    zero = torch.zeros_like(r)
    r = torch.where(easy, 0.5 * (r_lo + r_hi), r)
    dyaw = torch.where(easy, zero, dyaw)
    pitch = torch.where(easy, zero, pitch)
    heading = torch.cumsum(dyaw, dim=1)
    delta = r[..., None] * torch.stack(
        [torch.cos(heading) * torch.cos(pitch), torch.sin(heading) * torch.cos(pitch),
         torch.sin(pitch)], dim=-1)
    pos = torch.cat([torch.zeros_like(delta[:, :1]), torch.cumsum(delta[:, 1:], dim=1)], dim=1)
    bar_dir = torch.stack([-torch.sin(heading), torch.cos(heading), zero], dim=-1)
    return pos, bar_dir


def sample_bars(params: MonkeyParams, gen: torch.Generator, stage: torch.Tensor):
    """Sample one chain per env: one (B, 3, K) unit-uniform draw from ``gen``."""
    draws = rng_mod.uniform(gen, (stage.shape[0], 3, params.num_bars), 0.0, 1.0)
    return bars_from_draws(params, stage, draws)


def closest_on_bar(bar_pos, bar_dir, p, half_len: float = monkey.BAR_HALF_LEN):
    """The point of the bar segment closest to ``p``; broadcasts over leading
    dimensions (vectors on the last one)."""
    t = torch.clamp(((p - bar_pos) * bar_dir).sum(-1, keepdim=True), -half_len, half_len)
    return bar_pos + t * bar_dir


def bar_scene(bar_pos, bar_dir) -> scene_mod.Scene:
    """The handhold chain as solid capsules over the plane at ``GROUND_Z``."""
    ext = monkey.BAR_HALF_LEN * bar_dir
    return scene_mod.with_bars(bar_pos - ext, bar_pos + ext,
                               torch.full_like(bar_pos[..., 0], monkey.BAR_RADIUS),
                               ground_z=GROUND_Z)


def make_palm_positions(model: RobotModel, spec: ConstraintSpec):
    """Build ``palms(q) → (B, 2, 3)``: the world palm points of the two grab
    links, right then left, from the links' own chains
    (kinematics.make_link_poses); the constants are made once."""
    poses = make_link_poses(model, spec.grab_links)
    palm = torch.as_tensor(monkey.PALM_OFFSET, dtype=torch.float32, device=model.device)

    def palms(q):
        pos, rot = poses(q)
        return pos + rot @ palm

    return palms


def hang_qj(model: RobotModel) -> torch.Tensor:
    """Joint angles (nj,) of :data:`HANG_POSE` (zero elsewhere)."""
    qj = torch.zeros(model.nj, device=model.device)
    for j, n in enumerate(model.joint_names):
        if n in HANG_POSE:
            qj[j] = HANG_POSE[n]
    return qj


def hang_from(palms, qj, bar_pos, bar_dir):
    """The body upright at joint angles ``qj`` (B, nj), its base placed so
    that the right palm lies on the bar ``(bar_pos, bar_dir)`` (B, 3) each;
    ``palms`` is a :func:`make_palm_positions` function. Returns ``(q (B,
    nq), the point of the bar under the palm (B, 3))``."""
    q = qj.new_zeros(qj.shape[0], qj.shape[1] + 7)
    q[:, 3] = 1.0
    q[:, 7:] = qj
    palm = palms(q)[:, 0]
    on_bar = closest_on_bar(bar_pos, bar_dir, palm)
    q[:, 0:3] = on_bar - palm
    # the palm moved onto the bar with the base: the JAX package takes the
    # anchor from a second FK there, which gives this point up to rounding
    return q, on_bar


def make_monkey3d_stepper(
    config: EngineConfig | None = None,
    params: MonkeyParams | None = None,
    device=None,
    name: str = "Monkey3DStepperEnv",
    model=None,
) -> FnEnv:
    """Build the brachiation family on ``device`` (None = the CUDA card), on
    the hand-built monkey or on ``model`` (the same robot, e.g. loaded from
    its URDF by ``models/assets.load``)."""
    device = resolve_device(device)
    model = (model or monkey.make_model()).to(device)
    config = config or EngineConfig()
    params = params or MonkeyParams()
    spec = monkey.constraints()
    K = params.num_bars
    nj = model.nj
    gain = params.power * model.power_coef * model.actuated
    hang = hang_qj(model)
    palms_of = make_palm_positions(model, spec)

    def actuation(q, qd, action):
        return gain * torch.clamp(action[:, :nj], -1.0, 1.0)

    control = make_control_step(model, config, constraints=spec, actuation=actuation)
    obs_dim = 8 + 2 * nj + 2 + 6   # body, joints, hand-hold flags, the next two bars

    def _row(arr, idx):
        """arr[b, idx[b]] for (B, K, D) ``arr`` and (B,) ``idx``."""
        return torch.gather(arr, 1, idx.long()[:, None, None].expand(-1, 1, arr.shape[-1]))[:, 0]

    def full_obs(state: EnvState) -> torch.Tensor:
        q, qd, task = state.q, state.qd, state.task
        yaw = T.heading_yaw(q)
        i0 = torch.clamp(task.next_bar, max=K - 1)
        i1 = torch.clamp(task.next_bar + 1, max=K - 1)
        tgt = _row(task.bar_pos, i0)
        to_t = tgt[:, :2] - q[:, 0:2]
        angle = torch.atan2(to_t[:, 1], to_t[:, 0]) - yaw
        body = T.body_obs(model, q, qd, monkey.INITIAL_Z, angle)
        q_s, qd_s = T.joint_obs(model, q, qd)
        rel0 = T.to_heading_frame(yaw, tgt - q[:, 0:3])
        rel1 = T.to_heading_frame(yaw, _row(task.bar_pos, i1) - q[:, 0:3])
        return torch.cat([body, q_s, qd_s, task.attached, rel0, rel1], dim=1)

    def reset(gen: torch.Generator, reset_count: torch.Tensor, prev=None) -> EnvState:
        # draws: the joint noise (B, nj), then the bar chain (B, 3, K)
        B = reset_count.shape[0]
        if prev is None:
            stage = torch.full((B,), params.stage, dtype=torch.float32, device=device)
        else:
            adv = prev.task.next_bar.to(torch.float32) >= params.adv_threshold
            stage = torch.clamp(prev.task.stage + adv.to(torch.float32), max=params.max_stage)
        noise = params.init_noise * rng_mod.uniform(gen, (B, nj), -1.0, 1.0)
        bar_pos, bar_dir = sample_bars(params, gen, stage)
        qj = torch.maximum(torch.minimum(hang + noise, model.limit_hi), model.limit_lo)
        q, on_bar = hang_from(palms_of, qj, bar_pos[:, 0], bar_dir[:, 0])
        anchor = torch.zeros(B, 2, 3, device=device)
        anchor[:, 0] = on_bar
        attached = torch.zeros(B, 2, device=device)
        attached[:, 0] = 1.0                               # hanging by the right hand
        hold_bar = torch.full((B, 2), -1, dtype=torch.int32, device=device)
        hold_bar[:, 0] = 0
        zeros_i = torch.zeros(B, dtype=torch.int32, device=device)
        task = MonkeyTaskState(
            bar_pos=bar_pos, bar_dir=bar_dir,
            next_bar=torch.ones(B, dtype=torch.int32, device=device),
            attached=attached, anchor=anchor, hold_bar=hold_bar,
            potential=-torch.linalg.vector_norm(bar_pos[:, 1] - q[:, 0:3], dim=1)
            / config.control_dt,
            stage=stage, since_hit=zeros_i.clone(),
        )
        return EnvState(
            q=q, qd=torch.zeros(B, model.nv, device=device),
            reset_count=reset_count.to(torch.int32), steps=zeros_i, task=task,
            scene=bar_scene(bar_pos, bar_dir),
            done=torch.zeros(B, dtype=torch.bool, device=device),
            blowup_count=zeros_i.clone(),
        )

    def raw_step(state: EnvState, action: torch.Tensor, gen: torch.Generator) -> Transition:
        task = state.task
        grab_sig = action[:, nj:]                                   # (B, 2)

        # ---- grab / release from the current pose: each palm against every
        # bar at once, (B, 2, K)
        palms = palms_of(state.q)                                   # (B, 2, 3)
        p = palms[:, :, None, :]
        closest = closest_on_bar(task.bar_pos[:, None], task.bar_dir[:, None], p)
        d = torch.linalg.vector_norm(closest - p, dim=-1)
        near = torch.argmin(d, dim=2)                               # the first of equals
        held = task.attached > 0.5
        new_attach = ~held & (grab_sig > 0.0) & (d.amin(dim=2) < monkey.GRAB_RADIUS)
        release = held & (grab_sig < 0.0)
        attached = torch.where(new_attach, 1.0, torch.where(release, 0.0, task.attached))
        grab_at = torch.gather(closest, 2, near[:, :, None, None].expand(-1, -1, 1, 3))[:, :, 0]
        anchor = torch.where(new_attach[..., None], grab_at, task.anchor)
        hold_bar = torch.where(new_attach, near.to(torch.int32),
                               torch.where(release, -1, task.hold_bar))

        q, qd, _ = control(state.q, state.qd, action, state.scene,
                           grab_active=attached, grab_target=anchor)

        # ---- bar-advance machine: a new grab on the target bar scores
        tgt_idx = torch.clamp(task.next_bar, max=K - 1)
        hit = (new_attach & (near == tgt_idx[:, None])).any(dim=1)
        success = hit & (task.next_bar >= K - 1)
        next_bar = torch.where(hit, torch.clamp(task.next_bar + 1, max=K - 1), task.next_bar)

        new_tgt = _row(task.bar_pos, torch.clamp(next_bar, max=K - 1))
        potential = -torch.linalg.vector_norm(new_tgt - q[:, 0:3], dim=1) / config.control_dt
        zero = torch.zeros_like(potential)
        progress = torch.where(hit, zero, params.w_progress * (potential - task.potential))

        holding = attached.amax(dim=1) > 0.5
        fell = q[:, 2] < params.fall_z
        costs = T.energy_costs(model, action[:, :nj], qd, params.w_electricity, params.w_stall)
        since_hit = torch.where(hit, 0, task.since_hit + 1)
        alive_ok = holding & (since_hit < params.hold_grace)
        to_tgt = new_tgt[:, 0:2] - q[:, 0:2]
        tgt_dir = to_tgt / torch.clamp(torch.linalg.vector_norm(to_tgt, dim=1), min=1e-6)[:, None]
        swing = params.w_swing * torch.clamp((qd[:, 0:2] * tgt_dir).sum(dim=1), min=0.0) \
            * holding.to(q.dtype)
        reward = (progress + torch.where(alive_ok, params.alive_bonus, zero) + swing - costs
                  + params.bar_bonus * hit.to(q.dtype)
                  + params.success_bonus * success.to(q.dtype))

        steps = state.steps + 1
        done = fell | success | (steps >= params.max_steps) | (since_hit >= params.progress_timeout)
        new_state = dataclasses.replace(
            state, q=q, qd=qd, steps=steps,
            task=dataclasses.replace(task, next_bar=next_bar, attached=attached, anchor=anchor,
                                     hold_bar=hold_bar, potential=potential,
                                     since_hit=since_hit),
        )
        metrics = {
            "bars_reached": next_bar.to(torch.float32),
            "holding": attached.sum(dim=1),
            "bar_hit": hit.to(q.dtype),
            "success": success.to(q.dtype),
            "fell": fell.to(q.dtype),
        }
        return Transition(state=new_state, obs=full_obs(new_state), reward=reward, done=done,
                          metrics=metrics)

    return make_fn_env(
        name=name, obs_dim=obs_dim, act_dim=nj + 2, reset=reset, raw_step=raw_step,
        obs_fn=full_obs, control_dt=config.control_dt, device=device, model=model,
    )
