"""Walker3DCustomEnv — walk to a target on flat ground, batch-first.

Counterpart of ``mocca_envs_tpu/tasks/walker_custom.py`` with torque or PD
actuation (``pd_control``), ``reset_obs="zero"`` and the flat scene; it also
carries the scaled-model variants (``Child3DCustomEnv``) and, through a
``constraints`` spec with the planar rows, the 2D variants
(``Walker2DCustomEnv``, ``Crab2DCustomEnv``), and, through a
``scene_builder``, the walker over a static scene (``Walker3DStairsEnv``'s
triangle-mesh staircase). Its step also serves the terrain families
(tasks/walker_terrain.py): over a scene with a heightfield or a mesh the
fall test measures the base's height above the surface under it, and a
resampled target is set on that surface.

Episode flow:
- reset: base at (0, 0, initial_z + 0.02), uniform joint-angle noise clipped
  to the limits, target on an annulus ahead of the start;
- step: torques τ = power · power_coef · clip(a), or with ``pd_control``
  joint targets mid + amp · clip(a) served by τ = kp · (target − q) with the
  derivative gain kp / 20 handled implicitly → one control step of physics
  → obs [body(8), scaled joints, 0.1·q̇, foot flags] → reward (potential
  progress + alive bonus − electricity/stall/limit costs + target bonus)
  → termination on a fall or the step cap; a reached target is
  resampled ahead of the walker.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mocca_envs_tpu_torch.core import rng as rng_mod
from mocca_envs_tpu_torch.envs.env import EnvState, FnEnv, Transition, make_fn_env
from mocca_envs_tpu_torch.models import walker3d
from mocca_envs_tpu_torch.models.schema import RobotModel
from mocca_envs_tpu_torch.ops.step import ConstraintSpec, make_control_step
from mocca_envs_tpu_torch.tasks import base as T
from mocca_envs_tpu_torch.terrain import scene as scene_mod
from mocca_envs_tpu_torch.utils.config import EngineConfig
from mocca_envs_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class WalkerParams:
    """Task parameters, the same names and defaults as the JAX package's
    (one value for the whole batch)."""

    power: float = 1.0                  # global actuation scale
    init_joint_noise: float = 0.1       # uniform joint-angle noise at reset
    target_dist_lo: float = 3.0
    target_dist_hi: float = 7.0
    target_angle_range: float = math.pi / 2   # target bearing ~ U(−r, r)
    target_reach_radius: float = 0.25
    terminal_height: float = 0.7        # fall when base z − ground < this
    w_progress: float = 1.0
    tall_bonus: float = 2.0             # +value while upright
    fall_penalty: float = 1.0           # −value on the falling step
    w_electricity: float = 2.0
    w_stall: float = 0.1
    w_limit: float = 0.1
    target_bonus: float = 2.0           # on reaching the target
    max_steps: int = 1000               # episode cap

    @classmethod
    def default(cls) -> "WalkerParams":
        return cls()


@dataclasses.dataclass
class WalkerTaskState:
    target: torch.Tensor      # (B, 3) world target position
    potential: torch.Tensor   # (B,) previous −dist / control_dt


def _obs_dim(model: RobotModel) -> int:
    return 8 + 2 * model.nj + len(model.foot_links)


def make_walker3d_custom(
    config: EngineConfig | None = None,
    params: WalkerParams | None = None,
    model: RobotModel | None = None,
    device=None,
    name: str = "Walker3DCustomEnv",
    initial_z: float | None = None,
    constraints: ConstraintSpec | None = None,
    terminal_link_names: tuple | None = None,
    pd_control: bool = False,
    scene_builder=None,
) -> FnEnv:
    """Build the walk-to-target family on ``device`` (None = the CUDA card).
    ``constraints`` adds equality rows to the physics (the planar lock of the
    2D variants); ``terminal_link_names`` overrides the links whose ground contact ends
    the episode; ``pd_control`` makes actions joint-angle targets;
    ``scene_builder(device)`` makes a one-env static scene in place of the
    flat plane. That scene is built here, once, on the device: every slot
    views it, and a fresh episode keeps its slot's scene, so no step copies
    it or builds it again."""
    device = resolve_device(device)
    model = (model or walker3d.make_model()).to(device)
    config = config or EngineConfig()
    params = params or WalkerParams.default()
    constraints = constraints or ConstraintSpec()
    initial_z = walker3d.INITIAL_Z if initial_z is None else initial_z
    if terminal_link_names is None:
        terminal_links = list(walker3d.terminal_links(model))
    else:
        terminal_links = [model.link_names.index(n) for n in terminal_link_names]
    # an index tensor on the device: indexing with a list would copy it
    # over, and wait for the device, every step
    terminal_links = torch.as_tensor(terminal_links, dtype=torch.long, device=device)
    nfeet = len(model.foot_links)
    static_scene = scene_builder(device) if scene_builder is not None else None

    if pd_control:
        # gains scale with the torque variant's power_coef so that both
        # variants saturate comparably
        mid = 0.5 * (model.limit_lo + model.limit_hi)
        amp = 0.5 * (model.limit_hi - model.limit_lo)
        kp = model.power_coef * (model.actuated > 0).to(model.power_coef.dtype)
        model = model.replace(kp=kp)

        def pd_targets(a):
            return mid + amp * torch.clamp(a, -1.0, 1.0)

        control = make_control_step(model, config, constraints=constraints,
                                    pd_targets=pd_targets, extra_damping=kp / 20.0)

        def cost_action(q_new, a):
            # the energy costs price the PD torque, not the target: one
            # radian of tracking error saturates the normalised torque
            return torch.clamp(pd_targets(a) - q_new[:, 7:], -1.0, 1.0)
    else:
        gain = params.power * model.power_coef * model.actuated

        def actuation(q, qd, a):
            return gain * torch.clamp(a, -1.0, 1.0)

        control = make_control_step(model, config, constraints=constraints,
                                    actuation=actuation)

        def cost_action(q_new, a):
            return a

    def sample_target(gen, base_xy, yaw):
        B = base_xy.shape[0]
        dist = rng_mod.uniform(gen, (B,), params.target_dist_lo, params.target_dist_hi)
        ang = yaw + rng_mod.uniform(
            gen, (B,), -params.target_angle_range, params.target_angle_range
        )
        xy = base_xy + dist[:, None] * torch.stack([torch.cos(ang), torch.sin(ang)], dim=1)
        return torch.cat([xy, xy.new_zeros(B, 1)], dim=1)

    def obs_with_contacts(state: EnvState, foot_contact) -> torch.Tensor:
        q, qd = state.q, state.qd
        to_t = state.task.target[:, :2] - q[:, 0:2]
        angle = torch.atan2(to_t[:, 1], to_t[:, 0]) - T.heading_yaw(q)
        body = T.body_obs(model, q, qd, initial_z, angle)
        q_s, qd_s = T.joint_obs(model, q, qd)
        return torch.cat([body, q_s, qd_s, foot_contact], dim=1)

    def reset_obs_fn(state: EnvState) -> torch.Tensor:
        # the spawn is airborne by construction: zero flags are exact
        return obs_with_contacts(state, state.q.new_zeros(state.q.shape[0], nfeet))

    def reset(gen: torch.Generator, reset_count: torch.Tensor, prev=None) -> EnvState:
        B = reset_count.shape[0]
        noise = params.init_joint_noise * rng_mod.uniform(gen, (B, model.nj), -1.0, 1.0)
        qj = torch.maximum(torch.minimum(noise, model.limit_hi), model.limit_lo)
        q = torch.zeros(B, model.nq, device=device)
        q[:, 2] = initial_z + 0.02
        q[:, 3] = 1.0
        q[:, 7:] = qj
        target = sample_target(gen, q[:, 0:2], torch.zeros(B, device=device))
        dist = torch.linalg.vector_norm(target[:, :2] - q[:, 0:2], dim=1)
        zeros_i = torch.zeros(B, dtype=torch.int32, device=device)
        return EnvState(
            q=q,
            qd=torch.zeros(B, model.nv, device=device),
            reset_count=reset_count.to(torch.int32),
            steps=zeros_i,
            task=WalkerTaskState(target=target, potential=-dist / config.control_dt),
            scene=(scene_mod.flat(B, device) if static_scene is None
                   else prev.scene if prev is not None
                   else scene_mod.broadcast_scene(static_scene, B)),
            done=torch.zeros(B, dtype=torch.bool, device=device),
            blowup_count=zeros_i.clone(),
        )

    def surface_z(scene, xy):
        # the ground under ``xy``: the heightfield where the scene has one
        # (the terrain families reuse this step), the highest mesh face
        # over it (the stairs), else the plane
        if scene.has_hf:
            return scene_mod.hf_sample(scene, xy)
        if scene.has_tris:
            return scene_mod.tri_surface_z(scene, xy)
        return scene.ground_z

    def raw_step(state: EnvState, action: torch.Tensor, gen: torch.Generator) -> Transition:
        q, qd, info = control(state.q, state.qd, action, state.scene)

        dist = torch.linalg.vector_norm(state.task.target[:, :2] - q[:, 0:2], dim=1)
        potential = -dist / config.control_dt
        progress = params.w_progress * (potential - state.task.potential)

        # height above the LOCAL surface: a raw q[2] test over a heightfield
        # would end episodes in valleys and miss falls on hills
        tall = q[:, 2] - surface_z(state.scene, q[:, 0:2]) > params.terminal_height
        body_touch = info.link_contact[:, terminal_links].amax(dim=1)
        fallen = (~tall) | (body_touch > 0.5)

        reached = dist < params.target_reach_radius
        new_target = sample_target(gen, q[:, 0:2], T.heading_yaw(q))
        if state.scene.has_hf:
            # a resampled target sits on the terrain (reset does the same in
            # tasks/walker_terrain.py)
            new_target[:, 2] = scene_mod.hf_sample(state.scene, new_target[:, :2])
        elif state.scene.has_tris:
            new_target[:, 2] = scene_mod.tri_surface_z(state.scene, new_target[:, :2])
        target = torch.where(reached[:, None], new_target, state.task.target)
        dist_after = torch.linalg.vector_norm(target[:, :2] - q[:, 0:2], dim=1)
        potential = -dist_after / config.control_dt

        alive = torch.where(
            fallen, torch.full_like(dist, -params.fall_penalty),
            torch.full_like(dist, params.tall_bonus),
        )
        costs = T.energy_costs(model, cost_action(q, action), qd, params.w_electricity,
                               params.w_stall) \
            + T.joints_at_limit_cost(model, q, params.w_limit)
        reward = progress + alive - costs + params.target_bonus * reached.to(q.dtype)

        steps = state.steps + 1
        done = fallen | (steps >= params.max_steps)
        new_state = dataclasses.replace(
            state, q=q, qd=qd, steps=steps,
            task=WalkerTaskState(target=target, potential=potential),
        )
        obs = obs_with_contacts(new_state, info.foot_contact)
        metrics = {
            "progress": progress,
            "dist_to_target": dist,
            "reached_target": reached.to(q.dtype),
            "fallen": fallen.to(q.dtype),
            "episode_steps": steps.to(torch.float32),
        }
        return Transition(state=new_state, obs=obs, reward=reward, done=done, metrics=metrics)

    def obs_fn(state: EnvState) -> torch.Tensor:
        # exact frame-0 contact flags from the narrowphase predicate
        return obs_with_contacts(
            state, T.reset_foot_flags(model, config.contact_margin, state))

    return make_fn_env(
        name=name, obs_dim=_obs_dim(model), act_dim=model.nj, reset=reset,
        raw_step=raw_step, obs_fn=obs_fn, control_dt=config.control_dt,
        device=device, mirror=T.mirror_spec(model), model=model,
        reset_obs_fn=reset_obs_fn,
    )
