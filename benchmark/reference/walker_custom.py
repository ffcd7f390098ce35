"""Walker3DCustomEnv's step, plain: walk to a target on flat ground under
torque control.

Frozen copy of the torque path of the port's ``tasks/walker_custom.py``:
torques τ = power · power_coef · clip(a) → one control step of the plain
physics → obs [body(8), scaled joints, 0.1·q̇, foot flags] → reward
(potential progress + alive bonus − electricity / stall / limit costs +
target bonus) → termination on a fall or the step cap. It computes the raw
step of a slot; the fresh episode that auto-reset puts into a done slot is
random, so it is judged by :meth:`WalkerCustom.reset_ok` against the draws
the configuration states.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import terms as T
from benchmark.reference import walker3d
from benchmark.reference.step import ConstraintSpec, EngineConfig, make_control_step

# rounding room of the reset checks: the draws are float32 and go through
# one clamp, one product and one sum
EPS = 1e-5


class WalkerCustom:
    """The reference of one configuration file (``config``: its ``engine``,
    ``scene`` and ``task`` blocks), on ``device``."""

    task_fields = ("target", "potential")

    def __init__(self, config: dict, device):
        self.device = torch.device(device)
        self.engine = EngineConfig(**{k: tuple(v) if isinstance(v, list) else v
                                      for k, v in config["engine"].items()})
        self.p = config["task"]
        self.ground_z = float(config["scene"]["ground_z"])
        self.friction = float(config["scene"]["friction"])
        model = walker3d.make_model().to(self.device)
        self.model = model
        self.initial_z = walker3d.INITIAL_Z
        self.terminal = torch.as_tensor(walker3d.terminal_links(model), dtype=torch.long,
                                        device=self.device)
        self.gain = self.p["power"] * model.power_coef * model.actuated
        self.act_dim = model.nj
        self.obs_dim = 8 + 2 * model.nj + len(model.foot_links)
        self.control = make_control_step(model, self.engine, actuation=self.actuation)

    def actuation(self, q, qd, a):
        return self.gain * torch.clamp(a, -1.0, 1.0)

    def unit_inputs(self, pre: dict, action):
        """The first launch unit's (q, qd, torques) of this step."""
        return pre["q"], pre["qd"], self.actuation(pre["q"], pre["qd"], action)

    def unit_spec(self):
        """(equality rows, PD mode, extra damping) of the launch unit."""
        return ConstraintSpec(), False, None

    def scene(self, B: int):
        z = torch.full((B,), self.ground_z, dtype=torch.float32, device=self.device)
        return z, torch.full((B,), self.friction, dtype=torch.float32, device=self.device)

    def _obs(self, q, qd, target, foot_contact):
        to_t = target[:, :2] - q[:, 0:2]
        angle = torch.atan2(to_t[:, 1], to_t[:, 0]) - T.heading_yaw(q)
        body = T.body_obs(self.model, q, qd, self.initial_z, angle)
        q_s, qd_s = T.joint_obs(self.model, q, qd)
        return torch.cat([body, q_s, qd_s, foot_contact], dim=1)

    def step(self, pre: dict, action, post: dict) -> dict:
        """The raw step of each slot from its state before the step. A slot
        that reaches its target draws a new one: the observation is then
        made towards the program's new target (``post``), which
        :meth:`carry_ok` judges."""
        p, m = self.p, self.model
        dt = self.engine.control_dt
        q, qd, info = self.control(pre["q"], pre["qd"], action, *self.scene(action.shape[0]))
        target0 = pre["task.target"]
        dist = torch.linalg.vector_norm(target0[:, :2] - q[:, 0:2], dim=1)
        progress = p["w_progress"] * (-dist / dt - pre["task.potential"])
        tall = q[:, 2] - self.ground_z > p["terminal_height"]
        body_touch = info.link_contact[:, self.terminal].amax(dim=1)
        fallen = (~tall) | (body_touch > 0.5)
        reached = dist < p["target_reach_radius"]
        alive = torch.where(fallen, torch.full_like(dist, -p["fall_penalty"]),
                            torch.full_like(dist, p["tall_bonus"]))
        costs = T.energy_costs(m, action, qd, p["w_electricity"], p["w_stall"]) \
            + T.joints_at_limit_cost(m, q, p["w_limit"])
        reward = progress + alive - costs + p["target_bonus"] * reached.to(q.dtype)
        steps = pre["steps"] + 1
        target = torch.where(reached[:, None], post["task.target"], target0)
        return {
            "q": q, "qd": qd, "reward": reward,
            "done": fallen | (steps >= p["max_steps"]),
            "obs": self._obs(q, qd, target, info.foot_contact),
            "steps": steps, "reached": reached, "task.target": target0,
        }

    def reset_obs(self, post: dict):
        """The observation of a fresh episode: zero foot flags (the spawn is
        airborne)."""
        q = post["q"]
        return self._obs(q, post["qd"], post["task.target"],
                         q.new_zeros(q.shape[0], len(self.model.foot_links)))

    def _target_ok(self, q, target, yaw):
        """A target drawn ahead of the base: its distance in [lo, hi], its
        bearing within the angle range of ``yaw``, on the plane."""
        p = self.p
        d = target[:, :2] - q[:, 0:2]
        dist = torch.linalg.vector_norm(d, dim=1)
        bearing = torch.remainder(torch.atan2(d[:, 1], d[:, 0]) - yaw + math.pi,
                                  2 * math.pi) - math.pi
        return ((dist >= p["target_dist_lo"] - EPS) & (dist <= p["target_dist_hi"] + EPS)
                & (bearing.abs() <= p["target_angle_range"] + EPS) & (target[:, 2] == 0))

    def reset_ok(self, post: dict):
        """Each slot's state is a fresh episode as the reset draws it."""
        p, m = self.p, self.model
        q, qd = post["q"], post["qd"]
        qj = q[:, 7:]
        pose = ((q[:, 0:2] == 0).all(dim=1) & (q[:, 2] == self.initial_z + 0.02)
                & (q[:, 3] == 1) & (q[:, 4:7] == 0).all(dim=1))
        joints = ((qj.abs() <= p["init_joint_noise"] + EPS) & (qj >= m.limit_lo)
                  & (qj <= m.limit_hi)).all(dim=1)
        target = post["task.target"]
        dist = torch.linalg.vector_norm(target[:, :2] - q[:, 0:2], dim=1)
        potential = torch.isclose(post["task.potential"], -dist / self.engine.control_dt,
                                  rtol=EPS, atol=0.0)
        return (pose & joints & (qd == 0).all(dim=1) & (post["steps"] == 0)
                & self._target_ok(q, target, torch.zeros_like(dist)) & potential)

    def carry_ok(self, post: dict, ref: dict):
        """The task state of a slot that goes on: the target kept, or,
        where the reference reached it, drawn anew ahead of the program's
        base; its potential the program's distance to it. A slot whose
        program and reference part on reaching counts as not ok."""
        target = post["task.target"]
        kept = (target == ref["task.target"]).all(dim=1)
        drawn = self._target_ok(post["q"], target, T.heading_yaw(post["q"]))
        dist = torch.linalg.vector_norm(target[:, :2] - post["q"][:, 0:2], dim=1)
        potential = torch.isclose(post["task.potential"], -dist / self.engine.control_dt,
                                  rtol=EPS, atol=0.0)
        return torch.where(ref["reached"], drawn, kept) & potential
