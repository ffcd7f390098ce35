"""CassieEnv's step, plain: the PD-servoed closed-chain biped walking
forward at a target speed.

Frozen copy of the 3D, phase-free path of the port's
``tasks/cassie_task.py``: the policy's 10 motor targets around the stand
pose, a PD servo whose proportional torque is refreshed every llc frame
and whose derivative gain rides the implicit damping, the achilles rods as
equality rows every substep → obs [body(8), scaled joints, 0.1·q̇, foot
flags] → reward (speed tracking + alive bonus − orientation, action-rate
and torque costs) → termination on a fall or the step cap. A done slot's
fresh episode is judged by :meth:`Cassie.reset_ok`.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import cassie
from benchmark.reference import quat as quat_ops
from benchmark.reference import terms as T
from benchmark.reference.step import EngineConfig, make_control_step

EPS = 1e-5


class Cassie:
    """The reference of one configuration file (``config``: its ``engine``,
    ``scene`` and ``task`` blocks), on ``device``."""

    task_fields = ("prev_action", "phase")

    def __init__(self, config: dict, device):
        self.device = torch.device(device)
        self.engine = EngineConfig(**{k: tuple(v) if isinstance(v, list) else v
                                      for k, v in config["engine"].items()})
        self.p = config["task"]
        self.ground_z = float(config["scene"]["ground_z"])
        self.friction = float(config["scene"]["friction"])
        model = cassie.make_model().to(self.device)
        self.model = model
        self.initial_z = cassie.initial_z()
        motors = np.nonzero(model.actuated.cpu().numpy() > 0.5)[0]
        self.motor_idx = torch.as_tensor(motors, dtype=torch.long, device=self.device)
        self.act_dim = len(motors)
        self.obs_dim = 8 + 2 * model.nj + len(model.foot_links)
        self.stand = torch.as_tensor(cassie.stand_q(model), dtype=torch.float32,
                                     device=self.device)
        self.torque_scale = self.p["w_torque"] * float(
            torch.sum(torch.square(model.kp * model.actuated)))
        to_joints = torch.zeros(self.act_dim, model.nj, device=self.device)
        to_joints[torch.arange(self.act_dim, device=self.device), self.motor_idx] = 1.0
        self.to_joints = to_joints
        self.control = make_control_step(model, self.engine, constraints=cassie.constraints(),
                                         pd_targets=self.pd_targets,
                                         extra_damping=model.actuated * model.kd)

    def pd_targets(self, action):
        """action = Δtargets around the stand pose, on the motor joints."""
        return self.stand + torch.clamp(action, -1.0, 1.0) @ self.to_joints

    def unit_inputs(self, pre: dict, action):
        """The launch unit's (q, qd, joint targets) of this step."""
        return pre["q"], pre["qd"], self.pd_targets(action)

    def unit_spec(self):
        """(equality rows, PD mode, extra damping) of the launch unit."""
        return cassie.constraints(), True, self.model.actuated * self.model.kd

    def scene(self, B: int):
        z = torch.full((B,), self.ground_z, dtype=torch.float32, device=self.device)
        return z, torch.full((B,), self.friction, dtype=torch.float32, device=self.device)

    def _obs(self, q, qd, foot_contact):
        body = T.body_obs(self.model, q, qd, self.initial_z, torch.zeros_like(q[:, 0]))
        q_s, qd_s = T.joint_obs(self.model, q, qd)
        return torch.cat([body, q_s, qd_s, foot_contact], dim=1)

    def step(self, pre: dict, action, post: dict) -> dict:
        """The raw step of each slot from its state before the step
        (``post`` is not read: no draw happens inside a Cassie step)."""
        p = self.p
        q, qd, info = self.control(pre["q"], pre["qd"], action, *self.scene(action.shape[0]))
        vx = qd[:, 0]
        speed_reward = p["w_speed"] * torch.exp(-2.0 * torch.square(torch.abs(
            vx - p["target_speed"])))
        rpy = quat_ops.to_rpy(q[:, 3:7])
        orient_cost = p["w_orientation"] * (torch.square(rpy[:, 0]) + torch.square(rpy[:, 1]))
        rate_cost = p["w_action_rate"] * torch.mean(
            torch.square(action - pre["task.prev_action"]), dim=1)
        torque_proxy = self.torque_scale * torch.mean(torch.square(action), dim=1)
        tall = q[:, 2] - self.ground_z > p["terminal_height"]
        fallen = (~tall) | (info.link_contact[:, 0] > 0.5)
        alive = torch.where(fallen, torch.full_like(vx, -p["fall_penalty"]),
                            torch.full_like(vx, p["tall_bonus"]))
        steps = pre["steps"] + 1
        return {
            "q": q, "qd": qd,
            "reward": speed_reward + alive - orient_cost - rate_cost - torque_proxy,
            "done": fallen | (steps >= p["max_steps"]),
            "obs": self._obs(q, qd, info.foot_contact),
            "steps": steps,
            "task.prev_action": action,
            "task.phase": torch.remainder(pre["task.phase"] + 1.0, p["phase_period"]),
        }

    def reset_obs(self, post: dict):
        """The observation of a fresh episode: zero foot flags."""
        q = post["q"]
        return self._obs(q, post["qd"], q.new_zeros(q.shape[0], len(self.model.foot_links)))

    def reset_ok(self, post: dict):
        """Each slot's state is a fresh episode as the reset draws it."""
        m = self.model
        q, qd = post["q"], post["qd"]
        qj = q[:, 7:]
        pose = ((q[:, 0:2] == 0).all(dim=1) & (q[:, 2] == self.initial_z + 0.01)
                & (q[:, 3] == 1) & (q[:, 4:7] == 0).all(dim=1))
        joints = (((qj - self.stand).abs() <= self.p["init_noise"] + EPS) & (qj >= m.limit_lo)
                  & (qj <= m.limit_hi)).all(dim=1)
        return (pose & joints & (qd == 0).all(dim=1) & (post["steps"] == 0)
                & (post["task.prev_action"] == 0).all(dim=1) & (post["task.phase"] == 0))

    def carry_ok(self, post: dict, ref: dict):
        """The task state of a slot that goes on: the action it took and
        its phase one on."""
        return ((post["task.prev_action"] == ref["task.prev_action"]).all(dim=1)
                & (post["task.phase"] == ref["task.phase"]))
