"""Parity harness: trajectory interchange format, recorder, replayer.

Counterpart of ``mocca_envs_tpu/harness/parity.py``, writing and reading
the same npz files, so that a recording made by either package (or by the
pybullet recorder, harness/parity_record_pybullet.py) loads in the other:

    meta (JSON string): env_id, seed, engine, model_hash, control_dt,
                        format_version (+ dt, sim_substeps, llc_frames,
                        solver_iters, friction for a raw recording)
    per-step arrays:    q (T+1, nq), qd (T+1, nv), action (T, nu),
                        obs (T, obs_dim), reward (T,), done (T,)

one episode, no batch axis. Base quaternions in FILES are pybullet's xyzw,
scalar last (core/quat.to_xyzw at the boundary).

``record`` / ``replay_check`` run a task env from a seed: the port's seeds
drive ``torch.Generator`` draws (core/rng.py), which the JAX package's
threefry keys cannot reproduce, so these two are a determinism gate within
the port. ``record_raw`` / ``replay_check_raw`` run raw physics from the
recording's own ``q[0]``, ``qd[0]`` and torques, so they are the gate
across packages and engines. Tolerance gates grow per step
(``atol · growth^t``): contact solvers diverge multiplicatively, so keep
pointwise windows short (under ~100 steps).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np
import torch

from mocca_envs_tpu_torch.core import quat as quat_ops
from mocca_envs_tpu_torch.core import rng as rng_mod
from mocca_envs_tpu_torch.envs.env import FnEnv
from mocca_envs_tpu_torch.models.schema import ARRAY_FIELDS, INDEX_FIELDS


def model_hash(model) -> str:
    """Stable content hash of a RobotModel's arrays + topology; equal to the
    JAX package's hash of the same model (its leaves in field order, floats
    as float32 and the index arrays as its int32)."""
    h = hashlib.sha256()
    h.update(repr((model.parent, model.jtype, model.floating)).encode())
    for f in ARRAY_FIELDS:
        arr = getattr(model, f).detach().cpu().numpy()
        h.update(np.ascontiguousarray(arr.astype(np.int32 if f in INDEX_FIELDS else np.float32))
                 .tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class Recording:
    meta: dict
    q: np.ndarray
    qd: np.ndarray
    action: np.ndarray
    obs: np.ndarray
    reward: np.ndarray
    done: np.ndarray

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            meta=json.dumps(self.meta),
            q=self.q, qd=self.qd, action=self.action,
            obs=self.obs, reward=self.reward, done=self.done,
        )

    @classmethod
    def load(cls, path: str) -> "Recording":
        z = np.load(path, allow_pickle=False)
        return cls(
            meta=json.loads(str(z["meta"])),
            q=z["q"], qd=z["qd"], action=z["action"],
            obs=z["obs"], reward=z["reward"], done=z["done"],
        )


def _q_to_file_convention(model, q: torch.Tensor) -> np.ndarray:
    """Internal wxyz → file xyzw for the base quaternion block; (…, nq)
    tensor in, numpy out."""
    if model.floating:
        q = torch.cat([q[..., 0:3], quat_ops.to_xyzw(q[..., 3:7]), q[..., 7:]], dim=-1)
    return q.detach().cpu().numpy()


def _q_from_file_convention(model, q: np.ndarray, device) -> torch.Tensor:
    q = torch.as_tensor(np.asarray(q, np.float32), device=device)
    if model.floating:
        q = torch.cat([q[..., 0:3], quat_ops.from_xyzw(q[..., 3:7]), q[..., 7:]], dim=-1)
    return q


def record(
    env: FnEnv,
    model,
    seed: int,
    horizon: int,
    policy=None,
    env_id: str = "",
) -> Recording:
    """Record one seeded episode of the port's env (no auto-reset) on the
    env's device: the generator is seeded ``seed`` (core/rng.py).

    ``policy(obs, t) → action`` defaults to zeros. The episode stops at its
    first done (one host read per step)."""
    gen = rng_mod.generator(seed, env.device)
    state = env.init(gen, 1)
    qs, qds, acts, obss, rews, dones = [state.q[0]], [state.qd[0]], [], [], [], []
    for t in range(horizon):
        if policy is None:
            a = np.zeros(env.act_dim, dtype=np.float32)
        else:
            obs = env.obs_fn(state)[0].cpu().numpy()
            a = np.asarray(policy(obs, t), dtype=np.float32)
        tr = env.step_no_reset(state, torch.as_tensor(a, device=env.device)[None], gen)
        state = tr.state
        acts.append(a)
        obss.append(tr.obs[0])
        rews.append(tr.reward[0])
        dones.append(tr.done[0])
        qs.append(state.q[0])
        qds.append(state.qd[0])
        if bool(tr.done[0]):
            break
    meta = {
        "env_id": env_id or env.name,
        "seed": seed,
        "engine": "torch",
        "model_hash": model_hash(model),
        "control_dt": env.control_dt,
        "format_version": 1,
    }
    return Recording(
        meta=meta,
        q=_q_to_file_convention(model, torch.stack(qs)),
        qd=torch.stack(qds).cpu().numpy(),
        action=np.stack(acts),
        obs=torch.stack(obss).cpu().numpy(),
        reward=torch.stack(rews).to(torch.float32).cpu().numpy(),
        done=torch.stack(dones).cpu().numpy(),
    )


@dataclasses.dataclass
class ToleranceGate:
    """Contact-solver tolerance gates."""

    q_atol: float = 1e-3          # base tolerance on generalized positions
    growth: float = 1.02          # per-step multiplicative envelope
    reward_atol: float = 1e-2
    obs_atol: float = 5e-3

    def envelope(self, t: int, atol: float) -> float:
        return atol * (self.growth ** t)


def replay_check(
    env: FnEnv,
    model,
    rec: Recording,
    gate: ToleranceGate = ToleranceGate(),
) -> dict:
    """Re-run the recorded actions from the recording's seed; return
    per-channel max errors + verdict. Every channel gates: positions,
    rewards, observations and the done flags."""
    gen = rng_mod.generator(int(rec.meta["seed"]), env.device)
    state = env.init(gen, 1)
    T = rec.action.shape[0]
    q_err = np.zeros(T)
    r_err = np.zeros(T)
    o_err = np.zeros(T)
    ok = True
    fail = ""
    for t in range(T):
        tr = env.step_no_reset(state, torch.as_tensor(rec.action[t], device=env.device)[None],
                               gen)
        state = tr.state
        q_now = _q_to_file_convention(model, state.q[0])
        q_err[t] = float(np.max(np.abs(q_now - rec.q[t + 1])))
        r_err[t] = abs(float(tr.reward[0]) - float(rec.reward[t]))
        o_err[t] = float(np.max(np.abs(tr.obs[0].cpu().numpy() - rec.obs[t])))
        if q_err[t] > gate.envelope(t, gate.q_atol):
            ok, fail = False, fail or f"q@{t}"
        if r_err[t] > gate.envelope(t, gate.reward_atol):
            ok, fail = False, fail or f"reward@{t}"
        if o_err[t] > gate.envelope(t, gate.obs_atol):
            ok, fail = False, fail or f"obs@{t}"
        if bool(tr.done[0]) != bool(rec.done[t]):
            ok, fail = False, fail or f"done@{t}"
            break
    return {
        "ok": ok,
        "first_failure": fail,
        "steps": T,
        "max_q_err": float(q_err.max(initial=0.0)),
        "max_reward_err": float(r_err.max(initial=0.0)),
        "max_obs_err": float(o_err.max(initial=0.0)),
    }


# --------------------------------------------------------------- raw physics
# Engine-level parity, independent of any task: the data/*.urdf assets
# (models/assets.py) describe the same robots in a format stock pybullet
# loads; its mirror of record_raw is parity_record_pybullet.py
# (--raw-urdf --match).


def _raw_control(model, config, friction: float):
    from mocca_envs_tpu_torch.ops.step import make_control_step
    from mocca_envs_tpu_torch.terrain import scene as scene_mod

    ctrl = make_control_step(model, config)
    scene = scene_mod.flat(1, model.device, friction=friction)
    return lambda q, qd, tau: ctrl(q, qd, tau, scene)[:2]


def record_raw(
    model,
    config,
    seed: int,
    horizon: int,
    q0: np.ndarray,
    qd0: np.ndarray | None = None,
    torque_scale: float = 0.3,
    friction: float = 0.8,
    name: str = "raw",
) -> Recording:
    """Record raw physics (no task) on the model's device: seeded torques
    (numpy's ``default_rng(seed)``, as the JAX package draws them) through
    make_control_step over the plane.

    ``action[t]`` holds the actual joint torques so any engine can mirror
    the run verbatim. obs/reward/done carry zeros (no task semantics)."""
    ctrl = _raw_control(model, config, friction)
    rng = np.random.default_rng(seed)
    taus = (
        torque_scale
        * model.power_coef.cpu().numpy()
        * rng.uniform(-1.0, 1.0, size=(horizon, model.nj))
    ).astype(np.float32)
    tau_d = torch.as_tensor(taus, device=model.device)
    q = torch.as_tensor(np.asarray(q0, np.float32), device=model.device).reshape(1, -1)
    qd = torch.as_tensor(
        np.asarray(qd0 if qd0 is not None else np.zeros(model.nv), np.float32),
        device=model.device).reshape(1, -1)
    qs, qds = [q[0]], [qd[0]]
    for t in range(horizon):
        q, qd = ctrl(q, qd, tau_d[t:t + 1])
        qs.append(q[0])
        qds.append(qd[0])
    T = horizon
    meta = {
        "env_id": name,
        "seed": seed,
        "engine": "torch_raw",
        "model_hash": model_hash(model),
        "control_dt": float(config.control_dt),
        "dt": float(config.dt),
        "sim_substeps": int(config.sim_substeps),
        "llc_frames": int(config.llc_frames),
        "solver_iters": int(config.solver_iters),
        "friction": friction,
        "format_version": 1,
    }
    return Recording(
        meta=meta,
        q=_q_to_file_convention(model, torch.stack(qs)),
        qd=torch.stack(qds).cpu().numpy(),
        action=taus,
        obs=np.zeros((T, 0), dtype=np.float32),
        reward=np.zeros((T,), dtype=np.float32),
        done=np.zeros((T,), dtype=bool),
    )


def replay_check_raw(
    model,
    config,
    rec: Recording,
    gate: ToleranceGate = ToleranceGate(),
) -> dict:
    """Replay a raw-physics recording through the port's engine on the
    model's device and gate q.

    The initial state comes from the recording itself (q[0]/qd[0], file xyzw
    convention), so a recording of the same URDF with the same torques made
    by the JAX package or by pybullet gates trajectory parity directly. The
    steps stay on the device; the errors are read once at the end."""
    ctrl = _raw_control(model, config, float(rec.meta["friction"]))
    q = _q_from_file_convention(model, rec.q[0], model.device).reshape(1, -1)
    qd = torch.as_tensor(np.asarray(rec.qd[0], np.float32), device=model.device).reshape(1, -1)
    tau = torch.as_tensor(np.asarray(rec.action, np.float32), device=model.device)
    T = rec.action.shape[0]
    qs = []
    for t in range(T):
        q, qd = ctrl(q, qd, tau[t:t + 1])
        qs.append(q[0])
    q_now = _q_to_file_convention(model, torch.stack(qs)) if T else np.zeros((0, model.nq))
    q_err = np.abs(q_now - rec.q[1:T + 1]).max(axis=1, initial=0.0)
    ok = True
    fail = ""
    for t in range(T):
        if q_err[t] > gate.envelope(t, gate.q_atol):
            ok, fail = False, fail or f"q@{t}"
    return {
        "ok": ok,
        "first_failure": fail,
        "steps": T,
        "max_q_err": float(q_err.max(initial=0.0)),
    }


def reference_recorder_stub() -> str:
    """CLI recipe for producing the pybullet half of the parity pair: runs
    where pybullet and the reference mocca_envs package are installed."""
    return (
        "python -m mocca_envs_tpu_torch.harness.parity_record_pybullet "
        "--env Walker3DCustomEnv-v0 --seed 0 --horizon 1000 "
        "--out recordings/walker3d_seed0.npz\n"
        "# writes the same npz schema with meta.engine='pybullet'; quats "
        "already xyzw; actions replayed from a saved action file or a "
        "seeded policy"
    )
