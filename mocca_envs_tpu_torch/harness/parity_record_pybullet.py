"""Record pybullet trajectories in the parity interchange format.

Counterpart of ``mocca_envs_tpu/harness/parity_record_pybullet.py`` (the
port's own copy): the other half of the parity pair (harness/parity.py).
It imports cleanly with neither gym, pybullet nor the reference
``mocca_envs`` package installed, and runs where they are —

    python -m mocca_envs_tpu_torch.harness.parity_record_pybullet \
        --env Walker3DCustomEnv-v0 --seed 0 --horizon 1000 \
        --out recordings/walker3d_seed0.npz [--actions acts.npz]

then gate with::

    from mocca_envs_tpu_torch.harness.parity import Recording, replay_check
    rec = Recording.load("recordings/walker3d_seed0.npz")
    report = replay_check(our_env, our_model, rec)

Raw-physics mode (needs pybullet alone) mirrors a ``parity.record_raw``
recording on one of the port's ``data/*.urdf`` assets (models/assets.py)::

    python -m mocca_envs_tpu_torch.harness.parity_record_pybullet \
        --raw-urdf mocca_envs_tpu_torch/data/walker3d.urdf \
        --match ours.npz --out pybullet.npz

Output schema = harness/parity.Recording (npz): q (T+1, nq) with base quat
in pybullet's xyzw, qd (T+1, nv) with world-frame base velocities, action
(T, nu), obs (T, obs_dim), reward (T,), done (T,), meta.engine="pybullet"
(or "pybullet_raw").

State extraction (``_extract_qqd``) targets the reference's Robot wrapper
layout (a pybullet body id + an ordered joint list) with fallbacks for the
attribute-name variants its families use; if no convention matches, q/qd
rows are NaN and the recording still carries obs/reward/done (replay_check
gates those channels independently).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _import_reference():
    """Import (gym, pybullet, mocca_envs) or explain exactly what's missing."""
    missing = []
    try:
        import gym  # noqa: F401
    except ImportError:
        try:
            import gymnasium as gym  # noqa: F401
        except ImportError:
            missing.append("gym/gymnasium")
            gym = None
    try:
        import pybullet  # noqa: F401
    except ImportError:
        missing.append("pybullet")
        pybullet = None
    try:
        import mocca_envs  # noqa: F401
    except ImportError:
        missing.append("mocca_envs (the reference package)")
        mocca_envs = None
    if missing:
        raise SystemExit(
            "parity_record_pybullet needs the reference stack; missing: "
            + ", ".join(missing)
            + ".\nInstall pybullet and the reference mocca_envs package, then re-run."
        )
    return gym, pybullet, mocca_envs


def _bullet_client(env):
    """The env's pybullet client (the reference keeps it at ``_p``)."""
    for attr in ("_p", "p", "client", "bullet_client"):
        c = getattr(env.unwrapped, attr, None)
        if c is not None and hasattr(c, "getBasePositionAndOrientation"):
            return c
    import pybullet

    return pybullet


def _robot_of(env):
    r = getattr(env.unwrapped, "robot", None)
    if r is None:
        raise RuntimeError("env has no .robot — adjust _robot_of for this family")
    return r


def _body_id(robot):
    for attr in ("id", "object_id", "robot_body"):
        v = getattr(robot, attr, None)
        if isinstance(v, int):
            return v
        # roboschool-lineage BodyPart wrapper: .bodies[.bodyIndex]
        if v is not None and hasattr(v, "bodies"):
            return v.bodies[getattr(v, "bodyIndex", 0)]
    raise RuntimeError("cannot find pybullet body id on robot")


def _joint_indices(robot, client, body):
    js = getattr(robot, "ordered_joints", None)
    if js:
        idx = []
        for j in js:
            for attr in ("jointIndex", "joint_index", "index"):
                v = getattr(j, attr, None)
                if isinstance(v, int):
                    idx.append(v)
                    break
        if len(idx) == len(js):
            return idx
    # fallback: all movable joints in definition order
    n = client.getNumJoints(body)
    movable = []
    for i in range(n):
        info = client.getJointInfo(body, i)
        if info[2] != 4:  # JOINT_FIXED
            movable.append(i)
    return movable


def _extract_qqd(client, body, joint_idx):
    """(q, qd) in the interchange layout: base pos + quat(xyzw) + joint q;
    world-frame base lin/ang velocity + joint q̇."""
    try:
        pos, orn = client.getBasePositionAndOrientation(body)
        lin, ang = client.getBaseVelocity(body)
        states = client.getJointStates(body, joint_idx)
        jq = [s[0] for s in states]
        jqd = [s[1] for s in states]
        q = np.concatenate([pos, orn, jq]).astype(np.float32)
        qd = np.concatenate([lin, ang, jqd]).astype(np.float32)
        return q, qd
    except Exception:
        nan = np.full(7 + len(joint_idx), np.nan, dtype=np.float32)
        return nan, nan[:-1]


def record_pybullet(
    env_id: str,
    seed: int,
    horizon: int,
    actions: np.ndarray | None = None,
) -> dict:
    """Roll the reference env and return the interchange arrays + meta."""
    gym, _, _ = _import_reference()

    env = gym.make(env_id)
    # old-gym (reference era) vs gymnasium seeding
    if hasattr(env, "seed"):
        env.seed(seed)
        obs = env.reset()
    else:
        obs, _ = env.reset(seed=seed)
    client = _bullet_client(env)
    robot = _robot_of(env)
    body = _body_id(robot)
    joint_idx = _joint_indices(robot, client, body)

    act_dim = int(np.prod(env.action_space.shape))
    qs, qds, acts, obss, rews, dones = [], [], [], [], [], []
    q, qd = _extract_qqd(client, body, joint_idx)
    qs.append(q)
    qds.append(qd)
    for t in range(horizon):
        a = (
            actions[t]
            if actions is not None
            else np.zeros(act_dim, dtype=np.float32)
        )
        out = env.step(a)
        if len(out) == 5:  # gymnasium
            obs, r, term, trunc, _ = out
            done = bool(term or trunc)
        else:
            obs, r, done, _ = out
        q, qd = _extract_qqd(client, body, joint_idx)
        acts.append(np.asarray(a, dtype=np.float32))
        obss.append(np.asarray(obs, dtype=np.float32))
        rews.append(float(r))
        dones.append(bool(done))
        qs.append(q)
        qds.append(qd)
        if done:
            break
    env.close()
    meta = {
        "env_id": env_id,
        "seed": seed,
        "engine": "pybullet",
        "model_hash": "",  # reference model: hash unavailable; matched by env_id
        "control_dt": float(getattr(env.unwrapped, "control_step", 1.0 / 60.0))
        if not callable(getattr(env.unwrapped, "control_step", None))
        else 1.0 / 60.0,
        "format_version": 1,
    }
    return {
        "meta": meta,
        "q": np.stack(qs),
        "qd": np.stack(qds),
        "action": np.stack(acts),
        "obs": np.stack(obss),
        "reward": np.asarray(rews, dtype=np.float32),
        "done": np.asarray(dones),
    }


def record_raw_pybullet(urdf: str, match: str) -> dict:
    """Mirror a raw-physics recording (parity.record_raw) in stock pybullet.

    Needs ONLY pybullet — not gym, not the reference package: the robot is
    one of the port's data/*.urdf assets (the same masses, inertias, limits
    and spheres as the hand-built models), so this is a cross-ENGINE
    comparison. Initial state, torque sequence, timestep, solver iterations
    and friction all come from the matched recording's arrays/meta; gate
    the result with parity.replay_check_raw on the other side.
    """
    try:
        import pybullet as p
    except ImportError:
        raise SystemExit("record_raw_pybullet needs pybullet (pip install pybullet)")

    z = np.load(match, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    q = np.asarray(z["q"], dtype=np.float64)
    qd = np.asarray(z["qd"], dtype=np.float64)
    taus = np.asarray(z["action"], dtype=np.float64)
    dt = float(meta["dt"])
    substeps = int(meta["sim_substeps"]) * int(meta.get("llc_frames", 1))
    friction = float(meta["friction"])

    cid = p.connect(p.DIRECT)
    p.setGravity(0.0, 0.0, -9.8, physicsClientId=cid)
    p.setTimeStep(dt, physicsClientId=cid)
    p.setPhysicsEngineParameter(
        numSolverIterations=int(meta["solver_iters"]),
        numSubSteps=0,
        physicsClientId=cid,
    )
    plane = p.createMultiBody(
        0, p.createCollisionShape(p.GEOM_PLANE, physicsClientId=cid),
        physicsClientId=cid,
    )
    p.changeDynamics(
        plane, -1, lateralFriction=friction, restitution=0.0,
        physicsClientId=cid,
    )
    body = p.loadURDF(
        urdf,
        basePosition=q[0, 0:3].tolist(),
        baseOrientation=q[0, 3:7].tolist(),   # file convention is xyzw already
        flags=p.URDF_USE_INERTIA_FROM_FILE,
        physicsClientId=cid,
    )
    nj = p.getNumJoints(body, physicsClientId=cid)
    movable = [
        i for i in range(nj)
        if p.getJointInfo(body, i, physicsClientId=cid)[2] != p.JOINT_FIXED
    ]
    assert len(movable) == taus.shape[1], (len(movable), taus.shape)
    for k, i in enumerate(movable):
        # kill default velocity motors; zero pybullet's implicit damping
        p.setJointMotorControl2(
            body, i, p.VELOCITY_CONTROL, force=0.0, physicsClientId=cid
        )
        p.resetJointState(
            body, i, float(q[0, 7 + k]), float(qd[0, 6 + k]),
            physicsClientId=cid,
        )
    for link in [-1] + movable:
        p.changeDynamics(
            body, link, lateralFriction=friction, restitution=0.0,
            linearDamping=0.0, angularDamping=0.0, spinningFriction=0.0,
            physicsClientId=cid,
        )
    p.resetBaseVelocity(
        body, qd[0, 0:3].tolist(), qd[0, 3:6].tolist(), physicsClientId=cid
    )

    qs, qds = [], []
    qq, dd = _extract_qqd(p, body, movable)
    qs.append(qq)
    qds.append(dd)
    for t in range(taus.shape[0]):
        p.setJointMotorControlArray(
            body, movable, p.TORQUE_CONTROL, forces=taus[t].tolist(),
            physicsClientId=cid,
        )
        for _ in range(substeps):
            p.stepSimulation(physicsClientId=cid)
        qq, dd = _extract_qqd(p, body, movable)
        qs.append(qq)
        qds.append(dd)
    p.disconnect(cid)
    meta = dict(meta)
    meta["engine"] = "pybullet_raw"
    T = taus.shape[0]
    return {
        "meta": meta,
        "q": np.stack(qs),
        "qd": np.stack(qds),
        "action": taus.astype(np.float32),
        "obs": np.zeros((T, 0), dtype=np.float32),
        "reward": np.zeros((T,), dtype=np.float32),
        "done": np.zeros((T,), dtype=bool),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", help="reference gym env id")
    ap.add_argument(
        "--raw-urdf",
        default=None,
        help="raw-physics mode: pybullet on one of the port's data/*.urdf assets, "
        "mirroring --match (a parity.record_raw npz); needs only pybullet",
    )
    ap.add_argument(
        "--match",
        default=None,
        help="recording whose initial state + torques to mirror (raw mode)",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--horizon", type=int, default=1000)
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument(
        "--actions",
        default=None,
        help="npz with an 'action' (T, nu) array to replay (default zeros)",
    )
    args = ap.parse_args(argv)

    if args.raw_urdf:
        if not args.match:
            ap.error("--raw-urdf requires --match (a parity.record_raw npz)")
        data = record_raw_pybullet(args.raw_urdf, args.match)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        np.savez_compressed(
            args.out,
            meta=json.dumps(data["meta"]),
            q=data["q"], qd=data["qd"], action=data["action"],
            obs=data["obs"], reward=data["reward"], done=data["done"],
        )
        print(f"raw-recorded {data['action'].shape[0]} steps -> {args.out}")
        return
    if not args.env:
        ap.error("--env is required (or use --raw-urdf)")

    actions = None
    if args.actions:
        actions = np.load(args.actions)["action"]
    data = record_pybullet(args.env, args.seed, args.horizon, actions)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(
        args.out,
        meta=json.dumps(data["meta"]),
        q=data["q"], qd=data["qd"], action=data["action"],
        obs=data["obs"], reward=data["reward"], done=data["done"],
    )
    print(f"recorded {data['action'].shape[0]} steps -> {args.out}")


if __name__ == "__main__":
    main()
