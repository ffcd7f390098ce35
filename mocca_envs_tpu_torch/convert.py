"""The seam that carries state across from the JAX package, through numpy.

Every function here takes numpy arrays (the caller converts a JAX object
with ``np.asarray``), so this module never imports JAX. The tests use it to
feed both packages the same model, states and parameters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mocca_envs_tpu_torch.envs.env import EnvState
from mocca_envs_tpu_torch.models.schema import RobotModel, model_from_numpy
from mocca_envs_tpu_torch.tasks.walker_custom import WalkerParams, WalkerTaskState
from mocca_envs_tpu_torch.terrain.scene import Scene


def robot_model_from_numpy(fields: dict, device="cpu") -> RobotModel:
    """RobotModel from every field of a JAX ``RobotModel`` (arrays as numpy,
    static topology as tuples / ints / bools)."""
    return model_from_numpy(fields, device=device, dtype=torch.float32)


def env_state_from_numpy(*, q, qd, steps, reset_count, done, blowup_count, target,
                         potential, ground_z=0.0, friction=0.8, device="cpu") -> EnvState:
    """Batched walker EnvState from numpy arrays with a leading batch axis
    (q (B, nq), qd (B, nv), target (B, 3), the rest (B,)); the scene is the
    flat plane at ``ground_z`` with ``friction`` (scalars or (B,))."""
    f32 = lambda x: torch.as_tensor(np.array(x, dtype=np.float32), device=device)  # noqa: E731
    i32 = lambda x: torch.as_tensor(np.array(x, dtype=np.int32), device=device)  # noqa: E731
    B = np.asarray(q).shape[0]
    return EnvState(
        q=f32(q),
        qd=f32(qd),
        reset_count=i32(reset_count),
        steps=i32(steps),
        task=WalkerTaskState(target=f32(target), potential=f32(potential)),
        scene=Scene(ground_z=f32(np.broadcast_to(ground_z, (B,))),
                    friction=f32(np.broadcast_to(friction, (B,)))),
        done=torch.as_tensor(np.array(done, dtype=bool), device=device),
        blowup_count=i32(blowup_count),
    )


def env_state_to_numpy(state: EnvState) -> dict:
    """The fields :func:`env_state_from_numpy` takes, as numpy arrays."""
    n = lambda x: x.detach().cpu().numpy()  # noqa: E731
    return dict(
        q=n(state.q), qd=n(state.qd), steps=n(state.steps),
        reset_count=n(state.reset_count), done=n(state.done),
        blowup_count=n(state.blowup_count), target=n(state.task.target),
        potential=n(state.task.potential), ground_z=n(state.scene.ground_z),
        friction=n(state.scene.friction),
    )


def walker_params_from_numpy(fields: dict) -> WalkerParams:
    """WalkerParams from a JAX ``WalkerParams``' fields (0-d arrays: the
    port holds one value for the whole batch)."""
    kw = {}
    for f in dataclasses.fields(WalkerParams):
        v = np.asarray(fields[f.name])
        if v.ndim:
            raise ValueError(f"WalkerParams.{f.name}: one value per batch, got shape {v.shape}")
        kw[f.name] = int(v) if f.name == "max_steps" else float(v)
    return WalkerParams(**kw)
