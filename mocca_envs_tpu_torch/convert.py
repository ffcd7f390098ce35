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
from mocca_envs_tpu_torch.models.cassie_gait import GaitTable
from mocca_envs_tpu_torch.models.schema import RobotModel, model_from_numpy
from mocca_envs_tpu_torch.ops.step import ConstraintSpec
from mocca_envs_tpu_torch.tasks.cassie_task import CassieParams, CassieTaskState
from mocca_envs_tpu_torch.tasks.monkey_stepper import MonkeyParams, MonkeyTaskState
from mocca_envs_tpu_torch.tasks.walker_custom import WalkerParams, WalkerTaskState
from mocca_envs_tpu_torch.tasks.walker_stepper import StepperParams, StepperTaskState
from mocca_envs_tpu_torch.terrain.scene import NO_GROUND_Z, Scene
from mocca_envs_tpu_torch.terrain.stones import StoneParams


def robot_model_from_numpy(fields: dict, device="cpu") -> RobotModel:
    """RobotModel from every field of a JAX ``RobotModel`` (arrays as numpy,
    static topology as tuples / ints / bools)."""
    return model_from_numpy(fields, device=device, dtype=torch.float32)


def _f32(x, device):
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def _i32(x, device):
    return torch.as_tensor(np.array(x, dtype=np.int32), device=device)


def _n(x):
    return x.detach().cpu().numpy()


def scene_from_numpy(batch: int, ground_z=0.0, friction=0.8, stone_pos=None, stone_quat=None,
                     stone_half=None, stone_active=None, bar_a=None, bar_b=None, bar_r=None,
                     bar_active=None, hf_height=None, hf_xy0=None, hf_cell=None,
                     tri_a=None, tri_b=None, tri_c=None, tri_active=None,
                     has_ground=True, device="cpu") -> Scene:
    """Scene for ``batch`` envs: the plane (scalars or (B,)) and, when
    ``stone_pos`` / ``bar_a`` / ``hf_height`` / ``tri_a`` is given, the
    stone boxes / bar capsules (B, K, ·) / heightfield (B, H, W), (B, 2),
    (B,) / mesh faces (B, Kt, ·) of a JAX ``Scene``. A JAX scene with ``has_ground=False`` (a terrain scene) keeps
    ``ground_z = 0`` and evaluates no plane; the port always evaluates one,
    so there it sinks to ``NO_GROUND_Z``."""
    if not has_ground:
        ground_z = NO_GROUND_Z
    scene = Scene(ground_z=_f32(np.broadcast_to(ground_z, (batch,)), device),
                  friction=_f32(np.broadcast_to(friction, (batch,)), device))
    if stone_pos is not None:
        scene = dataclasses.replace(
            scene, stone_pos=_f32(stone_pos, device), stone_quat=_f32(stone_quat, device),
            stone_half=_f32(stone_half, device), stone_active=_f32(stone_active, device))
    if bar_a is not None:
        scene = dataclasses.replace(
            scene, bar_a=_f32(bar_a, device), bar_b=_f32(bar_b, device),
            bar_r=_f32(bar_r, device), bar_active=_f32(bar_active, device))
    if hf_height is not None:
        scene = dataclasses.replace(
            scene, hf_height=_f32(hf_height, device), hf_xy0=_f32(hf_xy0, device),
            hf_cell=_f32(hf_cell, device))
    if tri_a is not None:
        scene = dataclasses.replace(
            scene, tri_a=_f32(tri_a, device), tri_b=_f32(tri_b, device),
            tri_c=_f32(tri_c, device), tri_active=_f32(tri_active, device))
    return scene


def scene_to_numpy(scene: Scene) -> dict:
    """The fields :func:`scene_from_numpy` takes (absent stones left out)."""
    return {f.name: _n(getattr(scene, f.name)) for f in dataclasses.fields(Scene)
            if getattr(scene, f.name) is not None}


def _env_state(task, scene, *, q, qd, steps, reset_count, done, blowup_count, device) -> EnvState:
    return EnvState(
        q=_f32(q, device), qd=_f32(qd, device), reset_count=_i32(reset_count, device),
        steps=_i32(steps, device), task=task, scene=scene,
        done=torch.as_tensor(np.array(done, dtype=bool), device=device),
        blowup_count=_i32(blowup_count, device),
    )


def _core_to_numpy(state: EnvState) -> dict:
    return dict(q=_n(state.q), qd=_n(state.qd), steps=_n(state.steps),
                reset_count=_n(state.reset_count), done=_n(state.done),
                blowup_count=_n(state.blowup_count))


def env_state_from_numpy(*, q, qd, steps, reset_count, done, blowup_count, target,
                         potential, ground_z=0.0, friction=0.8, hf_height=None, hf_xy0=None,
                         hf_cell=None, tri_a=None, tri_b=None, tri_c=None, tri_active=None,
                         has_ground=True, device="cpu") -> EnvState:
    """Batched walker EnvState from numpy arrays with a leading batch axis
    (q (B, nq), qd (B, nv), target (B, 3), the rest (B,)); the scene is the
    plane at ``ground_z`` with ``friction`` (scalars or (B,)) and, for the
    terrain families, each slot's heightfield (``hf_height`` (B, H, W),
    ``hf_xy0`` (B, 2), ``hf_cell`` (B,); a JAX terrain state has
    ``has_ground=False``, see :func:`scene_from_numpy`), and for the stairs
    each slot's mesh faces (``tri_a``, ``tri_b``, ``tri_c`` (B, Kt, 3),
    ``tri_active`` (B, Kt))."""
    B = np.asarray(q).shape[0]
    return _env_state(
        WalkerTaskState(target=_f32(target, device), potential=_f32(potential, device)),
        scene_from_numpy(B, ground_z, friction, hf_height=hf_height, hf_xy0=hf_xy0,
                         hf_cell=hf_cell, tri_a=tri_a, tri_b=tri_b, tri_c=tri_c,
                         tri_active=tri_active, has_ground=has_ground, device=device),
        q=q, qd=qd, steps=steps, reset_count=reset_count, done=done,
        blowup_count=blowup_count, device=device)


def env_state_to_numpy(state: EnvState) -> dict:
    """The fields :func:`env_state_from_numpy` takes, as numpy arrays."""
    return dict(**_core_to_numpy(state), target=_n(state.task.target),
                potential=_n(state.task.potential), **scene_to_numpy(state.scene))


def stepper_state_from_numpy(*, q, qd, steps, reset_count, done, blowup_count, stone_top,
                             task_stone_quat, next_step, potential, foot_potential, stage,
                             ground_z, friction, stone_pos, stone_quat, stone_half,
                             stone_active, device="cpu") -> EnvState:
    """Batched stepper EnvState: the task fields of a JAX ``StepperTaskState``
    (``task_stone_quat`` is its ``stone_quat``) and the scene with its stones."""
    B = np.asarray(q).shape[0]
    task = StepperTaskState(
        stone_top=_f32(stone_top, device), stone_quat=_f32(task_stone_quat, device),
        next_step=_i32(next_step, device), potential=_f32(potential, device),
        foot_potential=_f32(foot_potential, device), stage=_f32(stage, device))
    scene = scene_from_numpy(B, ground_z, friction, stone_pos, stone_quat, stone_half,
                             stone_active, device=device)
    return _env_state(task, scene, q=q, qd=qd, steps=steps, reset_count=reset_count,
                      done=done, blowup_count=blowup_count, device=device)


def stepper_state_to_numpy(state: EnvState) -> dict:
    """The fields :func:`stepper_state_from_numpy` takes, as numpy arrays."""
    t = state.task
    return dict(**_core_to_numpy(state), stone_top=_n(t.stone_top),
                task_stone_quat=_n(t.stone_quat), next_step=_n(t.next_step),
                potential=_n(t.potential), foot_potential=_n(t.foot_potential),
                stage=_n(t.stage), **scene_to_numpy(state.scene))


def cassie_state_from_numpy(*, q, qd, steps, reset_count, done, blowup_count, prev_action,
                            phase, ground_z=0.0, friction=0.8, device="cpu") -> EnvState:
    """Batched Cassie EnvState: the task fields of a JAX ``CassieTaskState``
    (``prev_action`` (B, 10), ``phase`` (B,)) over the flat plane."""
    B = np.asarray(q).shape[0]
    return _env_state(
        CassieTaskState(prev_action=_f32(prev_action, device), phase=_f32(phase, device)),
        scene_from_numpy(B, ground_z, friction, device=device),
        q=q, qd=qd, steps=steps, reset_count=reset_count, done=done,
        blowup_count=blowup_count, device=device)


def cassie_state_to_numpy(state: EnvState) -> dict:
    """The fields :func:`cassie_state_from_numpy` takes, as numpy arrays."""
    return dict(**_core_to_numpy(state), prev_action=_n(state.task.prev_action),
                phase=_n(state.task.phase), **scene_to_numpy(state.scene))


def monkey_state_from_numpy(*, q, qd, steps, reset_count, done, blowup_count, bar_pos, bar_dir,
                            next_bar, attached, anchor, hold_bar, potential, stage, since_hit,
                            ground_z, friction, bar_a, bar_b, bar_r, bar_active,
                            device="cpu") -> EnvState:
    """Batched monkey EnvState: the task fields of a JAX ``MonkeyTaskState``
    and the scene with its bars."""
    B = np.asarray(q).shape[0]
    task = MonkeyTaskState(
        bar_pos=_f32(bar_pos, device), bar_dir=_f32(bar_dir, device),
        next_bar=_i32(next_bar, device), attached=_f32(attached, device),
        anchor=_f32(anchor, device), hold_bar=_i32(hold_bar, device),
        potential=_f32(potential, device), stage=_f32(stage, device),
        since_hit=_i32(since_hit, device))
    scene = scene_from_numpy(B, ground_z, friction, bar_a=bar_a, bar_b=bar_b, bar_r=bar_r,
                             bar_active=bar_active, device=device)
    return _env_state(task, scene, q=q, qd=qd, steps=steps, reset_count=reset_count,
                      done=done, blowup_count=blowup_count, device=device)


def monkey_state_to_numpy(state: EnvState) -> dict:
    """The fields :func:`monkey_state_from_numpy` takes, as numpy arrays."""
    task = {f.name: _n(getattr(state.task, f.name)) for f in dataclasses.fields(MonkeyTaskState)}
    return dict(**_core_to_numpy(state), **task, **scene_to_numpy(state.scene))


def constraint_spec_from_numpy(fields: dict) -> ConstraintSpec:
    """ConstraintSpec from the fields of a JAX ``ConstraintSpec`` (tuples or
    arrays; anchors keep their full precision)."""
    def points(x):
        return tuple(tuple(float(v) for v in p) for p in np.asarray(x, np.float64).reshape(-1, 3))

    def links(x):
        return tuple(int(v) for v in np.asarray(x).reshape(-1))

    return ConstraintSpec(
        p2p_link_a=links(fields.get("p2p_link_a", ())),
        p2p_link_b=links(fields.get("p2p_link_b", ())),
        p2p_anchor_a=points(fields.get("p2p_anchor_a", ())),
        p2p_anchor_b=points(fields.get("p2p_anchor_b", ())),
        planar=bool(fields.get("planar", False)),
        num_grabs=int(fields.get("num_grabs", 0)),
        grab_links=links(fields.get("grab_links", ())),
        grab_anchors=points(fields.get("grab_anchors", ())),
    )


def gait_table_from_numpy(q_motors, stance, period_steps, device="cpu") -> GaitTable:
    """GaitTable from the arrays of a JAX ``GaitTable``."""
    return GaitTable(_f32(q_motors, device), _f32(stance, device), float(period_steps))


def _scalars_from_numpy(cls, fields: dict, ints=(), skip=()):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in skip:
            continue
        v = np.asarray(fields[f.name])
        if v.ndim:
            raise ValueError(f"{cls.__name__}.{f.name}: one value per batch, got shape {v.shape}")
        kw[f.name] = int(v) if f.name in ints else float(v)
    return kw


def walker_params_from_numpy(fields: dict) -> WalkerParams:
    """WalkerParams from a JAX ``WalkerParams``' fields (0-d arrays: the
    port holds one value for the whole batch)."""
    return WalkerParams(**_scalars_from_numpy(WalkerParams, fields, ints=("max_steps",)))


def cassie_params_from_numpy(fields: dict) -> CassieParams:
    """CassieParams from a JAX ``CassieParams``' fields (0-d arrays)."""
    return CassieParams(**_scalars_from_numpy(CassieParams, fields, ints=("max_steps",)))


def stone_params_from_numpy(fields: dict) -> StoneParams:
    """StoneParams from a JAX ``StoneParams``' fields (0-d arrays)."""
    return StoneParams(**_scalars_from_numpy(StoneParams, fields, ints=("num_steps",)))


def stepper_params_from_numpy(fields: dict) -> StepperParams:
    """StepperParams from a JAX ``StepperParams``' fields, with ``walker``
    and ``stones`` given as dicts of their own fields."""
    return StepperParams(
        walker=walker_params_from_numpy(fields["walker"]),
        stones=stone_params_from_numpy(fields["stones"]),
        **_scalars_from_numpy(StepperParams, fields, skip=("walker", "stones")))


def monkey_params_from_numpy(fields: dict) -> MonkeyParams:
    """MonkeyParams from a JAX ``MonkeyParams``' fields (0-d arrays)."""
    return MonkeyParams(**_scalars_from_numpy(
        MonkeyParams, fields, ints=("num_bars", "max_steps", "hold_grace", "progress_timeout")))
