"""Stepping-stone placement and its curriculum, batch-first.

Counterpart of ``mocca_envs_tpu/terrain/stones.py``: a chain of N stones
sampled in spherical increments. Per step a distance r, a heading change, a
pitch (height change) and two stone tilts are drawn uniformly in ranges
that widen with the curriculum stage, ``stage / max_stage`` interpolating
from the first stage's range to the last one's. The stage is per-env data
(a ``(B,)`` tensor), so stages differ between the slots of one batch.

The sampler is split in two: :func:`stones_from_draws` is deterministic in
five unit-uniform draws, and :func:`sample_stones` makes those draws from a
``torch.Generator`` (core/rng.py documents the order).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mocca_envs_tpu_torch.core import quat as quat_ops
from mocca_envs_tpu_torch.core import rng as rng_mod

DEG = math.pi / 180.0


@dataclasses.dataclass(frozen=True)
class StoneParams:
    """Sampling ranges, the same names and defaults as the JAX package's
    (one value for the whole batch; the stage itself is per-env data)."""

    num_steps: int = 20
    stage: float = 0.0              # the stage fresh batches start at
    max_stage: float = 9.0
    # per-step increment ranges at stage 0 → the last stage
    r_lo_start: float = 0.35
    r_lo_end: float = 0.65
    r_hi_start: float = 0.45
    r_hi_end: float = 1.35
    yaw_max_end: float = 20.0 * DEG
    pitch_max_end: float = 50.0 * DEG
    tilt_max_end: float = 25.0 * DEG
    # stone geometry (box half extents)
    half_x: float = 0.25
    half_y: float = 0.25
    half_z: float = 0.5

    def set_stage(self, stage) -> "StoneParams":
        return dataclasses.replace(self, stage=float(stage))


def stones_from_draws(params: StoneParams, stage: torch.Tensor, draws: torch.Tensor,
                      start: torch.Tensor):
    """The stone chain from unit-uniform ``draws`` (B, 5, K) — rows r, heading
    change, pitch, tilt about x, tilt about y — at per-env ``stage`` (B,).
    ``start`` (B, 3) is the top center of stone 0; the first two increments
    are flat and straight ahead so the reset pose is always feasible.
    Returns ``(top centers (B, K, 3), quat (B, K, 4))``."""
    K = params.num_steps
    frac = torch.clamp(stage / max(params.max_stage, 1.0), 0.0, 1.0)[:, None]   # (B, 1)
    r_lo = params.r_lo_start + frac * (params.r_lo_end - params.r_lo_start)
    r_hi = params.r_hi_start + frac * (params.r_hi_end - params.r_hi_start)

    def centered(u, half_range):
        return -half_range + (2.0 * half_range) * u

    r = r_lo + (r_hi - r_lo) * draws[:, 0]
    dyaw = centered(draws[:, 1], frac * params.yaw_max_end)
    pitch = centered(draws[:, 2], frac * params.pitch_max_end)
    tilt_x = centered(draws[:, 3], frac * params.tilt_max_end)
    tilt_y = centered(draws[:, 4], frac * params.tilt_max_end)

    easy = torch.arange(K, device=draws.device) < 2
    zero = torch.zeros_like(r)
    dyaw = torch.where(easy, zero, dyaw)
    pitch = torch.where(easy, zero, pitch)
    tilt_x = torch.where(easy, zero, tilt_x)
    tilt_y = torch.where(easy, zero, tilt_y)
    r = torch.where(easy, 0.5 * (r_lo + r_hi), r)

    heading = torch.cumsum(dyaw, dim=1)
    delta = r[..., None] * torch.stack(
        [torch.cos(heading) * torch.cos(pitch), torch.sin(heading) * torch.cos(pitch),
         torch.sin(pitch)], dim=-1)
    # stone 0 sits under the start; later stones accumulate the increments
    offsets = torch.cat([torch.zeros_like(delta[:, :1]), torch.cumsum(delta[:, 1:], dim=1)], dim=1)
    pos = start[:, None, :] + offsets
    quat = quat_ops.from_rpy(torch.stack([tilt_x, tilt_y, heading], dim=-1))
    return pos, quat


def sample_stones(params: StoneParams, gen: torch.Generator, stage: torch.Tensor,
                  start: torch.Tensor):
    """Sample one chain per env: one (B, 5, K) unit-uniform draw from ``gen``."""
    draws = rng_mod.uniform(gen, (stage.shape[0], 5, params.num_steps), 0.0, 1.0)
    return stones_from_draws(params, stage, draws, start)


def stones_to_scene_boxes(params: StoneParams, top_pos: torch.Tensor, quat: torch.Tensor):
    """Top-center poses (B, K, ·) → box centers and half extents for
    ``terrain/scene.with_stones``: the center sits ``half_z`` below the top
    face along the stone's own z."""
    # filled by scalar, not from a host list: that would be a copy to the
    # device, and a wait for it, at every reset
    half = torch.empty_like(top_pos)
    down = torch.zeros_like(top_pos)
    for axis, extent in enumerate((params.half_x, params.half_y, params.half_z)):
        half[..., axis] = extent
    down[..., 2] = params.half_z
    return top_pos - quat_ops.rotate(quat, down), half
