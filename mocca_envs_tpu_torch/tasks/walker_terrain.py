"""Walker3DTerrainEnv / Walker3DTerrainLidarEnv — walk to a target over
fractal terrain, batch-first.

Counterpart of ``mocca_envs_tpu/tasks/walker_terrain.py``: the walk-to-target
task of tasks/walker_custom.py over a heightfield scene with no plane.

- a bank of 16 fractal grids (terrain/heightfield.py, seeds
  ``terrain_seed·1000 + i``) is made when the family is built; at init each
  slot picks one (a draw after the base reset's, core/rng.py) and keeps it
  across auto-resets: the fresh episode of a slot reuses its grid;
- the spawn and the target stand on the surface under them;
- each control step cuts ONE ``HF_PATCH × HF_PATCH`` window around the
  root (terrain/scene.py::extract_patch); the physics (K1f on the card),
  the height-above-surface fall test, the probes and the LIDAR all read
  that window. The target's height is re-pinned from the full grid, since
  a resampled target lands 3–7 m away, outside the window;
- the observation appends 8 terrain probes (heights around the root in the
  heading frame, minus the height under the root) and, for the LIDAR
  family, the hit parameters of 8 rays fanned ±75° and pitched 45° down,
  marched in 16 fixed steps up to 2.2 m and divided by 2.2 (1 for a miss).
  All 8 × 16 march points are sampled in one gather and the first hit per
  ray taken, which gives the values of the step-by-step march.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mocca_envs_tpu_torch.envs.env import EnvState, FnEnv, Transition, make_fn_env
from mocca_envs_tpu_torch.models import walker3d
from mocca_envs_tpu_torch.tasks import base as T
from mocca_envs_tpu_torch.tasks.walker_custom import WalkerParams, make_walker3d_custom
from mocca_envs_tpu_torch.terrain.heightfield import fractal_heightfield, with_heightfield
from mocca_envs_tpu_torch.terrain.scene import HF_PATCH, extract_patch, hf_sample
from mocca_envs_tpu_torch.utils.config import EngineConfig
from mocca_envs_tpu_torch.utils.device import resolve_device

N_BANK = 16
# terrain probes: (forward, left) offsets in the heading frame [m]; mirror
# pairs under y-reflection 3↔4, 5↔6
PROBE_OFFSETS = np.array(
    [(0.35, 0.0), (0.70, 0.0), (1.05, 0.0), (0.35, 0.35), (0.35, -0.35),
     (0.70, 0.70), (0.70, -0.70), (-0.35, 0.0)], dtype=np.float32)
PROBE_MIRROR = (0, 1, 2, 4, 3, 6, 5, 7)
# the LIDAR fan: 8 rays, yaw ±75° in the heading frame, pitched 45° down,
# from 0.3 m above the root; the symmetric fan reverses under the mirror
LIDAR_YAWS = np.linspace(-1.309, 1.309, 8).astype(np.float32)
LIDAR_PITCH = np.float32(np.pi / 4)
LIDAR_MAX_T = 2.2
LIDAR_STEPS = 16
LIDAR_MIRROR = tuple(range(7, -1, -1))


def terrain_bank(grid: int = 65, amplitude: float = 0.25, terrain_seed: int = 0) -> np.ndarray:
    """The family's ``N_BANK`` grids, (N_BANK, grid, grid) float32."""
    return np.stack([fractal_heightfield(grid, amplitude=amplitude, seed=terrain_seed * 1000 + i)
                     for i in range(N_BANK)])


def make_walker3d_terrain(
    config: EngineConfig | None = None,
    params: WalkerParams | None = None,
    device=None,
    name: str = "Walker3DTerrainEnv",
    grid: int = 65,
    extent: float = 20.0,
    amplitude: float = 0.25,
    terrain_seed: int = 0,
    lidar: bool = False,
) -> FnEnv:
    """Build the terrain family on ``device`` (None = the CUDA card);
    ``lidar`` appends the ray fan to the observation."""
    device = resolve_device(device)
    base = make_walker3d_custom(config=config, params=params, device=device, name=name,
                                initial_z=walker3d.INITIAL_Z)
    bank = torch.as_tensor(terrain_bank(grid, amplitude, terrain_seed), device=device)
    offsets = torch.as_tensor(PROBE_OFFSETS, device=device)
    K = len(PROBE_OFFSETS)
    cp, sp = float(np.cos(LIDAR_PITCH)), float(np.sin(LIDAR_PITCH))
    yaws = torch.as_tensor(LIDAR_YAWS, device=device)
    ray_local = torch.stack([cp * torch.cos(yaws), cp * torch.sin(yaws),
                             torch.full_like(yaws, -sp)], dim=1)                  # (R, 3)
    R = len(LIDAR_YAWS)
    march_t = torch.arange(1, LIDAR_STEPS + 1, dtype=torch.float32, device=device) * (
        LIDAR_MAX_T / LIDAR_STEPS)                                               # (S,)
    lift = torch.tensor([0.0, 0.0, 0.3], device=device)

    def reset(gen: torch.Generator, reset_count: torch.Tensor, prev=None) -> EnvState:
        state = base.reset(gen, reset_count)
        B = reset_count.shape[0]
        if prev is None:
            pick = torch.randint(0, N_BANK, (B,), generator=gen, device=device)
            scene = with_heightfield(bank[pick], extent)
        else:
            scene = prev.scene
        # the spawn stands on the surface under it; the target sits on it
        hs = hf_sample(scene, torch.stack([state.q[:, 0:2], state.task.target[:, 0:2]], dim=1))
        state.q[:, 2] += hs[:, 0]
        state.task.target[:, 2] = hs[:, 1]
        return dataclasses.replace(state, scene=scene)

    def probes(state: EnvState, scene) -> torch.Tensor:
        """K heights around the root in the heading frame, minus the height
        under the root, (B, K)."""
        q = state.q
        yaw = T.heading_yaw(q)
        c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
        world = q[:, None, 0:2] + torch.stack(
            [c * offsets[:, 0] - s * offsets[:, 1], s * offsets[:, 0] + c * offsets[:, 1]],
            dim=2)                                                               # (B, K, 2)
        h = hf_sample(scene, torch.cat([world, q[:, None, 0:2]], dim=1))
        return h[:, :K] - h[:, K:]

    def lidar_obs(state: EnvState, scene) -> torch.Tensor:
        """The fan's hit parameters over ``LIDAR_MAX_T``, (B, R): every march
        point of every ray sampled at once, the first at or under the
        surface taken."""
        q = state.q
        B = q.shape[0]
        yaw = T.heading_yaw(q)
        c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
        dw = torch.stack([c * ray_local[:, 0] - s * ray_local[:, 1],
                          s * ray_local[:, 0] + c * ray_local[:, 1],
                          ray_local[:, 2].expand(B, R)], dim=2)                  # (B, R, 3)
        origin = q[:, 0:3] + lift
        p = origin[:, None, None, :] + march_t[None, None, :, None] * dw[:, :, None, :]
        h = hf_sample(scene, p[..., :2].reshape(B, R * LIDAR_STEPS, 2)).reshape(
            B, R, LIDAR_STEPS)
        below = p[..., 2] <= h
        first = torch.argmax(below.to(torch.uint8), dim=2)
        t_hit = torch.where(below.any(dim=2), march_t[first],
                            torch.full_like(march_t[:1], LIDAR_MAX_T))
        return t_hit / LIDAR_MAX_T

    def tails(state: EnvState, scene) -> list:
        return [probes(state, scene)] + ([lidar_obs(state, scene)] if lidar else [])

    def obs_fn(state: EnvState) -> torch.Tensor:
        return torch.cat([base.obs_fn(state), *tails(state, state.scene)], dim=1)

    def reset_obs_fn(state: EnvState) -> torch.Tensor:
        return torch.cat([base.reset_obs_fn(state), *tails(state, state.scene)], dim=1)

    def raw_step(state: EnvState, action: torch.Tensor, gen: torch.Generator) -> Transition:
        # one window per control step, read by the physics, the fall test,
        # the probes and the LIDAR
        patch = extract_patch(state.scene, state.q[:, 0:2], HF_PATCH)
        tr = base.step_no_reset(dataclasses.replace(state, scene=patch), action, gen)
        target = tr.state.task.target
        target[:, 2] = hf_sample(state.scene, target[:, :2])
        st = dataclasses.replace(tr.state, scene=state.scene)
        obs = torch.cat([tr.obs, *tails(st, patch)], dim=1)
        return dataclasses.replace(tr, state=st, obs=obs)

    extra = K + (R if lidar else 0)
    mirror = dict(base.mirror)
    nb = base.obs_dim
    perm = [nb + p for p in PROBE_MIRROR] + ([nb + K + p for p in LIDAR_MIRROR] if lidar else [])
    mirror["obs_perm"] = torch.cat([mirror["obs_perm"],
                                    torch.as_tensor(perm, dtype=torch.int64, device=device)])
    mirror["obs_sign"] = torch.cat([mirror["obs_sign"], torch.ones(extra, device=device)])
    return make_fn_env(
        name=name, obs_dim=base.obs_dim + extra, act_dim=base.act_dim, reset=reset,
        raw_step=raw_step, obs_fn=obs_fn, control_dt=base.control_dt, device=device,
        mirror=mirror, model=base.model, reset_obs_fn=reset_obs_fn,
    )
