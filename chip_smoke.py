"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

1. print the card's name and power limit; build every instantiation of the
   engine kernel from ``mocca_envs_tpu_torch/csrc/engine_k1.cu`` and the
   raycast kernel K2 from ``csrc/raycast_k2.cu`` (one nvcc process each,
   side by side), and print each one's ptxas registers and stack frame;
2. each kernel vs its plain PyTorch version at B = 4096: K1a on walker
   states near contact, K1c on stepper states (stones at stages 0–9, feet
   in or near contact with tilted stone tops, some envs over a gap), K1b on
   the K1a states with random joint targets, and the K1b instance for two
   llc frames (no registered family runs it yet) on the same states; K1e on
   Cassie and Cassie2D states near the stand pose (feet in or near contact,
   rods slightly open, the planar variant a little out of its plane) and on
   Walker2D states; K1d on monkey states hanging from bars drawn by the
   port's sampler at stages 0–9 (the right hand attached, the left in half
   of the envs, anchors at the palms ±1 cm, bars moved next to the feet and
   the torso in half of the envs, random torques); K1f on walker states
   over the terrain families' grids (the lowest foot within ±2 cm of the
   surface under it, on the grid's slopes, a tenth of the roots within
   0.5 m of its edge, the window around the root packed as the main path
   packs it), and a grid smaller than the window must raise on the card;
   K1g on walker states on the stairs' staircase (a third each with the
   feet over treads, the lowest foot sphere at a nosing edge, the foremost
   against a riser; the 16 nearest of the 24 faces packed as the main path
   packs them); K1h-si on the K1a states with split impulse; its twins
   K1h-c, K1h-e, K1h-e2d and K1h-d (split impulse over the stones, on
   Cassie's whole PD step with the rods, with the planar lock added, and
   over the monkey's bars with its grab rows) on the K1c, Cassie, Cassie2D
   and K1d states, each held to its twin's gate. Per-env median and p99
   of |Δq|, |Δqd|, |Δdepth|, |Δimpulse|; the medians must stay within q
   2e-4, qd 5e-3, depth 2e-4, impulse 5e-3 (K1e: q 5e-4, qd 2e-2, depth
   5e-4, impulse 5e-3, the tolerances the JAX package holds its own kernel
   to over equality rows; K1d: the same with impulse 1e-2, the looser of
   its gates for grab rows and for bars), and the largest single-env error
   within ten times those. For the two Cassie instances and K1d the
   ten-times gate holds the 99th percentile instead of the largest env,
   and the envs beyond it are counted and printed: over
   the 20 stiff substeps of one call (a 0.15 kg toe under k_d = 5, springs
   of 1500 N·m/rad) two roundings of one iteration part by more than any
   pointwise tolerance in a few envs of a thousand, the plain path against
   the JAX oracle on the CPU as well (tests/test_torch_cassie_step.py).
   K1f is held to the JAX package's heightfield gate: medians within q
   2e-4, qd 1e-2, depth 5e-4, impulse 1e-2, the largest env within ten
   times. K1g's ten-times gate holds the 99th percentile of the envs with
   no contact on a vertical face (:func:`vertical_contacts` says why; the
   others beyond it are counted), and at least 97% of its q entries must
   lie within 1e-3 of the plain version's (the JAX package's mesh gate).
   K2 on 32,768 rays (4096 envs × 8) over a 129² fractal grid, 64
   steps to ``max_t`` 10: t equal to the plain version's on at least 99.9%
   of the rays, any other ray one march step apart, h within 1e-5 where t
   agrees;
3. the main paths through ``BatchedEnv(make(id), 4096).step`` with uniform
   random actions, the launch counts set to 0 just before each and read
   just after: ``Walker3DCustomEnv-v0`` for 600 control steps (K1a),
   ``Walker3DStepperEnv-v0`` for 600 (K1c), ``Walker3DPDCustomEnv-v0`` for
   200 (K1b), ``Child3DCustomEnv-v0`` for 100 (K1a), ``CassieEnv-v0`` for
   300, ``Cassie2DEnv-v0`` for 100, ``Walker2DCustomEnv-v0`` for 200 and
   ``Crab2DCustomEnv-v0`` for 100 (K1e), ``Monkey3DStepperEnv-v0`` for 300
   (K1d, grab signals included in the random actions),
   ``Walker3DTerrainEnv-v0`` for 600 and ``Walker3DTerrainLidarEnv-v0`` for
   200 (K1f), ``Walker3DStairsEnv-v0`` for 600 (K1g),
   ``Walker3DCustomEnv-v0`` made with ``EngineConfig(split_impulse=True)``
   for 200 (K1h-si), and K2's own entry point ``make_raycaster`` for 10 calls of
   32,768 rays with the origins moved between calls. The path's kernel
   must launch exactly once per step and no other kernel at all, the state
   stay finite and auto-reset fire; resets forced by a non-finite state are
   counted and printed; of the 2D families the median env must end in its
   plane (|y| < 0.02 m, the lock's roll and yaw measures < 0.05), the worst
   is printed; of the monkey the bars reached, the share of envs holding on
   and the falls are printed, and then 50 steps of zero torques with both
   grab signals on from fresh episodes must hang the body: the median
   palm-to-anchor distance under 2 cm, the median base height within 0.5 m
   of its start, fewer than 1% of the envs falling; of the terrain
   families the falls and the base's height above the local surface are
   printed, its median between 0.3 and 1.5 m; of the stairs the same over
   the mesh's support surface, and the slots whose root was over a tread;
   then the training path, ``python -m mocca_envs_tpu_torch.harness.train
   --split-impulse`` through its ``main``: ``Walker3DStepperEnv`` with
   4096 envs, horizon 128, 2 updates with a checkpoint, then the same to 3
   updates, which must resume from update 2 (exactly 384 ``k1h_c`` launches
   over both runs and no other kernel); ``CassieEnv`` and ``Cassie2DEnv``
   (64 ``k1h_e`` launches each: PD launches once per control step) and
   ``Monkey3DStepperEnv`` (64 ``k1h_d``), 2 updates at horizon 32. Every
   metric line must be finite but the env channels the learner leaves NaN
   (no episode ended), and each prints env-steps/s and the seconds of the
   rollout and of the PPO update per update. ``--split-impulse`` on a
   family without an instance (the PD walker, Walker2D, terrain, stairs)
   must raise NotImplementedError, naming it, before any launch;
4. per-call times of each kernel and its plain version (CUDA events), the
   bound from the operations and bytes these inputs need, and the time of
   the stepper's cull of 20 stones to the window plus their packing (env
   layer, once per control step, outside the kernel's time), and the
   stepper's step split into the step proper and the fresh episodes of
   auto-reset; K2's time and bound (the march steps these rays need);
   the terrain step's window cut and packing; the step time outside the
   kernel of Cassie, the planar walkers, the monkey, the terrain families,
   the stairs and the split-impulse walker; the training rollouts' time per
   env step outside the kernel; a ``torch.profiler`` trace of one stepper
   update at horizon 16 (``--profile-dir``): the device's busy share and
   its largest kernels;
5. one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import logging
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

B = 4096
SEED = 0
# per-env median tolerances of tests/test_pallas_engine.py (kernel vs
# oracle), and those of its equality-row case
TOL = {"q": 2e-4, "qd": 5e-3, "depth": 2e-4, "nimp": 5e-3}
TOL_EQ = {"q": 5e-4, "qd": 2e-2, "depth": 5e-4, "nimp": 5e-3}
# over bars and grab rows: the looser of the JAX package's two gates for
# what K1d combines (equality rows with grabs, and bars)
TOL_GRAB = {"q": 5e-4, "qd": 2e-2, "depth": 5e-4, "nimp": 1e-2}
# over a heightfield: the JAX package's gate for its heightfield kernel
TOL_HF = {"q": 2e-4, "qd": 1e-2, "depth": 5e-4, "nimp": 1e-2}
# published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
SOURCE = "mocca_envs_tpu_torch/csrc/engine_k1.cu"
REPLACES = "mocca_envs_tpu/ops/pallas/engine.py:216"
RAYCAST_SOURCE = "mocca_envs_tpu_torch/csrc/raycast_k2.cu"
RAYCAST_REPLACES = "mocca_envs_tpu/ops/pallas/raycast.py:91"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def near_contact_states(model, rng, batch=B):
    """Walker states with the base around 0.9 m over the plane z = 0: feet
    in or near contact. Numpy ``(q, qd, tau, ground_z, friction)``."""
    q = np.zeros((batch, model.nq), np.float32)
    q[:, 2] = 0.9 + 0.05 * rng.standard_normal(batch)
    q[:, 3:7] = np.array([1.0, 0.0, 0.0, 0.0]) + 0.03 * rng.standard_normal((batch, 4))
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q[:, 7:] = 0.1 * rng.standard_normal((batch, model.nj))
    qd = (0.3 * rng.standard_normal((batch, model.nv))).astype(np.float32)
    gain = model.power_coef.cpu().numpy()
    tau = (rng.uniform(-1.0, 1.0, (batch, model.nj)) * gain).astype(np.float32)
    return q, qd, tau, np.zeros(batch, np.float32), np.full(batch, 0.8, np.float32)


def pd_target_states(model, rng, batch=B):
    """The near-contact states with uniform random joint targets inside the
    limits in place of the torques."""
    q, qd, _, gz, fric = near_contact_states(model, rng, batch)
    lo, hi = model.limit_lo.cpu().numpy(), model.limit_hi.cpu().numpy()
    targets = rng.uniform(lo, hi, (batch, model.nj)).astype(np.float32)
    return q, qd, targets, gz, fric


def stepper_states(model, rng, window: int, batch=B):
    """Walker states over stepping stones: chains at stages 0–9 (one stage
    per slot, in turn), the root about 0.9 m above the top of one of the
    first stones with a horizontal scatter that puts feet on tops, edges and
    neighbours, and one slot in ten moved sideways over the gap, where only
    the plane at −20 m is below. Returns numpy ``(q, qd, tau, ground_z,
    friction)`` and the culled stones, packed ``(window·11, batch)``."""
    from mocca_envs_tpu_torch.ops.cuda.engine import pack_stones
    from mocca_envs_tpu_torch.terrain import scene as scene_mod
    from mocca_envs_tpu_torch.terrain.stones import (
        StoneParams, stones_from_draws, stones_to_scene_boxes)

    params = StoneParams()
    stage = torch.as_tensor(np.arange(batch) % 10, dtype=torch.float32)
    draws = torch.as_tensor(rng.random((batch, 5, params.num_steps)), dtype=torch.float32)
    top, quat = stones_from_draws(params, stage, draws, torch.zeros(batch, 3))
    center, half = stones_to_scene_boxes(params, top, quat)
    q, qd, tau, _, fric = near_contact_states(model, rng, batch)
    under = top.numpy()[np.arange(batch), rng.integers(0, 8, batch)]
    q[:, 0:2] = under[:, :2] + 0.12 * rng.standard_normal((batch, 2))
    q[:, 1] += np.where(rng.random(batch) < 0.1, 2.0, 0.0)
    q[:, 2] += under[:, 2]
    scene = scene_mod.with_stones(center, quat, half, ground_z=-20.0)
    culled = scene_mod.cull_stones(scene, torch.as_tensor(q[:, 0:2]), window)
    return q, qd, tau, culled.ground_z.numpy(), fric, pack_stones(culled).numpy()


def cassie_states(model, stand, initial_z: float, rng, planar: bool, batch=B):
    """Cassie states near the stand pose: the pelvis 3 mm under its standing
    height, give or take 3 mm, so that the feet are in or near contact; a
    small tilt; ±5 mrad of joint noise, which leaves the achilles rods a few
    millimetres open; for the planar variant a small drift out of the plane
    (y, roll, yaw). The ``tau`` slot holds PD targets: the stand pose plus
    uniform ±0.05 rad on the motors. Numpy ``(q, qd, targets, ground_z,
    friction)``."""
    q = np.zeros((batch, model.nq), np.float32)
    q[:, 2] = initial_z - 0.003 + 0.003 * rng.standard_normal(batch)
    tilt = 0.005 * rng.standard_normal((batch, 4))
    if planar:
        q[:, 1] = 2e-3 * rng.standard_normal(batch)
        tilt[:, [1, 3]] *= 0.1
    q[:, 3:7] = np.array([1.0, 0.0, 0.0, 0.0]) + tilt
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q[:, 7:] = stand + rng.uniform(-0.005, 0.005, (batch, model.nj))
    qd = (0.05 * rng.standard_normal((batch, model.nv))).astype(np.float32)
    if planar:
        qd[:, [1, 3, 5]] *= 0.05
    motors = model.actuated.cpu().numpy()
    targets = (stand + motors * rng.uniform(-0.05, 0.05, (batch, model.nj))).astype(np.float32)
    return q, qd, targets, np.zeros(batch, np.float32), np.full(batch, 0.8, np.float32)


def planar_walker_states(model, stand_z: float, rng, batch=B):
    """Walker2D / Crab2D states with the feet in or near contact: the base
    around ``stand_z``, pitched a little, joints near zero inside their
    limits, a small drift out of the plane, uniform random torques. Numpy
    ``(q, qd, tau, ground_z, friction)``."""
    q = np.zeros((batch, model.nq), np.float32)
    q[:, 1] = 2e-3 * rng.standard_normal(batch)
    q[:, 2] = stand_z + 0.03 * rng.standard_normal(batch)
    tilt = 0.03 * rng.standard_normal((batch, 4))
    tilt[:, [1, 3]] *= 0.1
    q[:, 3:7] = np.array([1.0, 0.0, 0.0, 0.0]) + tilt
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    lo, hi = model.limit_lo.cpu().numpy(), model.limit_hi.cpu().numpy()
    q[:, 7:] = np.clip(0.1 * rng.standard_normal((batch, model.nj)), lo, hi)
    qd = (0.3 * rng.standard_normal((batch, model.nv))).astype(np.float32)
    qd[:, [1, 3, 5]] *= 0.05
    gain = model.power_coef.cpu().numpy()
    tau = (rng.uniform(-1.0, 1.0, (batch, model.nj)) * gain).astype(np.float32)
    return q, qd, tau, np.zeros(batch, np.float32), np.full(batch, 0.8, np.float32)


def monkey_states(model, rng, batch=B, left: float = 0.5, right: float = 1.0,
                  near_bar: float = 0.5):
    """Monkey states hanging from the bars: chains from the port's sampler at
    stages 0–9 (one stage per slot, in turn), the hang pose with ±0.3 rad of
    joint noise, the base placed so that the right palm is on one of the
    first four bars. The right hand is attached in a ``right`` share of the
    envs and the left in a ``left`` share, each anchored at its palm ±1 cm.
    In a ``near_bar`` share of the envs each of the two feet and the torso in
    turn gets one of the last bars moved to within −1 to +2 cm of its sphere
    (the contact margin is 2 cm), on a random side. Random velocities and
    uniform random torques. Returns numpy ``(q, qd, tau, ground_z,
    friction, bars (16·8, batch), grabs (2·4, batch))``."""
    from mocca_envs_tpu_torch.models import monkey
    from mocca_envs_tpu_torch.ops.cuda.engine import pack_bars, pack_grabs
    from mocca_envs_tpu_torch.ops.collide import sphere_centers
    from mocca_envs_tpu_torch.ops.kinematics import forward_kinematics
    from mocca_envs_tpu_torch.tasks import monkey_stepper as ms

    model = model.to("cpu")
    spec = monkey.constraints()
    params = ms.MonkeyParams()
    K = params.num_bars
    stage = torch.as_tensor(np.arange(batch) % 10, dtype=torch.float32)
    pos, axis = ms.bars_from_draws(
        params, stage, torch.as_tensor(rng.random((batch, 3, K)), dtype=torch.float32))
    pos, axis = pos.numpy(), axis.numpy()
    lo, hi = model.limit_lo.numpy(), model.limit_hi.numpy()
    qj = np.clip(ms.hang_qj(model).numpy() + rng.uniform(-0.3, 0.3, (batch, model.nj)), lo, hi)
    rows = np.arange(batch)
    held = rng.integers(0, 4, batch)
    palms_of = ms.make_palm_positions(model, spec)
    q, _ = ms.hang_from(palms_of, torch.as_tensor(qj, dtype=torch.float32),
                        torch.as_tensor(pos[rows, held]), torch.as_tensor(axis[rows, held]))
    palms = palms_of(q).numpy()
    q = q.numpy()
    active = np.stack([rng.random(batch) < right, rng.random(batch) < left], axis=1)
    target = palms + rng.uniform(-0.01, 0.01, palms.shape)
    # bars moved next to the feet and the torso: the last three of the chain
    fd = forward_kinematics(model, torch.as_tensor(q), torch.zeros(batch, model.nv))
    centers = sphere_centers(model, fd).numpy()
    radius = model.sph_radius.numpy()
    for k, s in enumerate(np.flatnonzero(model.sph_no_bar.numpy() < 0.5)):
        moved = rows[rng.random(batch) < near_bar]
        side = rng.standard_normal((len(moved), 3))
        side -= (side * axis[moved, K - 1 - k]).sum(1, keepdims=True) * axis[moved, K - 1 - k]
        side /= np.linalg.norm(side, axis=1, keepdims=True)
        gap = radius[s] + monkey.BAR_RADIUS + rng.uniform(-0.01, 0.02, len(moved))
        along = rng.uniform(-0.3, 0.3, len(moved))[:, None] * axis[moved, K - 1 - k]
        pos[moved, K - 1 - k] = centers[moved, s] - gap[:, None] * side - along
    scene = ms.bar_scene(torch.as_tensor(pos), torch.as_tensor(axis))
    qd = (0.3 * rng.standard_normal((batch, model.nv))).astype(np.float32)
    gain = model.power_coef.numpy()
    tau = (rng.uniform(-1.0, 1.0, (batch, model.nj)) * gain).astype(np.float32)
    grabs = pack_grabs(torch.as_tensor(active, dtype=torch.float32),
                       torch.as_tensor(target, dtype=torch.float32))
    return (q, qd, tau, scene.ground_z.numpy(), scene.friction.numpy(),
            pack_bars(scene).numpy(), grabs.numpy())


def terrain_states(model, rng, batch=B, border: float = 0.1):
    """Walker states over the terrain families' grids: each slot over one
    grid of the bank, the root anywhere on it and in a ``border`` share of
    the slots within 0.5 m of an edge, the lowest foot sphere placed within
    ±2 cm of the surface under it (in contact or within the margin), on
    whatever slope the grid has there; uniform random torques. Returns numpy
    ``(q, qd, tau, ground_z, friction, hf (batch, 16·16 + 3))``: the window
    around the root, packed as K1f reads it."""
    from mocca_envs_tpu_torch.ops.collide import sphere_centers
    from mocca_envs_tpu_torch.ops.cuda.engine import pack_hf
    from mocca_envs_tpu_torch.ops.kinematics import forward_kinematics
    from mocca_envs_tpu_torch.tasks.walker_terrain import terrain_bank
    from mocca_envs_tpu_torch.terrain import scene as scene_mod
    from mocca_envs_tpu_torch.terrain.heightfield import with_heightfield

    model = model.to("cpu")
    bank = terrain_bank()
    scene = with_heightfield(torch.as_tensor(bank[rng.integers(0, len(bank), batch)]))
    q, qd, tau, _, fric = near_contact_states(model, rng, batch)
    q[:, 0:2] = rng.uniform(-9.5, 9.5, (batch, 2))
    edge = np.flatnonzero(rng.random(batch) < border)
    q[edge, rng.integers(0, 2, len(edge))] = rng.choice([-1.0, 1.0], len(edge)) * rng.uniform(
        9.5, 10.0, len(edge))
    feet = np.flatnonzero(model.sph_foot.sum(1).numpy() > 0)
    centers = sphere_centers(model, forward_kinematics(
        model, torch.as_tensor(q), torch.zeros(batch, model.nv)))[:, feet]
    gap = (centers[..., 2] - model.sph_radius[feet]
           - scene_mod.hf_sample(scene, centers[..., :2])).amin(dim=1).numpy()
    q[:, 2] -= gap + rng.uniform(-0.02, 0.02, batch)
    window = scene_mod.extract_patch(scene, torch.as_tensor(q[:, 0:2]))
    return (q, qd, tau, window.ground_z.numpy(), fric, pack_hf(window).numpy())


def stairs_states(model, rng, batch=B):
    """Walker states on the stairs family's staircase (6 steps of 0.12 m by
    0.35 m from x = 0.6 m, 4 m wide), a third each with the feet over the
    treads (the root anywhere from 0.3 to 2.9 m), with the lowest foot
    sphere's center within ±3 cm of a nosing edge in x, and with the
    foremost foot sphere against a riser (its center one radius in front of
    the riser face, give or take 2 cm); the root's y within ±1.5 m. The body
    is then lowered until the lowest foot sphere is within ±2 cm of the
    support surface under it, which keeps every sphere out of the steps'
    solid. Uniform random torques. Returns numpy ``(q, qd, tau, ground_z,
    friction, tris (16·10, batch))``: the 24 faces culled to the 16 nearest
    the root and packed, as the main path packs them."""
    from mocca_envs_tpu_torch.ops.collide import sphere_centers
    from mocca_envs_tpu_torch.ops.cuda.engine import pack_tris
    from mocca_envs_tpu_torch.ops.kinematics import forward_kinematics
    from mocca_envs_tpu_torch.terrain import scene as scene_mod

    model = model.to("cpu")
    rise, run, start = 0.12, 0.35, 0.6
    scene = scene_mod.broadcast_scene(scene_mod.stairs_trimesh(
        n_steps=6, rise=rise, run=run, width=4.0, start_x=start), batch)
    q, qd, tau, _, fric = near_contact_states(model, rng, batch)
    feet = np.flatnonzero(model.sph_foot.sum(1).numpy() > 0)
    radius = model.sph_radius[feet].numpy()

    def foot_centers():
        return sphere_centers(model, forward_kinematics(
            model, torch.as_tensor(q), torch.zeros(batch, model.nv)))[:, feet].numpy()

    q[:, 0:3] = 0.0
    c = foot_centers()
    rows = np.arange(batch)
    feature = np.arange(batch) % 3
    x0 = start + run * rng.integers(0, 6, batch)
    low, front = c[..., 2].argmin(axis=1), c[..., 0].argmax(axis=1)
    x_root = np.select(
        [feature == 0, feature == 1],
        [rng.uniform(0.3, 2.9, batch), x0 + rng.uniform(-0.03, 0.03, batch) - c[rows, low, 0]],
        x0 - radius[front] + rng.uniform(-0.02, 0.02, batch) - c[rows, front, 0])
    q[:, 0] = x_root
    q[:, 1] = rng.uniform(-1.5, 1.5, batch)
    c = foot_centers()
    support = np.stack([scene_mod.tri_surface_z(scene, torch.as_tensor(c[:, i, :2])).numpy()
                        for i in range(len(feet))], axis=1)
    clearance = (c[..., 2] - radius - support).min(axis=1)
    q[:, 2] -= clearance + rng.uniform(-0.02, 0.02, batch)
    culled = scene_mod.cull_tris(scene, torch.as_tensor(q[:, 0:2]), 16)
    return (q, qd, tau, culled.ground_z.numpy(), fric, pack_tris(culled).numpy())


def raycast_inputs(rng, batch: int, n: int = 129):
    """Rays over a fractal ``n × n`` grid 20 m wide (the terrain families'
    extent): origins 0.5–2.5 m above it, over it and up to 2 m past its
    edges, directions pitched 5–85° down in any heading, one in sixteen
    pointing up. Numpy ``(origins, directions, grid, xy0, cell)``."""
    from mocca_envs_tpu_torch.terrain.heightfield import fractal_heightfield

    hf = fractal_heightfield(n, amplitude=0.5, seed=int(rng.integers(0, 2**31)))
    origins = np.stack([rng.uniform(-12.0, 12.0, batch), rng.uniform(-12.0, 12.0, batch),
                        rng.uniform(0.5, 2.5, batch)], axis=1).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, batch)
    pitch = rng.uniform(np.deg2rad(5.0), np.deg2rad(85.0), batch)
    pitch[rng.random(batch) < 1 / 16] *= -1.0
    d = np.stack([np.cos(pitch) * np.cos(yaw), np.cos(pitch) * np.sin(yaw), -np.sin(pitch)],
                 axis=1).astype(np.float32)
    return (origins, d, hf, np.array([-10.0, -10.0], np.float32),
            np.array(20.0 / (n - 1), np.float32))


def check_rays(t, h, want_t, want_h, dt: float) -> tuple:
    """K2's gate against its plain version (numpy arrays): t equal on at
    least 99.9% of the rays, any other ray one march step ``dt`` apart (a
    march point within an ulp of the surface), h within 1e-5 where t
    agrees. Returns (share of equal t, largest |Δt|, largest |Δh| where t
    agrees)."""
    same = t == want_t
    share = float(same.mean())
    dt_err = float(np.abs(t - want_t).max())
    h_err = float(np.abs(h - want_h)[same].max()) if same.any() else 0.0
    check(share >= 0.999, f"k2: t equal on only {share:.5f} of the rays")
    step_apart = np.abs(np.abs(t - want_t)[~same] - dt) <= 1e-5 * max(1.0, dt)
    check(bool(step_apart.all()), f"k2: {int((~step_apart).sum())} rays part by more than a "
          f"march step (largest |dt| {dt_err:.3e})")
    check(h_err <= 1e-5, f"k2: h differs by {h_err:.3e} where t agrees")
    return share, dt_err, h_err


def vertical_contacts(kernel, args) -> torch.Tensor:
    """Envs (bool (B,)) with an active contact on a vertical face (|n_z| <
    1e-3) at any substep of the plain version's run of one call. There the
    branchless tangent basis (ops/solver.py::tangent_basis) switches the sign
    of its first tangent with the sign of n_z, which rounding decides, while
    the warm-started friction impulse keeps the previous substep's sign: two
    roundings of one state can part by O(1) within a call (the JAX package's
    oracle and kernel part the same way; its mesh gate is 97% of q within
    1e-3)."""
    from mocca_envs_tpu_torch.ops.kinematics import forward_kinematics
    from mocca_envs_tpu_torch.ops.step import make_substep

    model, config = kernel.model, kernel.config
    substep = make_substep(model, config)
    q, qd, tau, gz, fric = args[:5]
    scene, _, _ = kernel.unpack(gz, fric, *args[5:])
    lam = q.new_zeros(q.shape[0], substep.num_rows)
    Minv0 = substep.minv_of(forward_kinematics(model, q, qd))
    vertical = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    for _ in range(config.sim_substeps):
        q, qd, info, lam = substep(q, qd, tau, scene, Minv_in=Minv0, lam_in=lam)
        c = info.contacts
        vertical |= ((c.normal[..., 2].abs() < 1e-3) & (c.active > 0.5)).any(dim=1)
    return vertical


def compare(kernel, args, label: str | None = None, tol=TOL, tail: str = "max",
            tail_envs=None) -> float:
    """Launch ``kernel`` once on ``args`` and hold it against its plain
    version: per-env medians within ``tol``, and ten times ``tol`` for the
    largest env (``tail="max"``) or the 99th percentile (``tail="p99"``, with
    the envs beyond counted); ``tail_envs`` (bool (B,)) limits the tail gate
    to those envs, the others beyond it counted. Returns the largest absolute
    error over all outputs."""
    label = label or kernel.variant
    out = kernel.launch(*args)
    torch.cuda.synchronize()
    ref = kernel.plain(*args)
    torch.cuda.synchronize()
    max_abs = 0.0
    held = np.ones(args[0].shape[0], bool) if tail_envs is None else tail_envs.cpu().numpy()
    for name, a, b in zip(("q", "qd", "depth", "nimp"), out, ref):
        check(bool(torch.isfinite(a).all()), f"{label} output {name} not finite")
        per_env = (a - b).abs().amax(dim=1).cpu().numpy()
        med, p99 = float(np.median(per_env)), float(np.quantile(per_env, 0.99))
        max_abs = max(max_abs, float(per_env.max()))
        beyond = per_env > 10 * tol[name]
        worst = (float(np.quantile(per_env[held], 0.99)) if tail == "p99"
                 else float(per_env[held].max()))
        print(f"[compare] {label} {name}: per-env median {med:.3e} p99 {p99:.3e} "
              f"max {per_env.max():.3e} (median tol {tol[name]:g}, {tail} tol "
              f"{10 * tol[name]:g}, {int(beyond.sum())} of {len(per_env)} envs beyond it"
              + ("" if tail_envs is None else
                 f"; over the {int(held.sum())} gated envs {tail} {worst:.3e}, "
                 f"{int((beyond & ~held).sum())} of the {int((~held).sum())} others beyond")
              + ")")
        check(med <= tol[name], f"{label} {name} median {med:.3e} > {tol[name]:g}")
        check(worst <= 10 * tol[name], f"{label} {name} {tail} {worst:.3e} > {10 * tol[name]:g}")
    active = float((ref[2] > -kernel.config.contact_margin).float().sum(1).mean())
    print(f"[compare] {label}: {active:.3f} active contacts per env at the last substep, "
          f"{float((ref[3] > 0).float().mean()):.3f} of the spheres loaded")
    check(float((ref[3] > 0).float().mean()) > 0.02, f"{label}: contacts carry no load")
    if kernel.num_tris:
        # the JAX package's own gate for its mesh kernel
        share = float(((out[0] - ref[0]).abs() < 1e-3).float().mean())
        print(f"[compare] {label}: {share:.5f} of the q entries within 1e-3 (JAX mesh gate 0.97)")
        check(share >= 0.97, f"{label}: only {share:.4f} of q within 1e-3")
    return max_abs


def drive(port, engine, card, env_id: str, steps: int, variant: str, sums=(), watch=None,
          **make_kw):
    """One main path: ``steps`` control steps of uniform random actions
    through the entry points (``make(env_id, **make_kw)``); ``watch`` is
    called on every transition. Returns (launches, final state, last
    transition, the batched env, ms per step, the sums over the run of the
    metrics named in ``sums``)."""
    env = port.make(env_id, **make_kw)
    batch = port.BatchedEnv(env, B, seed=SEED)
    state = batch.init()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    dones = torch.zeros((), dtype=torch.int64, device="cuda")
    totals = {k: torch.zeros((), device="cuda") for k in sums}
    torch.cuda.synchronize()
    engine.LAUNCHES.clear()
    t0 = time.perf_counter()
    for _ in range(steps):
        actions = torch.rand((B, env.act_dim), generator=gen, device="cuda") * 2.0 - 1.0
        tr = batch.step(state, actions)
        state = tr.state
        dones += tr.done.sum()
        for k in sums:
            totals[k] += tr.metrics[k].sum()
        if watch is not None:
            watch(tr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(engine.LAUNCHES)
    launches, dones = counts.get(variant, 0), int(dones)
    print(f"[main] {env_id}: {steps} steps × {B} envs in {wall:.3f} s "
          f"({1e3 * wall / steps:.3f} ms/step): {steps * B / wall:.0f} env-steps/s on {card}; "
          f"launches {counts}")
    check(counts == {variant: steps},
          f"{env_id}: expected {steps} {variant} launches and no other, got {counts}")
    check(bool(torch.isfinite(state.q).all() and torch.isfinite(state.qd).all()),
          f"{env_id}: final state not finite")
    check(tr.obs.shape == (B, env.obs_dim) and bool(torch.isfinite(tr.obs).all()),
          f"{env_id}: observations malformed")
    check(dones > 0 and int(state.reset_count.sum()) > 0, f"{env_id}: auto-reset never fired")
    print(f"[main] {env_id}: episodes ended {dones}, resets {int(state.reset_count.sum())}, "
          f"blow-ups {int(state.blowup_count.sum())}, mean episode steps now "
          f"{float(state.steps.float().mean()):.1f}")
    return launches, state, tr, batch, 1e3 * wall / steps, {k: float(v) for k, v in totals.items()}


def hang_check(batch, spec, card) -> None:
    """50 control steps of zero torques with both grab signals on, from
    fresh episodes, without auto-reset: the body must hang from its bar."""
    from mocca_envs_tpu_torch.tasks.monkey_stepper import make_palm_positions

    env = batch.env
    state = env.init(batch.generator, B)
    z0 = state.q[:, 2].clone()
    actions = torch.zeros((B, env.act_dim), device="cuda")
    actions[:, -2:] = 1.0
    fell = torch.zeros(B, dtype=torch.bool, device="cuda")
    for _ in range(50):
        tr = env.step_no_reset(state, actions, batch.generator)
        state = tr.state
        fell |= tr.metrics["fell"] > 0.5
    palms = make_palm_positions(env.model, spec)(state.q)
    gap = torch.linalg.vector_norm(palms - state.task.anchor, dim=2)[state.task.attached > 0.5]
    sag = (z0 - state.q[:, 2]).abs()
    med_gap, med_sag, falls = float(gap.median()), float(sag.median()), float(fell.float().mean())
    print(f"[main] Monkey3DStepperEnv-v0 hang, 50 steps of zero torques on {card}: palm to "
          f"anchor median {med_gap:.4e} m (p99 {float(gap.quantile(0.99)):.4e}), base height "
          f"change median {med_sag:.4e} m, fallen share {falls:.5f}")
    check(med_gap < 0.02, f"hang: the palms left their anchors ({med_gap:.3e} m)")
    check(med_sag < 0.5, f"hang: the body sank {med_sag:.3e} m")
    check(falls < 0.01, f"hang: {falls:.2%} of the envs fell")


def time_call(fn, args, n: int) -> float:
    """Mean ms per call over ``n`` calls after two warm-up calls."""
    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_and_bound(engine, card, kernel, args) -> dict:
    """Per-call times of the kernel (50 calls) and its plain version (3),
    and the bound from the operations and bytes these inputs need."""
    ms = time_call(kernel.launch, args, 50)
    plain_ms = time_call(kernel.plain, args, 3)
    scene_inputs = args[5:]
    stones = args[5] if kernel.num_stones else None
    lim_act, con_act, walk = engine.k1_activity(kernel, *args)
    flops = engine.k1_flops(kernel, lim_act, con_act, *scene_inputs, tri_walk=walk)
    flops_all = engine.k1_flops(kernel, torch.ones_like(lim_act), torch.ones_like(con_act),
                                *scene_inputs, tri_walk=walk)
    nbytes = engine.k1_bytes_per_env(kernel) * B
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    v = kernel.name
    scene_activity = ""
    if stones is not None:
        n_act = float((engine.unpack_stones(stones)["stone_active"] > 0.5).float().sum(1).mean())
        scene_activity = f", active stones {n_act:.3f} of {kernel.num_stones}"
    if kernel.num_bars:
        held = float((engine.unpack_grabs(args[6])[0] > 0.5).float().sum(1).mean())
        scene_activity = f", attached grabs {held:.3f} of {kernel.constraints.num_grabs}"
    if kernel.num_tris:
        n_act = float((engine.unpack_tris(args[5])["tri_active"] > 0.5).float().sum(1).mean())
        per_pair = float(walk.double().sum()) / (walk.numel() * kernel.model.ns * n_act)
        scene_activity = (f", active faces {n_act:.3f} of {kernel.num_tris}, walk "
                          f"{per_pair:.2f} ops per sphere and face")
    print(f"[bound] {v} active per env and substep: limit rows "
          f"{float(lim_act.float().sum(2).mean()):.3f} of {lim_act.shape[2]}, contacts "
          f"{float(con_act.float().sum(2).mean()):.3f} of {con_act.shape[2]}{scene_activity}; "
          f"{flops} fp32 ops needed ({flops / B:.0f} per env), {flops_all} with every row "
          f"active; {nbytes} bytes")
    print(f"[time] {v} {ms:.4f} ms/call, plain {plain_ms:.3f} ms/call at B={B} on {card}; "
          f"bound {bound_ms:.5f} ms by {bound_by} (ops {t_ops:.5f} ms, bytes {t_bytes:.5f} ms); "
          f"kernel at {bound_ms / ms:.2%} of it")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def cull_and_pack_time(engine, card, model, config) -> None:
    """The stepper's per-control-step pass in front of K1c: cull 20 stones
    to the window nearest the root, pack them for the kernel."""
    from mocca_envs_tpu_torch.terrain import scene as scene_mod
    from mocca_envs_tpu_torch.terrain.stones import (
        StoneParams, sample_stones, stones_to_scene_boxes)

    params = StoneParams()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    stage = torch.arange(B, device="cuda", dtype=torch.float32) % 10
    top, quat = sample_stones(params, gen, stage, torch.zeros(B, 3, device="cuda"))
    center, half = stones_to_scene_boxes(params, top, quat)
    scene = scene_mod.with_stones(center, quat, half, ground_z=-20.0)
    root_xy = top[:, 3, :2].contiguous()
    ms = time_call(
        lambda: engine.pack_stones(scene_mod.cull_stones(scene, root_xy, config.stone_window)),
        (), 50)
    print(f"[time] stepper cull {params.num_steps} → {config.stone_window} stones + pack: "
          f"{ms:.4f} ms/call at B={B} on {card}")


def stepper_env_layer_times(card, batch, state) -> None:
    """Where a stepper control step goes outside K1c: the step without
    auto-reset (physics unit, state machine, reward, observation) and the
    fresh episode that auto-reset builds for every slot every step (joint
    noise, a 20-stone chain, its boxes), each timed alone on the main
    path's final state."""
    env, gen = batch.env, batch.generator
    actions = torch.zeros((B, env.act_dim), device="cuda")
    raw_ms = time_call(env.step_no_reset, (state, actions, gen), 20)
    reset_ms = time_call(env.reset, (gen, state.reset_count, state), 20)
    step_ms = time_call(env.step, (state, actions, gen), 20)
    print(f"[time] stepper env layer at B={B} on {card}: step {step_ms:.3f} ms, of which the "
          f"step without auto-reset {raw_ms:.3f} ms (K1c inside) and the fresh episodes "
          f"{reset_ms:.3f} ms")


def small_grid_raises(model, config) -> None:
    """On the card a heightfield smaller than the K1f window has no
    instance: the physics step must raise, naming it, not fall back."""
    from mocca_envs_tpu_torch.ops.step import make_control_step
    from mocca_envs_tpu_torch.terrain.heightfield import with_heightfield

    step = make_control_step(model, config)
    scene = with_heightfield(torch.zeros(4, 12, 12, device="cuda"), extent=3.0)
    q = torch.zeros(4, model.nq, device="cuda")
    q[:, 2], q[:, 3] = 0.95, 1.0
    try:
        step(q, torch.zeros(4, model.nv, device="cuda"), torch.zeros(4, model.nj, device="cuda"),
             scene)
    except NotImplementedError as e:
        check("smaller than the window" in str(e), f"small grid: unexpected message {e}")
        print(f"[compare] k1f: a 12×12 grid on the card raises: {e}")
        return
    check(False, "a grid smaller than the K1f window ran on the card")


def terrain_readings(env_id: str, state, sums: dict) -> None:
    """The terrain main path's outcome: falls over the run and the base's
    height above the local surface at the end."""
    from mocca_envs_tpu_torch.terrain.scene import hf_sample

    above = state.q[:, 2] - hf_sample(state.scene, state.q[:, 0:2])
    print(f"[main] {env_id}: falls over the run {sums['fallen']:.0f}, base height above the "
          f"local surface at the end mean {float(above.mean()):.4f} m (median "
          f"{float(above.median()):.4f}, min {float(above.min()):.4f})")
    check(0.3 < float(above.median()) < 1.5, f"{env_id}: bodies not over the terrain")


def stairs_readings(state, sums: dict, on_stairs) -> None:
    """The stairs main path's outcome: falls over the run, the slots whose
    root was over a tread at some step (x from 0.6 to 2.7 m, |y| ≤ 2 m), and
    the base's height above the support surface under it at the end."""
    from mocca_envs_tpu_torch.terrain.scene import tri_surface_z

    above = state.q[:, 2] - tri_surface_z(state.scene, state.q[:, 0:2])
    print(f"[main] Walker3DStairsEnv-v0: falls over the run {sums['fallen']:.0f}; slots whose "
          f"root was over a tread at some step {int(on_stairs.sum())} of {B}; base height above "
          f"the support surface at the end mean {float(above.mean()):.4f} m (median "
          f"{float(above.median()):.4f}, min {float(above.min()):.4f})")
    check(0.3 < float(above.median()) < 1.5, "Walker3DStairsEnv-v0: bodies not over the stairs")
    check(state.scene.tri_a.shape == (B, 24, 3), "Walker3DStairsEnv-v0: the mesh is not carried")


def raycast_main_path(engine, card, rng, sweeps: int = 10):
    """K2's entry point, ``make_raycaster``, driven as a LIDAR sweep would:
    ``sweeps`` calls of 32,768 rays (4096 envs × 8 rays) over one 129² grid,
    the origins moved between calls, counts set to 0 just before. Returns
    (launches, the last call's inputs)."""
    from mocca_envs_tpu_torch.ops.raycast import make_raycaster

    o, d, hf, xy0, cell = (torch.as_tensor(x, device="cuda")
                           for x in raycast_inputs(rng, 8 * B))
    raycast = make_raycaster(tuple(hf.shape), max_t=10.0, num_steps=64)
    shift = torch.tensor([0.05, -0.03, 0.0], device="cuda")
    hits = torch.zeros((), device="cuda")
    torch.cuda.synchronize()
    engine.LAUNCHES.clear()
    for i in range(sweeps):
        t, h = raycast(o + i * shift, d, hf, xy0, cell)
        hits += (t < 10.0).sum()
    torch.cuda.synchronize()
    counts = dict(engine.LAUNCHES)
    print(f"[main] make_raycaster: {sweeps} calls × {8 * B} rays on {card}; launches {counts}; "
          f"hits {int(hits)} of {sweeps * 8 * B}")
    check(counts == {"k2": sweeps}, f"make_raycaster: expected {sweeps} k2 launches, got {counts}")
    check(bool(torch.isfinite(t).all() and (t > 0).all() and (t <= 10.0).all()),
          "make_raycaster: t out of range")
    check(0 < int(hits) < sweeps * 8 * B, "make_raycaster: no hits, or no misses")
    return counts["k2"], (o, d, hf, xy0, cell), raycast


def raycast_time_and_bound(card, raycast, args, max_abs: float) -> dict:
    """K2's per-call time (50 calls) against its plain version's (3), and
    the bound from the march steps these rays need and the bytes moved."""
    from mocca_envs_tpu_torch.ops.raycast import (
        K2_OPS_PER_STEP, k2_bytes, k2_flops, raycast_reference)

    ms = time_call(raycast, args, 50)
    plain_ms = time_call(lambda *a: raycast_reference(*a, 10.0, 64), args, 3)
    t, _ = raycast(*args)
    flops, nbytes = k2_flops(t, 10.0, 64), k2_bytes(args[0].shape[0], tuple(args[2].shape))
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"[bound] k2: {flops} fp32 ops needed ({flops / args[0].shape[0]:.1f} per ray, "
          f"{flops / args[0].shape[0] / K2_OPS_PER_STEP:.2f} march steps), {nbytes} bytes")
    print(f"[time] k2 {ms:.4f} ms/call, plain {plain_ms:.3f} ms/call at {args[0].shape[0]} rays "
          f"on {card}; bound {bound_ms:.6f} ms by {bound_by} (ops {t_ops:.6f} ms, bytes "
          f"{t_bytes:.6f} ms); kernel at {bound_ms / ms:.2%} of it; max |err| {max_abs:.3e}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def window_and_pack_time(engine, card, state) -> None:
    """The terrain step's pass in front of K1f: cut the 16×16 window around
    each root from its 65² grid and pack it for the kernel."""
    from mocca_envs_tpu_torch.terrain import scene as scene_mod

    root_xy = state.q[:, 0:2].contiguous()
    ms = time_call(lambda: engine.pack_hf(scene_mod.extract_patch(state.scene, root_xy)), (), 50)
    print(f"[time] terrain window cut 65² → 16² + pack: {ms:.4f} ms/call at B={B} on {card}")


class _Records(logging.Handler):
    """Keeps the messages logged while it is attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def train_run(engine, card, env_id: str, updates: int, horizon: int, workdir: Path,
              expect: dict, resume_updates: int | None = None) -> list:
    """The training path through the CLI's ``main`` with ``--split-impulse``
    at 4096 envs, the launch counts set to 0 just before and read just
    after; with ``resume_updates`` a second run to that many updates from
    the first's checkpoint, which must say it resumed. The kernel launches
    must be ``expect``, every metric finite but the NaN env channels the
    learner allows. Returns the metric lines."""
    from mocca_envs_tpu_torch.harness import train

    ckpt, metrics = workdir / f"{env_id}_ckpt", workdir / f"{env_id}.jsonl"
    base = ["--env", env_id, "--split-impulse", "--num-envs", str(B), "--horizon", str(horizon),
            "--log-every", "1", "--ckpt-dir", str(ckpt), "--metrics", str(metrics)]
    records = _Records()
    logging.getLogger().addHandler(records)
    torch.cuda.synchronize()
    engine.LAUNCHES.clear()
    t0 = time.perf_counter()
    try:
        state = train.main([*base, "--updates", str(updates)])
        if resume_updates is not None:
            state = train.main([*base, "--updates", str(resume_updates)])
    finally:
        logging.getLogger().removeHandler(records)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(engine.LAUNCHES)
    total = resume_updates or updates
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    print(f"[train] {env_id} --split-impulse: {total} updates of {horizon} steps × {B} envs in "
          f"{wall:.3f} s on {card}; launches {counts}")
    for line in lines:
        print(f"[train] {env_id} update {line['step']}: {line['env_steps_per_s']:.0f} env-steps/s, "
              f"rollout {line['rollout_s']:.4f} s, PPO update {line['update_s']:.4f} s, reward "
              f"per step {line['reward_per_step']:.4f}, done rate "
              f"{line['episode_done_rate']:.4f}, pg loss {line['pg_loss']:.4f}, v loss "
              f"{line['v_loss']:.4f}")
    check(counts == expect, f"{env_id} training: expected launches {expect}, got {counts}")
    check([x["step"] for x in lines] == list(range(1, total + 1)),
          f"{env_id} training: metric lines for updates {[x['step'] for x in lines]}")
    if resume_updates is not None:
        check(f"resumed from update {updates}" in records.messages,
              f"{env_id} training: the second run did not resume from update {updates}")
        print(f"[train] {env_id}: the second run logged 'resumed from update {updates}'")
    for line in lines:
        bad = [k for k, v in line.items() if not np.isfinite(v)
               and not k.startswith(("env/", "ep_end/"))]
        check(not bad, f"{env_id} training: non-finite metrics {bad}")
    check(state.update_count == total, f"{env_id} training: ended at {state.update_count}")
    check(all(bool(torch.isfinite(p).all()) for p in state.params.parameters()),
          f"{env_id} training: non-finite parameters")
    check(bool(torch.isfinite(state.env_state.q).all()), f"{env_id} training: non-finite state")
    return lines


def split_refused(engine, env_id: str, workdir: Path) -> None:
    """``--split-impulse`` on a family whose split impulse has no instance
    raises on the card, naming it, before any kernel launch or update."""
    from mocca_envs_tpu_torch.harness import train

    metrics = workdir / f"{env_id}_refused.jsonl"
    engine.LAUNCHES.clear()
    try:
        train.main(["--env", env_id, "--split-impulse", "--num-envs", "64", "--horizon", "2",
                    "--updates", "1", "--minibatches", "1", "--metrics", str(metrics)])
    except NotImplementedError as e:
        check("no K1 instantiation" in str(e), f"{env_id}: unexpected refusal {e}")
        check(sum(engine.LAUNCHES.values()) == 0 and not metrics.read_text(),
              f"{env_id}: launched or updated before the refusal")
        print(f"[train] {env_id} --split-impulse raises on the card: {str(e)[:160]}")
        return
    check(False, f"{env_id} --split-impulse trained on the card without a kernel instance")


def profile_update(card, workdir: Path) -> None:
    """One stepper update at horizon 16 under ``--profile-dir``: the
    device's busy share over the traced window and its largest kernels,
    read from the Chrome trace the CLI writes. Where the trace holds no
    device events, says so."""
    from mocca_envs_tpu_torch.harness import train
    from mocca_envs_tpu_torch.harness.profile import TRACE_FILE

    prof = workdir / "profile"
    train.main(["--env", "Walker3DStepperEnv", "--split-impulse", "--num-envs", str(B),
                "--horizon", "16", "--updates", "1", "--profile-dir", str(prof)])
    events = json.loads((prof / TRACE_FILE).read_text())["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and "dur" in e]
    if not dev:
        print(f"[profile] stepper update: the trace holds no device events on {card}: device "
              "busy share not measured")
        return
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    window = spans[-1][1] - spans[0][0]
    by_name: dict = {}
    for e in dev:
        n = e["name"][:60]
        by_name[n] = (by_name.get(n, (0.0, 0))[0] + float(e["dur"]), by_name.get(n, (0.0, 0))[1] + 1)
    print(f"[profile] stepper update (16 steps × {B} envs + PPO) on {card}: {len(dev)} device "
          f"events over {window / 1e3:.3f} ms from the first to the last, busy "
          f"{busy / 1e3:.3f} ms = {busy / window:.2%}, idle {1 - busy / window:.2%}")
    for n, (dur, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[profile]   {dur / 1e3:10.3f} ms  {cnt:6d} calls  {n}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import mocca_envs_tpu_torch as port
    from mocca_envs_tpu_torch.models import cassie, monkey, walker2d, walker3d
    from mocca_envs_tpu_torch.ops.cuda import engine
    from mocca_envs_tpu_torch.ops.raycast import make_raycaster, raycast_reference
    from mocca_envs_tpu_torch.tasks.cassie_task import CASSIE_CONFIG
    from mocca_envs_tpu_torch.terrain.scene import HF_PATCH, hf_normal
    from mocca_envs_tpu_torch.utils.config import EngineConfig
    from mocca_envs_tpu_torch.utils.device import pin_fp32

    pin_fp32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- phase 1: build
    t0 = time.perf_counter()
    engine.build()
    print(f"[build] {len(engine.INSTANTIATIONS)} K1 instantiations and K2 built in "
          f"{time.perf_counter() - t0:.1f} s")
    for symbol, log in engine._Library.logs.items():
        for line in log.splitlines():
            if "registers" in line or "stack frame" in line:
                print(f"[build] {symbol}: {line.strip()}")

    # ---- phase 2: each kernel vs its plain version at the main paths' shapes
    config = EngineConfig()
    split = lambda cfg: dataclasses.replace(cfg, split_impulse=True)  # noqa: E731
    model = walker3d.make_model("cuda")
    kp = model.power_coef * (model.actuated > 0).to(torch.float32)
    cuda = lambda arrays: [torch.as_tensor(x, device="cuda") for x in arrays]  # noqa: E731
    rng = np.random.default_rng(SEED)
    kernels = {
        "k1a": (engine.K1a(model, config), cuda(near_contact_states(model, rng))),
        "k1c": (engine.K1c(model, config),
                cuda(stepper_states(model, rng, config.stone_window))),
        "k1b": (engine.K1b(model.replace(kp=kp), config, extra_damping=kp / 20.0),
                cuda(pd_target_states(model, rng))),
    }
    max_abs = {v: compare(kernel, args) for v, (kernel, args) in kernels.items()}
    two_frames = engine.K1b(model.replace(kp=kp), EngineConfig(llc_frames=2),
                            extra_damping=kp / 20.0)
    compare(two_frames, kernels["k1b"][1], "k1b (2 llc frames)")

    cmodel = cassie.make_model("cuda")
    rods, stand, stand_z = cassie.constraints(), cassie.stand_q(cmodel), cassie.initial_z()
    for v, spec in (("k1e_cassie", rods),
                    ("k1e_cassie2d", dataclasses.replace(rods, planar=True))):
        kernels[v] = (
            engine.K1e(cmodel, CASSIE_CONFIG, spec, pd_mode=True,
                       extra_damping=cmodel.actuated * cmodel.kd),
            cuda(cassie_states(cmodel, stand, stand_z, rng, spec.planar)))
        max_abs[v] = compare(*kernels[v], v, TOL_EQ, tail="p99")
    wmodel = walker2d.make_walker2d("cuda")
    kernels["k1e_planar"] = (engine.K1e(wmodel, config, walker2d.planar_spec()),
                             cuda(planar_walker_states(wmodel, 1.22, rng)))
    max_abs["k1e_planar"] = compare(*kernels["k1e_planar"], "k1e_planar", TOL_EQ)
    mmodel = monkey.make_model("cuda")
    kernels["k1d"] = (engine.K1d(mmodel, config, monkey.constraints(), 16),
                      cuda(monkey_states(mmodel, rng)))
    held = (engine.unpack_grabs(kernels["k1d"][1][6])[0] > 0.5).sum(0).tolist()
    print(f"[compare] k1d: grabs attached (right, left) {held} of {B} envs")
    max_abs["k1d"] = compare(*kernels["k1d"], "k1d", TOL_GRAB, tail="p99")
    kernels["k1f"] = (engine.K1f(model, config, HF_PATCH), cuda(terrain_states(model, rng)))
    window = engine.unpack_hf(kernels["k1f"][1][5])
    lo, cell = window["hf_xy0"], window["hf_cell"][:, None]
    pinned = ((lo - (-10.0)).abs() < 1e-4) | ((lo + (HF_PATCH - 1) * cell - 10.0).abs() < 1e-4)
    wscene = engine.make_scene(kernels["k1f"][1][3], kernels["k1f"][1][4], hf=kernels["k1f"][1][5])
    slope = hf_normal(wscene, kernels["k1f"][1][0][:, 0:2])[:, 2]
    print(f"[compare] k1f: windows pinned to a grid edge in {int(pinned.any(1).sum())} of {B} "
          f"envs; surface under the root steeper than 10° in {int((slope < 0.9848).sum())}, "
          f"steepest {float(torch.rad2deg(torch.arccos(slope.min()))):.1f}°")
    max_abs["k1f"] = compare(*kernels["k1f"], "k1f", TOL_HF)
    small_grid_raises(model, config)
    kernels["k1g"] = (engine.K1g(model, config), cuda(stairs_states(model, rng)))
    vertical = vertical_contacts(*kernels["k1g"])
    print(f"[compare] k1g: {int(vertical.sum())} of {B} envs touch a vertical face in the plain "
          "run; the tail gate holds the others")
    max_abs["k1g"] = compare(*kernels["k1g"], "k1g", TOL, tail="p99", tail_envs=~vertical)
    kernels["k1h_si"] = (engine.K1hSi(model, EngineConfig(split_impulse=True)),
                         kernels["k1a"][1])
    max_abs["k1h_si"] = compare(*kernels["k1h_si"], "k1h_si")
    # the split-impulse twins of the training path, each on its twin's states
    # and held to its twin's gate
    kernels["k1h_c"] = (engine.K1c(model, split(config)), kernels["k1c"][1])
    max_abs["k1h_c"] = compare(*kernels["k1h_c"], "k1h_c")
    for v, twin in (("k1h_e", "k1e_cassie"), ("k1h_e2d", "k1e_cassie2d")):
        kernels[v] = (engine.K1e(cmodel, split(CASSIE_CONFIG), kernels[twin][0].constraints,
                                 pd_mode=True, extra_damping=cmodel.actuated * cmodel.kd),
                      kernels[twin][1])
        max_abs[v] = compare(*kernels[v], v, TOL_EQ, tail="p99")
    kernels["k1h_d"] = (engine.K1d(mmodel, split(config), monkey.constraints(), 16),
                        kernels["k1d"][1])
    max_abs["k1h_d"] = compare(*kernels["k1h_d"], "k1h_d", TOL_GRAB, tail="p99")
    ray_args = cuda(raycast_inputs(rng, 8 * B))
    ray_t, ray_h = make_raycaster((129, 129))(*ray_args)
    torch.cuda.synchronize()
    want_t, want_h = raycast_reference(*ray_args)
    share, dt_err, h_err = check_rays(*(x.cpu().numpy() for x in (ray_t, ray_h, want_t, want_h)),
                                      10.0 / 64)
    max_abs["k2"] = max(dt_err, h_err)
    print(f"[compare] k2: {8 * B} rays over a 129² grid, t equal on {share:.5f} of them, largest "
          f"|Δt| {dt_err:.4e} (one march step is {10.0 / 64:.4f}), largest |Δh| where t agrees "
          f"{h_err:.3e}; {float((want_t < 10.0).float().mean()):.4f} of the rays hit")

    # ---- phase 3: the main paths through the user entry points
    launches, step_ms = {}, {}
    launches["k1a"], *_ = drive(port, engine, card, "Walker3DCustomEnv-v0", 600, "k1a")
    launches["k1c"], stepper_state, tr, stepper, *_ = drive(
        port, engine, card, "Walker3DStepperEnv-v0", 600, "k1c")
    print(f"[main] Walker3DStepperEnv-v0: steps_reached mean "
          f"{float(tr.metrics['steps_reached'].mean()):.3f} max "
          f"{float(tr.metrics['steps_reached'].max()):.0f}, stone hits on the last step "
          f"{int(tr.metrics['stone_hit'].sum())}, mean stage "
          f"{float(stepper_state.task.stage.mean()):.4f}")
    launches["k1b"], *_ = drive(port, engine, card, "Walker3DPDCustomEnv-v0", 200, "k1b")
    drive(port, engine, card, "Child3DCustomEnv-v0", 100, "k1a")
    for v, env_id, steps in (("k1e_cassie", "CassieEnv-v0", 300),
                             ("k1e_cassie2d", "Cassie2DEnv-v0", 100),
                             ("k1e_planar", "Walker2DCustomEnv-v0", 200),
                             ("k1e_crab", "Crab2DCustomEnv-v0", 100)):
        launches[v], state, _, _, step_ms[v], _ = drive(port, engine, card, env_id, steps, "k1e")
        if "2D" in env_id:
            # the lock's own measures of roll and yaw (Euler angles jump to π
            # when a toppled body pitches past 90°). The lock pulls back at
            # no more than max_push_vel, so a toppled, thrashing body leaves
            # the plane for a while: the median env is held, the worst shown
            w, x, y, z = state.q[:, 3:7].unbind(dim=1)
            drift = [v.abs() for v in (state.q[:, 1], 2 * (w * x + y * z), 2 * (w * z + x * y))]
            med, worst = [float(v.median()) for v in drift], [float(v.max()) for v in drift]
            print(f"[main] {env_id}: out of plane at the end, median / max over the envs: "
                  f"|y| {med[0]:.3e} / {worst[0]:.3e} m, |2(wx+yz)| {med[1]:.3e} / "
                  f"{worst[1]:.3e}, |2(wz+xy)| {med[2]:.3e} / {worst[2]:.3e}")
            check(med[0] < 0.02 and med[1] < 0.05 and med[2] < 0.05,
                  f"{env_id}: the median env left its plane: {med}")
    launches["k1d"], state, tr, monkey_batch, step_ms["k1d"], sums = drive(
        port, engine, card, "Monkey3DStepperEnv-v0", 300, "k1d", sums=("fell", "bar_hit"))
    print(f"[main] Monkey3DStepperEnv-v0: bars_reached mean "
          f"{float(tr.metrics['bars_reached'].mean()):.4f} max "
          f"{float(tr.metrics['bars_reached'].max()):.0f}; holding on at the end "
          f"{float((tr.metrics['holding'] > 0).float().mean()):.4f} of the envs, both hands "
          f"{float((tr.metrics['holding'] > 1).float().mean()):.4f}; over the run falls "
          f"{sums['fell']:.0f}, bar hits {sums['bar_hit']:.0f}")
    hang_check(monkey_batch, monkey.constraints(), card)
    launches["k1f"], terrain_state, _, _, step_ms["k1f"], sums = drive(
        port, engine, card, "Walker3DTerrainEnv-v0", 600, "k1f", sums=("fallen",))
    terrain_readings("Walker3DTerrainEnv-v0", terrain_state, sums)
    _, state, _, _, step_ms["k1f_lidar"], sums = drive(
        port, engine, card, "Walker3DTerrainLidarEnv-v0", 200, "k1f", sums=("fallen",))
    terrain_readings("Walker3DTerrainLidarEnv-v0", state, sums)
    on_stairs = torch.zeros(B, dtype=torch.bool, device="cuda")

    def over_a_tread(tr):
        x, y = tr.state.q[:, 0], tr.state.q[:, 1]
        on_stairs.logical_or_((x >= 0.6) & (x <= 2.7) & (y.abs() <= 2.0))

    launches["k1g"], state, _, _, step_ms["k1g"], sums = drive(
        port, engine, card, "Walker3DStairsEnv-v0", 600, "k1g", sums=("fallen",),
        watch=over_a_tread)
    stairs_readings(state, sums, on_stairs)
    launches["k1h_si"], state, _, _, step_ms["k1h_si"], sums = drive(
        port, engine, card, "Walker3DCustomEnv-v0", 200, "k1h_si", sums=("fallen",),
        config=EngineConfig(split_impulse=True))
    print(f"[main] Walker3DCustomEnv-v0 with split impulse: falls over the run "
          f"{sums['fallen']:.0f}, base height at the end median {float(state.q[:, 2].median()):.4f}"
          f" m")
    launches["k2"], ray_main, raycaster = raycast_main_path(engine, card, rng)

    # ---- phase 3 (training): the PPO trainer's CLI with --split-impulse
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    atexit.register(shutil.rmtree, workdir, True)
    train_lines = {"k1h_c": train_run(engine, card, "Walker3DStepperEnv", 2, 128, workdir,
                                      {"k1h_c": 384}, resume_updates=3)}
    launches["k1h_c"] = 384
    for v, env_id in (("k1h_e", "CassieEnv"), ("k1h_e2d", "Cassie2DEnv"),
                      ("k1h_d", "Monkey3DStepperEnv")):
        variant = "k1h_e" if v == "k1h_e2d" else v
        train_lines[v] = train_run(engine, card, env_id, 2, 32, workdir, {variant: 64})
        launches[v] = 64
    for env_id in ("Walker3DPDCustomEnv", "Walker2DCustomEnv", "Walker3DTerrainEnv",
                   "Walker3DStairsEnv"):
        split_refused(engine, env_id, workdir)

    # ---- phase 4: per-call times at B = 4096
    times = {v: time_and_bound(engine, card, kernel, args)
             for v, (kernel, args) in kernels.items()}

    cull_and_pack_time(engine, card, model, config)
    stepper_env_layer_times(card, stepper, stepper_state)
    times["k2"] = raycast_time_and_bound(card, raycaster, ray_main, max_abs["k2"])
    window_and_pack_time(engine, card, terrain_state)
    for v in ("k1e_cassie", "k1e_cassie2d", "k1e_planar", "k1d", "k1f", "k1f_lidar", "k1g",
              "k1h_si"):
        kernel_ms = times[v.removesuffix("_lidar")]["ms"]
        print(f"[time] {v}: main path {step_ms[v]:.3f} ms/step, kernel {kernel_ms:.4f} "
              f"ms/call, so {step_ms[v] - kernel_ms:.3f} ms/step outside the kernel "
              f"(env layer) at B={B} on {card}")
    for v, lines in train_lines.items():
        horizon = 128 if v == "k1h_c" else 32
        rollout_ms = 1e3 * lines[-1]["rollout_s"] / horizon
        print(f"[time] {v} training: the last update's rollout {rollout_ms:.3f} ms per env "
              f"step, kernel {times[v]['ms']:.4f} ms/call, so {rollout_ms - times[v]['ms']:.3f} "
              f"ms per step outside the kernel (env layer and policy), PPO update "
              f"{lines[-1]['update_s']:.4f} s, {lines[-1]['env_steps_per_s']:.0f} env-steps/s "
              f"at B={B} on {card}")
    profile_update(card, workdir)

    names = {"k1a": "k1a_engine_frame", "k1c": "k1c_engine_frame_stones",
             "k1b": "k1b_engine_step_pd", "k1e_cassie": "k1e_engine_step_pd_rods",
             "k1e_cassie2d": "k1e_engine_step_pd_rods_planar",
             "k1e_planar": "k1e_engine_frame_planar", "k1d": "k1d_engine_frame_bars_grabs",
             "k1f": "k1f_engine_frame_heightfield", "k1g": "k1g_engine_frame_trimesh",
             "k1h_si": "k1h_engine_frame_split_impulse",
             "k1h_c": "k1h_engine_frame_stones_split_impulse",
             "k1h_e": "k1h_engine_step_pd_rods_split_impulse",
             "k1h_e2d": "k1h_engine_step_pd_rods_planar_split_impulse",
             "k1h_d": "k1h_engine_frame_bars_grabs_split_impulse", "k2": "k2_raycast"}
    print(json.dumps({"kernels": [{
        "name": names[v],
        "route": "cuda",
        "source": RAYCAST_SOURCE if v == "k2" else SOURCE,
        "replaces": RAYCAST_REPLACES if v == "k2" else REPLACES,
        "launches": launches[v],
        "max_abs_err": max_abs[v],
        **times[v],
        "library_ms": None,
    } for v in names]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
