"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

1. print the card's name and power limit; build the warp-per-env
   instances of K1a, of Cassie's and Cassie2D's K1e and of their split
   twins K1h-e and K1h-e2d, of the PD walkers' K1b,
   of the terrain walkers' K1f, of the stepper's K1c, of the stairs' K1g,
   of the split twins of the stairs, the terrain walkers, the stepper,
   the PD walkers and the walker on the plane, K1h-g, K1h-f, K1h-c, K1h-b
   and K1h-si, of the monkey's K1d and its split twin K1h-d, of the
   planar walkers' K1e and its split twin, the planar K1h-e, of the
   walker's split key in the A-form (``matfree_pgs=False``), of its key
   in the A-form, alone and with all four PGS options off, and of its key
   with scalar friction rows, with a factor every substep and with a cold
   start, from
   ``mocca_envs_tpu_torch/csrc/engine_k1w.cu``, the fifteen
   named instances of the engine kernel from
   ``mocca_envs_tpu_torch/csrc/engine_k1.cu``, the generic instance of every
   key phase 2 adds (one warp per env from ``-DK1W_*`` flags: the walker
   and the stepper at 2 substeps × 8 sweeps, and the PD keys of several
   llc frames of :data:`LLC_KEYS`, K1b and its split twin K1h-b at two llc
   frames and Cassie's K1e at five; one thread per env: the
   thread-per-env twins of terrain, the stairs, the PD walker at
   one llc frame, the torque planar walkers, the walker's three A-form
   keys, its scalar friction, factor-every-substep and cold-start keys,
   the two 2 × 8 keys, K1h-b at two llc frames and Cassie at five (K1b's
   at two is the named ``k1b_..._llc2``); the all-off key's matrix-free
   form and the A-form twins of :data:`MATFREE_OPTIONS` and of the cold
   start) and the raycast kernel
   K2 from
   ``csrc/raycast_k2.cu`` (one nvcc process each, side by side), and print
   each one's ptxas registers and stack frame (K2's per kernel: its
   cooperative march and its one-thread-per-ray twin, their spills and
   static shared memory, and the cooperative march's lanes per ray, grid
   placement, blocks resident per SM and shared memory per block over 65²,
   129² and 257² grids, every grid read through L1); the fifteen named frames
   and spills must be :data:`FRAMES`, and each warp-per-env instance must
   spill nothing, use no global workspace and keep the registers, dynamic
   shared memory per block and envs resident per SM of :data:`WARP_BUILDS`,
   its resident blocks fitting the card's shared memory per SM (read from
   the card, with the runtime's reserve per block, and equal to the sm_90
   figures the host picks generic launch shapes from); each generic
   warp-per-env instance must spill nothing, use no global workspace, hold
   the envs per block the host picked and keep at least one block resident
   per SM;
2. each kernel vs its plain PyTorch version at B = 4096: K1a on walker
   states near contact, and against the thread-per-env K1a at
   :data:`TOL_TWIN` on those states and with every base lifted 3 m (no
   contact: every contact row skipped), K1c on stepper states (stones at stages 0–9, feet
   in or near contact with tilted stone tops, some envs over a gap), and
   against the thread-per-env K1c at :data:`TOL_TWIN` on those states and
   lifted 3 m, K1b on
   the K1a states with random joint targets, and against the thread-per-env
   K1b at :data:`TOL_TWIN` on those states and lifted 3 m, and K1b at two
   llc frames (:data:`LLC_KEYS`) on the same states; K1e on
   Cassie and Cassie2D states near the stand pose (feet in or near contact,
   rods slightly open, the planar variant a little out of its plane), by
   their warp-per-env instances, and those against their thread-per-env
   twins at :data:`TOL_EQ` with the p99 tail (:func:`compare_twins` says
   why) on those states and with every foot lifted 1 m (every contact row
   skipped); K1e on Walker2D states by its warp-per-env instance, and
   against its thread-per-env twin (:func:`twin_and_lifted`,
   :func:`rounding_floor` over all envs) on those states and with every base
   lifted 3 m; K1d on monkey states hanging from bars drawn by the
   port's sampler at stages 0–9 (the right hand attached, the left in half
   of the envs, anchors at the palms ±1 cm, bars moved next to the feet and
   the torso in half of the envs, random torques) by its warp-per-env
   instance, and against the thread-per-env K1d (:func:`twin_and_lifted`,
   :func:`rounding_floor` over all envs) on those states and with every
   base lifted 3 m; K1f on walker states
   over the terrain families' grids (the lowest foot within ±2 cm of the
   surface under it, on the grid's slopes, a tenth of the roots within
   0.5 m of its edge, the window around the root packed as the main path
   packs it), and against the thread-per-env K1f at :data:`TOL_TWIN` on
   those states and lifted 3 m; a grid smaller than the window must raise
   on the card;
   K1g on walker states on the stairs' staircase (a third each with the
   feet over treads, the lowest foot sphere at a nosing edge, the foremost
   against a riser; the 16 nearest of the 24 faces packed as the main path
   packs them), and against the thread-per-env K1g at :data:`TOL_TWIN` on
   those states (the tail gate by K1g's riser rule, the p99 of the envs
   with no contact on a vertical face, beside the 1e-7 q̇-nudge floor:
   :func:`rounding_floor`) and lifted 3 m; K1h-si on the K1a states with
   split impulse by its warp-per-env instance, held as K1h-c is below (its
   unsplit warp-per-env twin K1a's); its twins
   K1h-c, K1h-e, K1h-e2d and K1h-d (split impulse over the stones, on
   Cassie's whole PD step with the rods, with the planar lock added, and
   over the monkey's bars with its grab rows) on the K1c, Cassie, Cassie2D
   and K1d states, each held to its twin's gate; K1h-d by its warp-per-env
   instance, and that against its thread-per-env twin as K1d is and against
   K1d's warp-per-env instance (:func:`split_against_unsplit`, parting on
   monkey states with a bar by each foot and the torso in every env); K1h-c
   by its warp-per-env
   instance, and that as K1h-f is below; K1h-e and K1h-e2d by their
   warp-per-env instances, and those against their thread-per-env twins by
   K1e's rule (:data:`TOL_EQ` with the p99 tail) on those states and with
   every foot lifted 1 m, grounded by the 1e-7 q̇-nudge floor over all envs
   (:func:`rounding_floor`); K1h-b (split impulse in PD
   mode, one and two llc frames) and the torque planar K1h-e on the K1b and
   Walker2D states, each held to its twin's gate; K1h-f, K1h-g, K1h-b
   (one llc frame) and the planar K1h-e by their warp-per-env instances on
   the K1f, K1g, K1b and Walker2D states, held to their twins' gates (K1h-g
   by K1g's riser rule); K1h-c, K1h-b, K1h-f, K1h-g, K1h-si and the planar
   K1h-e against their thread-per-env twins as K1f's and
   K1g's are (:func:`twin_and_lifted`, :func:`rounding_floor`; K1h-g off
   risers), and against their unsplit warp-per-env twins
   (:func:`split_against_unsplit`: bit for bit with every base lifted 3 m
   and every joint inside its limits, parting by more than the plain gate
   near contact); the walker's PGS options
   (:data:`OPTION_CONFIGS`: the A-form, scalar friction rows, a cold start,
   a factor every substep, all four, the A-form with split impulse, and 2
   substeps × 8 sweeps) on the K1a states at K1a's gate, and each A-form
   (:data:`AFORMS`: alone, with split impulse, with all four options off)
   by its warp-per-env instance against its matrix-free twin on the same
   inputs at :data:`TOL_TWIN` (medians, the largest env within ten times)
   and against its thread-per-env twin (:func:`twin_and_lifted`); scalar
   friction and a factor every substep (:data:`MATFREE_OPTIONS`) by their
   warp-per-env instances against their thread-per-env twins
   (:func:`twin_and_lifted`) and against their A-form twins at
   :data:`TOL_TWIN`; the stepper at 2 × 8 on the K1c states at K1c's gate;
   the cold start (its named warp-per-env instance) and the walker and the
   stepper at 2 × 8 (the generic warp-per-env instances of their keys,
   :data:`NEW_WARP`) against their thread-per-env twins
   (:func:`twin_and_lifted`), the cold start also against its A-form twin at
   :data:`TOL_TWIN`; each other option's
   instance (and the stepper at 2 × 8) must part from the shipped one (K1a;
   K1c) on the same inputs by more
   than that gate in the per-env medians of q and qd
   (:func:`parts_from_shipped`), and each thread-per-env A-form's workspace
   must hold its NR × NR matrix and residual beside its matrix-free
   twin's; Cassie's K1e at five llc frames on the Cassie states at K1e's
   gate, and the PD keys of several llc frames (:data:`LLC_KEYS`, the
   generic warp-per-env instances of their keys) against their
   thread-per-env twins (:func:`twin_and_lifted`: the walker keys at
   :data:`TOL_TWIN` with the largest env, beside :func:`rounding_floor` over
   all envs, every base lifted 3 m; Cassie at :data:`TOL_EQ` with the p99,
   every foot lifted 1 m), K1h-b at two frames also parting from K1b at
   two near contact. Per-env median and p99
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
   agrees; its one-thread-per-ray twin the same, and the two designs equal
   bit for bit on t and h on those rays and on 32,768 over a 65² and a
   257² grid (:func:`raycast_designs_agree`);
3. the main paths through ``BatchedEnv(make(id), 4096).step`` with uniform
   random actions, the launch counts set to 0 just before each and read
   just after: ``Walker3DCustomEnv-v0`` for 600 control steps (K1a, by
   the warp-per-env instance alone, as the child),
   ``Walker3DStepperEnv-v0`` for 600 (K1c, by its warp-per-env instance
   alone), ``Walker3DPDCustomEnv-v0`` for
   200 and ``Child3DPDCustomEnv-v0`` for 100 (K1b, each by its warp-per-env
   instance alone), ``Child3DCustomEnv-v0`` for 100 (K1a), ``CassieEnv-v0`` for
   300 and ``Cassie2DEnv-v0`` for 100 (K1e, each by its warp-per-env
   instance alone), ``Walker2DCustomEnv-v0`` for 200 and
   ``Crab2DCustomEnv-v0`` for 100 (K1e, each by its warp-per-env instance
   alone), ``Monkey3DStepperEnv-v0`` for 300
   (K1d, by its warp-per-env instance alone, grab signals included in the
   random actions),
   ``Walker3DTerrainEnv-v0`` for 600 and ``Walker3DTerrainLidarEnv-v0`` for
   200 (K1f, each by its warp-per-env instance alone),
   ``Walker3DStairsEnv-v0`` for 600 (K1g, by its warp-per-env instance
   alone),
   ``Walker3DCustomEnv-v0`` made with ``EngineConfig(split_impulse=True)``
   for 200 (K1h-si, by its warp-per-env instance alone),
   ``Walker3DStairsEnv-v0``, ``Walker3DTerrainEnv-v0``
   and ``Walker3DTerrainLidarEnv-v0`` made with it for 200 each (K1h-g,
   K1h-f, each by its warp-per-env instance alone),
   ``Walker3DStepperEnv-v0`` and ``Walker3DPDCustomEnv-v0`` made with it
   for 200 each and ``Child3DPDCustomEnv-v0`` for 100 (K1h-c, K1h-b, each
   by its warp-per-env instance alone), ``Monkey3DStepperEnv-v0`` made with
   it for 200 (K1h-d, by its warp-per-env instance alone), the walker with
   each
   of :data:`OPTION_CONFIGS` for 100 (its own
   instance, counted under its name and by its symbol in
   ``engine.INSTANCE_LAUNCHES``), ``Walker3DStepperEnv-v0`` made with 2
   substeps × 8 sweeps for 100 (the generic warp-per-env instance of its
   key), ``Walker3DPDCustomEnv-v0`` made with ``EngineConfig(llc_frames=2)``
   for 100, alone and with split impulse, and ``CassieEnv-v0`` made with
   Cassie's configuration at ``llc_frames=5`` for 200 (the generic
   warp-per-env instance of each key, one launch per control step; the ms
   per step printed beside the family's at its shipped llc frames), and
   K2's own entry point
   ``make_raycaster`` for 10 calls of 32,768 rays with the origins moved
   between calls (10 ``k2`` launches of the cooperative march, no other). A grid smaller than the K1f window and PD mode over stones
   must raise on the card before any launch. The path's kernel
   must launch exactly once per step and no other kernel at all, the state
   stay finite and auto-reset fire; resets forced by a non-finite state are
   counted and printed; of the 2D families the median env must end in its
   plane (|y| < 0.02 m, the lock's roll and yaw measures < 0.05), the worst
   is printed; of the monkey the bars reached, the share of envs holding on
   and the falls are printed, and then 50 steps of zero torques with both
   grab signals on from fresh episodes, by the warp-per-env K1d alone,
   must hang the body: the median
   palm-to-anchor distance under 2 cm, the median base height within 0.5 m
   of its start, fewer than 1% of the envs falling; of the terrain
   families the falls and the base's height above the local surface are
   printed, its median between 0.3 and 1.5 m; of the stairs the same over
   the mesh's support surface, and the slots whose root was over a tread;
   then the training path, ``python -m mocca_envs_tpu_torch.harness.train
   --split-impulse`` through its ``main``: ``Walker3DStepperEnv`` with
   4096 envs, horizon 128, 2 updates with a checkpoint, then the same to 3
   updates, which must resume from update 2 (exactly 384 ``k1h_c`` launches
   over both runs, all by the warp-per-env instance, and no other kernel);
   ``CassieEnv`` and ``Cassie2DEnv``
   (64 ``k1h_e`` launches each, all by the warp-per-env instance: PD
   launches once per control step),
   ``Monkey3DStepperEnv`` (64 ``k1h_d``, all by the warp-per-env instance)
   and the seven of
   :data:`SPLIT_FAMILIES` (64 launches each under the name it gives, all by
   the instance phase 1 built for it: the warp-per-env K1h-b for the PD
   walker and the PD child, K1h-f for the two terrain families and K1h-g
   for the stairs, the planar K1h-e for the planar walkers), 2 updates at
   horizon 32. Every
   metric line must be finite but the env channels the learner leaves NaN
   (no episode ended), and each prints env-steps/s and the seconds of the
   rollout and of the PPO update per update; then the training pipelines
   at the published widths (4096 envs, (256, 256), horizon 128, 4 epochs),
   depth cut to 2 updates a phase (:func:`pipelines`): ``run_allsteps`` (32
   minibatches, mirror_coef 4.0; P1 the walker, exactly 256 ``k1a``; P2 and
   P3 the stepper and the ladder at stages 0 and 4 of 100 steps each,
   exactly 712 ``k1c``), ``run_brachiation`` (exactly 712 ``k1d``: two
   phases, its pinned stage 9 and its adaptive eval row of 100 steps
   each), each run again on the same root, which must short-circuit every
   phase, launch only its eval steps (200 ``k1c``; 200 ``k1d``) and give
   the first run's rows (its state restored from the checkpoints), and
   the mixed suite through the CLI (``--env
   Walker3DCustomEnv,CassieEnv,Monkey3DStepperEnv --num-envs 3072
   --mirror-coef 4.0``): 2 updates (exactly 256 each of ``k1a``, ``k1e``,
   ``k1d``: Cassie's PD key one launch per control step), then resumed to 3
   (128 each), which must log that it resumed; every launch by the named
   warp-per-env instance of its key; every phase finished with its
   ``PHASE_DONE`` and a finite network in its newest checkpoint, the update
   rows and metric lines finite, the ladder and eval rows of the JAX
   package's keys; it prints each phase's env-steps/s and the mixed
   suite's rollout seconds per family;
4. per-call times of each kernel and its plain version (CUDA events), the
   two K1a designs in turns (old, new, new, old) at each B of
   :data:`SWEEP` beside their bound, the two designs of Cassie's and of
   Cassie2D's K1e and of their split twins K1h-e and K1h-e2d likewise at
   each B of :data:`CASSIE_SWEEP`, those of K1b,
   K1f, K1c, K1g, K1h-g, K1h-f, K1h-c, K1h-b, K1h-si, K1d, K1h-d, the
   planar K1e, the planar K1h-e, the three A-forms, scalar friction, a
   factor every substep, a cold start and the walker and the stepper at
   2 × 8, K1b and K1h-b at two llc frames at each B of
   :data:`WALKER_SWEEP` (an A-form's bound on its matrix-free twin's
   count), Cassie's K1e at five llc frames at each B of
   :data:`CASSIE_SWEEP`, the
   walker's step against the host's
   time to enqueue it and the device's busy share over 20 traced steps, the
   bound from the operations and bytes these inputs need, and the time of
   the stepper's cull of 20 stones to the window plus their packing (env
   layer, once per control step, outside the kernel's time), and the
   stepper's step split into the step proper and the fresh episodes of
   auto-reset; K2's two designs in turns, each kernel's own time on the
   device (:func:`kernel_times`: the median of 50 launches in a profiler
   trace), its ctypes launch alone and through its wrapper, at 32,768 rays
   over 129² (the main path's last call) beside the bound (the march steps
   these rays need), then at 4,096 and 262,144 rays over 129² and 32,768
   over 65² and 257² (:func:`raycast_time_and_bound`); K2's ``ms`` in the
   JSON line is the cooperative march's own device time;
   the terrain step's window cut and packing; the step time outside the
   kernel of the PD walkers, Cassie, the planar walkers, the monkey, the terrain families,
   the stairs, the split-impulse walker and the split stairs, terrain,
   stepper, PD walkers and monkey, the A-forms, the walker under
   :data:`MATFREE_OPTIONS`, with a cold start and at 2 × 8, and the stepper
   at 2 × 8; the training rollouts' time per
   env step outside the kernel; an A-form's bound counts its matrix-free
   twin's operations on the same activity (the same function in fewer), its
   own count printed beside it; a ``torch.profiler`` trace of one stepper
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
# an A-form instance against its matrix-free twin on the same inputs: the
# JAX package's gate between its two PGS forms (tests/test_pallas_engine.py,
# matfree vs A-form: q 2e-5, qd 5e-4, impulse 5e-4; depth held as q)
TOL_TWIN = {"q": 2e-5, "qd": 5e-4, "depth": 2e-5, "nimp": 5e-4}
# the walker's PGS options turned off (each alone, all four, the A-form
# with split impulse) and a key outside the fifteen named instances: label →
# EngineConfig fields
OPTION_CONFIGS = {
    "k1a_aform": {"matfree_pgs": False},
    "k1a_scalar": {"block_pgs": False},
    "k1a_cold": {"warm_start": False},
    "k1a_refactor": {"reuse_factor": False},
    "k1a_aform_scalar_cold_refactor": {"matfree_pgs": False, "block_pgs": False,
                                       "warm_start": False, "reuse_factor": False},
    "k1h_si_aform": {"matfree_pgs": False, "split_impulse": True},
    "k1a_sub2_it8": {"sim_substeps": 2, "solver_iters": 8},
}
# the option configurations in the A-form, each on a warp-per-env instance
AFORMS = ("k1a_aform", "k1h_si_aform", "k1a_aform_scalar_cold_refactor")
# single options in the matrix-free form on a warp-per-env instance (scalar
# friction rows, a factor every substep), each with its A-form twin
MATFREE_OPTIONS = ("k1a_scalar", "k1a_refactor")
# the stepper at 2 substeps × 8 sweeps: a key over a scene geometry that the
# generic warp-per-env instance runs, built from -DK1W_* flags
STEPPER_2X8 = {"sim_substeps": 2, "solver_iters": 8}
# the keys moved onto one warp per env last: the cold start (named), the
# walker and the stepper at 2 × 8 (generic), each held to its thread-per-env
# twin
NEW_WARP = ("k1a_cold", "k1a_sub2_it8", "k1c_sub2_it8")
# PD keys of several llc frames, each on the generic warp-per-env instance
# of its key and held to its thread-per-env twin: K1b and its split twin
# K1h-b at two llc frames, Cassie's K1e at five
LLC_KEYS = ("k1b_llc2", "k1h_b_llc2", "k1e_cassie_llc5")
# --split-impulse on the PD walkers, the planar walkers, terrain and the
# stairs: env id → the count its launches go under
SPLIT_FAMILIES = {"Walker3DPDCustomEnv": "k1h_b", "Child3DPDCustomEnv": "k1h_b",
                  "Walker2DCustomEnv": "k1h_e", "Crab2DCustomEnv": "k1h_e",
                  "Walker3DTerrainEnv": "k1h_f", "Walker3DTerrainLidarEnv": "k1h_f",
                  "Walker3DStairsEnv": "k1h_g"}
# published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
SOURCE = "mocca_envs_tpu_torch/csrc/engine_k1.cu"
SOURCE_W = "mocca_envs_tpu_torch/csrc/engine_k1w.cu"   # one warp per env
# ptxas's stack frame, spill stores and spill loads (bytes) of the fifteen
# named engine_k1.cu instances, as every build since they were written has
# reported them: moving code into csrc/k1_common.cuh must not change them
FRAMES = {
    "k1a_nl22_ns14_nlim21_sub4_it4": (8288, 688, 900),
    "k1c_nl22_ns14_nlim21_sub4_it4_k6": (8584, 608, 912),
    "k1b_nl22_ns14_nlim21_sub4_it4_llc1": (8280, 680, 888),
    "k1b_nl22_ns14_nlim21_sub4_it4_llc2": (8376, 776, 1064),
    "k1e_nl17_ns5_nlim16_sub2_it4_llc10_p2p2": (6208, 648, 916),
    "k1e_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_planar": (6768, 1044, 1320),
    "k1e_nl7_ns5_nlim6_sub4_it4_planar": (3904, 1240, 1692),
    "k1d_nl11_ns5_nlim8_sub4_it4_kb16_ng2": (6688, 2776, 3352),
    "k1f_nl22_ns14_nlim21_sub4_it4_hf16": (8400, 712, 1128),
    "k1g_nl22_ns14_nlim21_sub4_it4_kt16": (8312, 572, 884),
    "k1h_nl22_ns14_nlim21_sub4_it4_si": (8128, 48, 48),
    "k1h_nl22_ns14_nlim21_sub4_it4_k6_si": (8520, 44, 44),
    "k1h_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_si": (6072, 96, 96),
    "k1h_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_planar_si": (6352, 240, 264),
    "k1h_nl11_ns5_nlim8_sub4_it4_kb16_ng2_si": (6224, 1592, 1608),
}
# the batches of the two designs' sweeps, and the timed calls at each: K1a,
# and Cassie's and Cassie2D's K1e, K1h-e and K1h-e2d (the thread-per-env one
# ~35–45 ms a call at 16,384)
SWEEP = {4096: 20, 16384: 10, 65536: 5}
CASSIE_SWEEP = {4096: 10, 16384: 5}
# K1b, K1f, K1c, K1g, K1h-g, K1h-f, K1h-c, K1h-b, K1h-si, K1d, K1h-d, the
# planar K1e, the planar K1h-e, the three A-forms, scalar friction and a
# factor every substep
WALKER_SWEEP = {4096: 20, 16384: 10}
# ptxas's registers and the dynamic shared memory per block (bytes) of each
# warp-per-env instance, and the envs each must keep resident per SM: the
# walker's keys 4 blocks of 4 envs (K1f's, K1c's, K1g's and K1h-f's
# registers sized for 8), K1h-g's, K1h-c's, K1h-b's, K1h-si's, scalar
# friction's and a factor every substep's one block of 16, Cassie's one
# block of 32 (and its split twins'), the monkey's one block of 32 (and its
# split twin's), the planar walkers' one block of 32 (and their split
# twin's), the A-forms' one block of 11; each as every build since it was
# written has reported it
WARP_BUILDS = {
    "k1w_nl22_ns14_nlim21_sub4_it4": (64, 53008, 16),
    "k1w_nl17_ns5_nlim16_sub2_it4_llc10_p2p2": (64, 202896, 32),
    "k1w_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_planar": (64, 213648, 32),
    "k1w_nl22_ns14_nlim21_sub4_it4_llc1": (56, 53344, 16),
    "k1w_nl22_ns14_nlim21_sub4_it4_hf16": (63, 53776, 16),
    "k1w_nl22_ns14_nlim21_sub4_it4_k6": (64, 54736, 16),
    "k1w_nl22_ns14_nlim21_sub4_it4_kt16": (64, 56240, 16),
    "k1w_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_si": (64, 208272, 32),
    "k1w_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_planar_si": (64, 219024, 32),
    "k1w_nl22_ns14_nlim21_sub4_it4_kt16_si": (92, 214416, 16),
    "k1w_nl22_ns14_nlim21_sub4_it4_hf16_si": (61, 54896, 16),
    "k1w_nl22_ns14_nlim21_sub4_it4_k6_si": (92, 208400, 16),
    "k1w_nl22_ns14_nlim21_sub4_it4_llc1_si": (56, 202832, 16),
    "k1w_nl22_ns14_nlim21_sub4_it4_si": (64, 201488, 16),
    "k1w_nl11_ns5_nlim8_sub4_it4_kb16_ng2": (64, 159712, 32),
    "k1w_nl11_ns5_nlim8_sub4_it4_kb16_ng2_si": (63, 163040, 32),
    "k1w_nl7_ns5_nlim6_sub4_it4_planar": (58, 83216, 32),
    "k1w_nl7_ns5_nlim6_sub4_it4_planar_si": (58, 86032, 32),
    "k1w_nl22_ns14_nlim21_sub4_it4_si_aform": (108, 228792, 11),
    "k1w_nl22_ns14_nlim21_sub4_it4_aform": (107, 225712, 11),
    "k1w_nl22_ns14_nlim21_sub4_it4_aform_scalar_cold_refactor": (108, 225712, 11),
    "k1w_nl22_ns14_nlim21_sub4_it4_scalar": (64, 197008, 16),
    "k1w_nl22_ns14_nlim21_sub4_it4_refactor": (96, 197008, 16),
    "k1w_nl22_ns14_nlim21_sub4_it4_cold": (64, 197008, 16),
}
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


def tail_gate(per_env, limit: float, tail: str, tail_envs) -> tuple:
    """The tail statistic of per-env errors (numpy (B,)): the largest env
    (``tail="max"``) or the 99th percentile, over ``tail_envs`` (bool (B,))
    if given; and the note that reports it, with the other envs beyond
    ``limit`` counted (empty without ``tail_envs``)."""
    if tail_envs is None:
        held = np.ones(len(per_env), bool)
    else:
        held = tail_envs.cpu().numpy()
    gated = float(np.quantile(per_env[held], 0.99)) if tail == "p99" else float(per_env[held].max())
    note = "" if tail_envs is None else (
        f"; over the {int(held.sum())} gated envs {tail} {gated:.3e}, "
        f"{int(((per_env > limit) & ~held).sum())} of the {int((~held).sum())} others beyond")
    return gated, note


def compare(kernel, args, label: str | None = None, tol=TOL, tail: str = "max",
            tail_envs=None, loaded: bool = True) -> float:
    """Launch ``kernel`` once on ``args`` and hold it against its plain
    version: per-env medians within ``tol``, and ten times ``tol`` for the
    largest env (``tail="max"``) or the 99th percentile (``tail="p99"``, with
    the envs beyond counted); ``tail_envs`` (bool (B,)) limits the tail gate
    to those envs, the others beyond it counted. Contacts must carry load,
    or with ``loaded=False`` none may be active. Returns the largest
    absolute error over all outputs."""
    label = label or kernel.variant
    out = kernel.launch(*args)
    torch.cuda.synchronize()
    ref = kernel.plain(*args)
    torch.cuda.synchronize()
    max_abs = 0.0
    for name, a, b in zip(("q", "qd", "depth", "nimp"), out, ref):
        check(bool(torch.isfinite(a).all()), f"{label} output {name} not finite")
        per_env = (a - b).abs().amax(dim=1).cpu().numpy()
        med, p99 = float(np.median(per_env)), float(np.quantile(per_env, 0.99))
        max_abs = max(max_abs, float(per_env.max()))
        worst, note = tail_gate(per_env, 10 * tol[name], tail, tail_envs)
        print(f"[compare] {label} {name}: per-env median {med:.3e} p99 {p99:.3e} "
              f"max {per_env.max():.3e} (median tol {tol[name]:g}, {tail} tol "
              f"{10 * tol[name]:g}, {int((per_env > 10 * tol[name]).sum())} of {len(per_env)} "
              f"envs beyond it{note})")
        check(med <= tol[name], f"{label} {name} median {med:.3e} > {tol[name]:g}")
        check(worst <= 10 * tol[name], f"{label} {name} {tail} {worst:.3e} > {10 * tol[name]:g}")
    active = float((ref[2] > -kernel.config.contact_margin).float().sum(1).mean())
    print(f"[compare] {label}: {active:.3f} active contacts per env at the last substep, "
          f"{float((ref[3] > 0).float().mean()):.3f} of the spheres loaded")
    if loaded:
        check(float((ref[3] > 0).float().mean()) > 0.02, f"{label}: contacts carry no load")
    else:
        check(active == 0.0 and not bool((out[3] != 0).any()), f"{label}: a contact is active")
    if kernel.num_tris:
        # the JAX package's own gate for its mesh kernel
        share = float(((out[0] - ref[0]).abs() < 1e-3).float().mean())
        print(f"[compare] {label}: {share:.5f} of the q entries within 1e-3 (JAX mesh gate 0.97)")
        check(share >= 0.97, f"{label}: only {share:.4f} of q within 1e-3")
    return max_abs


def compare_twins(kernel, twin, args, label: str, tol=TOL_TWIN, tail: str = "max",
                  tail_envs=None) -> float:
    """Launch ``kernel`` and a ``twin`` that runs the same iteration with its
    sums in another order (an A-form's matrix-free twin; a warp-per-env
    instance's thread-per-env one) once each on ``args``: per-env medians
    within ``tol`` (:data:`TOL_TWIN`), ten times ``tol`` for the largest env
    or, with ``tail="p99"``, the 99th percentile; ``tail_envs`` (bool (B,))
    limits the tail gate to those envs, the others beyond it counted (K1g's
    riser rule, :func:`vertical_contacts`). Cassie's warp-per-env
    instances are held to their twins at :data:`TOL_EQ` with the p99 tail:
    over 20 stiff substeps two orders of the same sums part as far as a 1e-7
    nudge of q̇ parts one order from itself (tests/test_torch_k1w_cassie.py).
    Returns the largest absolute difference."""
    out = kernel.launch(*args)
    ref = twin.launch(*args)
    torch.cuda.synchronize()
    max_abs = 0.0
    for name, a, b in zip(("q", "qd", "depth", "nimp"), out, ref):
        per_env = (a - b).abs().amax(dim=1).cpu().numpy()
        med, worst = float(np.median(per_env)), float(per_env.max())
        p99 = float(np.quantile(per_env, 0.99))
        max_abs = max(max_abs, worst)
        gated, note = tail_gate(per_env, 10 * tol[name], tail, tail_envs)
        print(f"[compare] {label} vs its twin {twin.name} {name}: per-env median "
              f"{med:.3e} p99 {p99:.3e} max {worst:.3e} (median tol {tol[name]:g}, {tail} tol "
              f"{10 * tol[name]:g}, {int((per_env > 10 * tol[name]).sum())} of {len(per_env)} "
              f"envs beyond it{note})")
        check(med <= tol[name], f"{label} vs twin {name} median {med:.3e}")
        check(gated <= 10 * tol[name], f"{label} vs twin {name} {tail} {gated:.3e}")
    return max_abs


def twin_and_lifted(kernel, twin, args, label: str, lift: float, tol=TOL_TWIN,
                    plain_tol=TOL, tail: str = "max", tail_envs=None) -> float:
    """A warp-per-env ``kernel`` against its thread-per-env ``twin``
    (:func:`compare_twins` at ``tol``) on ``args`` and with every base raised
    ``lift`` m (every contact row skipped), and there against its plain
    version at ``plain_tol`` with no contact active. Given ``tail_envs``, the
    tail gate on ``args`` is the 99th percentile over those envs (K1g's
    riser rule, as :func:`compare` holds K1g to its plain version;
    :func:`rounding_floor` says why). Returns the largest absolute error."""
    lifted = [args[0].clone(), *args[1:]]
    lifted[0][:, 2] += lift
    near_tail = tail if tail_envs is None else "p99"
    return max(compare_twins(kernel, twin, args, label, tol, near_tail, tail_envs),
               compare(kernel, lifted, f"{label} (no contact)", plain_tol, tail=tail,
                       loaded=False),
               compare_twins(kernel, twin, lifted, f"{label} (no contact)", tol, tail))


def rounding_floor(kernel, twin, args, label: str, tail_envs) -> None:
    """The 1e-7 q̇-nudge measurement behind K1g's and K1h-g's twin gate
    (and behind K1h-e's, K1h-e2d's and K1h-f's, over all envs: ``tail_envs``
    all true). The
    thread-per-env ``twin`` runs ``args`` and ``args`` with q̇ nudged by 1e-7
    (relative, numpy seed 0); the per-env |Δq̇| between those two runs is
    the rounding floor. The two designs' per-env |Δq̇| on ``args`` must lie
    within three times the floor at the median and at the 99th percentile
    over ``tail_envs`` (the envs with no contact on a vertical face): the
    designs part by rounding, amplified where a sphere's nearest face
    changes, not by another iteration. Over the stairs the nudge alone
    parts about one env in a few thousand beyond ten times ``TOL_TWIN``'s
    qd, so the largest env is no gate there; the 99th percentile is."""
    noise = torch.as_tensor(np.random.default_rng(0).standard_normal(tuple(args[1].shape)),
                            device=args[1].device)
    nudged = [args[0], (args[1].double() * (1 + 1e-7 * noise)).float(), *args[2:]]
    base, ours, moved = twin.launch(*args), kernel.launch(*args), twin.launch(*nudged)
    torch.cuda.synchronize()
    held = tail_envs.cpu().numpy()
    gap = (ours[1] - base[1]).abs().amax(dim=1).cpu().numpy()
    floor = (moved[1] - base[1]).abs().amax(dim=1).cpu().numpy()
    stats = [(float(np.median(x)), float(np.quantile(x[held], 0.99)), float(x[held].max()))
             for x in (gap, floor)]
    print(f"[compare] {label} vs its twin {twin.name}, qd against the 1e-7 q̇-nudge floor: "
          f"median {stats[0][0]:.3e} / {stats[1][0]:.3e}, over the {int(held.sum())} gated envs "
          f"p99 {stats[0][1]:.3e} / {stats[1][1]:.3e}, max {stats[0][2]:.3e} / {stats[1][2]:.3e} "
          f"(twins / floor)")
    check(stats[0][0] <= 3 * stats[1][0] and stats[0][1] <= 3 * stats[1][1],
          f"{label}: the twins part beyond three times the rounding floor: {stats}")


def split_against_unsplit(kernel, unsplit, args, label: str, tol) -> None:
    """A split-impulse instance against its unsplit twin of the same design:
    with every base lifted 3 m and every joint 0.05 rad inside its limits
    (no contact, every push-out bias 0) the two must agree bit for bit;
    on ``args`` (near contact) they must part by more than ``tol``, the gate
    the split instance is held to against its plain version, in the per-env
    medians of q and qd (:func:`parts_from_shipped`), so that gate would
    catch a kernel that ignored the position pass."""
    model = kernel.model
    lifted = [args[0].clone(), *args[1:]]
    lifted[0][:, 2] += 3.0
    lifted[0][:, 7:] = torch.minimum(torch.maximum(lifted[0][:, 7:], model.limit_lo + 0.05),
                                     model.limit_hi - 0.05)
    out, ref = kernel.launch(*lifted), unsplit.launch(*lifted)
    torch.cuda.synchronize()
    same = [bool(torch.equal(a, b)) for a, b in zip(out, ref)]
    print(f"[compare] {label} vs its unsplit twin {unsplit.name}, every base lifted 3 m and every "
          f"joint inside its limits: bit-equal q, qd, depth, impulse {same}")
    check(all(same) and not bool((out[3] != 0).any()),
          f"{label}: parts from its unsplit twin where every bias is 0: {same}")
    parts_from_shipped(kernel, unsplit, args, label, tol)


def parts_from_shipped(kernel, shipped, args, label: str, tol=TOL) -> None:
    """An option's instance and the ``shipped`` instance, launched once each
    on ``args``: the per-env medians of |Δq| and |Δqd| between them must
    exceed ``tol``, the gate the option's instance is held to against its
    plain version, so that gate would catch a kernel that ignored the
    option."""
    out = kernel.launch(*args)
    ref = shipped.launch(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("q", "qd"), out, ref):
        per_env = (a - b).abs().amax(dim=1).cpu().numpy()
        med = float(np.median(per_env))
        print(f"[compare] {label} vs the shipped instance {shipped.name} {name}: per-env "
              f"median {med:.3e} p10 {float(np.quantile(per_env, 0.1)):.3e} ({med / tol[name]:.1f}"
              f"× the gate {tol[name]:g} it is held to)")
        check(med > tol[name], f"{label} parts from {shipped.name} in {name} by a median of "
                               f"{med:.3e}, within its gate {tol[name]:g}")


def aform_workspace(engine, kernel, twin, label: str) -> None:
    """An A-form's workspace per env, read from its built library, must be
    its matrix-free twin's plus the NR × NR matrix A and the NR residuals
    (a model without equality rows: NR is its limit rows and three rows per
    contact)."""
    ws = [engine.layout(engine.build([k.instance])[k.name], k.name)[1] for k in (kernel, twin)]
    nr = kernel.key.nlim + 3 * kernel.key.ns
    print(f"[compare] {label}: workspace {ws[0]} floats per env, its twin {twin.name} {ws[1]}, "
          f"A and the residual {nr} × {nr} + {nr}")
    check(ws[0] - ws[1] == nr * nr + nr, f"{label}: workspace {ws} holds no {nr}² matrix")


def ptxas(log: str) -> dict:
    """Registers, static shared memory, stack frame and spills (bytes) of the
    one kernel in an nvcc ``-Xptxas -v`` report."""
    import re

    found = {}
    for key, pattern in (("registers", r"Used (\d+) registers"), ("smem", r"(\d+) bytes smem"),
                         ("frame", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
        hit = re.search(pattern, log)
        found[key] = int(hit.group(1)) if hit else None
    return found


def build_report(engine, card, generic=()) -> None:
    """Phase 1's readings: the fifteen named frames as :data:`FRAMES` has
    them; each warp-per-env instance with no spill, no global workspace,
    at least one block resident per SM, and its registers, shared memory
    and envs resident per SM as :data:`WARP_BUILDS` has them (each of the
    ``generic`` warp-per-env instances: the envs per block the host picked,
    from the card's shared memory, which must be the sm_90 figures the pick
    assumes), and the shared memory its resident blocks and their reserves
    hold beside the card's per SM."""
    logs = engine._Library.logs
    for symbol, want in FRAMES.items():
        got = ptxas(logs.get(symbol, ""))
        check((got["frame"], got["spill_stores"], got["spill_loads"]) == want,
              f"{symbol}: ptxas frame / spills {got}, want {want}")
    print(f"[build] the fifteen named engine_k1.cu frames and spills unchanged: "
          f"{[v[0] for v in FRAMES.values()]}")
    smem = engine.smem_limits(engine.build()[next(iter(engine.WARP_INSTANCES.values())).symbol])
    print(f"[build] {card}: {smem['per_sm']} bytes of shared memory per SM, {smem['per_block']} "
          f"per block (opt-in), {smem['reserved_per_block']} reserved per resident block")
    check(smem == engine.SM90_SMEM, f"the card's shared memory {smem} is not the "
                                    f"{engine.SM90_SMEM} the generic launch shapes are picked for")
    for inst in [*engine.WARP_INSTANCES.values(), *generic]:
        lib = engine.build()[inst.symbol]
        got = ptxas(logs.get(inst.symbol, ""))
        occ = engine.occupancy(lib, inst.symbol)
        ws = engine.layout(lib, inst.symbol)[1]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        print(f"[build] {inst.symbol} (warp per env): {got['registers']} registers, "
              f"{got['smem']} bytes static smem + {occ['smem_per_block']} bytes dynamic smem per "
              f"block of {occ['envs_per_block']} envs, stack frame {got['frame']} bytes, spill "
              f"stores {got['spill_stores']} / loads {got['spill_loads']} bytes, global workspace "
              f"{ws} floats per env; {occ['blocks_per_sm']} blocks = {occ['envs_per_sm']} envs "
              f"resident per SM, {occ['envs_per_sm'] * sms} on the {sms} SMs of {card}")
        check(got["spill_stores"] == 0 and got["spill_loads"] == 0,
              f"{inst.symbol}: ptxas reports spills: {got}")
        check(ws == 0 and occ["blocks_per_sm"] >= 1, f"{inst.symbol}: workspace {ws}, {occ}")
        held = occ["blocks_per_sm"] * (occ["smem_per_block"] + smem["reserved_per_block"])
        print(f"[build] {inst.symbol}: {occ['blocks_per_sm']} × ({occ['smem_per_block']} + "
              f"{smem['reserved_per_block']}) = {held} of the SM's {smem['per_sm']} bytes; one "
              f"more block would need {held + occ['smem_per_block'] + smem['reserved_per_block']}")
        if inst.index is None:
            print(f"[build] {inst.symbol} (generic): the host picked {inst.envs} envs × "
                  f"{inst.blocks} block of {engine.warp_env_bytes(inst.key)} bytes each")
            check(occ["envs_per_block"] == inst.envs, f"{inst.symbol}: {occ}, the host picked "
                                                      f"{inst.envs} envs per block")
            continue
        want = WARP_BUILDS[inst.symbol]
        check((got["registers"], occ["smem_per_block"], occ["envs_per_sm"]) == want,
              f"{inst.symbol}: registers, shared memory per block, envs per SM "
              f"{(got['registers'], occ['smem_per_block'], occ['envs_per_sm'])}, want {want}")


def design_sweep(engine, card, label: str, new, old, states, sweep, matfree=None) -> None:
    """The two designs of one key timed in turns (thread per env, warp per
    env, warp per env, thread per env; CUDA events) on ``states(batch,
    rng)`` (numpy inputs) at each B of ``sweep`` ({B: timed calls}), each
    beside the bound these inputs need (an A-form's on the fewer operations
    of its own count and its ``matfree`` twin's, as :func:`time_and_bound`
    takes it) and the waves of the warp-per-env design's envs resident per
    SM."""
    rng = np.random.default_rng(SEED + 2)
    occ = engine.occupancy(engine.build()[new.name], new.name)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for batch, calls in sweep.items():
        args = [torch.as_tensor(x, device="cuda") for x in states(batch, rng)]
        t = [time_call(k.launch, args, calls) for k in (old, new, new, old)]
        old_ms, new_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        lim_act, con_act, walk = engine.k1_activity(new, *args)
        flops = engine.k1_flops(new, lim_act, con_act, *args[5:], tri_walk=walk)
        if matfree is not None:
            flops = min(flops, engine.k1_flops(matfree, lim_act, con_act, *args[5:],
                                               tri_walk=walk))
        t_ops = flops / PEAK_FP32 * 1e3
        t_bytes = engine.k1_bytes_per_env(new) * batch / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        print(f"[sweep] {label} at B={batch} on {card}: thread per env {t[0]:.4f} / {t[3]:.4f} "
              f"ms/call, warp per env {t[1]:.4f} / {t[2]:.4f} (in the order old, new, new, old; "
              f"{calls} calls each); bound {bound:.5f} ms by "
              f"{'operations' if t_ops >= t_bytes else 'bytes'}; old {old_ms / bound:.1f}× and "
              f"new {new_ms / bound:.1f}× the bound, new {old_ms / new_ms:.2f}× faster; "
              f"{batch / (occ['envs_per_sm'] * sms):.2f} waves of {occ['envs_per_sm']} envs per "
              f"SM; active per env and substep: limit rows "
              f"{float(lim_act.float().sum(2).mean()):.3f}, contacts "
              f"{float(con_act.float().sum(2).mean()):.3f}")
        del args


def drive(port, engine, card, env_id: str, steps: int, variant: str, sums=(), watch=None,
          instance: str | None = None, **make_kw):
    """One main path: ``steps`` control steps of uniform random actions
    through the entry points (``make(env_id, **make_kw)``); ``watch`` is
    called on every transition. Every launch must be ``variant``'s and, if
    given, by the K1 ``instance`` of that symbol. Returns (launches, final state, last
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
    engine.INSTANCE_LAUNCHES.clear()
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
    counts, by_instance = dict(engine.LAUNCHES), dict(engine.INSTANCE_LAUNCHES)
    launches, dones = counts.get(variant, 0), int(dones)
    print(f"[main] {env_id}: {steps} steps × {B} envs in {wall:.3f} s "
          f"({1e3 * wall / steps:.3f} ms/step): {steps * B / wall:.0f} env-steps/s on {card}; "
          f"launches {counts}, by instance {by_instance}")
    check(counts == {variant: steps},
          f"{env_id}: expected {steps} {variant} launches and no other, got {counts}")
    check(instance is None or by_instance == {instance: steps},
          f"{env_id}: expected {steps} launches of the instance {instance}, got {by_instance}")
    check(bool(torch.isfinite(state.q).all() and torch.isfinite(state.qd).all()),
          f"{env_id}: final state not finite")
    check(tr.obs.shape == (B, env.obs_dim) and bool(torch.isfinite(tr.obs).all()),
          f"{env_id}: observations malformed")
    check(dones > 0 and int(state.reset_count.sum()) > 0, f"{env_id}: auto-reset never fired")
    print(f"[main] {env_id}: episodes ended {dones}, resets {int(state.reset_count.sum())}, "
          f"blow-ups {int(state.blowup_count.sum())}, mean episode steps now "
          f"{float(state.steps.float().mean()):.1f}")
    return launches, state, tr, batch, 1e3 * wall / steps, {k: float(v) for k, v in totals.items()}


def hang_check(engine, batch, spec, card, instance: str) -> None:
    """50 control steps of zero torques with both grab signals on, from
    fresh episodes, without auto-reset: the body must hang from its bar, by
    the K1 ``instance`` of that symbol alone (one launch per step)."""
    from mocca_envs_tpu_torch.tasks.monkey_stepper import make_palm_positions

    env = batch.env
    state = env.init(batch.generator, B)
    z0 = state.q[:, 2].clone()
    actions = torch.zeros((B, env.act_dim), device="cuda")
    actions[:, -2:] = 1.0
    fell = torch.zeros(B, dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    engine.INSTANCE_LAUNCHES.clear()
    for _ in range(50):
        tr = env.step_no_reset(state, actions, batch.generator)
        state = tr.state
        fell |= tr.metrics["fell"] > 0.5
    torch.cuda.synchronize()
    by_instance = dict(engine.INSTANCE_LAUNCHES)
    print(f"[main] Monkey3DStepperEnv-v0 hang: launches by instance {by_instance}")
    check(by_instance == {instance: 50}, f"hang: expected 50 launches of {instance}, got "
                                         f"{by_instance}")
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


def time_and_bound(engine, card, kernel, args, twin=None) -> dict:
    """Per-call times of the kernel (50 calls) and its plain version (3),
    and the bound from the operations and bytes these inputs need. With a
    matrix-free ``twin`` (an A-form computes the same function) the bound
    takes the fewer of the two counts of operations on this activity; the
    kernel's own count is printed beside it."""
    ms = time_call(kernel.launch, args, 50)
    plain_ms = time_call(kernel.plain, args, 3)
    scene_inputs = args[5:]
    stones = args[5] if kernel.num_stones else None
    lim_act, con_act, walk = engine.k1_activity(kernel, *args)
    flops = engine.k1_flops(kernel, lim_act, con_act, *scene_inputs, tri_walk=walk)
    flops_all = engine.k1_flops(kernel, torch.ones_like(lim_act), torch.ones_like(con_act),
                                *scene_inputs, tri_walk=walk)
    nbytes = engine.k1_bytes_per_env(kernel) * B
    own_flops = flops
    if twin is not None:
        flops = min(flops, engine.k1_flops(twin, lim_act, con_act, *scene_inputs, tri_walk=walk))
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
    if twin is not None:
        print(f"[bound] {v}: its matrix-free twin {twin.name} computes the same function in "
              f"{flops} fp32 ops on this activity, which set the bound; its own form counts "
              f"{own_flops} ({own_flops / B:.0f} per env, {own_flops / flops:.3f}×): own-form "
              f"bound {max(own_flops / PEAK_FP32 * 1e3, t_bytes):.5f} ms")
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
    return counts["k2"], (o, d, hf, xy0, cell)


def ptxas_kernels(log: str) -> dict:
    """:func:`ptxas` of each entry function of an nvcc ``-Xptxas -v`` report
    that holds several: ``{mangled name: readings}``."""
    import re

    parts = re.split(r"Compiling entry function '([^']+)'", log)
    return {parts[j]: ptxas(parts[j + 1]) for j in range(1, len(parts), 2)}


def k2_kernel_label(name: str) -> str:
    """K2's kernels by their design: the cooperative march with its grid
    staged in shared memory or read through L1, or the thread march."""
    if "k2_thread_kernel" in name:
        return "one thread per ray"
    return "cooperative, grid staged" if "ILb1E" in name else "cooperative, grid through L1"


def graph_ms(fn, n: int = 50) -> float:
    """ms per launch of ``fn``'s kernel: ``n`` launches captured in one CUDA
    graph, its replays bracketed by CUDA events (no host issue between
    launches)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * n)


def kernel_times(fns, match: str, n: int = 50) -> tuple:
    """The device's own time of each of ``fns``' kernels (each launches one
    kernel whose name holds ``match``), ms: the median duration of ``n``
    launches in a ``torch.profiler`` trace of the card's activity, all of
    ``fns`` in one trace, in turns as given. Where the trace does not hold
    them all, each from a replayed CUDA graph (:func:`graph_ms`). Returns
    (times, "profiler" or "graph")."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for fn in fns:
            for _ in range(n):
                fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "kernels.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    mine = sorted((e for e in events if e.get("cat") == "kernel" and match in e.get("name", "")
                   and "dur" in e), key=lambda e: float(e["ts"]))
    if len(mine) != n * len(fns):
        return [graph_ms(fn, n) for fn in fns], "graph"
    dur = [float(e["dur"]) for e in mine]
    return [float(np.median(dur[j * n:(j + 1) * n])) / 1e3 for j in range(len(fns))], "profiler"


def raycast_build_report(engine, card) -> None:
    """Phase 1's K2 readings: ptxas's registers, stack frame, spills and
    static shared memory of each of its kernels, and the cooperative
    march's lanes per ray, placement (every grid through L1), blocks
    resident per SM and dynamic shared memory per block at the 65², 129² and
    257² grids."""
    lib = engine.build()[engine.RAYCAST_SYMBOL]
    kernels = ptxas_kernels(engine._Library.logs.get(engine.RAYCAST_SYMBOL, ""))
    for name, got in kernels.items():
        print(f"[build] k2 {k2_kernel_label(name)} ({name}): {got['registers']} registers, "
              f"stack frame {got['frame']} bytes, spill stores {got['spill_stores']} / loads "
              f"{got['spill_loads']} bytes, static smem {got['smem'] or 0} bytes")
    check({k2_kernel_label(name) for name in kernels} == {
        "one thread per ray", "cooperative, grid through L1"},
        f"k2: the library's kernels are {list(kernels)}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in (65, 129, 257):
        occ = engine.raycast_occupancy(lib, (n, n))
        print(f"[build] k2 cooperative march over {n}²: {occ['group']} lanes per ray, grid "
              f"{'staged in shared memory' if occ['staged'] else 'through L1'}, "
              f"{occ['blocks_per_sm']} blocks of {occ['threads']} threads resident per SM "
              f"({occ['blocks_per_sm'] * occ['threads'] // 32} warps, "
              f"{occ['blocks_per_sm'] * occ['threads'] // 32 * 32 // occ['group']} rays at once "
              f"per SM, {sms} SMs on {card}), {occ['smem_per_block']} bytes of dynamic shared "
              "memory per block")
        check(not occ["staged"], f"k2: the {n}² grid's placement {occ}")
        check(occ["blocks_per_sm"] >= 1, f"k2: {occ}")


def raycast_designs_agree(engine, card, ray_args, rng) -> float:
    """Phase 2's hold of K2's cooperative march to its one-thread-per-ray
    twin, bit for bit on t and h, on the main path's 32,768 rays over 129²
    (``ray_args``) and on 32,768 rays over a 65² and a 257² grid (the latter
    read through L1), and of the twin to the plain version
    (:func:`check_rays`). Returns the twin's largest error."""
    from mocca_envs_tpu_torch.ops.raycast import make_raycaster, raycast_reference

    worst = 0.0
    for n, args in ((129, ray_args), (65, None), (257, None)):
        if args is None:
            args = [torch.as_tensor(x, device="cuda") for x in raycast_inputs(rng, 8 * B, n)]
        engine.LAUNCHES.clear()
        t, h = make_raycaster((n, n))(*args)
        tw, hw = make_raycaster((n, n), thread_per_ray=True)(*args)
        torch.cuda.synchronize()
        check(dict(engine.LAUNCHES) == {"k2": 1, "k2_thread": 1},
              f"k2: the two designs launched {dict(engine.LAUNCHES)}")
        same = bool(torch.equal(t, tw) and torch.equal(h, hw))
        print(f"[compare] k2 over {n}²: the cooperative march and the one-thread-per-ray twin "
              f"on {8 * B} rays: the same bits: {same} ({int((t != tw).sum())} t and "
              f"{int((h != hw).sum())} h differ)")
        check(same, f"k2 over {n}²: the cooperative march parts from its twin")
        want_t, want_h = raycast_reference(*args)
        share, dt_err, h_err = check_rays(*(x.cpu().numpy() for x in (tw, hw, want_t, want_h)),
                                          10.0 / 64)
        worst = max(worst, dt_err, h_err)
        print(f"[compare] k2 twin over {n}² vs plain: t equal on {share:.5f}, largest |Δt| "
              f"{dt_err:.4e}, largest |Δh| where t agrees {h_err:.3e}; "
              f"{float((want_t < 10.0).float().mean()):.4f} of the rays hit, on {card}")
    return worst


def raycast_design_times(engine, args, lib=None, n: int = 50, max_t: float = 10.0,
                         num_steps: int = 64) -> dict:
    """K2's two designs on ``args`` in turns (twin, cooperative, cooperative,
    twin), ms per call: ``device``, the kernel's own time
    (:func:`kernel_times`); ``launch``, its ctypes launch alone (the library
    looked up once, the outputs allocated once, the pointers taken once; 50
    calls bracketed by CUDA events), which times the host's issue where the
    kernel is shorter; and, with the shipped library (``lib`` None),
    ``wrapper``, through ``make_raycaster``. Each design's outputs from
    the launch alone must equal the wrapper's, and the two designs' each
    other's. Uncounted. ``{"thread": {...}, "group": {...}, "how": ...}``."""
    from mocca_envs_tpu_torch.ops.raycast import make_raycaster

    o, d, hf, xy0, cell = args
    cell = cell.reshape(1)
    H, W = hf.shape
    shipped = lib is None
    lib = engine.build()[engine.RAYCAST_SYMBOL] if shipped else lib
    out = {v: (torch.empty(o.shape[0], dtype=torch.float32, device=o.device),
               torch.empty(o.shape[0], dtype=torch.float32, device=o.device))
           for v in ("thread", "group")}
    calls = {}
    for v, suffix in (("thread", "_thread_launch"), ("group", "_launch")):
        fn = getattr(lib, engine.RAYCAST_SYMBOL + suffix)
        head = (o.data_ptr(), d.data_ptr(), hf.data_ptr(), H, W, xy0.data_ptr(),
                cell.data_ptr(), max_t, max_t / num_steps, num_steps, out[v][0].data_ptr(),
                out[v][1].data_ptr(), o.shape[0])
        calls[v] = lambda fn=fn, head=head: fn(*head, torch.cuda.current_stream().cuda_stream)
    for v, call in calls.items():
        check(call() == 0, f"k2 {v}: the launch failed")
    torch.cuda.synchronize()
    check(bool(torch.equal(out["thread"][0], out["group"][0])
               and torch.equal(out["thread"][1], out["group"][1])),
          "k2: the two designs' launches gave other bits")
    order = ("thread", "group", "group", "thread")
    device, how = kernel_times([calls[v] for v in order], "k2_", n)
    launch = [time_call(calls[v], (), 50) for v in order]
    got = {"how": how}
    for v in ("thread", "group"):
        got[v] = {"device": (device[order.index(v)] + device[3 - order.index(v)]) / 2,
                  "launch": (launch[order.index(v)] + launch[3 - order.index(v)]) / 2}
    if shipped:
        wrappers = {v: make_raycaster(tuple(hf.shape), max_t, num_steps,
                                      thread_per_ray=v == "thread") for v in ("thread", "group")}
        wrapper = [time_call(wrappers[v], args, 50) for v in order]
        for v in ("thread", "group"):
            got[v]["wrapper"] = (wrapper[order.index(v)] + wrapper[3 - order.index(v)]) / 2
            t, h = wrappers[v](*args)
            torch.cuda.synchronize()
            check(bool(torch.equal(t, out[v][0]) and torch.equal(h, out[v][1])),
                  f"k2 {v}: the launch alone gave other outputs than the wrapper")
    return got


def raycast_bound(t, args) -> tuple:
    """(bound ms, its reason, fp32 operations, bytes) of one K2 call whose
    rays stopped at ``t``: the march steps these rays need, the bytes
    moved."""
    from mocca_envs_tpu_torch.ops.raycast import k2_bytes, k2_flops

    flops, nbytes = k2_flops(t, 10.0, 64), k2_bytes(args[0].shape[0], tuple(args[2].shape))
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops, nbytes


def raycast_time_and_bound(engine, card, args, max_abs: float) -> dict:
    """K2's per-call times on the main path's 32,768 rays over 129² (its
    last call's inputs): both designs by :func:`raycast_design_times`, the
    plain version's (3 calls), and the bound from the march steps these rays
    need and the bytes moved; then both designs at 4,096 and 262,144 rays
    over 129² and at 32,768 over 65² and 257². The JSON line's ``ms`` is
    the cooperative march's own time on the main path's rays."""
    from mocca_envs_tpu_torch.ops.raycast import (
        K2_OPS_PER_STEP, make_raycaster, raycast_reference)

    rng = np.random.default_rng(SEED + 23)
    plain_ms = time_call(lambda *a: raycast_reference(*a, 10.0, 64), args, 3)
    main = None
    for rays, n in ((8 * B, 129), (4096, 129), (64 * B, 129), (8 * B, 65), (8 * B, 257)):
        cur = args if main is None else [torch.as_tensor(x, device="cuda")
                                          for x in raycast_inputs(rng, rays, n)]
        got = raycast_design_times(engine, cur)
        bound_ms, bound_by, flops, nbytes = raycast_bound(make_raycaster((n, n))(*cur)[0], cur)
        print(f"[bound] k2 {rays} rays over {n}²: {flops} fp32 ops needed "
              f"({flops / rays:.1f} per ray, {flops / rays / K2_OPS_PER_STEP:.2f} march steps), "
              f"{nbytes} bytes; bound {bound_ms:.6f} ms by {bound_by}")
        for v, label in (("group", "cooperative"), ("thread", "thread twin")):
            r = got[v]
            print(f"[time] k2 {label} {rays} rays over {n}² on {card}: device {r['device']:.5f} "
                  f"ms/call ({got['how']}), its ctypes launch alone {r['launch']:.5f}, through "
                  f"the wrapper {r['wrapper']:.5f}; {r['device'] / bound_ms:.1f}× the bound on "
                  f"the device, {r['launch'] / bound_ms:.1f}× on the launch alone")
        print(f"[time] k2 {rays} rays over {n}²: the cooperative march "
              f"{got['thread']['device'] / got['group']['device']:.2f}× faster than the twin on "
              "the device")
        if main is None:
            main = {"ms": got["group"]["device"], "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by}
            print(f"[time] k2 main path: cooperative {main['ms']:.5f} ms/call on the device, "
                  f"plain {plain_ms:.3f} ms/call at {rays} rays on {card}; bound "
                  f"{bound_ms:.6f} ms, the kernel at {bound_ms / main['ms']:.2%} of it; max "
                  f"|err| {max_abs:.3e}")
    return main


def window_and_pack_time(engine, card, state) -> None:
    """The terrain step's pass in front of K1f: cut the 16×16 window around
    each root from its 65² grid and pack it for the kernel."""
    from mocca_envs_tpu_torch.terrain import scene as scene_mod

    root_xy = state.q[:, 0:2].contiguous()
    ms = time_call(lambda: engine.pack_hf(scene_mod.extract_patch(state.scene, root_xy)), (), 50)
    print(f"[time] terrain window cut 65² → 16² + pack: {ms:.4f} ms/call at B={B} on {card}")


def counted(engine, fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after: (its result, the counts by variant, by instance, the wall s)."""
    torch.cuda.synchronize()
    engine.LAUNCHES.clear()
    engine.INSTANCE_LAUNCHES.clear()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, dict(engine.LAUNCHES), dict(engine.INSTANCE_LAUNCHES),
            time.perf_counter() - t0)


class _Records(logging.Handler):
    """Keeps the messages logged while it is attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def train_run(engine, card, env_id: str, updates: int, horizon: int, workdir: Path,
              expect: dict, resume_updates: int | None = None, instance: str | None = None
              ) -> list:
    """The training path through the CLI's ``main`` with ``--split-impulse``
    at 4096 envs, the launch counts set to 0 just before and read just
    after; with ``resume_updates`` a second run to that many updates from
    the first's checkpoint, which must say it resumed. The kernel launches
    must be ``expect`` (and, if given, all by the K1 ``instance`` of that
    symbol), every metric finite but the NaN env channels the
    learner allows. Returns the metric lines."""
    from mocca_envs_tpu_torch.harness import train

    ckpt, metrics = workdir / f"{env_id}_ckpt", workdir / f"{env_id}.jsonl"
    base = ["--env", env_id, "--split-impulse", "--num-envs", str(B), "--horizon", str(horizon),
            "--log-every", "1", "--ckpt-dir", str(ckpt), "--metrics", str(metrics)]
    def run():
        state = train.main([*base, "--updates", str(updates)])
        if resume_updates is not None:
            state = train.main([*base, "--updates", str(resume_updates)])
        return state

    records = _Records()
    logging.getLogger().addHandler(records)
    try:
        state, counts, by_instance, wall = counted(engine, run)
    finally:
        logging.getLogger().removeHandler(records)
    total = resume_updates or updates
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    print(f"[train] {env_id} --split-impulse: {total} updates of {horizon} steps × {B} envs in "
          f"{wall:.3f} s on {card}; launches {counts}, by instance {by_instance}")
    for line in lines:
        print(f"[train] {env_id} update {line['step']}: {line['env_steps_per_s']:.0f} env-steps/s, "
              f"rollout {line['rollout_s']:.4f} s, PPO update {line['update_s']:.4f} s, reward "
              f"per step {line['reward_per_step']:.4f}, done rate "
              f"{line['episode_done_rate']:.4f}, pg loss {line['pg_loss']:.4f}, v loss "
              f"{line['v_loss']:.4f}")
    check(counts == expect, f"{env_id} training: expected launches {expect}, got {counts}")
    check(instance is None or by_instance == {instance: sum(expect.values())},
          f"{env_id} training: expected the instance {instance} alone, got {by_instance}")
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


LADDER_KEYS = {"stage", "deterministic", "truncated", "episodes", "ep_end_steps_mean",
               "ep_end_steps_p50", "ep_end_steps_p90", "frac_ge_4", "frac_ge_8",
               "frac_complete"}
BAR_EVAL_KEYS = {"stage", "deterministic", "truncated", "episodes", "ep_end_bars_mean",
                 "ep_end_bars_p50", "ep_end_bars_p90", "frac_ge_4", "stage_mean"}
MIXED_IDS = ("Walker3DCustomEnv", "CassieEnv", "Monkey3DStepperEnv")


def check_eval_rows(rows, keys: set, label: str) -> None:
    """Each eval row has the JAX package's keys; a row with episodes has
    finite statistics and shares in [0, 1], one without has None."""
    for row in rows:
        check(set(row) == keys, f"{label}: row keys {sorted(row)}")
        stats = [k for k in keys if k.startswith(("ep_end", "frac", "stage_mean"))]
        if row["episodes"] == 0:
            check(all(row[k] is None for k in stats), f"{label}: a row without episodes {row}")
        else:
            check(all(np.isfinite(row[k]) for k in stats), f"{label}: non-finite row {row}")
            check(all(0.0 <= row[k] <= 1.0 for k in stats if k.startswith("frac")),
                  f"{label}: a share outside [0, 1] in {row}")


def check_phase_rows(emits, phases: dict, label: str, card: str) -> None:
    """The update rows of each phase (``phases``: tag → updates) are there,
    finite, and printed with their env-steps/s."""
    for tag, n in phases.items():
        rows = [e for e in emits if e.get("phase") == tag and "update" in e]
        check([e["update"] for e in rows] == list(range(1, n + 1)),
              f"{label} {tag}: update rows {[e['update'] for e in rows]}")
        for e in rows:
            bad = [k for k, v in e.items() if isinstance(v, float) and not np.isfinite(v)]
            check(not bad, f"{label} {tag}: non-finite {bad} in {e}")
            print(f"[pipelines] {label} {tag} update {e['update']}: {e['env_steps_per_s']} "
                  f"env-steps/s, reward per step {e['reward_per_step']:.4f}, pg loss "
                  f"{e['pg_loss']:.4f}, v loss {e['v_loss']:.4f}, log-std floor "
                  f"{e['log_std_floor']}, speed {e['speed']}"
                  + (f", mean stage {e['mean_stage']}" if "mean_stage" in e else "")
                  + f" at B={B} on {card}")


def check_checkpoint(path: Path, label: str) -> None:
    """The newest checkpoint of a phase: its network's parameters finite."""
    newest = max(path.glob("ckpt_*.pt"), key=lambda p: int(p.stem.split("_")[1]))
    module = torch.load(newest, map_location="cpu", weights_only=True)["state"]["fields"][
        "params"]["module"]
    check(all(bool(torch.isfinite(v).all()) for v in module.values()),
          f"{label}: non-finite parameters in {newest.name}")


def pipelines(engine, card, workdir: Path, symbols: dict) -> dict:
    """The three training pipelines at the published widths (4096 envs,
    (256, 256), horizon 128, 4 epochs), depth cut to 2 updates a phase:
    ``run_allsteps`` (32 minibatches, mirror_coef 4.0; the ladder at stages 0
    and 4, 100 steps each), ``run_brachiation`` (its pinned stage 9 and its
    adaptive row, 100 steps each), each run twice on one root (the second
    launches only its evaluation steps), and the mixed suite through the
    CLI, ``--num-envs 3072`` (1024 a family), 2 updates, then resumed to 3.
    Each run's launches must be exactly the listed counts, each by its named
    warp-per-env instance (``symbols``). Returns the mixed CLI's metric
    lines."""
    from mocca_envs_tpu_torch.harness import allsteps, brachiation, train

    steps = 128
    emits: list = []
    hooks = allsteps.RunHooks(emit=lambda **kw: emits.append(kw))
    # the published widths, spelled out: the configs' defaults
    widths = dict(num_envs=B, horizon=steps, num_epochs=4, num_minibatches=32,
                  hidden=(256, 256))
    cfg = allsteps.AllstepsConfig(**widths, mirror_coef=4.0, seed=SEED,
                                  ckpt_root=str(workdir / "allsteps"), pretrain_updates=2,
                                  stepper_updates=2, highstage_updates=2, eval_stages=(0, 4),
                                  eval_steps=100, log_every=1)
    ladder, first = 2 * cfg.eval_steps, {}
    for run in (1, 2):
        emits.clear()
        out, counts, by_instance, wall = counted(engine, lambda: allsteps.run_allsteps(cfg, hooks))
        print(f"[pipelines] run_allsteps, run {run}: {wall:.3f} s on {card}; launches {counts}, "
              f"by instance {by_instance}")
        want = ({"k1a": 2 * steps, "k1c": 4 * steps + ladder} if run == 1 else
                {"k1c": ladder})
        check(counts == want, f"run_allsteps run {run}: expected launches {want}, got {counts}")
        check(by_instance == {symbols[v]: n for v, n in
                              (("k1a", want.get("k1a")), ("k1c", want["k1c"])) if n},
              f"run_allsteps run {run}: not the named warp instances alone: {by_instance}")
        check(out["pretrain_finished"] and out["stepper_finished"] and out["highstage_finished"],
              f"run_allsteps run {run}: a phase did not finish: {out}")
        check([row["stage"] for row in out["ladder"]] == [0, 4],
              f"run_allsteps run {run}: ladder {out['ladder']}")
        check_eval_rows(out["ladder"], LADDER_KEYS, "ladder")
        for row in out["ladder"]:
            print(f"[pipelines] ladder run {run}: {row}")
        if run == 1:
            check(sum(1 for e in emits if e.get("seeded")) == 2, "run_allsteps: seeded phases")
            check_phase_rows(emits, {"pretrain": 2, "stepper": 2, "highstage": 2}, "allsteps",
                             card)
            for phase in ("pre", "st", "hs"):
                d = workdir / "allsteps" / f"s{SEED}" / phase
                check((d / "PHASE_DONE").exists(), f"run_allsteps: no PHASE_DONE in {phase}")
                check_checkpoint(d, f"run_allsteps {phase}")
            first["ladder"] = out["ladder"]
        else:
            check(sum(1 for e in emits if "already_done_at" in e) == 3
                  and not any("update" in e for e in emits),
                  f"run_allsteps run 2 did not short-circuit every phase: {emits}")
            # the restored state is the trained one: the same ladder
            check(out["ladder"] == first["ladder"], "run_allsteps run 2: another ladder")

    bcfg = brachiation.BrachiationConfig(**widths, seed=SEED,
                                         ckpt_root=str(workdir / "brachiation"), main_updates=2,
                                         ft_updates=2, eval_steps=100, log_every=1)
    evals = 2 * bcfg.eval_steps
    for run in (1, 2):
        emits.clear()
        out, counts, by_instance, wall = counted(
            engine, lambda: brachiation.run_brachiation(bcfg, hooks))
        print(f"[pipelines] run_brachiation, run {run}: {wall:.3f} s on {card}; launches "
              f"{counts}, by instance {by_instance}")
        want = 4 * steps + evals if run == 1 else evals
        check(counts == {"k1d": want},
              f"run_brachiation run {run}: expected {want} k1d launches, got {counts}")
        check(by_instance == {symbols["k1d"]: want},
              f"run_brachiation run {run}: not the named warp instance alone: {by_instance}")
        check(out["main_finished"] and out["ft_finished"],
              f"run_brachiation run {run}: a phase did not finish: {out}")
        check([row["stage"] for row in out["evals"]] == [9.0, None],
              f"run_brachiation run {run}: evals {out['evals']}")
        check_eval_rows(out["evals"], BAR_EVAL_KEYS, "bar eval")
        for row in out["evals"]:
            print(f"[pipelines] bar eval run {run}: {row}")
        if run == 1:
            check_phase_rows(emits, {"monkey_main": 2, "monkey_ft": 2}, "brachiation", card)
            for phase in ("main", "ft"):
                d = workdir / "brachiation" / f"s{SEED}" / phase
                check((d / "PHASE_DONE").exists(), f"run_brachiation: no PHASE_DONE in {phase}")
                check_checkpoint(d, f"run_brachiation {phase}")
            first["evals"] = out["evals"]
        else:
            check(sum(1 for e in emits if "already_done_at" in e) == 2
                  and not any("update" in e for e in emits),
                  f"run_brachiation run 2 did not short-circuit every phase: {emits}")
            check(out["evals"] == first["evals"], "run_brachiation run 2: other eval rows")

    metrics, per_family = workdir / "mixed.jsonl", B // 4
    base = ["--env", ",".join(MIXED_IDS), "--num-envs", str(3 * per_family), "--horizon",
            str(steps),
            "--epochs", "4", "--mirror-coef", "4.0", "--log-every", "1", "--ckpt-dir",
            str(workdir / "mixed_ckpt"), "--metrics", str(metrics)]
    records = _Records()
    logging.getLogger().addHandler(records)
    try:
        for run, updates in ((1, 2), (2, 3)):
            state, counts, by_instance, wall = counted(
                engine, lambda: train.main([*base, "--updates", str(updates)]))
            n = steps * (2 if run == 1 else 1)
            print(f"[pipelines] mixed suite through the CLI, run {run} (to update {updates}): "
                  f"{wall:.3f} s on {card}; launches {counts}, by instance {by_instance}")
            check(counts == {"k1a": n, "k1e": n, "k1d": n},
                  f"mixed run {run}: expected {n} launches of k1a, k1e, k1d, got {counts}")
            check(by_instance == {symbols[v]: n for v in ("k1a", "k1e_cassie", "k1d")},
                  f"mixed run {run}: not the named warp instances alone: {by_instance}")
    finally:
        logging.getLogger().removeHandler(records)
    check("resumed from update 2" in records.messages, "mixed: the second run did not resume")
    print("[pipelines] mixed suite: the second run logged 'resumed from update 2'")
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    check([x["step"] for x in lines] == [1, 2, 3], f"mixed: metric lines {lines}")
    for line in lines:
        bad = [k for k, v in line.items() if not np.isfinite(v)
               and not k.startswith(("env/", "ep_end/"))]
        check(not bad, f"mixed: non-finite metrics {bad}")
        fams = ", ".join(f"{name} {line[f'rollout_s/{name}']:.4f} s" for name in MIXED_IDS)
        print(f"[pipelines] mixed update {line['step']}: {line['env_steps_per_s']:.0f} "
              f"env-steps/s, rollout {line['rollout_s']:.4f} s ({fams}), PPO update "
              f"{line['update_s']:.4f} s, reward per step {line['reward_per_step']:.4f} at "
              f"B=3 × {per_family} on {card}")
        check(all(np.isfinite(line[f"env/{name}/blowup"]) for name in MIXED_IDS),
              f"mixed: a family's channels are missing or not finite: {line}")
    check(state.update_count == 3, f"mixed: ended at {state.update_count}")
    check(all(bool(torch.isfinite(p).all()) for p in state.params.parameters()),
          "mixed: non-finite parameters")
    check(all(bool(torch.isfinite(s.q).all()) for s in state.env_state),
          "mixed: non-finite state")
    return lines


def combination_refused(engine, model, config) -> None:
    """On the card a scene combination the kernel source does not compose
    (PD mode over stones) must raise, naming it, before any launch."""
    from mocca_envs_tpu_torch.ops.step import make_control_step
    from mocca_envs_tpu_torch.terrain import scene as scene_mod

    step = make_control_step(model, config, pd_targets=lambda a: a)
    n = 4
    scene = scene_mod.with_stones(torch.zeros(n, 6, 3, device="cuda"),
                                  torch.tensor([1.0, 0, 0, 0], device="cuda").expand(n, 6, 4),
                                  torch.full((n, 6, 3), 0.1, device="cuda"))
    q = torch.zeros(n, model.nq, device="cuda")
    q[:, 2], q[:, 3] = 0.95, 1.0
    engine.LAUNCHES.clear()
    try:
        step(q, torch.zeros(n, model.nv, device="cuda"), torch.zeros(n, model.nj, device="cuda"),
             scene)
    except NotImplementedError as e:
        check("no K1 instantiation" in str(e), f"PD over stones: unexpected message {e}")
        check(sum(engine.LAUNCHES.values()) == 0, "PD over stones: launched before the refusal")
        print(f"[main] PD mode over stones on the card raises before any launch: {e}")
        return
    check(False, "PD mode over stones ran on the card")


def device_busy(events) -> tuple:
    """(the device events of a Chrome trace, µs in which the device was
    busy, µs from the first event's start to the last one's end)."""
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and "dur" in e]
    if not dev:
        return dev, 0.0, 0.0
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return dev, busy, spans[-1][1] - spans[0][0]


def walker_trace(port, card, steps: int = 20) -> None:
    """Where the walker's control step goes now that K1a is short: the host's
    time to enqueue ``steps`` steps (no synchronise) against the wall time
    ended by one, and a ``torch.profiler`` trace of the same steps: the
    device's busy share and its events per step."""
    env = port.make("Walker3DCustomEnv-v0")
    batch = port.BatchedEnv(env, B, seed=SEED)
    state = batch.init()
    actions = torch.zeros((B, env.act_dim), device="cuda")
    for _ in range(5):
        state = batch.step(state, actions).state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = batch.step(state, actions).state
    enqueued = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            state = batch.step(state, actions).state
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "walker.json"
        prof.export_chrome_trace(str(path))
        dev, busy, window = device_busy(json.loads(path.read_text())["traceEvents"])
    share = f"busy {busy / 1e3:.3f} ms of {window / 1e3:.3f} = {busy / window:.2%}" if dev else \
        "no device events in the trace: busy share not measured"
    print(f"[profile] Walker3DCustomEnv-v0, {steps} steps × {B} envs on {card}: the host enqueued "
          f"them in {1e3 * enqueued / steps:.3f} ms/step, the wall to the synchronise "
          f"{1e3 * wall / steps:.3f} ms/step; traced: {len(dev) / steps:.0f} device events per "
          f"step, {share}")


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
    dev, busy, window = device_busy(events)
    if not dev:
        print(f"[profile] stepper update: the trace holds no device events on {card}: device "
              "busy share not measured")
        return
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

    config = EngineConfig()
    split = lambda cfg: dataclasses.replace(cfg, split_impulse=True)  # noqa: E731
    model = walker3d.make_model("cuda")
    kp = model.power_coef * (model.actuated > 0).to(torch.float32)
    cmodel = cassie.make_model("cuda")
    wmodel = walker2d.make_walker2d("cuda")
    # split impulse on the PD walker (one and two llc frames), the torque
    # planar walkers, terrain and the stairs (K1h-b at one llc frame, the
    # planar K1h-e, K1h-f and K1h-g by their warp-per-env instances); the
    # walker's PGS options (OPTION_CONFIGS; the A-forms of AFORMS by their
    # warp-per-env instances); the PD keys of several llc frames (LLC_KEYS,
    # the generic warp-per-env instances of their keys)
    added = {
        "k1c_sub2_it8": engine.K1c(model, EngineConfig(**STEPPER_2X8)),
        "k1h_b": engine.K1b(model.replace(kp=kp), split(config), extra_damping=kp / 20.0),
        "k1b_llc2": engine.K1b(model.replace(kp=kp), EngineConfig(llc_frames=2),
                               extra_damping=kp / 20.0),
        "k1h_b_llc2": engine.K1b(model.replace(kp=kp), EngineConfig(llc_frames=2,
                                                                     split_impulse=True),
                                 extra_damping=kp / 20.0),
        "k1e_cassie_llc5": engine.K1e(cmodel, dataclasses.replace(CASSIE_CONFIG, llc_frames=5),
                                      cassie.constraints(), pd_mode=True,
                                      extra_damping=cmodel.actuated * cmodel.kd),
        "k1h_e_planar": engine.K1e(wmodel, split(config), walker2d.planar_spec()),
        "k1h_f": engine.K1f(model, split(config), HF_PATCH),
        "k1h_g": engine.K1g(model, split(config)),
        **{v: engine.make_kernel(model, EngineConfig(**fields))
           for v, fields in OPTION_CONFIGS.items()},
    }
    # the thread-per-env twins of K1h-f, K1h-g, K1h-c, K1h-b, K1h-si, the
    # planar K1h-e, the walker's three A-form keys (with split impulse,
    # alone and with all four options off), its scalar friction,
    # factor-every-substep and cold-start keys, the walker and the stepper
    # at 2 × 8 and the PD keys of several llc frames: the generic
    # engine_k1.cu instances of their keys (K1h-c's and K1h-si's the named
    # k1h_..._k6_si and k1h_..._si, K1b's at two llc frames the named
    # k1b_..._llc2)
    thread_twins = {"k1h_f": engine.K1f(model, split(config), HF_PATCH, thread_per_env=True),
                    "k1h_g": engine.K1g(model, split(config), thread_per_env=True),
                    "k1h_c": engine.K1c(model, split(config), thread_per_env=True),
                    "k1h_b": engine.K1b(model.replace(kp=kp), split(config),
                                        extra_damping=kp / 20.0, thread_per_env=True),
                    "k1h_si": engine.K1hSi(model, split(config), thread_per_env=True),
                    "k1h_e_planar": engine.K1e(wmodel, split(config), walker2d.planar_spec(),
                                               thread_per_env=True),
                    **{v: type(added[v])(model, added[v].config, thread_per_env=True)
                       for v in (*AFORMS, *MATFREE_OPTIONS, *NEW_WARP)},
                    **{v: engine.K1b(model.replace(kp=kp), added[v].config,
                                     extra_damping=kp / 20.0, thread_per_env=True)
                       for v in ("k1b_llc2", "k1h_b_llc2")},
                    "k1e_cassie_llc5": engine.K1e(
                        cmodel, added["k1e_cassie_llc5"].config, cassie.constraints(),
                        pd_mode=True, extra_damping=cmodel.actuated * cmodel.kd,
                        thread_per_env=True)}
    # the all-off key's matrix-free form (the same function): the generic
    # engine_k1.cu instance of its other three options
    matfree_off = engine.K1a(model, EngineConfig(block_pgs=False, warm_start=False,
                                                 reuse_factor=False), thread_per_env=True)
    # the A-form twins of scalar friction, of a factor every substep and of a
    # cold start (the same function, written independently): the generic
    # engine_k1.cu instances
    aform_twins = {v: engine.K1a(model, EngineConfig(**OPTION_CONFIGS[v], matfree_pgs=False),
                                 thread_per_env=True) for v in (*MATFREE_OPTIONS, "k1a_cold")}

    # ---- phase 1: build
    t0 = time.perf_counter()
    extra = [*added.values(), *thread_twins.values(), matfree_off, *aform_twins.values()]
    engine.build([k.instance for k in extra])
    generic = sum(k.instance.index is None for k in extra)
    print(f"[build] {len(engine.WARP_INSTANCES)} warp-per-env K1 instances, "
          f"{len(engine.INSTANTIATIONS)} named ones, {generic} generic ones and K2 built in "
          f"{time.perf_counter() - t0:.1f} s")
    for symbol, log in engine._Library.logs.items():
        for line in log.splitlines():
            if "registers" in line or "stack frame" in line:
                print(f"[build] {symbol}: {line.strip()}")
    build_report(engine, card, [k.instance for k in extra if k.instance.source == engine.SOURCE_W
                                and k.instance.index is None])
    raycast_build_report(engine, card)

    # ---- phase 2: each kernel vs its plain version at the main paths' shapes
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
    # the warp-per-env K1a and K1b against their thread-per-env instances (the
    # same iteration), near contact and with every base lifted clear of the
    # plane (every contact row skipped)
    k1a_thread = engine.K1a(model, config, thread_per_env=True)
    k1b_thread = engine.K1b(model.replace(kp=kp), config, extra_damping=kp / 20.0,
                            thread_per_env=True)
    k1c_thread = engine.K1c(model, config, thread_per_env=True)
    for v, thread in (("k1a", k1a_thread), ("k1b", k1b_thread), ("k1c", k1c_thread)):
        check(kernels[v][0].instance.source != thread.instance.source,
              f"{v}: the main path's instance is the thread-per-env one")
        max_abs[v] = max(max_abs[v], twin_and_lifted(kernels[v][0], thread, kernels[v][1], v,
                                                     3.0))
    two_frames = added["k1b_llc2"]
    kernels["k1b_llc2"] = (two_frames, kernels["k1b"][1])
    max_abs["k1b_llc2"] = compare(two_frames, kernels["k1b"][1], "k1b (2 llc frames)")

    rods, stand, stand_z = cassie.constraints(), cassie.stand_q(cmodel), cassie.initial_z()
    k1e_thread = {}
    for v, spec in (("k1e_cassie", rods),
                    ("k1e_cassie2d", dataclasses.replace(rods, planar=True))):
        new, k1e_thread[v] = (engine.K1e(cmodel, CASSIE_CONFIG, spec, pd_mode=True,
                                         extra_damping=cmodel.actuated * cmodel.kd,
                                         thread_per_env=tpe) for tpe in (False, True))
        kernels[v] = (new, cuda(cassie_states(cmodel, stand, stand_z, rng, spec.planar)))
        check(new.instance.source != k1e_thread[v].instance.source,
              f"{v}: the main path's instance is the thread-per-env one")
        max_abs[v] = compare(*kernels[v], v, TOL_EQ, tail="p99")
        # against the thread-per-env instance, near the stand and with every
        # foot lifted 1 m (every contact row skipped)
        max_abs[v] = max(max_abs[v], twin_and_lifted(new, k1e_thread[v], kernels[v][1], v, 1.0,
                                                     TOL_EQ, TOL_EQ, "p99"))
    kernels["k1e_planar"] = (engine.K1e(wmodel, config, walker2d.planar_spec()),
                             cuda(planar_walker_states(wmodel, 1.22, rng)))
    max_abs["k1e_planar"] = compare(*kernels["k1e_planar"], "k1e_planar", TOL_EQ)
    # the warp-per-env planar K1e against its thread-per-env instance, near
    # contact (within the rounding floor over all envs) and with every base
    # lifted 3 m clear of the plane
    k1e_planar_thread = engine.K1e(wmodel, config, walker2d.planar_spec(), thread_per_env=True)
    check(kernels["k1e_planar"][0].instance.source == engine.SOURCE_W
          and k1e_planar_thread.instance.source == engine.SOURCE,
          f"k1e_planar: the main path's instance {kernels['k1e_planar'][0].name} is not the "
          "warp-per-env one")
    rounding_floor(kernels["k1e_planar"][0], k1e_planar_thread, kernels["k1e_planar"][1],
                   "k1e_planar", torch.ones(B, dtype=torch.bool, device="cuda"))
    max_abs["k1e_planar"] = max(max_abs["k1e_planar"], twin_and_lifted(
        kernels["k1e_planar"][0], k1e_planar_thread, kernels["k1e_planar"][1], "k1e_planar", 3.0,
        plain_tol=TOL_EQ))
    mmodel = monkey.make_model("cuda")
    kernels["k1d"] = (engine.K1d(mmodel, config, monkey.constraints(), 16),
                      cuda(monkey_states(mmodel, rng)))
    held = (engine.unpack_grabs(kernels["k1d"][1][6])[0] > 0.5).sum(0).tolist()
    print(f"[compare] k1d: grabs attached (right, left) {held} of {B} envs")
    max_abs["k1d"] = compare(*kernels["k1d"], "k1d", TOL_GRAB, tail="p99")
    # the warp-per-env K1d against its thread-per-env instance, hanging from
    # the bars (within the rounding floor over all envs) and with every base
    # lifted 3 m clear of them
    k1d_thread = engine.K1d(mmodel, config, monkey.constraints(), 16, thread_per_env=True)
    check(kernels["k1d"][0].instance.source == engine.SOURCE_W
          and k1d_thread.instance.source == engine.SOURCE,
          f"k1d: the main path's instance {kernels['k1d'][0].name} is not the warp-per-env one")
    rounding_floor(kernels["k1d"][0], k1d_thread, kernels["k1d"][1], "k1d",
                   torch.ones(B, dtype=torch.bool, device="cuda"))
    max_abs["k1d"] = max(max_abs["k1d"], twin_and_lifted(kernels["k1d"][0], k1d_thread,
                                                         kernels["k1d"][1], "k1d", 3.0,
                                                         plain_tol=TOL_GRAB))
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
    # the warp-per-env K1f against its thread-per-env instance, over the
    # terrain and with every base lifted 3 m clear of it
    k1f_thread = engine.K1f(model, config, HF_PATCH, thread_per_env=True)
    check(kernels["k1f"][0].instance.source != k1f_thread.instance.source,
          "k1f: the main path's instance is the thread-per-env one")
    max_abs["k1f"] = max(max_abs["k1f"], twin_and_lifted(kernels["k1f"][0], k1f_thread,
                                                         kernels["k1f"][1], "k1f", 3.0,
                                                         plain_tol=TOL_HF))
    kernels["k1g"] = (engine.K1g(model, config), cuda(stairs_states(model, rng)))
    vertical = vertical_contacts(*kernels["k1g"])
    print(f"[compare] k1g: {int(vertical.sum())} of {B} envs touch a vertical face in the plain "
          "run; the tail gate holds the others")
    max_abs["k1g"] = compare(*kernels["k1g"], "k1g", TOL, tail="p99", tail_envs=~vertical)
    # the warp-per-env K1g against its thread-per-env instance, on the stairs
    # (the tail gate by the riser rule, its p99 grounded by the rounding
    # floor) and with every base lifted 3 m clear
    k1g_thread = engine.K1g(model, config, thread_per_env=True)
    check(kernels["k1g"][0].instance.source != k1g_thread.instance.source,
          "k1g: the main path's instance is the thread-per-env one")
    rounding_floor(kernels["k1g"][0], k1g_thread, kernels["k1g"][1], "k1g", ~vertical)
    max_abs["k1g"] = max(max_abs["k1g"], twin_and_lifted(kernels["k1g"][0], k1g_thread,
                                                         kernels["k1g"][1], "k1g", 3.0,
                                                         tail_envs=~vertical))
    kernels["k1h_si"] = (engine.K1hSi(model, EngineConfig(split_impulse=True)),
                         kernels["k1a"][1])
    max_abs["k1h_si"] = compare(*kernels["k1h_si"], "k1h_si")
    # the split-impulse twins of the training path, each on its twin's states
    # and held to its twin's gate
    kernels["k1h_c"] = (engine.K1c(model, split(config)), kernels["k1c"][1])
    max_abs["k1h_c"] = compare(*kernels["k1h_c"], "k1h_c")
    # Cassie's and Cassie2D's split keys by their warp-per-env instances, and
    # those against their thread-per-env twins by K1e's rule (TOL_EQ, p99),
    # near the stand (grounded by the 1e-7 q̇-nudge floor over all envs) and
    # with every foot lifted 1 m
    k1h_thread = {}
    for v, twin in (("k1h_e", "k1e_cassie"), ("k1h_e2d", "k1e_cassie2d")):
        new, k1h_thread[v] = (engine.K1e(cmodel, split(CASSIE_CONFIG),
                                         kernels[twin][0].constraints, pd_mode=True,
                                         extra_damping=cmodel.actuated * cmodel.kd,
                                         thread_per_env=tpe) for tpe in (False, True))
        kernels[v] = (new, kernels[twin][1])
        check(new.instance.source == engine.SOURCE_W
              and k1h_thread[v].instance.source == engine.SOURCE,
              f"{v}: the main path's instance {new.name} is not the warp-per-env one")
        max_abs[v] = compare(*kernels[v], v, TOL_EQ, tail="p99")
        rounding_floor(new, k1h_thread[v], kernels[v][1], v,
                       torch.ones(B, dtype=torch.bool, device="cuda"))
        max_abs[v] = max(max_abs[v], twin_and_lifted(new, k1h_thread[v], kernels[v][1], v, 1.0,
                                                     TOL_EQ, TOL_EQ, "p99"))
    kernels["k1h_d"] = (engine.K1d(mmodel, split(config), monkey.constraints(), 16),
                        kernels["k1d"][1])
    max_abs["k1h_d"] = compare(*kernels["k1h_d"], "k1h_d", TOL_GRAB, tail="p99")
    # K1h-d by its warp-per-env instance: against its thread-per-env twin as
    # K1d is (within the rounding floor over all envs, and with every base
    # lifted 3 m clear of the bars), and against K1d's warp-per-env instance,
    # bit for bit where every bias is 0 (lifted, the grabs as drawn) and
    # parting on states with a bar by each foot and the torso in every env
    k1h_d_thread = engine.K1d(mmodel, split(config), monkey.constraints(), 16,
                              thread_per_env=True)
    check(kernels["k1h_d"][0].instance.source == engine.SOURCE_W
          and k1h_d_thread.instance.source == engine.SOURCE,
          f"k1h_d: the main path's instance {kernels['k1h_d'][0].name} is not the warp-per-env one")
    rounding_floor(kernels["k1h_d"][0], k1h_d_thread, kernels["k1h_d"][1], "k1h_d",
                   torch.ones(B, dtype=torch.bool, device="cuda"))
    max_abs["k1h_d"] = max(max_abs["k1h_d"], twin_and_lifted(
        kernels["k1h_d"][0], k1h_d_thread, kernels["k1h_d"][1], "k1h_d", 3.0,
        plain_tol=TOL_GRAB))
    split_against_unsplit(kernels["k1h_d"][0], kernels["k1d"][0],
                          cuda(monkey_states(mmodel, np.random.default_rng(SEED + 3),
                                             near_bar=1.0)), "k1h_d", TOL_GRAB)
    # this slice's split instances, each on its twin's states and gate (K1g's
    # riser rule included), and the walker's PGS options on the K1a states
    # at the walker's gates; each A-form also against its matrix-free twin
    for v, twin in (("k1h_b", "k1b"), ("k1h_e_planar", "k1e_planar"), ("k1h_f", "k1f"),
                    ("k1h_g", "k1g")):
        kernels[v] = (added[v], kernels[twin][1])
    kernels["k1h_b_llc2"] = (added["k1h_b_llc2"], kernels["k1b"][1])
    max_abs["k1h_b_llc2"] = compare(added["k1h_b_llc2"], kernels["k1b"][1],
                                    "k1h_b (2 llc frames)")
    max_abs["k1h_b"] = compare(*kernels["k1h_b"], "k1h_b")
    max_abs["k1h_e_planar"] = compare(*kernels["k1h_e_planar"], "k1h_e_planar", TOL_EQ)
    max_abs["k1h_f"] = compare(*kernels["k1h_f"], "k1h_f", TOL_HF)
    vertical = vertical_contacts(*kernels["k1h_g"])
    print(f"[compare] k1h_g: {int(vertical.sum())} of {B} envs touch a vertical face in the "
          "plain run; the tail gate holds the others")
    max_abs["k1h_g"] = compare(*kernels["k1h_g"], "k1h_g", TOL, tail="p99", tail_envs=~vertical)
    # K1h-f, K1h-g, K1h-c, K1h-b, K1h-si and the planar K1h-e by their
    # warp-per-env instances: against their thread-per-env twins as K1f's and
    # K1g's are (K1h-g by the riser rule), each within the rounding floor
    # (K1h-g off risers, the others over all envs), on the states and with
    # every base lifted 3 m; and against their unsplit warp-per-env twins
    for v, unsplit, plain_tol, tail_envs in (("k1h_f", "k1f", TOL_HF, None),
                                             ("k1h_g", "k1g", TOL, ~vertical),
                                             ("k1h_c", "k1c", TOL, None),
                                             ("k1h_b", "k1b", TOL, None),
                                             ("k1h_si", "k1a", TOL, None),
                                             ("k1h_e_planar", "k1e_planar", TOL_EQ, None)):
        new, twin = kernels[v][0], thread_twins[v]
        check(new.instance.source == engine.SOURCE_W and twin.instance.source == engine.SOURCE,
              f"{v}: the main path's instance {new.name} is not the warp-per-env one")
        rounding_floor(new, twin, kernels[v][1], v,
                       torch.ones(B, dtype=torch.bool, device="cuda") if tail_envs is None
                       else tail_envs)
        max_abs[v] = max(max_abs[v], twin_and_lifted(new, twin, kernels[v][1], v, 3.0,
                                                     plain_tol=plain_tol, tail_envs=tail_envs))
        split_against_unsplit(new, kernels[unsplit][0], kernels[v][1], v, plain_tol)
    for v in OPTION_CONFIGS:
        kernels[v] = (added[v], kernels["k1a"][1])
        max_abs[v] = compare(*kernels[v], v)
    # each A-form against its matrix-free form; the workspaces of its
    # thread-per-env pair (the warp-per-env instances have none); and by its
    # warp-per-env instance against its thread-per-env twin, near contact and
    # with every base lifted 3 m
    matfree = {"k1a_aform": kernels["k1a"][0], "k1h_si_aform": kernels["k1h_si"][0],
               "k1a_aform_scalar_cold_refactor": matfree_off}
    matfree_thread = {"k1a_aform": k1a_thread, "k1h_si_aform": thread_twins["k1h_si"],
                      "k1a_aform_scalar_cold_refactor": matfree_off}
    for v in AFORMS:
        max_abs[v] = max(max_abs[v], compare_twins(added[v], matfree[v], kernels["k1a"][1], v))
        aform_workspace(engine, thread_twins[v], matfree_thread[v], v)
        check(added[v].instance.source == engine.SOURCE_W
              and thread_twins[v].instance.source == engine.SOURCE,
              f"{v}: the main path's instance {added[v].name} is not the warp-per-env one")
        max_abs[v] = max(max_abs[v], twin_and_lifted(added[v], thread_twins[v],
                                                     kernels["k1a"][1], v, 3.0))
    # scalar friction and a factor every substep by their warp-per-env
    # instances: against their thread-per-env twins, near contact and with
    # every base lifted 3 m, and against their A-form twins
    for v in MATFREE_OPTIONS:
        check(added[v].instance.source == engine.SOURCE_W
              and thread_twins[v].instance.source == engine.SOURCE
              and aform_twins[v].instance.source == engine.SOURCE,
              f"{v}: the main path's instance {added[v].name} is not the warp-per-env one")
        max_abs[v] = max(max_abs[v], twin_and_lifted(added[v], thread_twins[v],
                                                     kernels["k1a"][1], v, 3.0),
                         compare_twins(added[v], aform_twins[v], kernels["k1a"][1], v))
    # the cold start by its warp-per-env instance, the walker and the stepper
    # at 2 × 8 by the generic warp-per-env instances of their keys: against
    # their thread-per-env twins, near contact and with every base lifted
    # 3 m; the cold start also against its A-form twin
    kernels["k1c_sub2_it8"] = (added["k1c_sub2_it8"], kernels["k1c"][1])
    max_abs["k1c_sub2_it8"] = compare(*kernels["k1c_sub2_it8"], "k1c_sub2_it8")
    for v in NEW_WARP:
        new, twin = added[v], thread_twins[v]
        check(new.instance.source == engine.SOURCE_W and twin.instance.source == engine.SOURCE
              and (new.instance.index is None) == (v != "k1a_cold"),
              f"{v}: the main path's instance {new.name} is not its warp-per-env one")
        max_abs[v] = max(max_abs[v], twin_and_lifted(new, twin, kernels[v][1], v, 3.0))
    max_abs["k1a_cold"] = max(max_abs["k1a_cold"], compare_twins(
        added["k1a_cold"], aform_twins["k1a_cold"], kernels["k1a"][1], "k1a_cold"))
    # every other option is another iteration: the shipped key's gate tells
    # it from the shipped key
    for v in ("k1a_scalar", "k1a_cold", "k1a_refactor", "k1a_aform_scalar_cold_refactor",
              "k1a_sub2_it8"):
        parts_from_shipped(added[v], kernels["k1a"][0], kernels["k1a"][1], v)
    parts_from_shipped(added["k1c_sub2_it8"], kernels["k1c"][0], kernels["k1c"][1],
                       "k1c_sub2_it8")
    # the PD keys of several llc frames by the generic warp-per-env instances
    # of their keys (the walker keys above, on the K1b states): Cassie at five
    # frames on the Cassie states at K1e's gate; each against its
    # thread-per-env twin near contact and lifted (the walker keys at
    # TOL_TWIN with the largest env, beside the 1e-7 q̇-nudge floor over all
    # envs; Cassie by K1e's rule, TOL_EQ with the p99, every foot lifted 1 m);
    # K1h-b at two frames parts from K1b at two near contact
    kernels["k1e_cassie_llc5"] = (added["k1e_cassie_llc5"], kernels["k1e_cassie"][1])
    max_abs["k1e_cassie_llc5"] = compare(*kernels["k1e_cassie_llc5"], "k1e_cassie_llc5",
                                         TOL_EQ, tail="p99")
    for v in LLC_KEYS:
        new, twin = added[v], thread_twins[v]
        check(new.instance == engine.warp_instance(new.key) and twin.instance.source
              == engine.SOURCE, f"{v}: the instance {new.name} is not the generic warp-per-env "
                                "one of its key")
        if v == "k1e_cassie_llc5":
            max_abs[v] = max(max_abs[v], twin_and_lifted(new, twin, kernels[v][1], v, 1.0,
                                                         TOL_EQ, TOL_EQ, "p99"))
            continue
        rounding_floor(new, twin, kernels[v][1], v,
                       torch.ones(B, dtype=torch.bool, device="cuda"))
        max_abs[v] = max(max_abs[v], twin_and_lifted(new, twin, kernels[v][1], v, 3.0))
    parts_from_shipped(added["k1h_b_llc2"], two_frames, kernels["k1b"][1], "k1h_b_llc2")
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
    max_abs["k2"] = max(max_abs["k2"], raycast_designs_agree(
        engine, card, ray_args, np.random.default_rng(SEED + 22)))

    # ---- phase 3: the main paths through the user entry points
    launches, step_ms = {}, {}
    launches["k1a"], _, _, _, step_ms["k1a"], _ = drive(
        port, engine, card, "Walker3DCustomEnv-v0", 600, "k1a", instance=kernels["k1a"][0].name)
    launches["k1c"], stepper_state, tr, stepper, step_ms["k1c"], _ = drive(
        port, engine, card, "Walker3DStepperEnv-v0", 600, "k1c", instance=kernels["k1c"][0].name)
    print(f"[main] Walker3DStepperEnv-v0: steps_reached mean "
          f"{float(tr.metrics['steps_reached'].mean()):.3f} max "
          f"{float(tr.metrics['steps_reached'].max()):.0f}, stone hits on the last step "
          f"{int(tr.metrics['stone_hit'].sum())}, mean stage "
          f"{float(stepper_state.task.stage.mean()):.4f}")
    launches["k1b"], _, _, _, step_ms["k1b"], _ = drive(
        port, engine, card, "Walker3DPDCustomEnv-v0", 200, "k1b", instance=kernels["k1b"][0].name)
    _, _, _, _, step_ms["k1b_child"], _ = drive(
        port, engine, card, "Child3DPDCustomEnv-v0", 100, "k1b", instance=kernels["k1b"][0].name)
    drive(port, engine, card, "Child3DCustomEnv-v0", 100, "k1a", instance=kernels["k1a"][0].name)
    for v, env_id, steps in (("k1e_cassie", "CassieEnv-v0", 300),
                             ("k1e_cassie2d", "Cassie2DEnv-v0", 100),
                             ("k1e_planar", "Walker2DCustomEnv-v0", 200),
                             ("k1e_crab", "Crab2DCustomEnv-v0", 100)):
        launches[v], state, _, _, step_ms[v], _ = drive(
            port, engine, card, env_id, steps, "k1e",
            instance=kernels["k1e_planar" if v == "k1e_crab" else v][0].name)
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
        port, engine, card, "Monkey3DStepperEnv-v0", 300, "k1d", sums=("fell", "bar_hit"),
        instance=kernels["k1d"][0].name)
    print(f"[main] Monkey3DStepperEnv-v0: bars_reached mean "
          f"{float(tr.metrics['bars_reached'].mean()):.4f} max "
          f"{float(tr.metrics['bars_reached'].max()):.0f}; holding on at the end "
          f"{float((tr.metrics['holding'] > 0).float().mean()):.4f} of the envs, both hands "
          f"{float((tr.metrics['holding'] > 1).float().mean()):.4f}; over the run falls "
          f"{sums['fell']:.0f}, bar hits {sums['bar_hit']:.0f}")
    hang_check(engine, monkey_batch, monkey.constraints(), card, kernels["k1d"][0].name)
    launches["k1f"], terrain_state, _, _, step_ms["k1f"], sums = drive(
        port, engine, card, "Walker3DTerrainEnv-v0", 600, "k1f", sums=("fallen",),
        instance=kernels["k1f"][0].name)
    terrain_readings("Walker3DTerrainEnv-v0", terrain_state, sums)
    _, state, _, _, step_ms["k1f_lidar"], sums = drive(
        port, engine, card, "Walker3DTerrainLidarEnv-v0", 200, "k1f", sums=("fallen",),
        instance=kernels["k1f"][0].name)
    terrain_readings("Walker3DTerrainLidarEnv-v0", state, sums)
    on_stairs = torch.zeros(B, dtype=torch.bool, device="cuda")

    def over_a_tread(tr):
        x, y = tr.state.q[:, 0], tr.state.q[:, 1]
        on_stairs.logical_or_((x >= 0.6) & (x <= 2.7) & (y.abs() <= 2.0))

    launches["k1g"], state, _, _, step_ms["k1g"], sums = drive(
        port, engine, card, "Walker3DStairsEnv-v0", 600, "k1g", sums=("fallen",),
        watch=over_a_tread, instance=kernels["k1g"][0].name)
    stairs_readings(state, sums, on_stairs)
    launches["k1h_si"], state, _, _, step_ms["k1h_si"], sums = drive(
        port, engine, card, "Walker3DCustomEnv-v0", 200, "k1h_si", sums=("fallen",),
        instance=kernels["k1h_si"][0].name, config=EngineConfig(split_impulse=True))
    print(f"[main] Walker3DCustomEnv-v0 with split impulse: falls over the run "
          f"{sums['fallen']:.0f}, base height at the end median {float(state.q[:, 2].median()):.4f}"
          f" m")
    # the stairs, the terrain walkers, the stepper and the PD walkers made
    # with split impulse: K1h-g, K1h-f, K1h-c and K1h-b, each by its
    # warp-per-env instance alone
    on_stairs.zero_()
    for v, env_id, steps in (("k1h_g", "Walker3DStairsEnv-v0", 200),
                             ("k1h_f", "Walker3DTerrainEnv-v0", 200),
                             ("k1h_f_lidar", "Walker3DTerrainLidarEnv-v0", 200),
                             ("k1h_c", "Walker3DStepperEnv-v0", 200),
                             ("k1h_b", "Walker3DPDCustomEnv-v0", 200),
                             ("k1h_b_child", "Child3DPDCustomEnv-v0", 100)):
        variant = v.removesuffix("_lidar").removesuffix("_child")
        _, state, _, _, step_ms[v], sums = drive(
            port, engine, card, env_id, steps, variant, sums=("fallen",),
            watch=over_a_tread if variant == "k1h_g" else None,
            instance=kernels[variant][0].name, config=EngineConfig(split_impulse=True))
        if variant == "k1h_g":
            stairs_readings(state, sums, on_stairs)
        elif variant == "k1h_f":
            terrain_readings(env_id, state, sums)
        else:
            print(f"[main] {env_id} with split impulse: falls over the run "
                  f"{sums['fallen']:.0f}, base height at the end median "
                  f"{float(state.q[:, 2].median()):.4f} m")
    # the monkey made with split impulse: K1h-d by its warp-per-env instance
    # alone, grab signals included in the random actions
    _, state, tr, _, step_ms["k1h_d"], sums = drive(
        port, engine, card, "Monkey3DStepperEnv-v0", 200, "k1h_d", sums=("fell", "bar_hit"),
        instance=kernels["k1h_d"][0].name, config=EngineConfig(split_impulse=True))
    print(f"[main] Monkey3DStepperEnv-v0 with split impulse: holding on at the end "
          f"{float((tr.metrics['holding'] > 0).float().mean()):.4f} of the envs; over the run "
          f"falls {sums['fell']:.0f}, bar hits {sums['bar_hit']:.0f}")
    # the walker made with each PGS option configuration, and the stepper at
    # 2 × 8: its own instance
    for v, fields in OPTION_CONFIGS.items():
        launches[v], _, _, _, step_ms[v], _ = drive(
            port, engine, card, "Walker3DCustomEnv-v0", 100, added[v].variant,
            instance=added[v].name, config=EngineConfig(**fields))
    launches["k1c_sub2_it8"], _, _, _, step_ms["k1c_sub2_it8"], _ = drive(
        port, engine, card, "Walker3DStepperEnv-v0", 100, "k1c",
        instance=added["k1c_sub2_it8"].name, config=EngineConfig(**STEPPER_2X8))
    # the PD walker made with two llc frames per control step, alone and with
    # split impulse, and Cassie with five: the generic warp-per-env instance
    # of each key, one launch per control step
    for v, env_id, steps, base in (("k1b_llc2", "Walker3DPDCustomEnv-v0", 100, "k1b"),
                                   ("k1h_b_llc2", "Walker3DPDCustomEnv-v0", 100, "k1h_b"),
                                   ("k1e_cassie_llc5", "CassieEnv-v0", 200, "k1e_cassie")):
        launches[v], _, _, _, step_ms[v], _ = drive(
            port, engine, card, env_id, steps, added[v].variant, instance=added[v].name,
            config=added[v].config)
        print(f"[main] {env_id} with {added[v].config.llc_frames} llc frames per control step "
              f"({added[v].name}): {step_ms[v]:.3f} ms per control step, beside "
              f"{step_ms[base]:.3f} at its family's shipped llc frames ({base}) in this call, at "
              f"B={B} on {card}")
    small_grid_raises(model, config)
    combination_refused(engine, model, config)
    launches["k2"], ray_main = raycast_main_path(engine, card, rng)

    # ---- phase 3 (training): the PPO trainer's CLI with --split-impulse
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    atexit.register(shutil.rmtree, workdir, True)
    train_lines = {"k1h_c": train_run(engine, card, "Walker3DStepperEnv", 2, 128, workdir,
                                      {"k1h_c": 384}, resume_updates=3,
                                      instance=kernels["k1h_c"][0].name)}
    launches["k1h_c"] = 384
    for v, env_id in (("k1h_e", "CassieEnv"), ("k1h_e2d", "Cassie2DEnv"),
                      ("k1h_d", "Monkey3DStepperEnv")):
        variant = "k1h_e" if v == "k1h_e2d" else v
        train_lines[v] = train_run(engine, card, env_id, 2, 32, workdir, {variant: 64},
                                   instance=kernels[v][0].name)
        launches[v] = 64
    # this slice's split instances: every family trains with --split-impulse
    for env_id, variant in SPLIT_FAMILIES.items():
        short = {"k1h_e": "k1h_e_planar"}.get(variant, variant)
        check(added[short].instance.source == engine.SOURCE_W,
              f"{env_id} training: {variant} is not on its warp-per-env instance")
        lines = train_run(engine, card, env_id, 2, 32, workdir, {variant: 64},
                          instance=added[short].name)
        train_lines.setdefault(short, lines)
        launches[short] = 64

    # ---- phase 3 (pipelines): ALLSTEPS, brachiation and the mixed suite
    pipelines(engine, card, workdir, {v: kernels[v][0].name for v in
                                      ("k1a", "k1c", "k1d", "k1e_cassie")})

    # ---- phase 4: per-call times at B = 4096
    times = {v: time_and_bound(engine, card, kernel, args, matfree.get(v))
             for v, (kernel, args) in kernels.items()}
    design_sweep(engine, card, "K1a", kernels["k1a"][0], k1a_thread,
                 lambda batch, r: near_contact_states(model, r, batch), SWEEP)
    print(f"[sweep] Walker3DCustomEnv-v0 at B={B}: {step_ms['k1a']:.3f} ms per control step on "
          f"{card}")
    for v, label in (("k1e_cassie", "K1e Cassie"), ("k1e_cassie2d", "K1e Cassie2D"),
                     ("k1h_e", "K1h-e Cassie"), ("k1h_e2d", "K1h-e2d Cassie2D")):
        planar = kernels[v][0].constraints.planar
        design_sweep(engine, card, label, kernels[v][0], {**k1e_thread, **k1h_thread}[v],
                     lambda batch, r, p=planar: cassie_states(cmodel, stand, stand_z, r, p, batch),
                     CASSIE_SWEEP)
    design_sweep(engine, card, "K1b", kernels["k1b"][0], k1b_thread,
                 lambda batch, r: pd_target_states(model, r, batch), WALKER_SWEEP)
    design_sweep(engine, card, "K1f", kernels["k1f"][0], k1f_thread,
                 lambda batch, r: terrain_states(model, r, batch), WALKER_SWEEP)
    design_sweep(engine, card, "K1c", kernels["k1c"][0], k1c_thread,
                 lambda batch, r: stepper_states(model, r, config.stone_window, batch),
                 WALKER_SWEEP)
    design_sweep(engine, card, "K1g", kernels["k1g"][0], k1g_thread,
                 lambda batch, r: stairs_states(model, r, batch), WALKER_SWEEP)
    design_sweep(engine, card, "K1h-g", kernels["k1h_g"][0], thread_twins["k1h_g"],
                 lambda batch, r: stairs_states(model, r, batch), WALKER_SWEEP)
    design_sweep(engine, card, "K1h-f", kernels["k1h_f"][0], thread_twins["k1h_f"],
                 lambda batch, r: terrain_states(model, r, batch), WALKER_SWEEP)
    design_sweep(engine, card, "K1h-c", kernels["k1h_c"][0], thread_twins["k1h_c"],
                 lambda batch, r: stepper_states(model, r, config.stone_window, batch),
                 WALKER_SWEEP)
    design_sweep(engine, card, "K1h-b", kernels["k1h_b"][0], thread_twins["k1h_b"],
                 lambda batch, r: pd_target_states(model, r, batch), WALKER_SWEEP)
    design_sweep(engine, card, "K1h-si", kernels["k1h_si"][0], thread_twins["k1h_si"],
                 lambda batch, r: near_contact_states(model, r, batch), WALKER_SWEEP)
    design_sweep(engine, card, "K1d", kernels["k1d"][0], k1d_thread,
                 lambda batch, r: monkey_states(mmodel, r, batch), WALKER_SWEEP)
    design_sweep(engine, card, "K1h-d", kernels["k1h_d"][0], k1h_d_thread,
                 lambda batch, r: monkey_states(mmodel, r, batch), WALKER_SWEEP)
    design_sweep(engine, card, "K1e planar", kernels["k1e_planar"][0], k1e_planar_thread,
                 lambda batch, r: planar_walker_states(wmodel, 1.22, r, batch), WALKER_SWEEP)
    design_sweep(engine, card, "K1h-e planar", kernels["k1h_e_planar"][0],
                 thread_twins["k1h_e_planar"],
                 lambda batch, r: planar_walker_states(wmodel, 1.22, r, batch), WALKER_SWEEP)
    for v, label in (("k1h_si_aform", "K1h A-form"), ("k1a_aform", "K1 A-form"),
                     ("k1a_aform_scalar_cold_refactor", "K1 all off"),
                     ("k1a_scalar", "K1 scalar"), ("k1a_refactor", "K1 refactor"),
                     ("k1a_cold", "K1 cold"), ("k1a_sub2_it8", "K1 walker 2x8")):
        design_sweep(engine, card, label, added[v], thread_twins[v],
                     lambda batch, r: near_contact_states(model, r, batch), WALKER_SWEEP,
                     matfree=matfree.get(v))
    design_sweep(engine, card, "K1 stepper 2x8", added["k1c_sub2_it8"],
                 thread_twins["k1c_sub2_it8"],
                 lambda batch, r: stepper_states(model, r, config.stone_window, batch),
                 WALKER_SWEEP)
    for v, label in (("k1b_llc2", "K1b 2 llc"), ("k1h_b_llc2", "K1h-b 2 llc")):
        design_sweep(engine, card, label, added[v], thread_twins[v],
                     lambda batch, r: pd_target_states(model, r, batch), WALKER_SWEEP)
    design_sweep(engine, card, "K1e Cassie 5 llc", added["k1e_cassie_llc5"],
                 thread_twins["k1e_cassie_llc5"],
                 lambda batch, r: cassie_states(cmodel, stand, stand_z, r, False, batch),
                 CASSIE_SWEEP)
    for v, env_id in (("k1b", "Walker3DPDCustomEnv-v0"), ("k1b_child", "Child3DPDCustomEnv-v0"),
                      ("k1f", "Walker3DTerrainEnv-v0"),
                      ("k1f_lidar", "Walker3DTerrainLidarEnv-v0"),
                      ("k1c", "Walker3DStepperEnv-v0"), ("k1g", "Walker3DStairsEnv-v0")):
        print(f"[sweep] {env_id} at B={B}: {step_ms[v]:.3f} ms per control step on {card}")
    walker_trace(port, card)

    cull_and_pack_time(engine, card, model, config)
    stepper_env_layer_times(card, stepper, stepper_state)
    times["k2"] = raycast_time_and_bound(engine, card, ray_main, max_abs["k2"])
    window_and_pack_time(engine, card, terrain_state)
    for v in ("k1b", "k1b_child", "k1c", "k1e_cassie", "k1e_cassie2d", "k1e_planar", "k1d",
              "k1f", "k1f_lidar", "k1g", "k1h_si", "k1h_g", "k1h_f", "k1h_f_lidar", "k1h_c",
              "k1h_b", "k1h_b_child", "k1h_d", *AFORMS, *MATFREE_OPTIONS, *NEW_WARP,
              *LLC_KEYS):
        kernel_ms = times[v.removesuffix("_lidar").removesuffix("_child")]["ms"]
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
             "k1h_d": "k1h_engine_frame_bars_grabs_split_impulse",
             "k1h_b": "k1h_engine_step_pd_split_impulse",
             "k1h_e_planar": "k1h_engine_frame_planar_split_impulse",
             "k1h_f": "k1h_engine_frame_heightfield_split_impulse",
             "k1h_g": "k1h_engine_frame_trimesh_split_impulse",
             "k1a_aform": "k1a_engine_frame_aform_pgs",
             "k1a_scalar": "k1a_engine_frame_scalar_friction",
             "k1a_cold": "k1a_engine_frame_cold_start",
             "k1a_refactor": "k1a_engine_frame_factor_every_substep",
             "k1a_aform_scalar_cold_refactor": "k1a_engine_frame_all_options_off",
             "k1h_si_aform": "k1h_engine_frame_split_impulse_aform_pgs",
             "k1a_sub2_it8": "k1a_engine_frame_sub2_it8",
             "k1c_sub2_it8": "k1c_engine_frame_stones_sub2_it8",
             "k1b_llc2": "k1b_engine_step_pd_llc2",
             "k1h_b_llc2": "k1h_engine_step_pd_split_impulse_llc2",
             "k1e_cassie_llc5": "k1e_engine_step_pd_rods_llc5", "k2": "k2_raycast"}
    print(json.dumps({"kernels": [{
        "name": names[v],
        "route": "cuda",
        "source": RAYCAST_SOURCE if v == "k2" else SOURCE_W
        if kernels[v][0].instance.source == engine.SOURCE_W else SOURCE,
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
