"""K1: the fused engine kernel on Hopper, its wrappers and its plain version.

Counterpart of ``mocca_envs_tpu/ops/pallas/engine.py::make_pallas_substep``
for floating all-revolute models, in eight variants: K1a (plane, torque
mode), K1c (K1a plus ``stone_window`` oriented stone boxes), K1b (PD mode:
the whole control step, joint targets in the ``tau`` input), K1e (the
equality rows of a ``ConstraintSpec`` in front of the others: point-to-point
rods and the planar base lock, in torque or PD mode), K1d (bar capsules and
the maskable grab rows, torque mode), K1f (K1a plus a per-env ``HF_PATCH ×
HF_PATCH`` heightfield window), K1g (K1a plus ``tri_window`` triangle-mesh
faces) and K1h (``split_impulse``: the bias split and the position pass) on
each of them (K1hSi on the walker's plane), each under any ``EngineConfig``:
the PGS options ``matfree_pgs`` (else the A-form), ``block_pgs`` (else
scalar friction rows), ``warm_start`` and ``reuse_factor``, any substeps and
sweeps. The kernel is CUDA C++ in two sources: ``csrc/engine_k1w.cu``, one
warp per env (W and the factor in shared memory, inactive rows skipped),
which the keys of :data:`WARP_INSTANCES` run (K1a, the walker's and the
child's; K1b, the PD walker's and the PD child's; K1f, the terrain
walkers'; K1c, the stepper's; K1g, the stairs'; K1e, Cassie's, Cassie2D's
and the planar walkers'; K1d, the monkey's; the split twins K1h-e,
K1h-e2d, K1h-g, K1h-f, K1h-c, K1h-b, K1h-si, the walker's on the plane,
K1h-d, the monkey's, and the planar K1h-e, the planar walkers'; the
walker's split key in the A-form; the walker's key in the A-form, alone
and with the other three PGS options off; and the walker's key with scalar
friction rows, with a factor in every substep and with a cold start), and
any other key it holds (:func:`warp_holds`: PD at several llc frames per
launch too, and models past 32 velocity DOFs, a lane holding ⌈NV / 32⌉ of
them) on a generic warp-per-env instance; and ``csrc/engine_k1.cu``, one
thread per env, for the keys it cannot hold (a torque key of several llc
frames, or one whose env fits no SM's shared memory), and as the
thread-per-env twin of every key. Any scene combination the TPU
kernel composes (several geometries in one instance, PD mode, equality rows
or extra damping beside any of them) is a key of both sources, wrapped by
:class:`K1x` where no shipped family runs it. An
instance is picked by its :class:`Key` (:func:`instance_for`): the named
warp-per-env one where there is one, else the generic warp-per-env one
where the source holds the key, whose name, template arguments and launch
shape come from ``-DK1W_*`` preprocessor flags (:func:`warp_instance`,
:func:`compile_flags`; as many envs per block as an SM's shared memory
holds, one block per SM), else the fifteen
``engine_k1.cu`` names (:data:`INSTANTIATIONS`, the shipped families at the
shipped options), else the generic ``engine_k1.cu`` instance
(:func:`canonical_symbol`, ``-DK1_*`` flags). The thread-per-env instances
of the warp keys stay built; only ``thread_per_env=True`` reaches them, to
compare the two designs. :func:`build` compiles them with ``nvcc`` for
``sm_90a`` into ``build/``, one compiler process per instance, all started
together (with the raycast kernel K2 of ``csrc/raycast_k2.cu``, whose
wrapper is ``ops/raycast.py``), each library named by its symbol and its
flags; a generic instance is built at the first launch of its key. They
are called through a plain C interface with ``ctypes``.

- :class:`K1a`, :class:`K1c`, :class:`K1b`, :class:`K1e`, :class:`K1d`,
  :class:`K1f`, :class:`K1g`, :class:`K1hSi` wrap one (model, config):
  ``launch`` launches the kernel on CUDA tensors and raises on anything
  else. The choice by device is made once, in
  ``ops/step.py::_make_llc_unit``; there is no fallback from one path to
  the other.
- ``plain`` is the plain PyTorch version: the port's ``ops/step.py`` path
  run for the same unit, on any device.
- ``LAUNCHES["k1a" | "k1b" | "k1c" | "k1e" | "k1d" | "k1f" | "k1g" |
  "k1h_si" | "k1h_c" | "k1h_b" | "k1h_e" | "k1h_d" | "k1h_f" | "k1h_g" |
  "k2" | "k2_thread"]`` counts kernel launches (plain runs do not count;
  ``k2_thread`` is K2's one-thread-per-ray twin); a split-impulse
  instance counts under its own name, and each PGS option turned off adds
  its tag (``k1a_aform``, ``k1h_si_aform``, ``k1a_scalar``, ``k1a_cold``,
  ``k1a_refactor``, ...); a :class:`K1x` combination counts under
  ``k1_`` (``k1h_`` with split impulse) and its :func:`scene_tags`
  (``k1_llc1_kt16``, ``k1_k6_kt16``, ``k1_damped`` for extra damping in
  torque mode, ...). ``INSTANCE_LAUNCHES[symbol]`` counts the same K1
  launches by the instance that ran, which tells apart keys that share a
  name (the walker at 2 substeps × 8 sweeps counts as ``k1a`` there).
- While a ``torch.profiler`` records (``harness/profile.py::tracing``), a
  warp-per-env instance launches its clocked kernel, ``k1w_kernel<C,
  true>`` (``<symbol>_launch_phases``): the same outputs, counted as the
  shipped launch, with each env's ``clock64()`` cycles and visits per phase
  of :data:`PHASES` added into a buffer kept on the card per instance and
  batch (:func:`phase_clocks`); :func:`k1_phases` sums them.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from mocca_envs_tpu_torch.harness.profile import tracing
from mocca_envs_tpu_torch.models.schema import REVOLUTE, RobotModel
from mocca_envs_tpu_torch.ops.collide import sphere_centers
from mocca_envs_tpu_torch.ops.integrate import LIMIT_SLOP, MAX_VEL
from mocca_envs_tpu_torch.ops.kinematics import forward_kinematics, joint_q
from mocca_envs_tpu_torch.ops.step import (
    ConstraintSpec, limited_joints, make_plain_llc, make_substep)
from mocca_envs_tpu_torch.terrain.scene import BAR_FIELDS, STONE_FIELDS, TRI_FIELDS, Scene
from mocca_envs_tpu_torch.utils.config import EngineConfig

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "engine_k1.cu"
SOURCE_W = SOURCE.with_name("engine_k1w.cu")        # the warp-per-env instances
HEADER = SOURCE.with_name("k1_common.cuh")          # included by both
RAYCAST_SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "raycast_k2.cu"
RAYCAST_SYMBOL = "k2_raycast"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
STONE_FLOATS = 11   # center (3), quaternion (4), half extents (3), active (1)
BAR_FLOATS = 8      # end a (3), end b (3), radius (1), active (1)
GRAB_FLOATS = 4     # active (1), target (3)
HF_META = 3         # behind a heightfield window's P·P heights: x0, y0, cell
TRI_FLOATS = 10     # vertices a, b, c (3 each), active (1)


@dataclasses.dataclass(frozen=True)
class Key:
    """What picks a K1 instance: the model's sizes, the solver's substeps and
    sweeps, the scene's windows, the actuation, the equality rows, split
    impulse and the four PGS options. Torque mode launches once per llc
    frame (``llc == 1``)."""

    nl: int
    ns: int
    nlim: int
    substeps: int
    iters: int
    stones: int = 0
    pd: bool = False
    llc: int = 1            # llc frames per launch (PD mode)
    rods: int = 0
    planar: bool = False
    bars: int = 0
    grabs: int = 0
    hf: int = 0             # heightfield window side
    tris: int = 0           # mesh face window
    split: bool = False
    matfree: bool = True    # matfree_pgs (else the A-form)
    block: bool = True      # block_pgs (else scalar friction rows)
    warm: bool = True       # warm_start (else λ from zero every substep)
    reuse: bool = True      # reuse_factor (else a factor every substep)


@dataclasses.dataclass(frozen=True)
class Instance:
    """One instantiation of a kernel template in ``source``: one of the
    fifteen ``engine_k1.cu`` names (``index`` is its K1_ONLY number), one of
    the warp-per-env instances of ``engine_k1w.cu`` (``index`` is its
    K1W_ONLY number) or, for any other key, a generic one (``index`` None)
    built from ``compile_flags``: of ``engine_k1w.cu`` where that source
    holds the key (:func:`warp_holds`; ``envs`` envs per block, registers
    for ``blocks`` blocks per SM), else of ``engine_k1.cu``."""

    symbol: str   # C symbol prefix
    index: int | None
    key: Key
    source: Path = SOURCE
    envs: int = 0
    blocks: int = 0


_W = dict(nl=22, ns=14, nlim=21, substeps=4, iters=4)         # Walker3D / Child3D
_C = dict(nl=17, ns=5, nlim=16, substeps=2, iters=4, pd=True, llc=10, rods=2)   # Cassie
_M = dict(nl=11, ns=5, nlim=8, substeps=4, iters=4, bars=16, grabs=2)           # Monkey3D
# the fifteen instances the source names, at the shipped solver options
INSTANTIATIONS = {inst.key: inst for inst in (
    Instance("k1a_nl22_ns14_nlim21_sub4_it4", 0, Key(**_W)),
    Instance("k1c_nl22_ns14_nlim21_sub4_it4_k6", 1, Key(**_W, stones=6)),
    Instance("k1b_nl22_ns14_nlim21_sub4_it4_llc1", 2, Key(**_W, pd=True)),
    Instance("k1b_nl22_ns14_nlim21_sub4_it4_llc2", 3, Key(**_W, pd=True, llc=2)),
    # Cassie and Cassie2D: the whole control step, 10 llc frames × 2 substeps
    Instance("k1e_nl17_ns5_nlim16_sub2_it4_llc10_p2p2", 4, Key(**_C)),
    Instance("k1e_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_planar", 5, Key(**_C, planar=True)),
    # Walker2D and Crab2D
    Instance("k1e_nl7_ns5_nlim6_sub4_it4_planar", 6,
             Key(nl=7, ns=5, nlim=6, substeps=4, iters=4, planar=True)),
    # Monkey3D: 16 bars, two grabs
    Instance("k1d_nl11_ns5_nlim8_sub4_it4_kb16_ng2", 7, Key(**_M)),
    # Walker3D over a 16 × 16 heightfield window (the terrain families)
    Instance("k1f_nl22_ns14_nlim21_sub4_it4_hf16", 8, Key(**_W, hf=16)),
    # Walker3D over 16 culled mesh faces (the stairs)
    Instance("k1g_nl22_ns14_nlim21_sub4_it4_kt16", 9, Key(**_W, tris=16)),
    # split impulse: the walker on the plane, the stepper, Cassie, Cassie2D,
    # the monkey
    Instance("k1h_nl22_ns14_nlim21_sub4_it4_si", 10, Key(**_W, split=True)),
    Instance("k1h_nl22_ns14_nlim21_sub4_it4_k6_si", 11, Key(**_W, stones=6, split=True)),
    Instance("k1h_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_si", 12, Key(**_C, split=True)),
    Instance("k1h_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_planar_si", 13,
             Key(**_C, planar=True, split=True)),
    Instance("k1h_nl11_ns5_nlim8_sub4_it4_kb16_ng2_si", 14, Key(**_M, split=True)),
)}
# the keys the warp-per-env source runs, at the shipped options: K1a, the
# walker and the child on the plane in torque mode; K1e, Cassie's and
# Cassie2D's whole PD control step with the rods (and the planar lock); K1b,
# the PD walker's and the PD child's control step (one llc frame); K1f, the
# walker over a 16 × 16 heightfield window (the terrain families); K1c, the
# walker over the stepper's 6 culled stones; K1g, the walker over the
# stairs' 16 culled mesh faces; K1h-e and K1h-e2d, Cassie's and Cassie2D's
# control step with split impulse; K1h-g and K1h-f, the stairs' and the
# terrain walkers' frame with split impulse; K1h-c and K1h-b, the stepper's
# frame and the PD walkers' control step with split impulse (their
# thread-per-env twins: the named k1h_..._k6_si and the generic
# k1_..._llc1_si; K1b at two llc frames, split or not, and Cassie at other
# llc counts run the generic warp-per-env instance of their keys);
# K1h-si, the walker's frame on the plane with split impulse, and K1d, the
# monkey's frame over its 16 bars with its two grab rows (their twins: the
# named k1h_..._si and k1d_..._kb16_ng2); K1h-d, the monkey's frame with
# split impulse, and K1e planar, Walker2D's and Crab2D's torque frame with
# the planar lock (their twins: the named k1h_..._kb16_ng2_si and
# k1e_nl7_..._planar); the planar K1h-e, Walker2D's and Crab2D's frame with
# split impulse (32 envs in one block of 1,024 threads, as the planar K1e),
# and the walker's frame with split impulse in the A-form (matfree_pgs
# off: A over the active rows, packed lower, in the env's shared memory,
# 11 envs in one block per SM) (their twins: the generic
# k1_nl7_..._planar_si and k1_nl22_..._si_aform); the walker's frame in the
# A-form, and with all four PGS options off (scalar friction rows, λ from
# zero and a factor in every substep), each the split A-form's shape
# (their twins: the generic k1_nl22_..._aform and
# k1_nl22_..._aform_scalar_cold_refactor); the walker's frame with scalar
# friction rows (block_pgs off: a contact's t1 then t2 row, each clamped
# alone, a butterfly each) and with a factor in every substep (reuse_factor
# off), each K1a's shape (their twins: the generic k1_nl22_..._scalar and
# k1_nl22_..._refactor); and the walker's frame with a cold start (warm_start
# off: λ from zero in every substep), K1a's Cfg with WARM false (its twin:
# the generic k1_nl22_..._cold). Any other key the source holds runs its
# generic warp-per-env instance (warp_instance), built at its first launch
WARP_INSTANCES = {inst.key: inst for inst in (
    Instance("k1w_nl22_ns14_nlim21_sub4_it4", 0, Key(**_W), SOURCE_W),
    Instance("k1w_nl17_ns5_nlim16_sub2_it4_llc10_p2p2", 1, Key(**_C), SOURCE_W),
    Instance("k1w_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_planar", 2, Key(**_C, planar=True),
             SOURCE_W),
    Instance("k1w_nl22_ns14_nlim21_sub4_it4_llc1", 3, Key(**_W, pd=True), SOURCE_W),
    Instance("k1w_nl22_ns14_nlim21_sub4_it4_hf16", 4, Key(**_W, hf=16), SOURCE_W),
    Instance("k1w_nl22_ns14_nlim21_sub4_it4_k6", 5, Key(**_W, stones=6), SOURCE_W),
    Instance("k1w_nl22_ns14_nlim21_sub4_it4_kt16", 6, Key(**_W, tris=16), SOURCE_W),
    Instance("k1w_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_si", 7, Key(**_C, split=True), SOURCE_W),
    Instance("k1w_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_planar_si", 8,
             Key(**_C, planar=True, split=True), SOURCE_W),
    Instance("k1w_nl22_ns14_nlim21_sub4_it4_kt16_si", 9, Key(**_W, tris=16, split=True),
             SOURCE_W),
    Instance("k1w_nl22_ns14_nlim21_sub4_it4_hf16_si", 10, Key(**_W, hf=16, split=True),
             SOURCE_W),
    Instance("k1w_nl22_ns14_nlim21_sub4_it4_k6_si", 11, Key(**_W, stones=6, split=True),
             SOURCE_W),
    Instance("k1w_nl22_ns14_nlim21_sub4_it4_llc1_si", 12, Key(**_W, pd=True, split=True),
             SOURCE_W),
    Instance("k1w_nl22_ns14_nlim21_sub4_it4_si", 13, Key(**_W, split=True), SOURCE_W),
    Instance("k1w_nl11_ns5_nlim8_sub4_it4_kb16_ng2", 14, Key(**_M), SOURCE_W),
    Instance("k1w_nl11_ns5_nlim8_sub4_it4_kb16_ng2_si", 15, Key(**_M, split=True), SOURCE_W),
    Instance("k1w_nl7_ns5_nlim6_sub4_it4_planar", 16,
             Key(nl=7, ns=5, nlim=6, substeps=4, iters=4, planar=True), SOURCE_W),
    Instance("k1w_nl7_ns5_nlim6_sub4_it4_planar_si", 17,
             Key(nl=7, ns=5, nlim=6, substeps=4, iters=4, planar=True, split=True), SOURCE_W),
    Instance("k1w_nl22_ns14_nlim21_sub4_it4_si_aform", 18, Key(**_W, split=True, matfree=False),
             SOURCE_W),
    Instance("k1w_nl22_ns14_nlim21_sub4_it4_aform", 19, Key(**_W, matfree=False), SOURCE_W),
    Instance("k1w_nl22_ns14_nlim21_sub4_it4_aform_scalar_cold_refactor", 20,
             Key(**_W, matfree=False, block=False, warm=False, reuse=False), SOURCE_W),
    Instance("k1w_nl22_ns14_nlim21_sub4_it4_scalar", 21, Key(**_W, block=False), SOURCE_W),
    Instance("k1w_nl22_ns14_nlim21_sub4_it4_refactor", 22, Key(**_W, reuse=False), SOURCE_W),
    Instance("k1w_nl22_ns14_nlim21_sub4_it4_cold", 23, Key(**_W, warm=False), SOURCE_W),
)}


def scene_tags(key: Key) -> list:
    """The tags of what ``key`` composes beside the model and the solver: its
    stones, actuation (PD: its llc frames), rods, planar lock, bars, grabs,
    heightfield window and mesh faces, in :func:`canonical_symbol`'s order."""
    return [tag for on, tag in (
        (key.stones, f"k{key.stones}"), (key.pd, f"llc{key.llc}"), (key.rods, f"p2p{key.rods}"),
        (key.planar, "planar"), (key.bars, f"kb{key.bars}"), (key.grabs, f"ng{key.grabs}"),
        (key.hf, f"hf{key.hf}"), (key.tris, f"kt{key.tris}")) if on]


def canonical_symbol(key: Key) -> str:
    """The C symbol prefix of the generic instance for ``key``."""
    parts = [f"k1_nl{key.nl}_ns{key.ns}_nlim{key.nlim}_sub{key.substeps}_it{key.iters}",
             *scene_tags(key)]
    for on, tag in ((key.split, "si"), (not key.matfree, "aform"), (not key.block, "scalar"),
                    (not key.warm, "cold"), (not key.reuse, "refactor")):
        if on:
            parts.append(tag)
    return "_".join(parts)


# the shared memory of the cards the sm_90a build runs on (compute
# capability 9.0: H100, H200, GH200), in bytes: per SM, per block (opt-in)
# and the reserve the runtime keeps per resident block
SM90_SMEM = {"per_sm": 233472, "per_block": 232448, "reserved_per_block": 1024}
WARP_MAX_ENVS = 32   # a block of 1,024 threads


def warp_holds(key: Key) -> bool:
    """Whether ``csrc/engine_k1w.cu`` holds ``key``, from the key alone: PD
    mode or one llc frame per launch (the source runs a PD key's llc frames
    in one call, the torque refreshed at each frame's start; torque mode
    launches once per frame), and one env beside the block's model table in
    an SM's shared memory (:func:`warp_shape` gives at least one env per
    block). Any model size is held: past 32 velocity DOFs a lane holds
    ⌈NV / 32⌉ of them. Any mix of stones, a heightfield window, mesh faces
    and bars is held too (:func:`warp_env_bytes` counts each one's
    state)."""
    return (key.pd or key.llc == 1) and warp_shape(key)[0] >= 1


def table_floats(key: Key) -> int:
    """Floats of the packed model table of ``key`` (``Layout::SIZE`` in
    ``csrc/k1_common.cuh``)."""
    nl, nj, ns = key.nl, key.nl - 1, key.ns
    return (12 + nl + nj * 10 + nl * 13 + ns * 5 + nj * 7 + key.nlim + nl * nj
            + 8 * key.rods + 4 * key.grabs + (ns if key.bars else 0))


def warp_env_bytes(key: Key) -> int:
    """Bytes of one env's state in ``csrc/engine_k1w.cu`` (``sizeof(EnvW)``
    of the key's ``Cfg``), counted from its members in their order: the
    non-empty bases, then the members and the union of W with the scratch
    written before it. All are 4-byte floats and ints but the heightfield
    window's pointer, which aligns its base and the whole to 8 bytes. The
    source exports the same number (``<sym>_env_bytes``); :func:`build`
    holds every warp-per-env library to it."""
    nl, nj, ns, nlim = key.nl, key.nl - 1, key.ns, key.nlim
    nv, nq = nj + 6, nj + 7
    ne0 = 3 * key.rods + (3 if key.planar else 0)
    nr = ne0 + 3 * key.grabs + nlim + 3 * ns
    general = key.hf or key.stones or key.tris or key.bars
    kin = 10 * nl + nv                     # quaternions, ω, COMs, the bias
    kin_in_w = ne0 > 0
    before_hf = 4 * ((nj if key.pd else 0) + 6 * key.rods + (3 * ns if general else 0))
    size = (before_hf + 7) // 8 * 8 + 24 if key.hf else before_hf
    size += 4 * (11 * key.stones + 10 * key.tris + (2 * (nlim + ns) if key.split else 0)
                 + 8 * key.bars + 7 * key.grabs
                 + (0 if key.matfree else nr * (nr + 1) // 2) + (0 if kin_in_w else kin))
    members = (nq + nv + nj + 2 + 3 * nl + 3 * nj + 4 * ns + nv + nv * (nv + 1) // 2 + nv
               + 5 * nr + 3 * ns)
    scratch = max(ns * (3 + key.bars) if key.bars else 0, 12 * nl, 13 * nl)
    w = max(nr * (nv | 1), (kin if kin_in_w else 0) + scratch)
    size += 4 * (members + w)
    return (size + 7) // 8 * 8 if key.hf else size


def warp_shape(key: Key) -> tuple[int, int]:
    """The launch shape of the generic warp-per-env instance of ``key``:
    (envs per block, blocks per SM). As many envs per block as one SM's
    shared memory holds beside the block's model table, less the runtime's
    reserve, at most 32; one block per SM, so that the registers may take
    up to 65,536 / (32 · envs). 0 envs where not one env fits: such a key
    runs its ``engine_k1.cu`` instance (:func:`warp_holds`,
    :func:`instance_for`), and :func:`build` refuses a warp-per-env instance
    asked for at that shape, naming the key and the bytes."""
    table = ((table_floats(key) + key.nl) * 4 + 15) // 16 * 16
    room = min(SM90_SMEM["per_sm"] - SM90_SMEM["reserved_per_block"],
               SM90_SMEM["per_block"]) - table
    return max(0, min(WARP_MAX_ENVS, room // warp_env_bytes(key))), 1


def warp_instance(key: Key, envs: int | None = None, blocks: int | None = None) -> Instance:
    """The generic warp-per-env instance of ``key`` at the launch shape of
    :func:`warp_shape` (or at ``envs`` × ``blocks``): its symbol is ``k1w``,
    :func:`canonical_symbol`'s tags, then the shape, so that it never
    collides with the ``engine_k1.cu`` twin of its key."""
    if envs is None or blocks is None:
        envs, blocks = warp_shape(key)
    symbol = "k1w" + canonical_symbol(key).removeprefix("k1") + f"_{envs}x{blocks}"
    return Instance(symbol, None, key, SOURCE_W, envs, blocks)


def instance_for(key: Key, thread_per_env: bool = False) -> Instance:
    """The instance that runs ``key``, in this order: its named warp-per-env
    instance; else, where ``csrc/engine_k1w.cu`` holds the key
    (:func:`warp_holds`, a rule on the key alone: PD mode or one llc frame,
    and one env fits an SM), the generic warp-per-env one
    (:func:`warp_instance`); else its named ``engine_k1.cu`` instance; else
    the generic ``engine_k1.cu`` one (a key whose env fits no SM runs there
    rather than raise). ``thread_per_env`` skips the first two: the named
    ``engine_k1.cu`` instance, or the generic one. A build or launch failure
    of the instance picked raises; nothing falls back."""
    if not thread_per_env:
        if key in WARP_INSTANCES:
            return WARP_INSTANCES[key]
        if warp_holds(key):
            return warp_instance(key)
    return INSTANTIATIONS.get(key) or Instance(canonical_symbol(key), None, key)


def compile_flags(inst: Instance) -> list:
    """The preprocessor flags that select ``inst`` from the source, for nvcc
    and for the host check alike: ``K1W_ONLY`` for a named warp-per-env
    instance, ``K1_ONLY`` for a named one, else the generic instance's name,
    template arguments and (one warp per env) launch shape, as
    ``-DK1W_*`` or ``-DK1_*``."""
    if inst.index is not None:
        return [f"-DK1W_ONLY={inst.index}" if inst.source == SOURCE_W
                else f"-DK1_ONLY={inst.index}"]
    k = inst.key
    b = lambda x: "true" if x else "false"  # noqa: E731
    values = {"NAME": inst.symbol, "NL": k.nl, "NS": k.ns, "NLIM": k.nlim, "NSUB": k.substeps,
              "ITERS": k.iters, "K": k.stones, "PD": b(k.pd), "NLLC": k.llc, "NP2P": k.rods,
              "PLANAR": b(k.planar), "KB": k.bars, "NGRAB": k.grabs, "PHF": k.hf, "KT": k.tris,
              "SPLIT": b(k.split), "MATFREE": b(k.matfree), "BLOCK": b(k.block),
              "WARM": b(k.warm), "REUSE": b(k.reuse)}
    if inst.source == SOURCE_W:
        values.update(ENVS=inst.envs, BLOCKS=inst.blocks)
        return [f"-DK1W_{name}={v}" for name, v in values.items()]
    return [f"-DK1_{name}={v}" for name, v in values.items()]


LAUNCHES: collections.Counter = collections.Counter()
# the same K1 launches by the instance that ran (its symbol)
INSTANCE_LAUNCHES: collections.Counter = collections.Counter()
# the phases of the clocked warp-per-env kernel (csrc/engine_k1w.cu's Phase,
# in its order), and its buffers: per (symbol, batch, device) the
# (B, len(PHASES), 2) int64 cycles and visits of every env, on the card
PHASES = ("io", "fk", "narrowphase", "bias", "factor", "rows", "pgs", "integrate")
PHASE_CLOCKS: dict = {}
# the tag of each PGS option in a count's name, where the config turns it off
OPTION_TAGS = {"matfree_pgs": "aform", "block_pgs": "scalar", "warm_start": "cold",
               "reuse_factor": "refactor"}

_P = ctypes.c_void_p
_I = ctypes.c_int


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, /usr/local/cuda, or PATH."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the K1 kernel needs the CUDA toolkit")
    return found


class _Library:
    """The built shared libraries (one per instance, and K2's), loaded once
    per process, and nvcc's register / spill report of each."""

    handles: dict = {}
    logs: dict = {}


def library_path(symbol: str, flags) -> Path:
    """Where the library of ``symbol`` built with the preprocessor ``flags``
    lies in ``build/``: named by the symbol and a hash of nvcc's flags and
    these, so that a library built with other flags (another launch shape,
    other template arguments) is never taken for it."""
    digest = hashlib.sha256(" ".join([*NVCC_FLAGS, *flags]).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{symbol}-{digest}.so"


def build(instances=()) -> dict:
    """Compile the warp-per-env instances of ``csrc/engine_k1w.cu``, the
    fifteen named instances of ``csrc/engine_k1.cu``, each of ``instances``
    (a generic one of either source included) and the raycast kernel of
    ``csrc/raycast_k2.cu`` whose library (:func:`library_path`) is missing
    or older than its sources, all compilers started together, and load
    them: ``{symbol: CDLL}``. What is loaded already is kept; a failed
    build raises with nvcc's output, and so does a generic warp-per-env
    instance that holds no whole env in an SM's shared memory (one asked
    for at an explicit shape: :func:`instance_for` sends such a key to
    ``engine_k1.cu``), or a warp-per-env library that counts another env
    size than :func:`warp_env_bytes`;
    ``_Library.logs`` keeps nvcc's report per symbol."""
    insts = {i.symbol: i for i in [*WARP_INSTANCES.values(), *INSTANTIATIONS.values(),
                                   *instances]}
    if all(sym in _Library.handles for sym in [*insts, RAYCAST_SYMBOL]):
        return _Library.handles
    for inst in insts.values():
        if inst.source == SOURCE_W and inst.index is None and inst.envs < 1:
            raise RuntimeError(
                f"{inst.key}: one env's state takes {warp_env_bytes(inst.key)} bytes of shared "
                f"memory "
                f"beside a model table of {table_floats(inst.key) * 4} bytes; an SM holds "
                f"{SM90_SMEM['per_sm'] - SM90_SMEM['reserved_per_block']} bytes for a block")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = [(sym, inst.source, compile_flags(inst)) for sym, inst in insts.items()
            if sym not in _Library.handles]
    if RAYCAST_SYMBOL not in _Library.handles:
        jobs.append((RAYCAST_SYMBOL, RAYCAST_SOURCE, []))
    running = []
    for symbol, source, flags in jobs:
        lib = library_path(symbol, flags)
        newest = max(p.stat().st_mtime for p in (source, HEADER))
        if lib.exists() and lib.stat().st_mtime >= newest:
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", tmp, str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((symbol, lib, tmp, proc))
    failed = []
    for symbol, lib, tmp, proc in running:
        log = proc.communicate()[0]
        _Library.logs[symbol] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{symbol}: nvcc failed ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    for symbol, _, flags in jobs:
        lib = ctypes.CDLL(str(library_path(symbol, flags)))
        if symbol == RAYCAST_SYMBOL:
            fn = raycast_signatures(lib)
        else:
            getattr(lib, symbol + "_layout").argtypes = [ctypes.POINTER(_I), ctypes.POINTER(_I)]
            getattr(lib, symbol + "_layout").restype = _I
            fn = getattr(lib, symbol + "_launch")
            fn.argtypes = [_P] * 15 + [_I, _P, _I, _P]
            if insts[symbol].source == SOURCE_W:
                getattr(lib, symbol + "_occupancy").argtypes = [ctypes.POINTER(_I)] * 3
                getattr(lib, symbol + "_occupancy").restype = _I
                getattr(lib, symbol + "_env_bytes").restype = _I
                got, want = getattr(lib, symbol + "_env_bytes")(), warp_env_bytes(insts[symbol].key)
                if got != want:
                    raise RuntimeError(f"{symbol}: the source's env takes {got} bytes, the host "
                                       f"counts {want} (warp_env_bytes)")
                clocked = getattr(lib, symbol + "_launch_phases")
                clocked.argtypes = [*fn.argtypes, _P]
                clocked.restype = _I
        fn.restype = _I
        _Library.handles[symbol] = lib
    return _Library.handles


def phase_clocks(symbol: str, B: int, device) -> torch.Tensor:
    """The clocked launches' buffer of ``symbol`` at batch ``B`` on
    ``device`` (:data:`PHASE_CLOCKS`), zeroed once where it is first asked
    for and kept: each clocked launch adds into it."""
    key = (symbol, B, torch.device(device))
    if key not in PHASE_CLOCKS:
        PHASE_CLOCKS[key] = torch.zeros((B, len(PHASES), 2), dtype=torch.int64, device=device)
    return PHASE_CLOCKS[key]


def k1_phases() -> dict:
    """The clocked K1 launches' totals so far, over every env and batch of
    each instance: ``{symbol: {phase: (cycles, visits)}}``, empty where no
    launch was clocked. Synchronises with the card: read it after a stretch
    of steps, not inside one."""
    out: dict = {}
    for (symbol, _, _), buf in PHASE_CLOCKS.items():
        have = out.setdefault(symbol, dict.fromkeys(PHASES, (0, 0)))
        for phase, (cycles, visits) in zip(PHASES, buf.sum(dim=0).tolist()):
            have[phase] = (have[phase][0] + cycles, have[phase][1] + visits)
    return out


def raycast_signatures(lib):
    """Give K2's library (``csrc/raycast_k2.cu``, built with any ``-DK2_*``
    flags) its argument types: the two launches (the cooperative march
    ``k2_raycast_launch`` and its one-thread-per-ray twin
    ``k2_raycast_thread_launch``), the grid placement by size, the lanes per
    ray and the launch's occupancy. Returns the cooperative launch."""
    # origins, directions, grid, H, W, xy0, cell, max_t, dt, steps, t out,
    # h out, B, stream
    launch = [_P, _P, _P, _I, _I, _P, _P, ctypes.c_float, ctypes.c_float, _I, _P, _P, _I, _P]
    for name in ("_launch", "_thread_launch"):
        getattr(lib, RAYCAST_SYMBOL + name).argtypes = launch
        getattr(lib, RAYCAST_SYMBOL + name).restype = _I
    getattr(lib, RAYCAST_SYMBOL + "_placement").argtypes = [_I, _I]
    getattr(lib, RAYCAST_SYMBOL + "_occupancy").argtypes = [_I, _I] + [ctypes.POINTER(_I)] * 3
    for name in ("_placement", "_group", "_occupancy"):
        getattr(lib, RAYCAST_SYMBOL + name).restype = _I
    return getattr(lib, RAYCAST_SYMBOL + "_launch")


def raycast_occupancy(lib, hf_shape: tuple) -> dict:
    """K2's cooperative march on the current card for grids of ``hf_shape``:
    lanes per ray, the grid's placement (``staged`` in each block's shared
    memory, else read through L1), blocks resident per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), threads and dynamic
    shared memory per block."""
    H, W = hf_shape
    blocks, threads, smem = _I(), _I(), _I()
    err = getattr(lib, RAYCAST_SYMBOL + "_occupancy")(H, W, ctypes.byref(blocks),
                                                      ctypes.byref(threads), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"k2: occupancy query failed: cudaError {err}")
    return {"group": getattr(lib, RAYCAST_SYMBOL + "_group")(),
            "staged": bool(getattr(lib, RAYCAST_SYMBOL + "_placement")(H, W)),
            "blocks_per_sm": blocks.value, "threads": threads.value, "smem_per_block": smem.value}


def layout(lib, name: str) -> tuple[int, int]:
    """(table floats, workspace floats per env) of one instantiation."""
    table, ws = _I(), _I()
    getattr(lib, name + "_layout")(ctypes.byref(table), ctypes.byref(ws))
    return table.value, ws.value


def occupancy(lib, name: str) -> dict:
    """A warp-per-env instance on the current card: blocks resident per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), envs per block and
    dynamic shared memory per block in bytes."""
    blocks, envs, smem = _I(), _I(), _I()
    err = getattr(lib, name + "_occupancy")(ctypes.byref(blocks), ctypes.byref(envs),
                                            ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"{name}: occupancy query failed: cudaError {err}")
    return {"blocks_per_sm": blocks.value, "envs_per_block": envs.value,
            "envs_per_sm": blocks.value * envs.value, "smem_per_block": smem.value}


def smem_limits(lib) -> dict:
    """The current card's shared memory in bytes, read through a
    warp-per-env instance's library (``cudaDeviceGetAttribute``): per SM, per
    block (opt-in) and the reserve the runtime keeps per resident block."""
    per_sm, per_block, reserved = _I(), _I(), _I()
    lib.k1w_smem_limits.argtypes = [ctypes.POINTER(_I)] * 3
    lib.k1w_smem_limits.restype = _I
    err = lib.k1w_smem_limits(ctypes.byref(per_sm), ctypes.byref(per_block),
                              ctypes.byref(reserved))
    if err != 0:
        raise RuntimeError(f"shared memory query failed: cudaError {err}")
    return {"per_sm": per_sm.value, "per_block": per_block.value,
            "reserved_per_block": reserved.value}


def supports(model: RobotModel) -> bool:
    """Whether the engine kernel covers this model: a floating base and
    revolute joints alone (``mocca_envs_tpu/ops/pallas/engine.py::supports``;
    every scene, actuation and constraint of the families is covered)."""
    return model.floating and all(t == REVOLUTE for t in model.jtype)


def kernel_key(model: RobotModel, config: EngineConfig, num_stones: int, num_bars: int,
               pd_mode: bool, constraints: ConstraintSpec, hf_patch: int, num_tris: int) -> Key:
    """The key of one (model, config, scene, actuation, constraints); raises
    for the models the kernel does not cover (:func:`supports`)."""
    if not supports(model):
        raise NotImplementedError("K1 covers floating-base all-revolute models")
    return Key(model.nl, model.ns, len(limited_joints(model)), config.sim_substeps,
               config.solver_iters, num_stones, pd_mode, config.llc_frames if pd_mode else 1,
               constraints.num_p2p, constraints.planar, num_bars, constraints.num_grabs, hf_patch,
               num_tris, config.split_impulse, config.matfree_pgs, config.block_pgs,
               config.warm_start, config.reuse_factor)


def pack_tables(model: RobotModel, config: EngineConfig, extra_damping=None,
                constraints: ConstraintSpec = ConstraintSpec(), num_bars: int = 0) -> np.ndarray:
    """The packed f32 model table, in the order of ``Layout`` in the source.
    ``extra_damping`` (nj,) joins the passive damping, and so the implicit
    diagonal ``dt·(c + dt·k) + armature`` too. The rods of ``constraints``
    come behind the ancestry (link a, link b, anchor a, anchor b each), then
    its grabs (link, palm anchor each) and, with bars, each sphere's no_bar
    flag."""
    m = {k: getattr(model, k).detach().cpu().numpy().astype(np.float64) for k in (
        "joint_quat", "joint_axis", "joint_pos", "com", "mass", "inertia",
        "sph_link", "sph_pos", "sph_radius", "damping", "stiffness",
        "spring_ref", "armature", "limit_lo", "limit_hi", "actuated", "kp", "anc",
        "sph_no_bar")}
    dt = config.dt
    scalars = [dt, *config.gravity, config.baumgarte / dt, config.slop,
               config.max_push_vel, config.cfm, config.contact_margin,
               config.limit_margin, LIMIT_SLOP, MAX_VEL]
    damping = m["damping"]
    if extra_damping is not None:
        damping = damping + extra_damping.detach().cpu().numpy().astype(np.float64)
    joint_diag = dt * (damping + dt * m["stiffness"]) + m["armature"]
    parts = [
        scalars, model.parent, m["joint_quat"], m["joint_axis"], m["joint_pos"],
        m["com"], m["mass"], m["inertia"], m["sph_link"], m["sph_pos"],
        m["sph_radius"], damping, m["stiffness"], m["spring_ref"], joint_diag,
        m["limit_lo"], m["limit_hi"], limited_joints(model), m["actuated"] * m["kp"],
        m["anc"],
        *([la, lb, *aa, *ab] for la, lb, aa, ab in zip(
            constraints.p2p_link_a, constraints.p2p_link_b,
            constraints.p2p_anchor_a, constraints.p2p_anchor_b)),
        *([lg, *ag] for lg, ag in zip(constraints.grab_links, constraints.grab_anchors)),
        m["sph_no_bar"] if num_bars else [],
    ]
    return np.concatenate([np.asarray(p, dtype=np.float64).ravel() for p in parts]).astype(
        np.float32
    )


def _pack(rows: torch.Tensor) -> torch.Tensor:
    """(B, n, c) rows → the kernel's component-major ``(n·c, B)`` layout."""
    return rows.reshape(rows.shape[0], -1).t().contiguous()


def pack_stones(scene: Scene) -> torch.Tensor:
    """The scene's (culled) stones in the kernel's layout, ``(K·11, B)``:
    row ``k·11 + c`` is component c of stone k (center, quaternion, half
    extents, active). One concatenation and one transposed copy."""
    return _pack(torch.cat([scene.stone_pos, scene.stone_quat, scene.stone_half,
                            scene.stone_active[..., None]], dim=2))


def pack_bars(scene: Scene) -> torch.Tensor:
    """The scene's bars in the kernel's layout, ``(KB·8, B)``: row ``k·8 + c``
    is component c of bar k (end a, end b, radius, active)."""
    return _pack(torch.cat([scene.bar_a, scene.bar_b, scene.bar_r[..., None],
                            scene.bar_active[..., None]], dim=2))


def pack_grabs(grab_active: torch.Tensor, grab_target: torch.Tensor) -> torch.Tensor:
    """Grab activity (B, ng) and targets (B, ng, 3) in the kernel's layout,
    ``(ng·4, B)``: row ``g·4 + c`` is component c of grab g (active, target)."""
    return _pack(torch.cat([grab_active[..., None], grab_target], dim=2))


def pack_hf(scene: Scene) -> torch.Tensor:
    """The scene's heightfield window in the kernel's layout, ``(B, P·P + 3)``:
    env-major (row b is env b's P×P heights row-major, then x0, y0, cell),
    so that the four corners one thread reads lie close together."""
    B = scene.hf_height.shape[0]
    return torch.cat([scene.hf_height.reshape(B, -1), scene.hf_xy0,
                      scene.hf_cell[:, None]], dim=1).contiguous()


def pack_tris(scene: Scene) -> torch.Tensor:
    """The scene's (culled) mesh faces in the kernel's layout, ``(Kt·10, B)``:
    row ``k·10 + c`` is component c of face k (vertex a, b, c, active),
    component-major like the stones, so that neighbouring threads read
    neighbouring addresses."""
    return _pack(torch.cat([scene.tri_a, scene.tri_b, scene.tri_c,
                            scene.tri_active[..., None]], dim=2))


def unpack_hf(hf: torch.Tensor) -> dict:
    """Inverse of :func:`pack_hf`: the three heightfield fields of a Scene."""
    B, C = hf.shape
    P = int(round((C - HF_META) ** 0.5))
    return {"hf_height": hf[:, :P * P].reshape(B, P, P), "hf_xy0": hf[:, P * P:P * P + 2],
            "hf_cell": hf[:, P * P + 2]}


def _unpack(packed: torch.Tensor, fields, widths) -> dict:
    rows = packed.t().reshape(packed.shape[1], -1, sum(widths))
    parts = [p[..., 0] if p.shape[-1] == 1 else p for p in rows.split(widths, dim=2)]
    return dict(zip(fields, parts))


def unpack_stones(stones: torch.Tensor) -> dict:
    """Inverse of :func:`pack_stones`: the four stone fields of a Scene."""
    return _unpack(stones, STONE_FIELDS, (3, 4, 3, 1))


def unpack_bars(bars: torch.Tensor) -> dict:
    """Inverse of :func:`pack_bars`: the four bar fields of a Scene."""
    return _unpack(bars, BAR_FIELDS, (3, 3, 1, 1))


def unpack_tris(tris: torch.Tensor) -> dict:
    """Inverse of :func:`pack_tris`: the four face fields of a Scene."""
    return _unpack(tris, TRI_FIELDS, (3, 3, 3, 1))


def make_scene(ground_z, friction, stones=None, bars=None, hf=None, tris=None) -> Scene:
    """The Scene a kernel call's scene arguments describe."""
    fields = {**(unpack_stones(stones) if stones is not None else {}),
              **(unpack_bars(bars) if bars is not None else {}),
              **(unpack_hf(hf) if hf is not None else {}),
              **(unpack_tris(tris) if tris is not None else {})}
    return Scene(ground_z=ground_z, friction=friction, **fields)


def unpack_grabs(grabs: torch.Tensor):
    """Inverse of :func:`pack_grabs`: ``(grab_active (B, ng), grab_target
    (B, ng, 3))``."""
    g = _unpack(grabs, ("active", "target"), (1, 3))
    return g["active"], g["target"]


class EngineKernel:
    """One launch unit of one (model, config, variant) on a batch:

    ``launch`` / ``plain``: ``(q (B,nq), qd (B,nv), tau (B,nj), ground_z (B,),
    friction (B,), *scene_inputs) → (q', qd', depth (B,ns), normal_impulse
    (B,ns))``, all f32. ``scene_inputs`` are the variant's packed inputs
    named in ``inputs``: none on the plane, ``stones (K·11,B)`` for K1c,
    ``bars (KB·8,B), grabs (ng·4,B)`` for K1d, ``hf (B,P·P+3)`` for K1f,
    ``tris (Kt·10,B)`` for K1g; :meth:`pack` makes them from a Scene and the
    grab state. In PD mode ``tau`` holds the joint targets and the unit is
    the whole control step; else it is one llc frame. ``plain_unit`` is the
    plain unit to compare against (built here when not given). A variant
    with a ``split_variant`` runs split impulse when ``config`` asks for it,
    counted under that name; ``split`` says whether this one runs it. Each
    PGS option ``config`` turns off adds its tag to the count's name
    (:data:`OPTION_TAGS`). The instance is the one of the key
    (:func:`kernel_key`, :func:`instance_for`): a named warp-per-env one,
    the generic warp-per-env one, a named ``engine_k1.cu`` one, or the
    generic ``engine_k1.cu`` one, each generic one built at its first
    launch; ``thread_per_env`` takes the ``engine_k1.cu`` instance of the
    key (to compare the two designs; no entry point passes it).
    """

    variant = "k1"
    split_variant: str | None = None

    def __init__(self, model: RobotModel, config: EngineConfig, *, num_stones: int = 0,
                 num_bars: int = 0, hf_patch: int = 0, num_tris: int = 0, pd_mode: bool = False,
                 extra_damping=None, plain_unit=None,
                 constraints: ConstraintSpec = ConstraintSpec(), thread_per_env: bool = False):
        if config.split_impulse and self.split_variant is None:
            raise NotImplementedError(
                f"no K1 instantiation for split_impulse on {self.variant}"
                + ("; the walker's split-impulse instance is K1hSi" if self.variant == "k1a"
                   else ""))
        self.split = config.split_impulse
        self.variant = (self.split_variant if self.split else self.variant) + "".join(
            f"_{tag}" for flag, tag in OPTION_TAGS.items() if not getattr(config, flag))
        for link in (*constraints.p2p_link_a, *constraints.p2p_link_b, *constraints.grab_links):
            if not 0 <= link < model.nl:
                raise ValueError(f"{self.variant}: a constraint names link {link} of a model "
                                 f"with {model.nl} links")
        self.key = kernel_key(model, config, num_stones, num_bars, pd_mode, constraints,
                              hf_patch, num_tris)
        self.instance = instance_for(self.key, thread_per_env)
        self.name = self.instance.symbol
        self.model = model
        self.config = config
        self.num_stones = num_stones
        self.num_bars = num_bars
        self.hf_patch = hf_patch
        self.num_tris = num_tris
        self.pd_mode = pd_mode
        self.extra_damping = extra_damping
        self.constraints = constraints
        self.inputs = (("stones",) if num_stones else ()) + (("bars",) if num_bars else ()) + (
            ("grabs",) if constraints.num_grabs else ()) + (("hf",) if hf_patch else ()) + (
            ("tris",) if num_tris else ())
        self.table_host = pack_tables(model, config, extra_damping, constraints, num_bars)
        self._plain_unit = plain_unit
        self._table: torch.Tensor | None = None
        self._ws: torch.Tensor | None = None
        self._lib = None   # the instance's library and layout, looked up at the first launch
        self._layout = (0, 0)

    def pack(self, scene: Scene, grab_active=None, grab_target=None) -> tuple:
        """This variant's scene inputs for ``scene`` and the grab state."""
        packed = {"stones": lambda: pack_stones(scene), "bars": lambda: pack_bars(scene),
                  "grabs": lambda: pack_grabs(grab_active, grab_target),
                  "hf": lambda: pack_hf(scene), "tris": lambda: pack_tris(scene)}
        return tuple(packed[name]() for name in self.inputs)

    def unpack(self, ground_z, friction, *scene_inputs):
        """``(Scene, grab_active, grab_target)`` of a call's inputs (no grabs:
        ``None, None``)."""
        named = dict(zip(self.inputs, scene_inputs))
        grabs = named.pop("grabs", None)
        scene = make_scene(ground_z, friction, **named)
        return (scene, *(unpack_grabs(grabs) if grabs is not None else (None, None)))

    def plain(self, q, qd, tau, ground_z, friction, *scene_inputs):
        """The plain PyTorch version on any device (never counted)."""
        if self._plain_unit is None:
            substep = make_substep(self.model, self.config, self.constraints,
                                   extra_damping=self.extra_damping)
            self._plain_unit = make_plain_llc(self.model, self.config, substep, self.pd_mode)
        qq, dd, info = self._plain_unit(q, qd, tau,
                                        *self.unpack(ground_z, friction, *scene_inputs))
        return qq, dd, info.contacts.depth, info.normal_impulse

    def _check_inputs(self, q, qd, tau, ground_z, friction, scene_inputs) -> int:
        B = q.shape[0]
        m = self.model
        want = {"q": (q, (B, m.nq)), "qd": (qd, (B, m.nv)), "tau": (tau, (B, m.nj)),
                "ground_z": (ground_z, (B,)), "friction": (friction, (B,))}
        if len(scene_inputs) != len(self.inputs):
            raise ValueError(f"{self.variant}: takes the scene inputs {self.inputs}, "
                             f"got {len(scene_inputs)} of them")
        shapes = {"stones": (self.num_stones * STONE_FLOATS, B),
                  "bars": (self.num_bars * BAR_FLOATS, B),
                  "grabs": (self.constraints.num_grabs * GRAB_FLOATS, B),
                  "hf": (B, self.hf_patch ** 2 + HF_META),
                  "tris": (self.num_tris * TRI_FLOATS, B)}
        for name, x in zip(self.inputs, scene_inputs):
            want[name] = (x, shapes[name])
        # shapes and dtypes of every input first, then where they live
        for name, (x, shape) in want.items():
            if tuple(x.shape) != shape:
                raise ValueError(
                    f"{self.variant}: {name} has shape {tuple(x.shape)}, want {shape}")
            if x.dtype != torch.float32:
                raise TypeError(f"{self.variant}: {name} must be float32, got {x.dtype}")
        for name, (x, _) in want.items():
            if x.device.type != "cuda" or x.device != q.device:
                raise ValueError(
                    f"{self.variant}: {name} must be on {q.device} (CUDA), got {x.device}")
            if not x.is_contiguous():
                raise ValueError(f"{self.variant}: {name} must be contiguous")
        return B

    def launch(self, q, qd, tau, ground_z, friction, *scene_inputs):
        """Launch the kernel on the current stream; raises on any failure.
        While a torch profiler records (``harness/profile.py::tracing``), a
        warp-per-env instance launches its clocked kernel
        (``<symbol>_launch_phases``: the same outputs, each env's phase
        cycles and visits added into :func:`phase_clocks`), counted as the
        shipped one."""
        B = self._check_inputs(q, qd, tau, ground_z, friction, scene_inputs)
        if self._lib is None:
            lib = build([self.instance])[self.name]
            table_size, ws_per_env = layout(lib, self.name)
            if table_size != self.table_host.size:
                raise RuntimeError(
                    f"{self.variant} table layout mismatch: source wants {table_size}, "
                    f"packed {self.table_host.size}"
                )
            self._lib, self._layout = lib, (table_size, ws_per_env)
        lib, (table_size, ws_per_env) = self._lib, self._layout
        dev = q.device
        if self._table is None or self._table.device != dev:
            self._table = torch.as_tensor(self.table_host, device=dev)
        if self._ws is None or self._ws.device != dev or self._ws.shape != (ws_per_env, B):
            self._ws = torch.empty((ws_per_env, B), dtype=torch.float32, device=dev)
        m = self.model
        q_out = torch.empty_like(q)
        qd_out = torch.empty_like(qd)
        depth = torch.empty((B, m.ns), dtype=torch.float32, device=dev)
        nimp = torch.empty((B, m.ns), dtype=torch.float32, device=dev)
        named = dict(zip(self.inputs, scene_inputs))
        ptr = lambda name: named[name].data_ptr() if name in named else None  # noqa: E731
        stream = torch.cuda.current_stream(dev).cuda_stream
        clocked = self.instance.source == SOURCE_W and tracing()
        with torch.cuda.device(dev):
            entry = "_launch_phases" if clocked else "_launch"
            clocks = (phase_clocks(self.name, B, dev).data_ptr(),) if clocked else ()
            err = getattr(lib, self.name + entry)(
                q.data_ptr(), qd.data_ptr(), tau.data_ptr(), ground_z.data_ptr(),
                friction.data_ptr(), ptr("stones"), ptr("bars"), ptr("grabs"), ptr("hf"),
                ptr("tris"), q_out.data_ptr(), qd_out.data_ptr(), depth.data_ptr(),
                nimp.data_ptr(), self._table.data_ptr(), table_size, self._ws.data_ptr(), B,
                stream, *clocks,
            )
        if err != 0:
            raise RuntimeError(f"{self.variant} launch failed: cudaError {err}")
        LAUNCHES[self.variant] += 1
        INSTANCE_LAUNCHES[self.name] += 1
        return q_out, qd_out, depth, nimp


class K1a(EngineKernel):
    """One llc frame on the plane, torque mode."""

    variant = "k1a"

    def __init__(self, model, config, plain_unit=None, thread_per_env: bool = False):
        super().__init__(model, config, plain_unit=plain_unit, thread_per_env=thread_per_env)


class K1c(EngineKernel):
    """One llc frame over ``config.stone_window`` stone boxes, torque mode."""

    variant = "k1c"
    split_variant = "k1h_c"

    def __init__(self, model, config, num_stones: int | None = None, plain_unit=None,
                 thread_per_env: bool = False):
        super().__init__(model, config, plain_unit=plain_unit,
                         num_stones=config.stone_window if num_stones is None else num_stones,
                         thread_per_env=thread_per_env)


class K1b(EngineKernel):
    """The whole control step on the plane, PD mode: ``model.kp`` holds the
    proportional gains, ``extra_damping`` the implicit derivative gains."""

    variant = "k1b"
    split_variant = "k1h_b"

    def __init__(self, model, config, extra_damping=None, plain_unit=None,
                 thread_per_env: bool = False):
        super().__init__(model, config, pd_mode=True, extra_damping=extra_damping,
                         plain_unit=plain_unit, thread_per_env=thread_per_env)


class K1e(EngineKernel):
    """A unit with the equality rows of ``constraints`` (rods, planar lock)
    on the plane: one llc frame in torque mode, the whole control step in PD
    mode."""

    variant = "k1e"
    split_variant = "k1h_e"

    def __init__(self, model, config, constraints: ConstraintSpec, pd_mode: bool = False,
                 extra_damping=None, plain_unit=None, thread_per_env: bool = False):
        if constraints.ne == 0:
            raise ValueError("K1e needs equality rows; without them the variant is K1a / K1b")
        super().__init__(model, config, pd_mode=pd_mode, extra_damping=extra_damping,
                         plain_unit=plain_unit, constraints=constraints,
                         thread_per_env=thread_per_env)


class K1d(EngineKernel):
    """One llc frame over ``num_bars`` bar capsules with the maskable grab
    rows of ``constraints``, torque mode; the scene inputs are the packed
    bars and grabs (:func:`pack_bars`, :func:`pack_grabs`)."""

    variant = "k1d"
    split_variant = "k1h_d"

    def __init__(self, model, config, constraints: ConstraintSpec, num_bars: int,
                 plain_unit=None, thread_per_env: bool = False):
        super().__init__(model, config, num_bars=num_bars, plain_unit=plain_unit,
                         constraints=constraints, thread_per_env=thread_per_env)


class K1f(EngineKernel):
    """One llc frame over a per-env ``hf_patch × hf_patch`` heightfield
    window, torque mode; the scene input is the packed window
    (:func:`pack_hf`). The scene has no plane: its ``ground_z`` is
    ``terrain.scene.NO_GROUND_Z``."""

    variant = "k1f"
    split_variant = "k1h_f"

    def __init__(self, model, config, hf_patch: int, plain_unit=None,
                 thread_per_env: bool = False):
        super().__init__(model, config, hf_patch=hf_patch, plain_unit=plain_unit,
                         thread_per_env=thread_per_env)


class K1g(EngineKernel):
    """One llc frame over ``num_tris`` culled triangle-mesh faces, torque
    mode; the scene input is the packed faces (:func:`pack_tris`)."""

    variant = "k1g"
    split_variant = "k1h_g"

    def __init__(self, model, config, num_tris: int | None = None, plain_unit=None,
                 thread_per_env: bool = False):
        super().__init__(model, config, plain_unit=plain_unit,
                         num_tris=config.tri_window if num_tris is None else num_tris,
                         thread_per_env=thread_per_env)


class K1hSi(EngineKernel):
    """One llc frame on the plane, torque mode, with split impulse: the
    push-out bias kept out of the velocity rows and solved in a position
    pass whose pseudo-velocity advances the positions only."""

    variant = "k1h_si"
    split_variant = "k1h_si"

    def __init__(self, model, config, plain_unit=None, thread_per_env: bool = False):
        if not config.split_impulse:
            raise NotImplementedError("k1h_si runs with split_impulse=True only")
        super().__init__(model, config, plain_unit=plain_unit, thread_per_env=thread_per_env)


class K1x(EngineKernel):
    """A unit of any other scene combination the TPU kernel composes: several
    of stones, bars (with or without grabs), a heightfield window and mesh
    faces in one instance, or one of them with PD mode or equality rows, or
    extra damping in torque mode. It runs the instance of its key like any
    other variant and counts under ``k1_`` (``k1h_`` with split impulse) and
    the key's :func:`scene_tags`, ``_damped`` added for extra damping in
    torque mode (which the key does not show: the damping is the table's)."""

    def __init__(self, model, config, *, num_stones: int = 0, num_bars: int = 0,
                 hf_patch: int = 0, num_tris: int = 0, pd_mode: bool = False,
                 extra_damping=None, plain_unit=None,
                 constraints: ConstraintSpec = ConstraintSpec(), thread_per_env: bool = False):
        tags = scene_tags(kernel_key(model, config, num_stones, num_bars, pd_mode, constraints,
                                     hf_patch, num_tris))
        if extra_damping is not None and not pd_mode:
            tags.append("damped")
        self.variant, self.split_variant = ("_".join([head, *tags]) for head in ("k1", "k1h"))
        super().__init__(model, config, num_stones=num_stones, num_bars=num_bars,
                         hf_patch=hf_patch, num_tris=num_tris, pd_mode=pd_mode,
                         extra_damping=extra_damping, plain_unit=plain_unit,
                         constraints=constraints, thread_per_env=thread_per_env)


def make_kernel(model, config, *, num_stones=0, num_bars=0, hf_patch=0, num_tris=0,
                pd_mode=False, extra_damping=None, plain_unit=None,
                constraints: ConstraintSpec = ConstraintSpec()) -> EngineKernel:
    """The variant for a scene with ``num_stones`` (culled) stones,
    ``num_bars`` bars, a ``hf_patch``-sided heightfield window and
    ``num_tris`` (culled) mesh faces (0: none), the actuation mode, the
    equality rows and the solver's split impulse (the same variant, which
    counts under its split-impulse name): the shipped families' variants,
    and :class:`K1x` for every other combination, as the TPU kernel takes
    them all."""
    geometries = sum(bool(n) for n in (num_stones, num_bars or constraints.num_grabs, hf_patch,
                                       num_tris))
    if geometries > 1 or (extra_damping is not None and not pd_mode) or (
            (num_stones or hf_patch or num_tris) and (pd_mode or constraints.ne)) or (
            (num_bars or constraints.num_grabs) and pd_mode):
        return K1x(model, config, num_stones=num_stones, num_bars=num_bars, hf_patch=hf_patch,
                   num_tris=num_tris, pd_mode=pd_mode, extra_damping=extra_damping,
                   plain_unit=plain_unit, constraints=constraints)
    if num_tris:
        return K1g(model, config, num_tris, plain_unit)
    if hf_patch:
        return K1f(model, config, hf_patch, plain_unit)
    if num_bars or constraints.num_grabs:
        return K1d(model, config, constraints, num_bars, plain_unit)
    if constraints.ne:
        return K1e(model, config, constraints, pd_mode, extra_damping, plain_unit)
    if pd_mode:
        return K1b(model, config, extra_damping, plain_unit)
    if num_stones:
        return K1c(model, config, num_stones, plain_unit)
    return (K1hSi if config.split_impulse else K1a)(model, config, plain_unit)


# fp32 operations of the kernel's mesh narrowphase per (sphere, active face),
# by the region its walk (csrc/k1_common.cuh::closest_on_triangle) ends in:
# vertex a, b, c, edge ab, ac, bc, the interior; then the offset to the
# center, its length, the depth and the compare (TRI_TAIL_OPS)
TRI_WALK_OPS = (27, 39, 51, 66, 72, 83, 89)
TRI_TAIL_OPS = 12


def tri_walk_ops(center, a, b, c) -> torch.Tensor:
    """Operations the kernel's sphere-vs-triangle test takes for these
    centers and faces (broadcast as :func:`terrain.scene.
    sphere_triangle_depth` takes them): the walk stops at the first region
    that holds the center."""
    ab, ac = b - a, c - a
    dot = lambda x, y: (x * y).sum(-1)  # noqa: E731
    d1, d2 = dot(ab, center - a), dot(ac, center - a)
    d3, d4 = dot(ab, center - b), dot(ac, center - b)
    d5, d6 = dot(ab, center - c), dot(ac, center - c)
    va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2
    regions = [(d1 <= 0) & (d2 <= 0), (d3 >= 0) & (d4 <= d3), (d6 >= 0) & (d5 <= d6),
               (vc <= 0) & (d1 >= 0) & (d3 <= 0), (vb <= 0) & (d2 >= 0) & (d6 <= 0),
               (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)]
    ops = torch.full_like(d1, float(TRI_WALK_OPS[-1]))
    for cond, n in reversed(list(zip(regions, TRI_WALK_OPS))):
        ops = torch.where(cond, torch.full_like(ops, float(n)), ops)
    return ops + TRI_TAIL_OPS


def k1_activity(kernel: EngineKernel, q, qd, tau, ground_z, friction, *scene_inputs):
    """Which rows each substep of one call of ``kernel`` needs, on these
    inputs: limit rows within the limit margin and spheres within the contact
    margin, at each substep's start state, taken from the plain version's
    run of the unit (rods and the planar lock are always active, a grab's
    rows as its input says for the whole call: neither has a mask here).
    Returns bool masks ``(limits (S,B,nlim), contacts (S,B,ns))`` over the
    S = llc frames × substeps of the call, and the operations of the mesh
    narrowphase per substep and env ``(S, B)`` (its walks over the active
    faces, :func:`tri_walk_ops`; zeros without a mesh)."""
    model, config = kernel.model, kernel.config
    substep = make_substep(model, config, kernel.constraints,
                           extra_damping=kernel.extra_damping)
    lim = torch.as_tensor(limited_joints(model), dtype=torch.long, device=q.device)
    scene, grab_active, grab_target = kernel.unpack(ground_z, friction, *scene_inputs)
    gain = model.actuated * model.kp
    lam = q.new_zeros(q.shape[0], substep.num_rows) if config.warm_start else None
    lim_act, con_act, walks = [], [], []
    for _ in range(config.llc_frames if kernel.pd_mode else 1):
        tau_j = gain * (tau - joint_q(model, q)) if kernel.pd_mode else tau
        Minv0 = substep.minv_of(forward_kinematics(model, q, qd)) if config.reuse_factor else None
        for _ in range(config.sim_substeps):
            qj = joint_q(model, q)[:, lim]
            gap = torch.minimum(qj - model.limit_lo[lim], model.limit_hi[lim] - qj)
            lim_act.append(gap < config.limit_margin)
            if scene.has_tris:
                centers = sphere_centers(model, forward_kinematics(model, q, qd))[:, :, None]
                ops = tri_walk_ops(centers, *(getattr(scene, f)[:, None] for f in TRI_FIELDS[:3]))
                walks.append((ops * (scene.tri_active[:, None] > 0.5)).sum(dim=(1, 2)))
            else:
                walks.append(q.new_zeros(q.shape[0]))
            q, qd, info, lam_out = substep(q, qd, tau_j, scene, grab_active, grab_target,
                                           Minv_in=Minv0, lam_in=lam)
            lam = lam_out if config.warm_start else None
            con_act.append(info.contacts.active > 0.5)
    return torch.stack(lim_act), torch.stack(con_act), torch.stack(walks)


def k1_flops(kernel: EngineKernel, lim_act, con_act, *scene_inputs, tri_walk=None) -> int:
    """fp32 operations one call of ``kernel`` needs, summed over the batch,
    given the activity masks of :func:`k1_activity` and the call's packed
    scene inputs (stones; bars, grabs; the heightfield window; the faces), a
    multiply-add counting 2. A mesh call also needs ``tri_walk``, the
    narrowphase's operations per substep and env from :func:`k1_activity`.

    Every substep needs FK, the narrowphase, RNEA, the free velocity and the
    integration; each llc frame needs CRBA and the Cholesky factor once
    (every substep without ``reuse_factor``). Only an active row needs its W
    = L⁻¹Jᵀ row and its share of the solve (:func:`_solver_ops`); the
    impulse map runs only where some row is active. A contact's Jacobian
    takes a cross product per ancestor joint of its sphere's link. With
    stones, every sphere is tested against every active stone of the window
    each substep (a narrowphase has to test a pair to know its depth), each
    sphere's deepest stone is carried to the world frame, and every active
    contact projects its Jacobian onto its own normal and tangents. With
    bars, every sphere that may touch them (not the palms) is tested against
    every active bar each substep, its deepest bar's normal and point made
    once, and active contacts project as over stones. With a heightfield
    window, every sphere samples it each substep (its cell, four corners, the
    bilinear height, the gradient, the normal, the depth and the merge with
    the plane) and active contacts project as over stones. With mesh faces,
    every sphere walks every active face each substep (as far as the region
    that holds its center: ``tri_walk``), its deepest face's normal is made
    once, and active contacts project as over stones. Split impulse adds the
    position pass (:func:`_solver_ops`) and, where any of its rows is
    active, the back substitution of z_pos and its addition to the velocity
    that advances the positions. PD mode adds the torque per llc frame. A
    unit over several geometries counts each one's narrowphase, and its
    active contacts project once. Extra damping, in either mode, rides the
    table's damping and implicit diagonal: it adds no operation.
    Rods and the planar lock are needed every substep: a rod takes its two
    anchors to the world frame, two point Jacobians over the
    anchors' ancestor joints, their difference, three dense W rows with
    their targets; a planar row is a unit row like a limit row. A grab is
    needed only where it is attached: its palm to the world frame, one point
    Jacobian, three dense rows like a rod's. The thread-per-env instances
    run every row whether or not it is active, so they do more work than
    this count, even with masks of all ones; the warp-per-env instances skip
    the inactive rows."""
    model, config = kernel.model, kernel.config
    nl, nj, nv, ns = model.nl, model.nj, model.nv, model.ns
    lim = limited_joints(model)
    anc = model.anc.cpu().numpy() > 0.5
    S, B = con_act.shape[:2]
    frames = S // config.sim_substeps
    # FK: 2 qmul (28 each) + 2 qrot (30 each) + sincos (~20) + 9 per joint;
    # per link qmat (24) + COM (18) + R I Rᵀ (90)
    fk = (nl - 1) * (2 * 28 + 2 * 30 + 20 + 9) + nl * (24 + 18 + 90)
    collide = ns * (15 + 3)
    # RNEA: forward (3 crosses + 6 adds) , per-link wrench (4 crosses, 2
    # matvecs, 12 mul/adds), backward (1 cross + 9 adds), joint dots
    rnea = (nl - 1) * (4 * 9 + 9) + nl * (4 * 9 + 2 * 15 + 12) + (nl - 1) * (9 + 6) + nj * 5
    free_vel = 2 * nv * nv + nj * 6 + nv * 2
    # every row's gap / sign / depth test and target, the velocity clamp and
    # the integration
    rows = len(lim) * 12 + ns * 10
    integ = 2 * nv + 40 + nj * 6
    per_sub = fk + collide + rnea + free_vel + rows + integ
    # CRBA: per-link composite (~40), up-sweep (13), momentum per base axis
    # and joint (~39) plus one pair (11) per stored nonzero of M
    pairs = 21 + nj * 7 + int(sum(anc[j + 1, :j].sum() for j in range(nj)))
    crba = nl * 40 + (nl - 1) * 13 + (6 + nj) * 39 + pairs * 11
    chol = sum((nv - j) * 2 * j for j in range(nv)) + nv * 4
    factors = frames if config.reuse_factor else S
    # per active limit row: its W row, a forward solve from its column
    span = torch.tensor([nv - (6 + j) for j in lim], dtype=torch.float64)
    # per active contact: Jacobian over the ancestor joints, three W rows
    # (dense forward solve and c)
    n_anc = torch.tensor(anc[model.sph_link.cpu().numpy()].sum(axis=1), dtype=torch.float64)
    con_row = n_anc * 12 + 9 + 3 * (nv * nv + 2 * nv)
    la, ca = lim_act.cpu().double(), con_act.cpu().double()
    total = S * B * per_sub + factors * B * (crba + chol)
    total += float((la * span * span).sum() + (ca * con_row).sum())
    named = dict(zip(kernel.inputs, scene_inputs))
    grab_on = unpack_grabs(named["grabs"])[0].cpu() > 0.5 if "grabs" in named else None
    any_act = lim_act.cpu().any(dim=2) | con_act.cpu().any(dim=2)
    if grab_on is not None:
        any_act = any_act | grab_on.any(dim=1)
    total += float(any_act.sum()) * (nv * nv)
    if "stones" in named:
        # per (sphere, active stone): into the box frame (33), clamp and
        # distance (20), depth and compare (2); per sphere: its deepest
        # stone's normal and point into the world frame (2 × 30 + 3) and the
        # merge with the plane
        n_active = (unpack_stones(named["stones"])["stone_active"] > 0.5).double().sum()
        total += S * ns * (55.0 * float(n_active) + B * 64.0)
    if "bars" in named:
        # per (sphere, active bar): the segment parameter (two dots, a
        # divide, a clamp: 17), the closest point (6), distance (9), depth
        # and compare (3); per sphere: its deepest bar's normal and point
        # (11) and the merge with the plane
        n_active = (unpack_bars(named["bars"])["bar_active"] > 0.5).double().sum()
        n_sph = float((model.sph_no_bar < 0.5).sum())
        total += S * n_sph * (35.0 * float(n_active) + B * 11.0)
    if "hf" in named:
        # per sphere: (u, v) (2 subtractions, 2 divisions, 4 clamps), two
        # floors and the fractions (4), 1 − f (2), the bilinear height (11),
        # the gradient (10) over the cell (2), the normal (3 products, 2 sums,
        # a root, 3 divisions: 9), the depth (3) and the compare (1)
        total += S * B * ns * 50.0
    if "tris" in named:
        if tri_walk is None:
            raise ValueError("k1_flops: a mesh call needs tri_walk from k1_activity")
        # the walks, and per sphere the winner's normal (5) and the merge (1)
        total += float(tri_walk.double().sum()) + S * B * ns * 6.0
    if named.keys() - {"grabs"}:
        # per active contact: the tangent basis (15) and three projections of
        # the 3 × nv point Jacobian (5 each)
        total += float(ca.sum()) * (15 + 3 * nv * 5)
    if kernel.pd_mode:
        total += frames * B * nj * 3
    if kernel.split:
        any_pos = lim_act.cpu().any(dim=2) | con_act.cpu().any(dim=2)
        total += float(any_pos.sum()) * (nv * nv + nv)
    spec = kernel.constraints
    eq_sub = 0.0
    for la_, lb_ in zip(spec.p2p_link_a, spec.p2p_link_b):
        # two anchors, two Jacobians, their difference; three dense W rows
        # with c and their targets
        eq_sub += 2 * 18 + (anc[la_].sum() + anc[lb_].sum()) * 12 + 2 * 9 + 3 * nv
        eq_sub += 3 * (nv * nv + 2 * nv + 6)
    if spec.planar:
        for col in (1, 3, 5):
            eq_sub += (nv - col) ** 2 + 6
        eq_sub += 6                                                # the two sine surrogates
    total += B * S * eq_sub
    if grab_on is not None:
        attached = grab_on.double().sum(dim=0)                      # (ng,)
        for g, lg in enumerate(spec.grab_links):
            grab_sub = 18 + anc[lg].sum() * 12 + 9 + 3 * nv + 3 * (nv * nv + 2 * nv + 6)
            total += float(attached[g]) * S * grab_sub
    total += _solver_ops(kernel, la, ca, grab_on)
    return int(round(total))


def _row_table(kernel: EngineKernel, la, ca, grab_on):
    """Every row of one call in the kernel's order [rods | planar | grabs |
    limits | contacts × (n, t1, t2)]: its activity per substep and env
    ``(S, B, NR)`` (float64) and its span, the columns from its first
    nonzero to nv ``(NR,)``; and the slices of the limit rows, the contacts'
    normal rows and their two tangent rows."""
    model, spec = kernel.model, kernel.constraints
    nv = model.nv
    S, B = ca.shape[:2]
    ones = lambda n: torch.ones((S, B, n), dtype=torch.float64)  # noqa: E731
    acts = [ones(3 * spec.num_p2p)]
    spans = [nv] * (3 * spec.num_p2p)
    if spec.planar:
        acts.append(ones(3))
        spans += [nv - col for col in (1, 3, 5)]
    if spec.num_grabs:
        on = grab_on.double() if grab_on is not None else torch.zeros(B, spec.num_grabs)
        acts.append(on.repeat_interleave(3, dim=1)[None].expand(S, B, -1))
        spans += [nv] * (3 * spec.num_grabs)
    acts += [la, ca.repeat_interleave(3, dim=2)]
    spans += [nv - (6 + j) for j in limited_joints(model)] + [nv] * (3 * model.ns)
    ne, nlim = spec.ne, la.shape[2]
    normals = torch.arange(ne + nlim, ne + nlim + 3 * model.ns, 3)
    return (torch.cat(acts, dim=2), torch.tensor(spans, dtype=torch.float64),
            torch.arange(ne, ne + nlim), normals)


def _solver_ops(kernel: EngineKernel, la, ca, grab_on) -> float:
    """fp32 operations of the PGS and the split-impulse position pass of one
    call, over the active rows: the diagonals (and the contacts' 2×2 friction
    blocks), ``solver_iters`` sweeps, the warm start from the substep
    before, and the position pass's sweeps from λ_pos = 0.

    Matrix-free: a row's diagonal is a dot over its span; a sweep visits it
    with a residual and an update of z = Wλ over its span (4·span + 6; a
    block friction pair 8·nv + 16 with its 2×2 step, a scalar tangent row
    4·nv + 6); a warm start adds Wλ over its span; the position pass visits
    each active limit row and contact normal (4·span + 7). A-form: A = WWᵀ
    + cfm·I over the active rows (a dot over the shorter span per pair, one
    add per diagonal), then a row's visit updates the residual of the n
    active rows (2·n + 6; a block friction pair 4·n + 16), a warm start
    adds A's column over the active rows (2·n per carried row), z = Wλ is
    made once after the sweeps (2·span per active row), and the position
    pass visits as the sweeps do (2·n + 7) and makes z_pos once."""
    config = kernel.config
    nv, iters = kernel.model.nv, config.solver_iters
    act, span, lim_rows, normals = _row_table(kernel, la, ca, grab_on)
    tangents = torch.cat([normals + 1, normals + 2])
    unit = torch.ones(act.shape[2], dtype=torch.bool)     # rows swept alone
    unit[tangents] = not config.block_pgs
    unit[normals] = True
    pos = torch.zeros_like(unit)
    pos[lim_rows] = pos[normals] = True
    carried = act[1:] * act[:-1]                          # warm-started rows
    n_con = float(ca.sum())
    total = 0.0
    if config.matfree_pgs:
        # the diagonals: every row's own dot; the contacts' a12 with block
        total += float((act * 2 * span).sum())
        if config.block_pgs:
            total += n_con * (2 * nv + 8)
        total += iters * float((act[..., unit] * (4 * span[unit] + 6)).sum())
        if config.block_pgs:
            total += iters * n_con * (8 * nv + 16)
        if config.warm_start:
            total += float((carried * 2 * span).sum())
        if kernel.split:
            total += iters * float((act[..., pos] * (4 * span[pos] + 7)).sum())
        return total
    n = act.sum(dim=2)                                    # active rows (S, B)
    shorter = torch.minimum(span[:, None], span[None, :])
    pairs = torch.triu(2 * shorter) + torch.eye(len(span), dtype=torch.float64)
    total += float(torch.einsum("sbi,ij,sbj->", act, pairs, act))
    if config.block_pgs:
        total += n_con * 8
    total += iters * float((act[..., unit] * (2 * n[..., None] + 6)).sum())
    if config.block_pgs:
        total += iters * float((ca * (4 * n[..., None] + 16)).sum())
    if config.warm_start:
        total += float((carried.sum(dim=2) * 2 * n[1:]).sum())
    total += float((act * 2 * span).sum())
    if kernel.split:
        total += iters * float((act[..., pos] * (2 * n[..., None] + 7)).sum())
        total += float((act[..., pos] * 2 * span[pos]).sum())
    return total


def k1_bytes_per_env(kernel: EngineKernel) -> int:
    """Bytes one env must move: each input read once, each output written
    once (q, qd, tau, ground_z, friction, the window's stones, the bars, the
    grabs, the heightfield window and the window's faces in; q', qd', depth,
    impulse out)."""
    model = kernel.model
    inputs = (model.nq + model.nv + model.nj + 2 + kernel.num_stones * STONE_FLOATS
              + kernel.num_bars * BAR_FLOATS + kernel.constraints.num_grabs * GRAB_FLOATS
              + (kernel.hf_patch ** 2 + HF_META if kernel.hf_patch else 0)
              + kernel.num_tris * TRI_FLOATS)
    outputs = model.nq + model.nv + 2 * model.ns
    return 4 * (inputs + outputs)
