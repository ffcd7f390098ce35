"""K1: the fused engine kernel on Hopper, its wrappers and its plain version.

Counterpart of ``mocca_envs_tpu/ops/pallas/engine.py::make_pallas_substep``
for floating all-revolute models at the shipped EngineConfig, in eight
variants: K1a (plane, torque mode), K1c (K1a plus ``stone_window`` oriented
stone boxes), K1b (PD mode: the whole control step, joint targets in the
``tau`` input), K1e (the equality rows of a ``ConstraintSpec`` in front
of the others: point-to-point rods and the planar base lock, in torque or PD
mode), K1d (bar capsules and the maskable grab rows, torque mode), K1f
(K1a plus a per-env ``HF_PATCH × HF_PATCH`` heightfield window), K1g (K1a
plus ``tri_window`` triangle-mesh faces) and K1h (``split_impulse``: the
bias split and the position pass) on K1a (K1h-si), K1c (K1h-c), Cassie's
K1e (K1h-e, K1h-e2d) and K1d (K1h-d). The kernel is CUDA C++ in
``csrc/engine_k1.cu``, one source for all variants. At first use every instantiation is built with ``nvcc``
for ``sm_90a`` into ``build/``, one compiler process per instantiation, all
started together (with the raycast kernel K2 of ``csrc/raycast_k2.cu``, whose
wrapper is ``ops/raycast.py``), and called through a plain C interface with
``ctypes``.

- :class:`K1a`, :class:`K1c`, :class:`K1b`, :class:`K1e`, :class:`K1d`,
  :class:`K1f`, :class:`K1g`, :class:`K1hSi` wrap one (model, config):
  ``launch`` launches the kernel on CUDA tensors and raises on anything
  else. The choice by device is made once, in
  ``ops/step.py::_make_llc_unit``; there is no fallback from one path to
  the other.
- ``plain`` is the plain PyTorch version: the port's ``ops/step.py`` path
  run for the same unit, on any device.
- ``LAUNCHES["k1a" | "k1b" | "k1c" | "k1e" | "k1d" | "k1f" | "k1g" |
  "k1h_si" | "k1h_c" | "k1h_e" | "k1h_d" | "k2"]`` counts kernel launches
  (plain runs do not count); a split-impulse instance counts under its
  own name.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from mocca_envs_tpu_torch.models.schema import REVOLUTE, RobotModel
from mocca_envs_tpu_torch.ops.collide import sphere_centers
from mocca_envs_tpu_torch.ops.integrate import LIMIT_SLOP, MAX_VEL
from mocca_envs_tpu_torch.ops.kinematics import forward_kinematics, joint_q
from mocca_envs_tpu_torch.ops.step import (
    ConstraintSpec, limited_joints, make_plain_llc, make_substep)
from mocca_envs_tpu_torch.terrain.scene import BAR_FIELDS, STONE_FIELDS, TRI_FIELDS, Scene
from mocca_envs_tpu_torch.utils.config import EngineConfig

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "engine_k1.cu"
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
class Instance:
    """One instantiation of the kernel template in the source."""

    symbol: str   # C symbol prefix
    index: int    # its K1_ONLY number there


# (nl, ns, nlim, sim_substeps, solver_iters, stones, pd_mode, llc frames per
# launch, rods, planar lock, bars, grabs, heightfield window side, mesh face
# window, split impulse) → instantiation; torque mode launches once per llc
# frame
INSTANTIATIONS = {
    (22, 14, 21, 4, 4, 0, False, 1, 0, False, 0, 0, 0, 0, False):
        Instance("k1a_nl22_ns14_nlim21_sub4_it4", 0),
    (22, 14, 21, 4, 4, 6, False, 1, 0, False, 0, 0, 0, 0, False):
        Instance("k1c_nl22_ns14_nlim21_sub4_it4_k6", 1),
    (22, 14, 21, 4, 4, 0, True, 1, 0, False, 0, 0, 0, 0, False):
        Instance("k1b_nl22_ns14_nlim21_sub4_it4_llc1", 2),
    (22, 14, 21, 4, 4, 0, True, 2, 0, False, 0, 0, 0, 0, False):
        Instance("k1b_nl22_ns14_nlim21_sub4_it4_llc2", 3),
    # Cassie and Cassie2D: the whole control step, 10 llc frames × 2 substeps
    (17, 5, 16, 2, 4, 0, True, 10, 2, False, 0, 0, 0, 0, False):
        Instance("k1e_nl17_ns5_nlim16_sub2_it4_llc10_p2p2", 4),
    (17, 5, 16, 2, 4, 0, True, 10, 2, True, 0, 0, 0, 0, False):
        Instance("k1e_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_planar", 5),
    # Walker2D and Crab2D
    (7, 5, 6, 4, 4, 0, False, 1, 0, True, 0, 0, 0, 0, False):
        Instance("k1e_nl7_ns5_nlim6_sub4_it4_planar", 6),
    # Monkey3D: 16 bars, two grabs
    (11, 5, 8, 4, 4, 0, False, 1, 0, False, 16, 2, 0, 0, False):
        Instance("k1d_nl11_ns5_nlim8_sub4_it4_kb16_ng2", 7),
    # Walker3D over a 16 × 16 heightfield window (the terrain families)
    (22, 14, 21, 4, 4, 0, False, 1, 0, False, 0, 0, 16, 0, False):
        Instance("k1f_nl22_ns14_nlim21_sub4_it4_hf16", 8),
    # Walker3D over 16 culled mesh faces (the stairs)
    (22, 14, 21, 4, 4, 0, False, 1, 0, False, 0, 0, 0, 16, False):
        Instance("k1g_nl22_ns14_nlim21_sub4_it4_kt16", 9),
    # Walker3D on the plane with split impulse
    (22, 14, 21, 4, 4, 0, False, 1, 0, False, 0, 0, 0, 0, True):
        Instance("k1h_nl22_ns14_nlim21_sub4_it4_si", 10),
    # ... and split impulse on the stepper, Cassie, Cassie2D and the monkey
    (22, 14, 21, 4, 4, 6, False, 1, 0, False, 0, 0, 0, 0, True):
        Instance("k1h_nl22_ns14_nlim21_sub4_it4_k6_si", 11),
    (17, 5, 16, 2, 4, 0, True, 10, 2, False, 0, 0, 0, 0, True):
        Instance("k1h_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_si", 12),
    (17, 5, 16, 2, 4, 0, True, 10, 2, True, 0, 0, 0, 0, True):
        Instance("k1h_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_planar_si", 13),
    (11, 5, 8, 4, 4, 0, False, 1, 0, False, 16, 2, 0, 0, True):
        Instance("k1h_nl11_ns5_nlim8_sub4_it4_kb16_ng2_si", 14),
}

LAUNCHES: collections.Counter = collections.Counter()

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
    """The built shared libraries (one per instantiation), loaded once per
    process, and nvcc's register / spill report of each."""

    handles: dict = {}
    logs: dict = {}


def library_path(inst: Instance) -> Path:
    return BUILD_DIR / f"lib{inst.symbol}.so"


def build() -> dict:
    """Compile every instantiation of ``csrc/engine_k1.cu`` and the raycast
    kernel of ``csrc/raycast_k2.cu`` whose library is missing or older than
    its source, all compilers started together, and load them: ``{symbol:
    CDLL}``. A failed build raises with nvcc's output; ``_Library.logs``
    keeps nvcc's report per symbol."""
    if _Library.handles:
        return _Library.handles
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    jobs = [(inst.symbol, SOURCE, [f"-DK1_ONLY={inst.index}"])
            for inst in INSTANTIATIONS.values()] + [(RAYCAST_SYMBOL, RAYCAST_SOURCE, [])]
    for symbol, source, flags in jobs:
        lib = BUILD_DIR / f"lib{symbol}.so"
        if lib.exists() and lib.stat().st_mtime >= source.stat().st_mtime:
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
    handles = {}
    for inst in INSTANTIATIONS.values():
        lib = ctypes.CDLL(str(library_path(inst)))
        getattr(lib, inst.symbol + "_layout").argtypes = [ctypes.POINTER(_I), ctypes.POINTER(_I)]
        getattr(lib, inst.symbol + "_layout").restype = _I
        fn = getattr(lib, inst.symbol + "_launch")
        fn.argtypes = [_P] * 15 + [_I, _P, _I, _P]
        fn.restype = _I
        handles[inst.symbol] = lib
    lib = ctypes.CDLL(str(BUILD_DIR / f"lib{RAYCAST_SYMBOL}.so"))
    fn = getattr(lib, RAYCAST_SYMBOL + "_launch")
    # origins, directions, grid, H, W, xy0, cell, max_t, dt, steps, t out,
    # h out, B, stream
    fn.argtypes = [_P, _P, _P, _I, _I, _P, _P, ctypes.c_float, ctypes.c_float, _I, _P, _P, _I,
                   _P]
    fn.restype = _I
    handles[RAYCAST_SYMBOL] = lib
    _Library.handles = handles
    return handles


def layout(lib, name: str) -> tuple[int, int]:
    """(table floats, workspace floats per env) of one instantiation."""
    table, ws = _I(), _I()
    getattr(lib, name + "_layout")(ctypes.byref(table), ctypes.byref(ws))
    return table.value, ws.value


def _check_supported(model: RobotModel, config: EngineConfig, num_stones: int, num_bars: int,
                     pd_mode: bool, constraints: ConstraintSpec, hf_patch: int,
                     num_tris: int) -> Instance:
    if not model.floating or any(t != REVOLUTE for t in model.jtype):
        raise NotImplementedError("K1 covers floating-base all-revolute models")
    options = dict(block_pgs=True, matfree_pgs=True, warm_start=True, reuse_factor=True)
    off = {k: getattr(config, k) for k, v in options.items() if getattr(config, k) != v}
    if off:
        raise NotImplementedError(f"K1 runs the shipped solver options; got {off}")
    key = (model.nl, model.ns, len(limited_joints(model)), config.sim_substeps,
           config.solver_iters, num_stones, pd_mode, config.llc_frames if pd_mode else 1,
           constraints.num_p2p, constraints.planar, num_bars, constraints.num_grabs, hf_patch,
           num_tris, config.split_impulse)
    if key not in INSTANTIATIONS:
        split = (" with split impulse (built for the walker on the plane and over stones, "
                 "Cassie, Cassie2D and the monkey)" if config.split_impulse else "")
        raise NotImplementedError(
            f"no K1 instantiation{split} for (nl, ns, nlim, substeps, iters, stones, pd_mode, "
            f"llc frames, rods, planar, bars, grabs, hf window, mesh faces, split) = {key}; "
            f"built: {sorted(INSTANTIATIONS)}"
        )
    return INSTANTIATIONS[key]


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
    counted under that name; ``split`` says whether this one runs it.
    """

    variant = "k1"
    split_variant: str | None = None

    def __init__(self, model: RobotModel, config: EngineConfig, *, num_stones: int = 0,
                 num_bars: int = 0, hf_patch: int = 0, num_tris: int = 0, pd_mode: bool = False,
                 extra_damping=None, plain_unit=None,
                 constraints: ConstraintSpec = ConstraintSpec()):
        if config.split_impulse and self.split_variant is None:
            raise NotImplementedError(
                f"no K1 instantiation for split_impulse on {self.variant}"
                + ("; the walker's split-impulse instance is K1hSi" if self.variant == "k1a"
                   else ""))
        self.split = config.split_impulse
        if self.split:
            self.variant = self.split_variant
        self.instance = _check_supported(model, config, num_stones, num_bars, pd_mode,
                                         constraints, hf_patch, num_tris)
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
        self.inputs = (("stones",) if num_stones else ()) + (
            ("bars", "grabs") if num_bars else ()) + (("hf",) if hf_patch else ()) + (
            ("tris",) if num_tris else ())
        self.table_host = pack_tables(model, config, extra_damping, constraints, num_bars)
        self._plain_unit = plain_unit
        self._table: torch.Tensor | None = None
        self._ws: torch.Tensor | None = None

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
        """Launch the kernel on the current stream; raises on any failure."""
        B = self._check_inputs(q, qd, tau, ground_z, friction, scene_inputs)
        lib = build()[self.name]
        table_size, ws_per_env = layout(lib, self.name)
        if table_size != self.table_host.size:
            raise RuntimeError(
                f"{self.variant} table layout mismatch: source wants {table_size}, "
                f"packed {self.table_host.size}"
            )
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
        with torch.cuda.device(dev):
            err = getattr(lib, self.name + "_launch")(
                q.data_ptr(), qd.data_ptr(), tau.data_ptr(), ground_z.data_ptr(),
                friction.data_ptr(), ptr("stones"), ptr("bars"), ptr("grabs"), ptr("hf"),
                ptr("tris"), q_out.data_ptr(), qd_out.data_ptr(), depth.data_ptr(),
                nimp.data_ptr(), self._table.data_ptr(), table_size, self._ws.data_ptr(), B,
                stream,
            )
        if err != 0:
            raise RuntimeError(f"{self.variant} launch failed: cudaError {err}")
        LAUNCHES[self.variant] += 1
        return q_out, qd_out, depth, nimp


class K1a(EngineKernel):
    """One llc frame on the plane, torque mode."""

    variant = "k1a"

    def __init__(self, model, config, plain_unit=None):
        super().__init__(model, config, plain_unit=plain_unit)


class K1c(EngineKernel):
    """One llc frame over ``config.stone_window`` stone boxes, torque mode."""

    variant = "k1c"
    split_variant = "k1h_c"

    def __init__(self, model, config, num_stones: int | None = None, plain_unit=None):
        super().__init__(model, config, plain_unit=plain_unit,
                         num_stones=config.stone_window if num_stones is None else num_stones)


class K1b(EngineKernel):
    """The whole control step on the plane, PD mode: ``model.kp`` holds the
    proportional gains, ``extra_damping`` the implicit derivative gains."""

    variant = "k1b"

    def __init__(self, model, config, extra_damping=None, plain_unit=None):
        super().__init__(model, config, pd_mode=True, extra_damping=extra_damping,
                         plain_unit=plain_unit)


class K1e(EngineKernel):
    """A unit with the equality rows of ``constraints`` (rods, planar lock)
    on the plane: one llc frame in torque mode, the whole control step in PD
    mode."""

    variant = "k1e"
    split_variant = "k1h_e"

    def __init__(self, model, config, constraints: ConstraintSpec, pd_mode: bool = False,
                 extra_damping=None, plain_unit=None):
        if constraints.ne == 0:
            raise ValueError("K1e needs equality rows; without them the variant is K1a / K1b")
        super().__init__(model, config, pd_mode=pd_mode, extra_damping=extra_damping,
                         plain_unit=plain_unit, constraints=constraints)


class K1d(EngineKernel):
    """One llc frame over ``num_bars`` bar capsules with the maskable grab
    rows of ``constraints``, torque mode; the scene inputs are the packed
    bars and grabs (:func:`pack_bars`, :func:`pack_grabs`)."""

    variant = "k1d"
    split_variant = "k1h_d"

    def __init__(self, model, config, constraints: ConstraintSpec, num_bars: int,
                 plain_unit=None):
        super().__init__(model, config, num_bars=num_bars, plain_unit=plain_unit,
                         constraints=constraints)


class K1f(EngineKernel):
    """One llc frame over a per-env ``hf_patch × hf_patch`` heightfield
    window, torque mode; the scene input is the packed window
    (:func:`pack_hf`). The scene has no plane: its ``ground_z`` is
    ``terrain.scene.NO_GROUND_Z``."""

    variant = "k1f"

    def __init__(self, model, config, hf_patch: int, plain_unit=None):
        super().__init__(model, config, hf_patch=hf_patch, plain_unit=plain_unit)


class K1g(EngineKernel):
    """One llc frame over ``num_tris`` culled triangle-mesh faces, torque
    mode; the scene input is the packed faces (:func:`pack_tris`)."""

    variant = "k1g"

    def __init__(self, model, config, num_tris: int | None = None, plain_unit=None):
        super().__init__(model, config, plain_unit=plain_unit,
                         num_tris=config.tri_window if num_tris is None else num_tris)


class K1hSi(EngineKernel):
    """One llc frame on the plane, torque mode, with split impulse: the
    push-out bias kept out of the velocity rows and solved in a position
    pass whose pseudo-velocity advances the positions only."""

    variant = "k1h_si"
    split_variant = "k1h_si"

    def __init__(self, model, config, plain_unit=None):
        if not config.split_impulse:
            raise NotImplementedError("k1h_si runs with split_impulse=True only")
        super().__init__(model, config, plain_unit=plain_unit)


def make_kernel(model, config, *, num_stones=0, num_bars=0, hf_patch=0, num_tris=0,
                pd_mode=False, extra_damping=None, plain_unit=None,
                constraints: ConstraintSpec = ConstraintSpec()) -> EngineKernel:
    """The variant for a scene with ``num_stones`` (culled) stones,
    ``num_bars`` bars, a ``hf_patch``-sided heightfield window and
    ``num_tris`` (culled) mesh faces (0: none), the actuation mode, the
    equality rows and the solver's split impulse (the same variant, which
    counts under its split-impulse name); combinations without an
    instantiation raise, naming what is missing."""
    if num_tris:
        if pd_mode or num_stones or num_bars or hf_patch or constraints.ne \
                or extra_damping is not None:
            raise NotImplementedError("no K1 instantiation for a mesh with PD mode, stones, "
                                      "bars, a heightfield or equality rows")
        return K1g(model, config, num_tris, plain_unit)
    if hf_patch:
        if pd_mode or num_stones or num_bars or constraints.ne or extra_damping is not None:
            raise NotImplementedError("no K1 instantiation for a heightfield with PD mode, "
                                      "stones, bars or equality rows")
        return K1f(model, config, hf_patch, plain_unit)
    if pd_mode and num_stones:
        raise NotImplementedError("no K1 instantiation for PD mode over stones")
    if constraints.ne and num_stones:
        raise NotImplementedError("no K1 instantiation for equality rows over stones")
    if extra_damping is not None and not pd_mode:
        raise NotImplementedError("no K1 instantiation for extra damping in torque mode")
    if num_bars or constraints.num_grabs:
        if pd_mode or num_stones:
            raise NotImplementedError("no K1 instantiation for bars or grabs in PD mode "
                                      "or over stones")
        return K1d(model, config, constraints, num_bars, plain_unit)
    if constraints.ne:
        return K1e(model, config, constraints, pd_mode, extra_damping, plain_unit)
    if pd_mode:
        return K1b(model, config, extra_damping, plain_unit)
    if num_stones:
        return K1c(model, config, num_stones, plain_unit)
    return (K1hSi if config.split_impulse else K1a)(model, config, plain_unit)


# fp32 operations of the kernel's mesh narrowphase per (sphere, active face),
# by the region its walk (csrc/engine_k1.cu::closest_on_triangle) ends in:
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
    lam = q.new_zeros(q.shape[0], substep.num_rows)
    lim_act, con_act, walks = [], [], []
    for _ in range(config.llc_frames if kernel.pd_mode else 1):
        tau_j = gain * (tau - joint_q(model, q)) if kernel.pd_mode else tau
        Minv0 = substep.minv_of(forward_kinematics(model, q, qd))
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
            q, qd, info, lam = substep(q, qd, tau_j, scene, grab_active, grab_target,
                                       Minv_in=Minv0, lam_in=lam)
            con_act.append(info.contacts.active > 0.5)
    return torch.stack(lim_act), torch.stack(con_act), torch.stack(walks)


def k1_flops(kernel: EngineKernel, lim_act, con_act, *scene_inputs, tri_walk=None) -> int:
    """fp32 operations one call of ``kernel`` needs, summed over the batch,
    given the activity masks of :func:`k1_activity` and the call's packed
    scene inputs (stones; bars, grabs; the heightfield window; the faces), a
    multiply-add counting 2. A mesh call also needs ``tri_walk``, the
    narrowphase's operations per substep and env from :func:`k1_activity`.

    Every substep needs FK, the narrowphase, RNEA, the free velocity and the
    integration; each llc frame needs CRBA and the Cholesky factor once.
    Only an active row needs its W = L⁻¹Jᵀ row, its diagonal and its sweeps;
    only a row active in the substep before as well carries a warm-start λ;
    the impulse map runs only where some row is active. A contact's Jacobian
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
    position pass: per substep, for each active limit row and contact normal
    its sweeps (residual and apply, over the row's span), and where any is
    active the back substitution of z_pos and its addition to the velocity
    that advances the positions. PD mode adds the torque per llc frame.
    Rods and the planar lock are needed every substep: a rod takes its two
    anchors to the world frame, two point Jacobians over the
    anchors' ancestor joints, their difference, three dense W rows with
    their diagonals, targets, sweeps and (from the second substep of the
    call on) warm starts; a planar row is a unit row like a limit row. A
    grab is needed only where it is attached: its palm to the world frame,
    one point Jacobian, three dense rows like a rod's. The kernel today runs
    every row whether or not it is active, so it does more work than this
    count, even with masks of all ones."""
    model, config = kernel.model, kernel.config
    nl, nj, nv, ns = model.nl, model.nj, model.nv, model.ns
    lim = limited_joints(model)
    nlim = len(lim)
    iters = config.solver_iters
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
    rows = nlim * 12 + ns * 10
    integ = 2 * nv + 40 + nj * 6
    per_sub = fk + collide + rnea + free_vel + rows + integ
    # CRBA: per-link composite (~40), up-sweep (13), momentum per base axis
    # and joint (~39) plus one pair (11) per stored nonzero of M
    pairs = 21 + nj * 7 + int(sum(anc[j + 1, :j].sum() for j in range(nj)))
    crba = nl * 40 + (nl - 1) * 13 + (6 + nj) * 39 + pairs * 11
    chol = sum((nv - j) * 2 * j for j in range(nv)) + nv * 4
    # per active limit row (its W row starts at its column): forward solve,
    # diagonal, sweeps (residual + apply); its warm start
    span = torch.tensor([nv - (6 + j) for j in lim], dtype=torch.float64)
    lim_row = span * span + 2 * span + iters * (4 * span + 6)
    lim_warm = 2 * span
    # per active contact: Jacobian over the ancestor joints, three W rows
    # (dense forward solve and c), the normal diagonal and the tangent 2×2
    # (four dots + inverse), sweeps (normal, two tangent residuals, one
    # joint apply, the 2×2 step); its warm start of three rows
    n_anc = torch.tensor(anc[model.sph_link.cpu().numpy()].sum(axis=1), dtype=torch.float64)
    con_row = n_anc * 12 + 9 + 3 * (nv * nv + 2 * nv) + 4 * 2 * nv + 8 + iters * (12 * nv + 22)
    con_warm = torch.full((ns,), 3.0 * 2 * nv, dtype=torch.float64)
    la, ca = lim_act.cpu().double(), con_act.cpu().double()
    total = S * B * per_sub + frames * B * (crba + chol)
    total += float((la * lim_row).sum() + (ca * con_row).sum())
    total += float((la[1:] * la[:-1] * lim_warm).sum() + (ca[1:] * ca[:-1] * con_warm).sum())
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
    if named:
        # per active contact: the tangent basis (15) and three projections of
        # the 3 × nv point Jacobian (5 each)
        total += float(ca.sum()) * (15 + 3 * nv * 5)
    if kernel.pd_mode:
        total += frames * B * nj * 3
    if kernel.split:
        # position pass: residual and apply of each active limit row (over
        # its span) and contact normal (dense) per sweep; L⁻ᵀ z_pos and the
        # addition where any of them is active
        total += float((la * (iters * (4 * span + 7))).sum()) + float(ca.sum()) * iters * (
            4 * nv + 7)
        any_pos = lim_act.cpu().any(dim=2) | con_act.cpu().any(dim=2)
        total += float(any_pos.sum()) * (nv * nv + nv)
    spec = kernel.constraints
    dense_row = nv * nv + 2 * nv + 2 * nv + iters * (4 * nv + 6)   # W row, c, diagonal, sweeps
    eq_sub, eq_warm = 0.0, 0.0
    for la, lb in zip(spec.p2p_link_a, spec.p2p_link_b):
        eq_sub += 2 * 18 + (anc[la].sum() + anc[lb].sum()) * 12 + 2 * 9 + 3 * nv
        eq_sub += 3 * (dense_row + 6)
        eq_warm += 3 * 2 * nv
    if spec.planar:
        for col in (1, 3, 5):
            span = nv - col
            eq_sub += span * span + 2 * span + iters * (4 * span + 6) + 6
            eq_warm += 2 * span
        eq_sub += 6                                                # the two sine surrogates
    total += B * (S * eq_sub + (S - 1) * eq_warm)
    if grab_on is not None:
        attached = grab_on.double().sum(dim=0)                      # (ng,)
        for g, lg in enumerate(spec.grab_links):
            grab_sub = 18 + anc[lg].sum() * 12 + 9 + 3 * nv + 3 * (dense_row + 6)
            total += float(attached[g]) * (S * grab_sub + (S - 1) * 3 * 2 * nv)
    return int(round(total))


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
