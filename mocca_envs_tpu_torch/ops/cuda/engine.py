"""K1a: the fused engine kernel on Hopper, its wrapper and its plain version.

Counterpart of ``mocca_envs_tpu/ops/pallas/engine.py::make_pallas_substep``
in its K1a variant (plane, torque mode, no equality rows, the shipped
EngineConfig). The kernel is CUDA C++ in ``csrc/engine_k1a.cu``, built with
``nvcc`` for ``sm_90a`` into ``build/`` at first use and called through a
plain C interface with ``ctypes``.

- :class:`K1a` wraps one (model, config): :meth:`K1a.launch` launches the
  kernel on CUDA tensors and raises on anything else. The choice by device
  is made once, in ``ops/step.py::_make_llc_unit``; there is no fallback
  from one path to the other.
- :meth:`K1a.plain` is the plain PyTorch version: the port's ``ops/step.py``
  path run for one llc frame, on any device.
- ``LAUNCHES["k1a"]`` counts kernel launches (plain runs do not count).
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from mocca_envs_tpu_torch.models.schema import REVOLUTE, RobotModel
from mocca_envs_tpu_torch.ops.integrate import LIMIT_SLOP, MAX_VEL
from mocca_envs_tpu_torch.ops.kinematics import forward_kinematics, joint_q
from mocca_envs_tpu_torch.ops.step import limited_joints, make_plain_llc, make_substep
from mocca_envs_tpu_torch.terrain.scene import Scene
from mocca_envs_tpu_torch.utils.config import EngineConfig

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "engine_k1a.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
LIBRARY = BUILD_DIR / "libengine_k1a.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# (nl, ns, nlim, sim_substeps, solver_iters) → C symbol prefix in the source
INSTANTIATIONS = {(22, 14, 21, 4, 4): "k1a_nl22_ns14_nlim21_sub4_it4"}

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
        raise RuntimeError("nvcc not found: the K1a kernel needs the CUDA toolkit")
    return found


class _Library:
    """The built shared library, loaded once per process."""

    handle: ctypes.CDLL | None = None
    log: str = ""


def build() -> ctypes.CDLL:
    """Compile ``csrc/engine_k1a.cu`` (when the library is missing or older
    than the source) and load it. A failed build raises with nvcc's output;
    ``_Library.log`` keeps nvcc's register / spill report."""
    if _Library.handle is not None:
        return _Library.handle
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _Library.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{_Library.log}")
        os.replace(tmp, LIBRARY)
    lib = ctypes.CDLL(str(LIBRARY))
    for name in INSTANTIATIONS.values():
        getattr(lib, name + "_layout").argtypes = [ctypes.POINTER(_I), ctypes.POINTER(_I)]
        getattr(lib, name + "_layout").restype = _I
        fn = getattr(lib, name + "_launch")
        fn.argtypes = [_P] * 10 + [_I, _P, _I, _P]
        fn.restype = _I
    _Library.handle = lib
    return lib


def layout(lib, name: str) -> tuple[int, int]:
    """(table floats, workspace floats per env) of one instantiation."""
    table, ws = _I(), _I()
    getattr(lib, name + "_layout")(ctypes.byref(table), ctypes.byref(ws))
    return table.value, ws.value


def _check_supported(model: RobotModel, config: EngineConfig) -> str:
    if not model.floating or any(t != REVOLUTE for t in model.jtype):
        raise NotImplementedError("K1a covers floating-base all-revolute models")
    options = dict(block_pgs=True, matfree_pgs=True, warm_start=True,
                   reuse_factor=True, split_impulse=False)
    off = {k: getattr(config, k) for k, v in options.items() if getattr(config, k) != v}
    if off:
        raise NotImplementedError(f"K1a runs the shipped solver options; got {off}")
    key = (model.nl, model.ns, len(limited_joints(model)), config.sim_substeps,
           config.solver_iters)
    if key not in INSTANTIATIONS:
        raise NotImplementedError(
            f"no K1a instantiation for (nl, ns, nlim, substeps, iters) = {key}; "
            f"built: {sorted(INSTANTIATIONS)}"
        )
    return INSTANTIATIONS[key]


def pack_tables(model: RobotModel, config: EngineConfig) -> np.ndarray:
    """The packed f32 model table, in the order of ``Layout`` in the source."""
    m = {k: getattr(model, k).detach().cpu().numpy().astype(np.float64) for k in (
        "joint_quat", "joint_axis", "joint_pos", "com", "mass", "inertia",
        "sph_link", "sph_pos", "sph_radius", "damping", "stiffness",
        "spring_ref", "armature", "limit_lo", "limit_hi", "anc")}
    dt = config.dt
    scalars = [dt, *config.gravity, config.baumgarte / dt, config.slop,
               config.max_push_vel, config.cfm, config.contact_margin,
               config.limit_margin, LIMIT_SLOP, MAX_VEL]
    joint_diag = dt * (m["damping"] + dt * m["stiffness"]) + m["armature"]
    parts = [
        scalars, model.parent, m["joint_quat"], m["joint_axis"], m["joint_pos"],
        m["com"], m["mass"], m["inertia"], m["sph_link"], m["sph_pos"],
        m["sph_radius"], m["damping"], m["stiffness"], m["spring_ref"], joint_diag,
        m["limit_lo"], m["limit_hi"], limited_joints(model), m["anc"],
    ]
    return np.concatenate([np.asarray(p, dtype=np.float64).ravel() for p in parts]).astype(
        np.float32
    )


class K1a:
    """One llc frame of one (model, config) on a batch:

    ``launch`` / ``plain``: ``(q (B,nq), qd (B,nv), tau (B,nj), ground_z (B,),
    friction (B,)) → (q', qd', depth (B,ns), normal_impulse (B,ns))``, all f32.
    ``plain_unit`` is the plain llc frame to compare against (built here
    when not given).
    """

    def __init__(self, model: RobotModel, config: EngineConfig, plain_unit=None):
        self.name = _check_supported(model, config)
        self.model = model
        self.config = config
        self.table_host = pack_tables(model, config)
        self._plain_unit = plain_unit
        self._table: torch.Tensor | None = None
        self._ws: torch.Tensor | None = None

    def plain(self, q, qd, tau, ground_z, friction):
        """The plain PyTorch version on any device (never counted)."""
        if self._plain_unit is None:
            self._plain_unit = make_plain_llc(self.model, self.config)
        qq, dd, info = self._plain_unit(q, qd, tau, Scene(ground_z=ground_z, friction=friction))
        return qq, dd, info.contacts.depth, info.normal_impulse

    def _check_inputs(self, q, qd, tau, ground_z, friction) -> int:
        B = q.shape[0]
        m = self.model
        want = {"q": (q, (B, m.nq)), "qd": (qd, (B, m.nv)), "tau": (tau, (B, m.nj)),
                "ground_z": (ground_z, (B,)), "friction": (friction, (B,))}
        for name, (x, shape) in want.items():
            if x.device.type != "cuda" or x.device != q.device:
                raise ValueError(f"K1a: {name} must be on {q.device} (CUDA), got {x.device}")
            if x.dtype != torch.float32:
                raise TypeError(f"K1a: {name} must be float32, got {x.dtype}")
            if tuple(x.shape) != shape:
                raise ValueError(f"K1a: {name} has shape {tuple(x.shape)}, want {shape}")
            if not x.is_contiguous():
                raise ValueError(f"K1a: {name} must be contiguous")
        return B

    def launch(self, q, qd, tau, ground_z, friction):
        """Launch the kernel on the current stream; raises on any failure."""
        B = self._check_inputs(q, qd, tau, ground_z, friction)
        lib = build()
        table_size, ws_per_env = layout(lib, self.name)
        if table_size != self.table_host.size:
            raise RuntimeError(
                f"K1a table layout mismatch: source wants {table_size}, "
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
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = getattr(lib, self.name + "_launch")(
                q.data_ptr(), qd.data_ptr(), tau.data_ptr(), ground_z.data_ptr(),
                friction.data_ptr(), q_out.data_ptr(), qd_out.data_ptr(),
                depth.data_ptr(), nimp.data_ptr(), self._table.data_ptr(),
                table_size, self._ws.data_ptr(), B, stream,
            )
        if err != 0:
            raise RuntimeError(f"K1a launch failed: cudaError {err}")
        LAUNCHES["k1a"] += 1
        return q_out, qd_out, depth, nimp


def k1a_activity(model: RobotModel, config: EngineConfig, q, qd, tau, ground_z, friction):
    """Which rows each substep of one K1a call needs, on these inputs: limit
    rows within the limit margin and spheres within the contact margin, at
    each substep's start state, taken from the plain version's run of the
    frame. Returns bool masks ``(limits (S,B,nlim), contacts (S,B,ns))``."""
    substep = make_substep(model, config)
    lim = torch.as_tensor(limited_joints(model), dtype=torch.long, device=q.device)
    scene = Scene(ground_z=ground_z, friction=friction)
    Minv0 = substep.minv_of(forward_kinematics(model, q, qd))
    lam = q.new_zeros(q.shape[0], substep.num_rows)
    lim_act, con_act = [], []
    for _ in range(config.sim_substeps):
        qj = joint_q(model, q)[:, lim]
        gap = torch.minimum(qj - model.limit_lo[lim], model.limit_hi[lim] - qj)
        lim_act.append(gap < config.limit_margin)
        q, qd, info, lam = substep(q, qd, tau, scene, Minv_in=Minv0, lam_in=lam)
        con_act.append(info.contacts.active > 0.5)
    return torch.stack(lim_act), torch.stack(con_act)


def k1a_flops(model: RobotModel, config: EngineConfig, lim_act, con_act) -> int:
    """fp32 operations one K1a call needs, summed over the batch, given the
    activity masks of :func:`k1a_activity` (a multiply-add counts 2).

    Every substep needs FK, the narrowphase, RNEA, the free velocity and the
    integration; the frame needs CRBA and the Cholesky factor once. Only an
    active row needs its W = L⁻¹Jᵀ row, its diagonal and its sweeps; only a
    row active in the substep before as well carries a warm-start λ; the
    impulse map runs only where some row is active. A contact's Jacobian
    takes a cross product per ancestor joint of its sphere's link. The
    kernel today runs every row whether or not it is active, so it does
    more work than this count, even with masks of all ones."""
    nl, nj, nv, ns = model.nl, model.nj, model.nv, model.ns
    lim = limited_joints(model)
    nlim = len(lim)
    iters = config.solver_iters
    anc = model.anc.cpu().numpy() > 0.5
    S, B = con_act.shape[:2]
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
    total = S * B * per_sub + B * (crba + chol)
    total += float((la * lim_row).sum() + (ca * con_row).sum())
    total += float((la[1:] * la[:-1] * lim_warm).sum() + (ca[1:] * ca[:-1] * con_warm).sum())
    any_act = (lim_act.any(dim=2) | con_act.any(dim=2)).sum()
    total += float(any_act) * (nv * nv)
    return int(round(total))


def k1a_bytes_per_env(model: RobotModel) -> int:
    """Bytes one env must move: each input read once, each output written
    once (q, qd, tau, ground_z, friction in; q', qd', depth, impulse out)."""
    inputs = model.nq + model.nv + model.nj + 2
    outputs = model.nq + model.nv + 2 * model.ns
    return 4 * (inputs + outputs)
