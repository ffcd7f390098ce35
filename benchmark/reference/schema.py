"""RobotModel: the precompiled kinematic tree, on a torch device.

Frozen copy of the port's ``models/schema.py``. The builder works on
numpy at build time; :meth:`ModelBuilder.
build` then moves every array onto a device as a tensor. The canonical form:

- links are topologically ordered (``parent[i] < i``), link 0 is the base;
- every non-base link hangs off one 1-DoF joint; joint ``j`` moves link
  ``j + 1``; fixed joints are folded into their parent at build time;
- the base is floating (7 position / 6 velocity coordinates prepended) or
  fixed;
- collision geometry is a static set of spheres attached to links.

Generalized coordinates (floating base):
    q  = [base_pos(3), base_quat_wxyz(4), joint_q(nj)]
    qd = [base_linvel_world(3), base_angvel_world(3), joint_qd(nj)]
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Joint type codes (static ints), the same values as the port's.
REVOLUTE = 0
PRISMATIC = 1
FIXED = 2  # builder-only; folded away before RobotModel is emitted

# Fields holding per-joint / per-link / per-sphere arrays, in declaration
# order; the rest of RobotModel is static topology.
ARRAY_FIELDS = (
    "joint_pos", "joint_quat", "joint_axis", "limit_lo", "limit_hi",
    "damping", "stiffness", "spring_ref", "armature", "actuated",
    "power_coef", "kp", "kd", "mass", "com", "inertia", "sph_link",
    "sph_pos", "sph_radius", "sph_foot", "sph_no_bar", "anc",
    "mirror_act_perm", "mirror_act_sign",
)
INDEX_FIELDS = ("sph_link", "mirror_act_perm")   # int64 tensors
STATIC_FIELDS = (
    "nl", "nj", "parent", "jtype", "floating", "link_names", "joint_names",
    "foot_links",
)


def _np_quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def _np_quat_to_mat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rpy_to_quat(rpy) -> np.ndarray:
    """URDF fixed-axis rpy → wxyz quaternion (host-side, build time)."""
    r, p, y = np.asarray(rpy, dtype=np.float64) * 0.5
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    return np.array(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ]
    )


@dataclasses.dataclass(frozen=True, eq=False)
class RobotModel:
    """Static-shape robot description; tensors live on one device."""

    # ---- static topology
    nl: int
    nj: int
    parent: tuple        # len nl; parent[0] = -1
    jtype: tuple         # len nj; REVOLUTE/PRISMATIC
    floating: bool
    link_names: tuple
    joint_names: tuple
    foot_links: tuple    # foot names whose spheres feed the contact flags

    # ---- joint frame data, indexed by joint j (moving link j+1)
    joint_pos: torch.Tensor     # (nj, 3) anchor in parent link frame
    joint_quat: torch.Tensor    # (nj, 4) parent frame → child pre-frame
    joint_axis: torch.Tensor    # (nj, 3) unit axis in child frame
    limit_lo: torch.Tensor      # (nj,)
    limit_hi: torch.Tensor      # (nj,)
    damping: torch.Tensor       # (nj,) passive viscous damping
    stiffness: torch.Tensor     # (nj,) passive spring k
    spring_ref: torch.Tensor    # (nj,) spring setpoint angle
    armature: torch.Tensor      # (nj,) reflected rotor inertia
    actuated: torch.Tensor      # (nj,) 1.0 where motorized
    power_coef: torch.Tensor    # (nj,) per-joint torque gain
    kp: torch.Tensor            # (nj,)
    kd: torch.Tensor            # (nj,)

    # ---- inertial data, indexed by link i
    mass: torch.Tensor          # (nl,)
    com: torch.Tensor           # (nl, 3) COM offset in link frame
    inertia: torch.Tensor       # (nl, 3, 3) about COM, link frame

    # ---- collision spheres
    sph_link: torch.Tensor      # (ns,) int64 owning link
    sph_pos: torch.Tensor       # (ns, 3) offset in link frame
    sph_radius: torch.Tensor    # (ns,)
    sph_foot: torch.Tensor      # (ns, nfeet) one-hot foot membership
    sph_no_bar: torch.Tensor    # (ns,) 1.0 = skips bar capsules

    # ---- ancestry: anc[i, j] = 1.0 iff joint j is on the base→link-i chain
    anc: torch.Tensor           # (nl, nj)

    # ---- action mirror maps
    mirror_act_perm: torch.Tensor   # (nj,) int64
    mirror_act_sign: torch.Tensor   # (nj,)

    @property
    def ns(self) -> int:
        return self.sph_radius.shape[0]

    @property
    def nq(self) -> int:
        return (7 if self.floating else 0) + self.nj

    @property
    def nv(self) -> int:
        return (6 if self.floating else 0) + self.nj

    @property
    def nu(self) -> int:
        return self.nj

    @property
    def device(self) -> torch.device:
        return self.mass.device

    def replace(self, **changes) -> "RobotModel":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "RobotModel":
        return self.replace(**{f: getattr(self, f).to(device) for f in ARRAY_FIELDS})


@dataclasses.dataclass
class _Link:
    name: str
    parent: int
    jtype: int
    joint_pos: np.ndarray
    joint_quat: np.ndarray
    joint_axis: np.ndarray
    limit: tuple
    damping: float
    stiffness: float
    spring_ref: float
    armature: float
    actuated: bool
    power_coef: float
    kp: float
    kd: float
    mass: float
    com: np.ndarray
    inertia: np.ndarray


class ModelBuilder:
    """Host-side builder: add links, fold fixed joints, emit a RobotModel."""

    def __init__(self, name: str, floating: bool = True):
        self.name = name
        self.floating = floating
        self.links: list[_Link] = [
            _Link(
                "base", -1, FIXED,
                np.zeros(3), np.array([1.0, 0, 0, 0]), np.array([0.0, 0, 1]),
                (0.0, 0.0), 0.0, 0.0, 0.0, 0.0, False, 0.0, 0.0, 0.0,
                0.0, np.zeros(3), np.zeros((3, 3)),
            )
        ]
        self.spheres: list[tuple] = []   # (link_idx, pos, radius, foot, no_bar)
        self.foot_names: list[str] = []

    def base_inertial(self, mass, com, inertia_diag=None, inertia=None):
        b = self.links[0]
        b.mass = float(mass)
        b.com = np.asarray(com, dtype=np.float64)
        b.inertia = self._inertia(inertia_diag, inertia)
        return self

    @staticmethod
    def _inertia(diag, full):
        if full is not None:
            return np.asarray(full, dtype=np.float64)
        return np.diag(np.asarray(diag, dtype=np.float64))

    def add_link(
        self,
        name: str,
        parent: str,
        *,
        jtype: int = REVOLUTE,
        joint_pos=(0, 0, 0),
        joint_rpy=(0, 0, 0),
        joint_quat=None,   # wxyz; overrides joint_rpy when given
        joint_axis=(0, 0, 1),
        limit=(-np.pi, np.pi),
        damping: float = 0.0,
        stiffness: float = 0.0,
        spring_ref: float = 0.0,
        armature: float = 0.0,
        actuated: bool = True,
        power_coef: float = 0.0,
        kp: float = 0.0,
        kd: float = 0.0,
        mass: float = 0.0,
        com=(0, 0, 0),
        inertia_diag=(0, 0, 0),
        inertia=None,
    ) -> "ModelBuilder":
        pidx = self.link_index(parent)
        axis = np.asarray(joint_axis, dtype=np.float64)
        n = np.linalg.norm(axis)
        axis = axis / n if n > 0 else np.array([0.0, 0.0, 1.0])
        if joint_quat is not None:
            jq = np.asarray(joint_quat, dtype=np.float64)
            jq = jq / np.linalg.norm(jq)
        else:
            jq = rpy_to_quat(joint_rpy)
        self.links.append(
            _Link(
                name, pidx, jtype,
                np.asarray(joint_pos, dtype=np.float64), jq, axis,
                (float(limit[0]), float(limit[1])), float(damping), float(stiffness),
                float(spring_ref), float(armature), bool(actuated), float(power_coef),
                float(kp), float(kd), float(mass),
                np.asarray(com, dtype=np.float64),
                self._inertia(inertia_diag, inertia),
            )
        )
        return self

    def add_sphere(self, link: str, pos, radius: float, foot: str | None = None,
                   no_bar: bool = False):
        """Attach a collision sphere; ``foot`` groups spheres into obs flags;
        ``no_bar`` excludes it from bar-capsule narrowphase."""
        if foot is not None and foot not in self.foot_names:
            self.foot_names.append(foot)
        self.spheres.append(
            (self.link_index(link), np.asarray(pos, dtype=np.float64),
             float(radius), foot, bool(no_bar))
        )
        return self

    def link_index(self, name: str) -> int:
        for i, l in enumerate(self.links):
            if l.name == name:
                return i
        raise KeyError(f"unknown link {name!r} in model {self.name!r}")

    def _fold_fixed(self):
        """Merge FIXED-jointed links into their parents (offline, exact)."""
        while True:
            fixed_idx = next(
                (i for i, l in enumerate(self.links) if i > 0 and l.jtype == FIXED), None
            )
            if fixed_idx is None:
                break
            child = self.links[fixed_idx]
            p = child.parent
            parent = self.links[p]
            R = _np_quat_to_mat(child.joint_quat)
            t = child.joint_pos
            m1, m2 = parent.mass, child.mass
            c2_in_p = t + R @ child.com
            c_new = (m1 * parent.com + m2 * c2_in_p) / (m1 + m2) if m1 + m2 > 0 else parent.com
            I2_p = R @ child.inertia @ R.T

            def _shift(I, m, d):
                return I + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

            parent.inertia = _shift(parent.inertia, m1, parent.com - c_new) + _shift(
                I2_p, m2, c2_in_p - c_new
            )
            parent.mass = m1 + m2
            parent.com = c_new
            for l in self.links:
                if l.parent == fixed_idx:
                    l.parent = p
                    l.joint_pos = t + R @ l.joint_pos
                    l.joint_quat = _np_quat_mul(child.joint_quat, l.joint_quat)
            self.spheres = [
                (p, t + R @ pos, r, foot, nb) if li == fixed_idx else (li, pos, r, foot, nb)
                for (li, pos, r, foot, nb) in self.spheres
            ]
            del self.links[fixed_idx]
            for l in self.links:
                if l.parent > fixed_idx:
                    l.parent -= 1
            self.spheres = [
                (li - 1 if li > fixed_idx else li, pos, r, foot, nb)
                for (li, pos, r, foot, nb) in self.spheres
            ]

    def build_numpy(self) -> dict:
        """Fold fixed joints and return every RobotModel field, arrays as
        float64/int64 numpy (the form :func:`model_from_numpy` takes)."""
        self._fold_fixed()
        nl = len(self.links)
        nj = nl - 1
        for i, l in enumerate(self.links):
            if i > 0 and not (0 <= l.parent < i):
                raise ValueError(
                    f"link {l.name!r}: parent index {l.parent} breaks topological order"
                )
        J = self.links[1:]
        anc = np.zeros((nl, nj))
        for i in range(1, nl):
            k = i
            while k > 0:
                anc[i, k - 1] = 1.0
                k = self.links[k].parent

        nfeet = max(1, len(self.foot_names))
        nsph = max(1, len(self.spheres))
        sph_foot = np.zeros((nsph, nfeet))
        sph_no_bar = np.zeros((nsph,))
        if self.spheres:
            sph_link = np.array([s[0] for s in self.spheres], dtype=np.int64)
            sph_pos = np.stack([s[1] for s in self.spheres])
            sph_radius = np.array([s[2] for s in self.spheres])
            for si, (_, _, _, foot, no_bar) in enumerate(self.spheres):
                if foot is not None:
                    sph_foot[si, self.foot_names.index(foot)] = 1.0
                if no_bar:
                    sph_no_bar[si] = 1.0
        else:  # keep shapes static and non-empty
            sph_link = np.zeros((1,), dtype=np.int64)
            sph_pos = np.zeros((1, 3))
            sph_radius = np.full((1,), -1e6)  # never collides

        def a(x, shape=None):
            arr = np.asarray(x, dtype=np.float64)
            return arr.reshape(shape) if shape is not None else arr

        return dict(
            nl=nl,
            nj=nj,
            parent=tuple(l.parent for l in self.links),
            jtype=tuple(l.jtype for l in J),
            floating=self.floating,
            link_names=tuple(l.name for l in self.links),
            joint_names=tuple(l.name for l in J),
            foot_links=tuple(self.foot_names),
            joint_pos=a([l.joint_pos for l in J], (nj, 3)),
            joint_quat=a([l.joint_quat for l in J], (nj, 4)),
            joint_axis=a([l.joint_axis for l in J], (nj, 3)),
            limit_lo=a([l.limit[0] for l in J]),
            limit_hi=a([l.limit[1] for l in J]),
            damping=a([l.damping for l in J]),
            stiffness=a([l.stiffness for l in J]),
            spring_ref=a([l.spring_ref for l in J]),
            armature=a([l.armature for l in J]),
            actuated=a([1.0 if l.actuated else 0.0 for l in J]),
            power_coef=a([l.power_coef for l in J]),
            kp=a([l.kp for l in J]),
            kd=a([l.kd for l in J]),
            mass=a([l.mass for l in self.links]),
            com=a([l.com for l in self.links]),
            inertia=a([l.inertia for l in self.links]),
            sph_link=sph_link,
            sph_pos=a(sph_pos),
            sph_radius=a(sph_radius),
            sph_foot=sph_foot,
            sph_no_bar=sph_no_bar,
            anc=anc,
            mirror_act_perm=np.arange(nj, dtype=np.int64),
            mirror_act_sign=np.ones(nj),
        )

    def build(self, device="cpu", dtype=torch.float32) -> RobotModel:
        return model_from_numpy(self.build_numpy(), device=device, dtype=dtype)


def model_from_numpy(fields: dict, device="cpu", dtype=torch.float32) -> RobotModel:
    """RobotModel from a dict of every field: numpy (or array-like) arrays
    and the static topology. Arrays are cast like the port's builder casts them
    (f32 through a float64 intermediate), indices to int64."""
    missing = [f for f in STATIC_FIELDS + ARRAY_FIELDS if f not in fields]
    if missing:
        raise KeyError(f"RobotModel fields missing: {missing}")
    kw = {}
    for f in STATIC_FIELDS:
        v = fields[f]
        kw[f] = tuple(v) if isinstance(v, (list, tuple)) else v
    kw["nl"], kw["nj"], kw["floating"] = int(kw["nl"]), int(kw["nj"]), bool(kw["floating"])
    kw["parent"] = tuple(int(p) for p in kw["parent"])
    kw["jtype"] = tuple(int(t) for t in kw["jtype"])
    for f in ARRAY_FIELDS:
        arr = np.asarray(fields[f])
        if f in INDEX_FIELDS:
            kw[f] = torch.as_tensor(arr.astype(np.int64), device=device)
        else:
            # f64 → f32 on the host first: one rounding on every device
            kw[f] = torch.as_tensor(arr.astype(np.float64).astype(np.float32),
                                    device=device).to(dtype)
    return RobotModel(**kw)
