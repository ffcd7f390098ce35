"""Offline URDF compiler: URDF XML → RobotModel on a torch device.

Counterpart of ``mocca_envs_tpu/models/urdf.py``, with its own copy of the
parser: the same XML gives the same numpy arithmetic, so the same float32
fields in both packages. Parsing happens on the host at build time; the
builder then moves the arrays onto ``device``. Supported subset:
revolute/continuous/prismatic/fixed joints (fixed folded by the builder),
full inertia tensors with rotated inertial frames, and sphere/capsule/
cylinder/box collision primitives canonicalized to collision spheres:

- sphere   → itself
- capsule / cylinder → end spheres (+ middle sphere when long)
- box      → corner spheres of radius min(half-extent), inset

Mesh collision geometry is approximated by a single sphere at the mesh
origin with an explicit warning.
"""

from __future__ import annotations

import logging
import xml.etree.ElementTree as ET

import numpy as np

from mocca_envs_tpu_torch.models.schema import (
    FIXED,
    PRISMATIC,
    REVOLUTE,
    ModelBuilder,
    RobotModel,
    rpy_to_quat,
    _np_quat_to_mat,
)

logger = logging.getLogger(__name__)

_JTYPES = {
    "revolute": REVOLUTE,
    "continuous": REVOLUTE,
    "prismatic": PRISMATIC,
    "fixed": FIXED,
}


def _floats(s: str | None, default=(0.0, 0.0, 0.0)):
    if not s:
        return np.asarray(default, dtype=np.float64)
    return np.asarray([float(v) for v in s.split()], dtype=np.float64)


def _parse_inertial(link_el):
    el = link_el.find("inertial")
    if el is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    origin = el.find("origin")
    xyz = _floats(origin.get("xyz") if origin is not None else None)
    rpy = _floats(origin.get("rpy") if origin is not None else None)
    mass = float(el.find("mass").get("value")) if el.find("mass") is not None else 0.0
    iel = el.find("inertia")
    if iel is None:
        I = np.zeros((3, 3))
    else:
        g = lambda k: float(iel.get(k, "0"))
        I = np.array(
            [
                [g("ixx"), g("ixy"), g("ixz")],
                [g("ixy"), g("iyy"), g("iyz")],
                [g("ixz"), g("iyz"), g("izz")],
            ]
        )
    R = _np_quat_to_mat(rpy_to_quat(rpy))
    return mass, xyz, R @ I @ R.T


def _collision_spheres(link_el):
    """Yield (pos, radius, foot, no_bar) canonical spheres for a link's
    collision geoms. ``foot``/``no_bar`` come from the ``mocca_foot`` /
    ``mocca_no_bar`` vendor attributes written by models/urdf_export.py
    (None / False when absent — plain third-party URDF)."""
    for col in link_el.findall("collision"):
        vfoot = col.get("mocca_foot")
        vno_bar = col.get("mocca_no_bar") == "1"
        vorder = col.get("mocca_order")
        vorder = int(vorder) if vorder is not None else None
        origin = col.find("origin")
        xyz = _floats(origin.get("xyz") if origin is not None else None)
        rpy = _floats(origin.get("rpy") if origin is not None else None)
        R = _np_quat_to_mat(rpy_to_quat(rpy))
        geom = col.find("geometry")
        if geom is None:
            continue
        sph = geom.find("sphere")
        cap = geom.find("capsule") if geom.find("capsule") is not None else geom.find("cylinder")
        box = geom.find("box")
        mesh = geom.find("mesh")
        if sph is not None:
            yield xyz, float(sph.get("radius")), vfoot, vno_bar, vorder
        elif cap is not None:
            r = float(cap.get("radius"))
            L = float(cap.get("length", "0"))
            ends = [-L / 2, L / 2] if L > 1e-9 else [0.0]
            if L > 4 * r:
                ends.append(0.0)
            for e in ends:
                yield xyz + R @ np.array([0.0, 0.0, e]), r, vfoot, vno_bar, vorder
        elif box is not None:
            half = _floats(box.get("size")) / 2.0
            r = float(max(min(half), 1e-3))
            inset = np.maximum(half - r, 0.0)
            for sx in (-1, 1):
                for sy in (-1, 1):
                    for sz in (-1, 1):
                        p = np.array([sx, sy, sz]) * inset
                        yield xyz + R @ p, r, vfoot, vno_bar, vorder
        elif mesh is not None:
            logger.warning(
                "mesh collision geometry approximated by a single sphere "
                "(file=%s)", mesh.get("filename")
            )
            yield xyz, 0.05, vfoot, vno_bar, vorder


def parse_urdf(
    source: str,
    *,
    floating: bool = True,
    default_power_coef: float = 40.0,
    foot_link_keywords: tuple = ("foot", "ankle", "toe"),
    device="cpu",
) -> RobotModel:
    """Compile a URDF document (path or XML string) into a RobotModel whose
    tensors live on ``device``.

    ``foot_link_keywords`` tags links whose collision spheres feed the obs
    contact flags.
    """
    text = source
    if not source.lstrip().startswith("<"):
        with open(source) as f:
            text = f.read()
    root = ET.fromstring(text)
    if root.tag != "robot":
        raise ValueError(f"not a URDF document (root tag {root.tag!r})")

    links = {l.get("name"): l for l in root.findall("link")}
    joints = list(root.findall("joint"))

    # find root link: a link that is never a child
    children = {j.find("child").get("link") for j in joints}
    roots = [n for n in links if n not in children]
    if len(roots) != 1:
        raise ValueError(f"expected exactly one root link, got {roots}")
    root_link = roots[0]

    b = ModelBuilder(root.get("name", "urdf_robot"), floating=floating)
    mass, com, inertia = _parse_inertial(links[root_link])
    b.base_inertial(mass, com, inertia=inertia)
    name_map = {root_link: "base"}

    # BFS over joints so parents are added before children
    remaining = list(joints)
    while remaining:
        progressed = False
        for j in list(remaining):
            parent = j.find("parent").get("link")
            child = j.find("child").get("link")
            if parent not in name_map:
                continue
            remaining.remove(j)
            progressed = True
            jtype = _JTYPES.get(j.get("type"))
            if jtype is None:
                raise ValueError(f"unsupported joint type {j.get('type')!r}")
            origin = j.find("origin")
            xyz = _floats(origin.get("xyz") if origin is not None else None)
            rpy = _floats(origin.get("rpy") if origin is not None else None)
            axis_el = j.find("axis")
            axis = _floats(axis_el.get("xyz") if axis_el is not None else None, (1, 0, 0))
            limit_el = j.find("limit")
            if j.get("type") == "continuous" or limit_el is None:
                limit = (-np.pi, np.pi) if jtype == REVOLUTE else (-1.0, 1.0)
                effort = default_power_coef
            else:
                limit = (
                    float(limit_el.get("lower", -np.pi)),
                    float(limit_el.get("upper", np.pi)),
                )
                effort = float(limit_el.get("effort", default_power_coef))
            dyn = j.find("dynamics")
            damping = float(dyn.get("damping", "0")) if dyn is not None else 0.0
            # vendor extension (models/urdf_export.py): engine constants URDF
            # has no vocabulary for — Cassie leaf springs, rotor armature,
            # PD gains, unactuated passive joints (reference behavior B3)
            mx = j.find("mocca_dynamics")
            mg = (lambda k, d="0": float(mx.get(k, d))) if mx is not None else None
            mass, com, inertia = _parse_inertial(links[child])
            b.add_link(
                child,
                name_map[parent],
                jtype=jtype,
                joint_pos=xyz,
                joint_rpy=rpy,
                joint_axis=axis,
                limit=limit,
                damping=damping,
                stiffness=mg("stiffness") if mx is not None else 0.0,
                spring_ref=mg("spring_ref") if mx is not None else 0.0,
                armature=mg("armature") if mx is not None else 0.0,
                kp=mg("kp") if mx is not None else 0.0,
                kd=mg("kd") if mx is not None else 0.0,
                actuated=(
                    mg("actuated", "1") > 0.5 if mx is not None else jtype != FIXED
                ),
                power_coef=effort,
                mass=mass,
                com=com,
                inertia=inertia,
            )
            name_map[child] = child
        if not progressed:
            raise ValueError(f"disconnected joints: {[j.get('name') for j in remaining]}")

    # collision spheres (after all links exist; fixed-fold remaps them)
    pending = []
    for urdf_name, el in links.items():
        target = name_map.get(urdf_name)
        if target is None:
            continue
        foot = None
        lowered = urdf_name.lower()
        if any(k in lowered for k in foot_link_keywords):
            foot = urdf_name
        for pos, radius, vfoot, vno_bar, vorder in _collision_spheres(el):
            # vendor attributes override the link-name heuristic
            pending.append(
                (vorder, len(pending), target, pos, radius,
                 vfoot if vfoot is not None else foot, vno_bar)
            )
    # exporter-stamped ``mocca_order`` restores the original sphere
    # enumeration (document order is link-major otherwise), so
    # parse(export(model)) reproduces sph_* arrays and foot-column order
    # EXACTLY (obs foot-flag layout is order-sensitive, behavior B4)
    if pending and all(p[0] is not None for p in pending):
        pending.sort(key=lambda p: p[0])
    for _, _, target, pos, radius, foot, no_bar in pending:
        b.add_sphere(target, pos, radius, foot=foot, no_bar=no_bar)

    return b.build(device=device)
