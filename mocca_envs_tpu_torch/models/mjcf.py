"""Offline MJCF compiler: MuJoCo XML → RobotModel on a torch device.

Counterpart of ``mocca_envs_tpu/models/mjcf.py``, with its own copy of the
parser (the same numpy arithmetic, so the same float32 fields). Host-side,
build-time only. Supported subset (what locomotion MJCF files use):

- nested ``<body>`` trees with ``pos`` / ``quat`` / ``euler`` frames;
- ``<joint type="hinge|slide">`` with ``axis``, ``pos`` (anchor offsets are
  re-rooted into the child frame), ``range``, ``damping``, ``stiffness``,
  ``armature``; multiple joints per body become stacked intermediate links
  (the builder's canonical one-joint-per-link form); a root
  ``<joint type="free">`` (or ``<freejoint/>``) selects the floating base;
- ``<geom type="sphere|capsule|box">`` (``fromto`` or ``pos``+``size``)
  canonicalized to collision spheres;
- ``<inertial>`` (explicit) or a crude sphere-mass fallback;
- ``<motor>`` actuators map ``gear`` onto ``power_coef``.

Degrees/radians: MJCF defaults to degrees for angles unless
``<compiler angle="radian">`` — both honored.
"""

from __future__ import annotations

import logging
import xml.etree.ElementTree as ET

import numpy as np

from mocca_envs_tpu_torch.models.schema import (
    PRISMATIC,
    REVOLUTE,
    ModelBuilder,
    RobotModel,
    _np_quat_to_mat,
)

logger = logging.getLogger(__name__)


def _floats(s, default=None, n=None):
    if s is None:
        return None if default is None else np.asarray(default, dtype=np.float64)
    v = np.asarray([float(x) for x in s.split()], dtype=np.float64)
    return v


def _frame_quat(el, deg: bool) -> np.ndarray:
    q = _floats(el.get("quat"))
    if q is not None:
        return q / np.linalg.norm(q)  # MJCF quat is wxyz already
    e = _floats(el.get("euler"))
    if e is not None:
        from mocca_envs_tpu_torch.models.schema import rpy_to_quat

        return rpy_to_quat(np.deg2rad(e) if deg else e)
    return np.array([1.0, 0.0, 0.0, 0.0])


def _geom_spheres(gel, deg: bool):
    gtype = gel.get("type", "sphere" if gel.get("size") else "capsule")
    size = _floats(gel.get("size"), default=(0.05,))
    fromto = _floats(gel.get("fromto"))
    pos = _floats(gel.get("pos"), default=(0, 0, 0))
    if gtype == "sphere":
        yield pos, float(size[0])
    elif gtype == "capsule":
        r = float(size[0])
        if fromto is not None:
            a, c = fromto[:3], fromto[3:]
        else:
            half = float(size[1]) if size.shape[0] > 1 else 0.0
            R = _np_quat_to_mat(_frame_quat(gel, deg))
            a = pos + R @ np.array([0, 0, -half])
            c = pos + R @ np.array([0, 0, half])
        pts = [a, c]
        if np.linalg.norm(np.asarray(c) - np.asarray(a)) > 4 * r:
            pts.append(0.5 * (np.asarray(a) + np.asarray(c)))
        for p in pts:
            yield np.asarray(p, dtype=np.float64), r
    elif gtype == "box":
        half = size[:3]
        r = float(max(min(half), 1e-3))
        inset = np.maximum(half - r, 0.0)
        R = _np_quat_to_mat(_frame_quat(gel, deg))
        for sx in (-1, 1):
            for sy in (-1, 1):
                for sz in (-1, 1):
                    yield pos + R @ (np.array([sx, sy, sz]) * inset), r
    else:
        logger.warning("unsupported geom type %r → single sphere", gtype)
        yield pos, 0.05


def _inertial_of(body, deg: bool):
    el = body.find("inertial")
    if el is not None:
        mass = float(el.get("mass", "0"))
        com = _floats(el.get("pos"), default=(0, 0, 0))
        diag = _floats(el.get("diaginertia"))
        if diag is not None:
            I = np.diag(diag)
        else:
            full = _floats(el.get("fullinertia"))
            if full is not None:
                ixx, iyy, izz, ixy, ixz, iyz = full
                I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
            else:
                I = np.zeros((3, 3))
        R = _np_quat_to_mat(_frame_quat(el, deg))
        return mass, com, R @ I @ R.T
    # fallback: lump geom volumes as point masses (crude, warns)
    mass, com = 0.0, np.zeros(3)
    for g in body.findall("geom"):
        m = float(g.get("mass", "1.0"))
        p = _floats(g.get("pos"), default=(0, 0, 0))
        com = (com * mass + p * m) / max(mass + m, 1e-9)
        mass += m
    if mass > 0:
        logger.warning("body %r lacks <inertial>; using geom point masses", body.get("name"))
    I = np.eye(3) * max(mass, 1e-3) * 0.01
    return mass, com, I


def parse_mjcf(
    source: str,
    *,
    default_power_coef: float = 40.0,
    foot_link_keywords: tuple = ("foot", "ankle", "toe"),
    device="cpu",
) -> RobotModel:
    """Compile an MJCF document (path or XML string) into a RobotModel whose
    tensors live on ``device``."""
    text = source
    if not source.lstrip().startswith("<"):
        with open(source) as f:
            text = f.read()
    root = ET.fromstring(text)
    if root.tag != "mujoco":
        raise ValueError(f"not an MJCF document (root tag {root.tag!r})")
    compiler = root.find("compiler")
    deg = (compiler.get("angle", "degree") if compiler is not None else "degree") == "degree"
    world = root.find("worldbody")
    if world is None:
        raise ValueError("MJCF missing <worldbody>")
    bodies = world.findall("body")
    if len(bodies) != 1:
        raise ValueError(f"expected one root body, got {len(bodies)}")
    rb = bodies[0]

    # actuator gears keyed by joint name (behavior B2 power_coef)
    gears: dict[str, float] = {}
    act = root.find("actuator")
    if act is not None:
        for m in act.findall("motor"):
            gears[m.get("joint", "")] = float(m.get("gear", default_power_coef))

    joints0 = rb.findall("joint") + rb.findall("freejoint")
    floating = any(
        j.tag == "freejoint" or j.get("type") == "free" for j in joints0
    )
    b = ModelBuilder(rb.get("name", "mjcf_robot"), floating=floating)
    mass, com, I = _inertial_of(rb, deg)
    b.base_inertial(mass, com, inertia=I)
    sphere_jobs: list[tuple] = []
    for g in rb.findall("geom"):
        for pos, r in _geom_spheres(g, deg):
            sphere_jobs.append(("base", pos, r, None))

    def conv_angle(v):
        return np.deg2rad(v) if deg else v

    def add_body(body, parent_builder_name: str, parent_off: np.ndarray):
        """Compile one <body>.

        ``parent_off``: origin of the parent's builder-link frame expressed
        in the parent BODY frame (= the parent's last joint anchor; zero for
        welds and the base). MJCF positions are body-frame, builder link
        frames are anchored at joints — every offset must be re-rooted.

        The body quat is folded into the chain's first joint_quat, so joint
        axes / geom offsets / child-body frames (all body-frame in MJCF) are
        passed through unrotated — the builder's link frame IS the body
        frame, just re-originated at the joint anchor.
        """
        name = body.get("name", f"body{id(body)}")
        pos = _floats(body.get("pos"), default=(0, 0, 0)) - parent_off
        quat = _frame_quat(body, deg)
        joints = [j for j in body.findall("joint") if j.get("type") != "free"]
        mass, com, I = _inertial_of(body, deg)

        if not joints:
            # weld: fixed joint folded by the builder (quat composed exactly)
            from mocca_envs_tpu_torch.models.schema import FIXED

            b.add_link(
                name, parent_builder_name, jtype=FIXED,
                joint_pos=pos, joint_quat=quat,
                mass=mass, com=com, inertia=I, actuated=False,
            )
            chain_name = name
            chain_off = np.zeros(3)
        else:
            chain_parent = parent_builder_name
            chain_name = name
            jpos_list = [
                _floats(j.get("pos"), default=(0, 0, 0)) for j in joints
            ]
            for k, j in enumerate(joints):
                jname = j.get("name", f"{name}_j{k}")
                last = k == len(joints) - 1
                seg = name if last else f"{jname}__stack"
                jtype = PRISMATIC if j.get("type") == "slide" else REVOLUTE
                axis = _floats(j.get("axis"), default=(0, 0, 1))
                jpos = jpos_list[k]
                rng = _floats(j.get("range"))
                if rng is not None and jtype == REVOLUTE:
                    limit = tuple(conv_angle(rng))
                elif rng is not None:
                    limit = tuple(rng)
                else:
                    limit = (-np.pi, np.pi)
                gear = gears.get(jname, default_power_coef)
                b.add_link(
                    seg, chain_parent,
                    jtype=jtype,
                    # first joint: parent-link-frame offset of this body plus
                    # the anchor, with the body quat folded into the joint
                    # frame; stacked joints chain anchor-to-anchor within the
                    # (already rotated) body frame
                    joint_pos=(pos + _np_quat_to_mat(quat) @ jpos)
                    if k == 0 else (jpos - jpos_list[k - 1]),
                    joint_quat=quat if k == 0 else None,
                    joint_axis=axis,
                    limit=limit,
                    damping=float(j.get("damping", "0")),
                    stiffness=float(j.get("stiffness", "0")),
                    armature=float(j.get("armature", "0")),
                    actuated=jname in gears or not gears,
                    power_coef=gear,
                    mass=mass if last else 0.0,
                    # body-frame inertial com, re-rooted at the last anchor
                    com=com - jpos if last else np.zeros(3),
                    inertia=I if last else np.zeros((3, 3)),
                )
                chain_parent = seg
                chain_name = seg
            chain_off = jpos_list[-1]

        foot = None
        if any(k in name.lower() for k in foot_link_keywords):
            foot = name
        for g in body.findall("geom"):
            for gpos, r in _geom_spheres(g, deg):
                sphere_jobs.append((chain_name, gpos - chain_off, r, foot))

        for child in body.findall("body"):
            add_body(child, chain_name, chain_off)

    for child in rb.findall("body"):
        add_body(child, "base", np.zeros(3))
    for link, pos, r, foot in sphere_jobs:
        b.add_sphere(link, pos, r, foot=foot)
    return b.build(device=device)
