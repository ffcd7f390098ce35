"""RobotModel → URDF exporter: generates the shipped asset files.

Counterpart of ``mocca_envs_tpu/models/urdf_export.py``, with its own copy
of the writer: the same model gives the same text, byte for byte, from
either package. The port's ``data/`` directory holds what it writes
(models/assets.py), and ``parse_urdf(export_urdf(model))`` reproduces the
model.

Everything URDF can express natively uses native tags (inertials, sphere
collisions, joint origin/axis/limit/effort, viscous damping). Engine
constants URDF has no vocabulary for ride vendor extensions that standard
parsers ignore:

- ``<mocca_dynamics stiffness= spring_ref= armature= kp= kd= actuated=/>``
  per joint (Cassie's leaf springs and PD gains);
- ``mocca_foot`` / ``mocca_no_bar`` attributes per collision sphere (the
  obs foot-flag grouping; palm exclusion from bar narrowphase).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from xml.dom import minidom

import numpy as np

from mocca_envs_tpu_torch.models.schema import PRISMATIC, RobotModel, rpy_to_quat


def host(t) -> np.ndarray:
    """A model tensor (on any device) as a numpy array of its own dtype."""
    return t.detach().cpu().numpy()


def quat_to_rpy(q) -> np.ndarray:
    """wxyz quaternion → URDF fixed-axis rpy (inverse of schema.rpy_to_quat)."""
    w, x, y, z = (float(v) for v in np.asarray(q, dtype=np.float64))
    sinp = 2.0 * (w * y - z * x)
    if abs(sinp) >= 1.0 - 1e-12:
        # gimbal: pitch = ±π/2, fold yaw into roll
        p = np.copysign(np.pi / 2, sinp)
        r = np.arctan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
        return np.array([r, p, 0.0])
    r = np.arctan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    p = np.arcsin(sinp)
    yaw = np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    rpy = np.array([r, p, yaw])
    # verify the round trip (quats compare up to sign)
    qr = rpy_to_quat(rpy)
    qn = np.asarray([w, x, y, z])
    if min(np.abs(qr - qn).max(), np.abs(qr + qn).max()) > 1e-9:
        raise ValueError(f"quat_to_rpy round-trip failed for {qn}")
    return rpy


def _fmt(values) -> str:
    return " ".join(repr(round(float(v), 12)) for v in np.atleast_1d(values))


def export_urdf(model: RobotModel, name: str | None = None) -> str:
    """Serialize a RobotModel to a standalone URDF document (string)."""
    m = lambda arr: host(arr).astype(np.float64)  # noqa: E731
    robot = ET.Element("robot", name=name or model.link_names[0])
    mass = m(model.mass)
    com = m(model.com)
    inertia = m(model.inertia)
    sph_link = host(model.sph_link)
    sph_pos = m(model.sph_pos)
    sph_r = m(model.sph_radius)
    sph_foot = m(model.sph_foot)
    sph_no_bar = m(model.sph_no_bar)

    for l, lname in enumerate(model.link_names):
        link_el = ET.SubElement(robot, "link", name=lname)
        inertial = ET.SubElement(link_el, "inertial")
        ET.SubElement(inertial, "origin", xyz=_fmt(com[l]), rpy="0 0 0")
        ET.SubElement(inertial, "mass", value=repr(float(mass[l])))
        I = inertia[l]
        ET.SubElement(
            inertial, "inertia",
            ixx=repr(float(I[0, 0])), iyy=repr(float(I[1, 1])),
            izz=repr(float(I[2, 2])), ixy=repr(float(I[0, 1])),
            ixz=repr(float(I[0, 2])), iyz=repr(float(I[1, 2])),
        )
        for s in range(model.ns):
            if int(sph_link[s]) != l or sph_r[s] <= 0:
                continue
            attrs = {"mocca_order": str(s)}
            f = np.argmax(sph_foot[s]) if sph_foot.shape[1] else 0
            if sph_foot.shape[1] and sph_foot[s, f] > 0.5:
                attrs["mocca_foot"] = model.foot_links[f]
            if sph_no_bar[s] > 0.5:
                attrs["mocca_no_bar"] = "1"
            col = ET.SubElement(link_el, "collision", **attrs)
            ET.SubElement(col, "origin", xyz=_fmt(sph_pos[s]), rpy="0 0 0")
            geom = ET.SubElement(col, "geometry")
            ET.SubElement(geom, "sphere", radius=repr(float(sph_r[s])))

    jpos = m(model.joint_pos)
    jquat = m(model.joint_quat)
    jaxis = m(model.joint_axis)
    lo = m(model.limit_lo)
    hi = m(model.limit_hi)
    damping = m(model.damping)
    stiffness = m(model.stiffness)
    spring_ref = m(model.spring_ref)
    armature = m(model.armature)
    actuated = m(model.actuated)
    power = m(model.power_coef)
    kp = m(model.kp)
    kd = m(model.kd)
    for j, jname in enumerate(model.joint_names):
        child = j + 1
        jt = "prismatic" if model.jtype[j] == PRISMATIC else "revolute"
        joint = ET.SubElement(robot, "joint", name=f"{jname}_joint", type=jt)
        ET.SubElement(joint, "parent", link=model.link_names[model.parent[child]])
        ET.SubElement(joint, "child", link=model.link_names[child])
        ET.SubElement(
            joint, "origin", xyz=_fmt(jpos[j]), rpy=_fmt(quat_to_rpy(jquat[j]))
        )
        ET.SubElement(joint, "axis", xyz=_fmt(jaxis[j]))
        ET.SubElement(
            joint, "limit",
            lower=repr(float(lo[j])), upper=repr(float(hi[j])),
            effort=repr(float(power[j])), velocity="100.0",
        )
        if damping[j] != 0.0:
            ET.SubElement(joint, "dynamics", damping=repr(float(damping[j])))
        extras = {}
        if stiffness[j] != 0.0:
            extras["stiffness"] = repr(float(stiffness[j]))
            extras["spring_ref"] = repr(float(spring_ref[j]))
        if armature[j] != 0.0:
            extras["armature"] = repr(float(armature[j]))
        if kp[j] != 0.0 or kd[j] != 0.0:
            extras["kp"] = repr(float(kp[j]))
            extras["kd"] = repr(float(kd[j]))
        if actuated[j] < 0.5:
            extras["actuated"] = "0"
        if extras:
            ET.SubElement(joint, "mocca_dynamics", **extras)

    raw = ET.tostring(robot, encoding="unicode")
    return minidom.parseString(raw).toprettyxml(indent="  ")
