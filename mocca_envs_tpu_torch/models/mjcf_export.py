"""RobotModel → MJCF exporter: the MuJoCo-XML side of the asset surface.

Counterpart of ``mocca_envs_tpu/models/mjcf_export.py``, with its own copy
of the writer (the same text for the same model, byte for byte). It emits
PLAIN MJCF (no vendor extensions — MuJoCo's compiler rejects unknown
attributes), so the file loads in stock MuJoCo. Engine constants MJCF can
express natively (damping, stiffness, armature, actuator gear) round-trip
exactly through models/mjcf.parse_mjcf; what it cannot (PD gains, foot-group
names, bar-exclusion flags) falls back to parse-time defaults/keyword
heuristics.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from xml.dom import minidom

import numpy as np

from mocca_envs_tpu_torch.models.schema import PRISMATIC, RobotModel
from mocca_envs_tpu_torch.models.urdf_export import host


def _fmt(values) -> str:
    return " ".join(repr(round(float(v), 12)) for v in np.atleast_1d(values))


def export_mjcf(model: RobotModel, name: str | None = None) -> str:
    """Serialize a RobotModel to a standalone MJCF document (string).

    One joint per link (the builder's canonical form): each link becomes a
    ``<body pos=joint_pos quat=joint_quat>`` whose frame sits at the joint
    anchor — exactly the fold parse_mjcf applies in reverse.
    """
    m = lambda a: host(a).astype(np.float64)  # noqa: E731
    mass, com, inertia = m(model.mass), m(model.com), m(model.inertia)
    jpos, jquat, jaxis = m(model.joint_pos), m(model.joint_quat), m(model.joint_axis)
    lo, hi = m(model.limit_lo), m(model.limit_hi)
    damping, stiffness = m(model.damping), m(model.stiffness)
    armature, power = m(model.armature), m(model.power_coef)
    actuated = m(model.actuated)
    sph_link = host(model.sph_link)
    sph_pos, sph_r = m(model.sph_pos), m(model.sph_radius)

    root = ET.Element("mujoco", model=name or model.link_names[0])
    ET.SubElement(root, "compiler", angle="radian")
    world = ET.SubElement(root, "worldbody")

    def fill_body(el, l):
        iel = ET.SubElement(el, "inertial", pos=_fmt(com[l]),
                            mass=repr(float(mass[l])))
        I = inertia[l]
        iel.set("fullinertia", _fmt(
            [I[0, 0], I[1, 1], I[2, 2], I[0, 1], I[0, 2], I[1, 2]]
        ))
        for s in range(model.ns):
            if int(sph_link[s]) != l or sph_r[s] <= 0:
                continue
            ET.SubElement(el, "geom", type="sphere", pos=_fmt(sph_pos[s]),
                          size=repr(float(sph_r[s])))

    base = ET.SubElement(world, "body", name=model.link_names[0], pos="0 0 0")
    if model.floating:
        ET.SubElement(base, "freejoint")
    fill_body(base, 0)

    body_el = {0: base}
    for l in range(1, model.nl):
        j = l - 1
        el = ET.SubElement(
            body_el[model.parent[l]], "body", name=model.link_names[l],
            pos=_fmt(jpos[j]), quat=_fmt(jquat[j]),
        )
        jel = ET.SubElement(
            el, "joint", name=model.joint_names[j],
            type="slide" if model.jtype[j] == PRISMATIC else "hinge",
            pos="0 0 0", axis=_fmt(jaxis[j]),
            range=f"{repr(float(lo[j]))} {repr(float(hi[j]))}",
        )
        if damping[j]:
            jel.set("damping", repr(float(damping[j])))
        if stiffness[j]:
            jel.set("stiffness", repr(float(stiffness[j])))
        if armature[j]:
            jel.set("armature", repr(float(armature[j])))
        fill_body(el, l)
        body_el[l] = el

    act = ET.SubElement(root, "actuator")
    for j in range(model.nj):
        if actuated[j] > 0.5:
            ET.SubElement(act, "motor", joint=model.joint_names[j],
                          gear=repr(float(power[j])))

    raw = ET.tostring(root, encoding="unicode")
    return minidom.parseString(raw).toprettyxml(indent="  ")
