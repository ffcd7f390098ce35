"""K1's ms a step in its bias phase (the Newton–Euler bias; in PD mode also
each frame's torque): the traced stretch's ``k1_ms`` times the phase's share
of the clocked kernel's cycles (benchmark/k1_phases.py)."""

from benchmark import k1_phases


def read(reading):
    return k1_phases.phase_ms(reading, "bias")
