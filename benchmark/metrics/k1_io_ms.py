"""K1's ms a step in its io phase (the table into shared memory, the env's
state and scene in, and the results out): the traced stretch's ``k1_ms``
times the phase's share of the clocked kernel's cycles
(benchmark/k1_phases.py)."""

from benchmark import k1_phases


def read(reading):
    return k1_phases.phase_ms(reading, "io")
