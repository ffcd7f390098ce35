"""K1's device time a step split by the phases of the clocked warp-per-env
kernel: ``k1_<phase>_ms`` is the traced stretch's ``k1_ms`` times the
phase's share of the cycles of the K1 instance that ran there.

The program counts each env's ``clock64()`` cycles and visits per phase
while a ``torch.profiler`` records, so over the traced stretch alone
(``mocca_envs_tpu_torch.ops.cuda.engine.k1_phases``, read after the window).
A share of the warps' cycles put on the trace's clock makes the phases sum
to ``k1_ms``. None where the run has no trace, no K1 launch in it, or a
program without the counters.
"""

from __future__ import annotations

from benchmark import cells


def totals(reading) -> dict | None:
    """``{phase: (cycles, visits)}`` of the instance the traced stretch
    launched most, or None."""
    t = reading.trace
    if t is None or not t.k1:
        return None
    from mocca_envs_tpu_torch.ops.cuda import engine

    read = getattr(engine, "k1_phases", None)
    if read is None:
        return None
    launched = reading.window.trace["launched"]
    phases = read()
    ran = [s for s in sorted(launched, key=launched.get, reverse=True) if s in phases]
    return phases[ran[0]] if ran else None


def phase_ms(reading, phase: str) -> float | None:
    """``phase``'s ms of K1 a step in the traced stretch."""
    tot = totals(reading)
    k1_ms = cells.reader("k1_ms")(reading)
    if tot is None or phase not in tot or k1_ms is None:
        return None
    cycles = sum(c for c, _ in tot.values())
    return k1_ms * tot[phase][0] / cycles if cycles > 0 else None
