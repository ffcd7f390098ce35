"""The readers of the clocked K1 phases and of the idle inside the program's
step, on synthetic readings: the eight ``k1_<phase>_ms`` split the traced
``k1_ms`` by the phases' shares of the cycles of the instance that ran and
sum to it; ``idle_in_step_pct`` counts the device's idle gaps where an
``env.step`` span covers them. Each returns None without a trace, and the
phases without the program's counters (a program that predates them)."""

import dataclasses

import pytest

from benchmark import cells, run
from benchmark.trace import Trace

PHASES = ("io", "fk", "narrowphase", "bias", "factor", "rows", "pgs", "integrate")
SYMBOL = "k1w_nl22_ns14_nlim21_sub4_it4"


@dataclasses.dataclass
class _Window:
    trace: dict | None


def _kernel(ts, dur, name="void k1w::k1w_kernel<k1w::Cfg<22, 14>, true>(float const*)"):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur}


def _reading(events, launched=None, steps=3):
    launched = {SYMBOL: steps} if launched is None else launched
    win = _Window(trace={"events": events, "launched": launched, "steps": steps})
    return run.Reading(window=win, trace=Trace(events, launched, steps))


def _k1_reading():
    # three K1 launches of 4, 4 and 2 µs and one other kernel: k1_ms 10/3 µs a step
    events = [_kernel(0, 4), _kernel(10, 4), _kernel(20, 2),
              {"cat": "kernel", "name": "void at::native::add", "ts": 30, "dur": 1}]
    return _reading(events)


def _totals(**cycles):
    return {p: (cycles.get(p, 0), 4) for p in PHASES}


def test_phases_split_k1_ms_by_their_cycles(monkeypatch):
    from mocca_envs_tpu_torch.ops.cuda import engine

    reading = _k1_reading()
    k1_ms = cells.reader("k1_ms")(reading)
    assert k1_ms == pytest.approx(10 / 3 / 1e3)
    cycles = dict(zip(PHASES, (5, 10, 20, 5, 10, 20, 25, 5)))
    # another instance's counts are not read
    monkeypatch.setattr(engine, "k1_phases", lambda: {SYMBOL: _totals(**cycles),
                                                      "k1w_other": _totals(io=1000)})
    got = {p: cells.reader(f"k1_{p}_ms")(reading) for p in PHASES}
    for p in PHASES:
        assert got[p] == pytest.approx(k1_ms * cycles[p] / 100)
    assert sum(got.values()) == pytest.approx(k1_ms)


def test_phases_read_the_instance_launched_most(monkeypatch):
    from mocca_envs_tpu_torch.ops.cuda import engine

    reading = _reading([_kernel(0, 3), _kernel(5, 3)], launched={"k1w_a": 1, "k1w_b": 2},
                       steps=1)
    monkeypatch.setattr(engine, "k1_phases", lambda: {"k1w_a": _totals(io=1),
                                                      "k1w_b": _totals(pgs=1)})
    assert cells.reader("k1_pgs_ms")(reading) == pytest.approx(cells.reader("k1_ms")(reading))
    assert cells.reader("k1_io_ms")(reading) == 0.0


def test_phases_read_nothing_where_there_is_nothing(monkeypatch):
    from mocca_envs_tpu_torch.ops.cuda import engine

    readers = [cells.reader(f"k1_{p}_ms") for p in PHASES]
    untraced = run.Reading(window=_Window(trace=None))
    assert all(r(untraced) is None for r in readers)
    # a trace with no K1 kernel
    no_k1 = _reading([{"cat": "kernel", "name": "void at::native::add", "ts": 0, "dur": 1}])
    assert all(r(no_k1) is None for r in readers)
    # a program that clocked nothing, or another instance
    monkeypatch.setattr(engine, "k1_phases", lambda: {})
    assert all(r(_k1_reading()) is None for r in readers)
    monkeypatch.setattr(engine, "k1_phases", lambda: {"k1w_other": _totals(io=1)})
    assert all(r(_k1_reading()) is None for r in readers)
    # a program without the counters
    monkeypatch.delattr(engine, "k1_phases")
    assert all(r(_k1_reading()) is None for r in readers)


def _span(ts, dur, cat="user_annotation", name="env.step"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


def test_idle_in_step_counts_the_gaps_a_step_covers():
    read = cells.reader("idle_in_step_pct")
    # device busy 0–10, 20–30, 40–50: idle 10–20 and 30–40 of a 50 µs window
    device = [_kernel(0, 10), _kernel(20, 10), _kernel(40, 10)]
    # a step over 5–25 covers 10 µs of the first gap, a step over 45–60
    # none; the device-side copy of a span and another span count nothing
    spans = [_span(5, 20), _span(45, 15), _span(28, 12, cat="gpu_user_annotation"),
             _span(30, 10, name="ProfilerStep#1")]
    reading = _reading(device + spans)
    assert read(reading) == pytest.approx(20.0)
    assert cells.reader("device_idle_pct")(reading) == pytest.approx(40.0)
    # overlapping spans count their union once; a span over every gap
    assert read(_reading(device + [_span(5, 20), _span(8, 10), _span(32, 2)])) \
        == pytest.approx(24.0)
    assert read(_reading(device + [_span(-5, 100)])) == pytest.approx(40.0)


def test_idle_in_step_reads_nothing_where_there_is_nothing():
    read = cells.reader("idle_in_step_pct")
    assert read(run.Reading(window=_Window(trace=None))) is None
    # no device event (a CPU run), or a program that opens no step span
    assert read(_reading([_span(0, 10)], launched={})) is None
    assert read(_reading([_kernel(0, 10), _kernel(20, 10)])) is None
