"""The share of the traced stretch, from its first device event's start to
its last one's end, in which no device event runs while the host is inside
the program's step (its ``env.step`` spans), %. ``device_idle_pct`` less
this is the idle the benchmark's own loop and the profiler leave. None
where the trace holds no device event or the program opens no such span."""

from benchmark import stats

SPAN = "env.step"


def read(reading):
    t = reading.trace
    if t is None or not t.device or t.window_us <= 0:
        return None
    steps = stats.union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                        for e in reading.window.trace["events"]
                        if e.get("cat") == "user_annotation" and e.get("name") == SPAN
                        and "dur" in e)
    if not steps:
        return None
    idle, j = 0.0, 0
    for a, b in sorted(stats.gaps(t.spans(t.device))):
        while j < len(steps) and steps[j][1] <= a:
            j += 1
        k = j
        while k < len(steps) and steps[k][0] < b:
            idle += max(0.0, min(b, steps[k][1]) - max(a, steps[k][0]))
            k += 1
    return 100.0 * idle / t.window_us
