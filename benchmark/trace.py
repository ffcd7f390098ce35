"""The traced stretch: a ``torch.profiler`` trace of a few steps inside the
window, the host's aten ops of one step, and what the metric readers take
from them.

The trace is written to a temporary file under ``TMPDIR``, read back and
deleted. Device events are the trace's kernels, copies and sets; K1's are
the kernels of its two CUDA sources' entry functions, ``k1w_kernel`` and
``k1_kernel`` (a kernel's name in the trace holds its template arguments,
not the instance's symbol), and the steps the device ran in the stretch are
their number over the K1 launches a step makes, as
``engine.INSTANCE_LAUNCHES`` counted them. Host and device times share the
trace's clock.
"""

from __future__ import annotations

import collections
import json
import os
import re
import tempfile

import torch

from benchmark import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
K1_KERNEL = re.compile(r"\bk1w?_kernel<")


def profile(step, lead: int, steps: int, sync) -> list:
    """Run ``lead + steps`` calls of ``step`` under the profiler, keeping
    the last ``steps`` and the device work they wait for; returns the
    trace's events."""
    from torch.profiler import ProfilerActivity, schedule

    out: list = []

    def keep(prof):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                out.extend(json.load(f)["traceEvents"])
        finally:
            os.unlink(path)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with torch.profiler.profile(activities=acts, on_trace_ready=keep,
                                schedule=schedule(wait=0, warmup=lead, active=steps,
                                                  repeat=1)) as prof:
        for j in range(lead + steps):
            step()
            if j == lead + steps - 1:
                sync()   # the last step's device work inside the trace
            prof.step()
    return out


def count_ops(step) -> int:
    """The aten ops one call of ``step`` dispatches on the host (a
    ``TorchDispatchMode`` count; K1's launch through ctypes is not one)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        step()
    return count.n


class Trace:
    """The device's work in a traced stretch, per step."""

    def __init__(self, events: list, launched: dict, host_steps: int):
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        self.cpu_ops = [e for e in events if e.get("cat") == "cpu_op" and "dur" in e]
        self.k1 = [e for e in self.device if e.get("cat") == "kernel"
                   and K1_KERNEL.search(e.get("name", ""))] if launched else []
        self.k1_ids = {id(e) for e in self.k1}
        per_host_step = sum(launched.values()) / host_steps if host_steps else 0.0
        # the steps the device ran in the trace: its K1 launches over the
        # launches a step makes
        self.steps = len(self.k1) / per_host_step if per_host_step else 0.0
        self.busy_us, self.window_us = stats.busy(self.spans(self.device))

    @staticmethod
    def spans(events) -> list:
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events]

    def per_step(self, value: float):
        return value / self.steps if self.steps else None

    def other_busy_us(self) -> float:
        """Device time outside the K1 launches (their union)."""
        return stats.busy(self.spans([e for e in self.device if id(e) not in self.k1_ids]))[0]

    def k1_us(self) -> float:
        return sum(float(e["dur"]) for e in self.k1)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by the innermost host op running when each began."""
        by_name = collections.Counter()
        for e in self.device:
            by_name[e.get("name", "?")[:120]] += float(e["dur"]) / 1e6
        ops = sorted(self.cpu_ops, key=lambda e: float(e["ts"]))
        idle = []
        for a, b in stats.gaps(self.spans(self.device))[:top]:
            doing = [e for e in ops if float(e["ts"]) <= a < float(e["ts"]) + float(e["dur"])]
            label = min(doing, key=lambda e: float(e["dur"]))["name"] if doing else "no aten op"
            idle.append([label[:120], (b - a) / 1e6])
        return {"device_ops": [[n, s] for n, s in by_name.most_common(top)],
                "idle_gaps": idle}
