"""Tracing and profiling hooks.

Counterpart of ``mocca_envs_tpu/harness/profile.py``: :func:`trace` records
a ``torch.profiler`` trace of the host and, where there is one, the CUDA
card, and writes it as a Chrome trace (``trace.json``, for Perfetto or
chrome://tracing) into its directory; :class:`StageTimer` is a wall-clock timer per stage that waits for the
device at the end of each stage.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block (the CUDA card's
    kernels too, where one is present) into ``log_dir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))



class StageTimer:
    """Wall-clock seconds per stage, summed over its uses. On a CUDA
    ``device`` each stage ends with a synchronise, so that it holds the
    device time of the work it queued. Usage: ``with timer.stage("rollout"):
    ...``."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.times.values()) or 1.0
        lines = [
            f"{k:24s} {v * 1e3:9.2f} ms  {100 * v / total:5.1f}%"
            for k, v in sorted(self.times.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)
