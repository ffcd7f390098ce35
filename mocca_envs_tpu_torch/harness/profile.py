"""Tracing and profiling hooks.

Counterpart of ``mocca_envs_tpu/harness/profile.py``: :func:`trace` records
a ``torch.profiler`` trace of the host and, where there is one, the CUDA
card, and writes it as a Chrome trace (``trace.json``, for Perfetto or
chrome://tracing) into its directory, beside the clocked K1 launches' phase
totals (``k1_phases.json``); :func:`tracing` says whether a profiler
records, which is the one gate of the program's own instrumentation: the
spans of :func:`span` and the clocked K1 kernel
(``ops/cuda/engine.py::EngineKernel.launch``); :class:`StageTimer` is a
wall-clock timer per stage that waits for the device at the end of each
stage.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

TRACE_FILE = "trace.json"
PHASES_FILE = "k1_phases.json"

_NO_SPAN = contextlib.nullcontext()


def tracing() -> bool:
    """Whether a ``torch.profiler`` records on this thread (a flag read,
    no aten op)."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A span named ``name`` on the profiler's clock, shared with the card's
    kernels, while a profiler records (``torch.profiler.record_function``);
    else one shared null context, which dispatches no op."""
    return torch.profiler.record_function(name) if tracing() else _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block (the CUDA card's
    kernels too, where one is present) into ``log_dir/trace.json``, and the
    clocked K1 launches' phase totals of the block into
    ``log_dir/k1_phases.json`` (``{symbol: {phase: [cycles, visits]}}``,
    ``ops/cuda/engine.py::k1_phases``; empty where no K1 kernel ran)."""
    from mocca_envs_tpu_torch.ops.cuda import engine

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    engine.PHASE_CLOCKS.clear()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
    with open(os.path.join(log_dir, PHASES_FILE), "w") as f:
        json.dump(engine.k1_phases(), f, indent=1)


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
