"""One run of one cell: set-up, the measured window, and what it leaves to
read.

The traffic is a closed loop of control steps through the program's entry
points, ``BatchedEnv(make(env_id), B, seed).step``, one fresh batch of
actions a step, uniform in the mix's range, made on the device from the
seed. Steps are dispatched ahead: nothing is read back inside the window,
which ends in one synchronise. After each step a CUDA event is recorded, so
the intervals between completions are read afterwards without a
synchronise per step.

A sample of slots at a sample of steps, drawn from the seed, is copied aside
on the device as the step goes (the state before, the action, what came
back) for the comparison after the window. A traced run profiles a bounded
stretch of steps inside the window and counts the host's aten ops of one
step.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import time

import numpy as np
import torch

# streams drawn from the seed besides the program's own generator
ACTION_STREAM, SAMPLE_STREAM = 1, 2


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of ``stream`` under ``seed`` (any whole number)."""
    state = np.random.SeedSequence([int(seed) % 2**64, stream]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def fields(state, tr=None) -> dict:
    """The named tensors of a batched state (and of a transition): what the
    comparison reads. The scene is the configuration's and not copied."""
    out = {"q": state.q, "qd": state.qd, "steps": state.steps,
           "reset_count": state.reset_count, "blowup_count": state.blowup_count}
    out.update({f"task.{f.name}": getattr(state.task, f.name)
                for f in dataclasses.fields(state.task)})
    if tr is not None:
        out.update(obs=tr.obs, reward=tr.reward, done=tr.done)
    return out


class Capture:
    """Sampled rows, ``K`` captures of ``S`` slots each, kept on the device."""

    def __init__(self, rows: torch.Tensor):
        self.rows = rows              # (K, S) slot indices
        self.buf: dict = {}

    def take(self, k: int, prefix: str, named: dict) -> None:
        for name, x in named.items():
            key = prefix + name
            if key not in self.buf:
                self.buf[key] = x.new_empty((self.rows.shape[0], self.rows.shape[1],
                                             *x.shape[1:]))
            torch.index_select(x, 0, self.rows[k], out=self.buf[key][k])

    def rows_of(self, prefix: str, k: int) -> dict:
        """The first ``k`` captures of ``prefix``'s fields, as (k·S, ...)."""
        n = len(prefix)
        return {key[n:]: v[:k].reshape(-1, *v.shape[2:]) for key, v in self.buf.items()
                if key.startswith(prefix)}

    def sample(self, k: int) -> tuple:
        """(state before, action, what came back) of the first ``k``
        captures, row by row."""
        return (self.rows_of("pre.", k), self.rows_of("act.", k)["action"],
                self.rows_of("post.", k))


@dataclasses.dataclass
class Window:
    """What a run measured: the host clock's window, each step's completion
    (ms from the window's start), the launches, and the traced stretch."""

    num_envs: int
    steps: int
    setup_s: float
    window_s: float
    stamps_ms: list
    launches: dict
    blowups: int
    memory_peak_bytes: int
    captures: int
    trace: dict | None = None
    host_ops: int | None = None


class Runner:
    """A cell's program, built and warmed up on ``device``."""

    def __init__(self, cell, seed: int, device: str, num_envs: int | None = None):
        from mocca_envs_tpu_torch import BatchedEnv, make
        from mocca_envs_tpu_torch.ops.cuda import engine

        self.engine = engine
        self.cell = cell
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        cfg, mix = cell.config, cell.traffic
        self.env = make(cfg["env_id"], device=device, **cfg.get("make", {}))
        self.num_envs = B = int(num_envs or mix["num_envs"])
        self.batch = BatchedEnv(self.env, B, seed=seed, device=device)
        self.state = self.batch.init()
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(sub_seed(seed, ACTION_STREAM))
        lo, hi = mix["actions"]["low"], mix["actions"]["high"]
        self.act_scale, self.act_lo = hi - lo, lo
        rng = np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, SAMPLE_STREAM]))
        S, K = min(int(mix["sample_envs"]), B), int(mix["sample_steps"])
        rows = np.stack([rng.choice(B, size=S, replace=False) for _ in range(K)])
        self.capture = Capture(torch.as_tensor(rows, device=self.device))
        self.rng = rng
        self.check_widths()

    def check_widths(self) -> None:
        """The program runs the configuration its file states."""
        w, env = self.cell.config["widths"], self.env
        got = {"links": env.model.nl, "spheres": env.model.ns, "joints": env.model.nj,
               "obs_dim": env.obs_dim, "act_dim": env.act_dim,
               "control_dt": round(env.control_dt, 9)}
        want = {k: (round(v, 9) if k == "control_dt" else v) for k, v in w.items()
                if k in got}
        if {k: got[k] for k in want} != want:
            raise RuntimeError(f"{self.cell.name}: the program runs {got}, the configuration "
                               f"states {w}")

    def actions(self) -> torch.Tensor:
        a = torch.rand((self.num_envs, self.env.act_dim), generator=self.gen,
                       device=self.device)
        return a.mul_(self.act_scale).add_(self.act_lo)

    def step(self, capture_k: int | None = None, action=None):
        a = self.actions() if action is None else action
        if capture_k is not None:
            self.capture.take(capture_k, "pre.", fields(self.state))
            self.capture.take(capture_k, "act.", {"action": a})
        tr = self.batch.step(self.state, a)
        self.state = tr.state
        if capture_k is not None:
            self.capture.take(capture_k, "post.", fields(tr.state, tr))
        return tr

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def warm_up(self) -> float:
        """Every shape the window uses, once; returns the seconds of one
        step as the warmed program takes it."""
        for k in range(int(self.cell.traffic["warmup_steps"])):
            self.step(capture_k=0 if k == 0 else None)
        self.sync()
        n = int(self.cell.traffic["timing_steps"])
        t = time.perf_counter()
        for _ in range(n):
            self.step()
        self.sync()
        return (time.perf_counter() - t) / n

    def run(self, seconds: float, t_start: float, trace: bool) -> Window:
        """Set-up's end, the window and its drain: ``seconds`` of steps, and
        on past them, should the steps run slower than set-up timed them,
        until every sampled step and the traced stretch have run. The
        window's time is all of it. ``t_start``: the process's start on
        the ``time.perf_counter`` clock."""
        mix = self.cell.traffic
        per_step = self.warm_up()
        # what set-up made stays: the collector's full passes, a stall of
        # the host inside the window, need not scan it
        gc.collect()
        gc.freeze()
        expected = max(1, int(seconds / per_step))
        K = self.capture.rows.shape[0]
        span = max(K + 1, int(0.45 * expected))
        when = sorted(self.rng.choice(np.arange(1, span), size=K, replace=False).tolist())
        capture_at = {int(s): k for k, s in enumerate(when)}
        trace_at = max(span, expected // 2) if trace else -1
        last = max(when[-1], trace_at)
        marks = Marks(self.cuda, int(1.5 * expected) + 64)
        blowups0 = self.state.blowup_count.sum()
        self.engine.LAUNCHES.clear()
        self.engine.INSTANCE_LAUNCHES.clear()
        traced, host_ops = None, None
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        marks.mark()
        i = 0
        while True:
            if i == trace_at:
                traced, host_ops, n = self.traced_stretch(int(mix["trace_steps"]), marks)
                i += n
            self.step(capture_k=capture_at.get(i))
            marks.mark()
            i += 1
            if i > last and time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        window_s = time.perf_counter() - t0
        return Window(
            num_envs=self.num_envs, steps=i, setup_s=setup_s, window_s=window_s,
            stamps_ms=marks.stamps_ms(), launches=dict(self.engine.INSTANCE_LAUNCHES),
            blowups=int(self.state.blowup_count.sum() - blowups0),
            memory_peak_bytes=(torch.cuda.max_memory_allocated(self.device)
                               if self.cuda else 0),
            captures=len(capture_at), trace=traced, host_ops=host_ops)

    def traced_stretch(self, steps: int, marks) -> tuple:
        """``steps`` steps under ``torch.profiler`` after two warm-up steps
        of it, then one ``BatchedEnv.step`` under an aten-op counter (its
        actions made before it). Returns (the trace's events and the K1
        launches by instance during it, the aten ops of one step, the steps
        taken)."""
        from benchmark import trace

        lead = 2
        before = collections.Counter(self.engine.INSTANCE_LAUNCHES)
        events = trace.profile(lambda: (self.step(), marks.mark()), lead, steps, self.sync)
        launched = collections.Counter(self.engine.INSTANCE_LAUNCHES)
        launched.subtract(before)
        action = self.actions()
        ops = trace.count_ops(lambda: self.step(action=action))
        marks.mark()
        return ({"events": events, "launched": dict(+launched), "steps": lead + steps},
                ops, lead + steps + 1)

    def free(self) -> None:
        """Drop the program's state, so that the reference finds the memory."""
        del self.state, self.batch, self.env
        if self.cuda:
            torch.cuda.empty_cache()


class Marks:
    """Completion stamps: a CUDA event after each step on the card, the host
    clock on the CPU (where every step is synchronous)."""

    def __init__(self, cuda: bool, capacity: int):
        self.cuda = cuda
        self.events = ([torch.cuda.Event(enable_timing=True) for _ in range(capacity + 1)]
                       if cuda else [])
        self.times: list = []
        self.n = 0

    def mark(self) -> None:
        """The window's start, or a step's completion."""
        if self.cuda:
            if self.n == len(self.events):
                self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[self.n].record()
        else:
            self.times.append(time.perf_counter())
        self.n += 1

    def stamps_ms(self) -> list:
        """The window's start and each step's completion, ms from the start."""
        if not self.cuda:
            return [1e3 * (t - self.times[0]) for t in self.times]
        first = self.events[0]
        return [0.0] + [first.elapsed_time(e) for e in self.events[1:self.n]]
