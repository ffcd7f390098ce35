"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. The last line of standard output is one JSON object: ``correct``,
``attempted`` (env-steps dispatched in the window), ``failed`` (env-steps
whose state went non-finite and were reset), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
comparison with the reference held, beside its limit. The same numbers end
standard error. Without the cards it asks for, or with JAX loaded, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import time

T_CALL = time.perf_counter()


def _since_process_start() -> float:
    """Seconds since this process started, from ``/proc`` (0 where there is
    none)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        import os

        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = T_CALL - _since_process_start()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmark import cells, imports, judge, roofline  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Reading:
    """Everything a run leaves for the metric readers."""

    window: object             # window.Window
    trace: object = None       # trace.Trace of the traced stretch, or None
    k1_bound_ms: float | None = None   # K1's least time a step (frozen count)


def keep_caches_in_checkout() -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout (the program's nvcc output already lies in ``build/``)."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))


def k1_bound_ms(ref, capture, taken: int, num_envs: int) -> float:
    """K1's least time a step (ms), from the frozen count over the captured
    rows with their own inputs, scaled from the sample to the batch."""
    pre, act, _ = capture.sample(taken)
    constraints, pd_mode, damping = ref.unit_spec()
    if not pd_mode and ref.engine.llc_frames != 1:
        raise NotImplementedError("the frozen count takes one launch unit a step")
    flops = 0
    for lo in range(0, act.shape[0], 4096):
        sl = slice(lo, lo + 4096)
        q, qd, tau = ref.unit_inputs({k: v[sl] for k, v in pre.items()}, act[sl])
        gz, fr = ref.scene(q.shape[0])
        lim, con = roofline.k1_activity(ref.model, ref.engine, constraints, pd_mode, q, qd, tau,
                                        gz, fr, extra_damping=damping)
        flops += roofline.k1_flops(ref.model, ref.engine, constraints, pd_mode, lim, con)
    return roofline.bound_ms(flops * num_envs / act.shape[0],
                             roofline.k1_bytes_per_env(ref.model) * num_envs)[0]


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             num_envs: int | None = None, t_start: float | None = None) -> tuple:
    """One run of ``cell``: (the result line's object, every gap number the
    comparison read, and what it was read on: the reference with the
    sampled rows' states before and their actions). The look for a card is
    the caller's (``main``); tests drive this on the CPU at a small batch."""
    import torch

    from benchmark import window
    from benchmark.trace import Trace

    runner = window.Runner(cell, seed, device, num_envs)
    win = runner.run(seconds, T_START if t_start is None else t_start, trace)
    capture, cfg = runner.capture, cell.config
    launch_mismatch = 0
    if runner.cuda:
        want = win.steps * int(cfg["k1_launches_per_step"])
        got = win.launches.get(cfg["k1_instance"], 0)
        launch_mismatch = abs(got - want) + sum(win.launches.values()) - got
    runner.free()

    dev = torch.device(device)
    ref = cells.reference(cfg, dev)
    with judge.fp32_products():
        pre, action, post = capture.sample(win.captures)
        g, bad = judge.gaps(ref, pre, action, post)
        nums = judge.numbers(g)
        rows = int(action.shape[0])
        ok, checks = judge.verdict(nums, bad, rows, cfg["checks"]["limits"],
                                   int(cfg["checks"]["min_rows"]))
        checks["launch_mismatch"] = [float(launch_mismatch), 0.0]
        ok = ok and launch_mismatch == 0
        traced = None
        reading = Reading(window=win)
        if trace and win.trace is not None:
            traced = Trace(win.trace["events"], win.trace["launched"], win.trace["steps"])
            reading.trace = traced
            if traced.k1:
                reading.k1_bound_ms = k1_bound_ms(ref, capture, win.captures, win.num_envs)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.reader(m["name"])(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if runner.cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if runner.cuda else "cpu",
                "count": cell.chips if runner.cuda else 0,
                "memory_peak_bytes": int(win.memory_peak_bytes)}
    if traced is not None and traced.device:
        dev_info["busy_s"] = traced.busy_us / 1e6
        dev_info["window_s"] = traced.window_us / 1e6
    result = {"correct": bool(ok), "attempted": win.num_envs * win.steps,
              "failed": int(win.blowups), "metrics": metrics, "device": dev_info}
    if traced is not None and traced.device:
        result["breakdown"] = traced.breakdown()
    result["checks"] = checks
    return result, nums, (ref, pre, action)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.find_cell(args.workload)
    keep_caches_in_checkout()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {found}",
              file=sys.stderr)
        return 2
    result, numbers, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    print("numbers: " + " ".join(f"{k} {v:.6g}" for k, v in numbers.items()), file=sys.stderr)
    bad = imports.forbidden_loaded() + [f"{f} imports {m}"
                                        for f, m in imports.reference_violations()]
    if bad:
        print("forbidden modules in this run: " + ", ".join(bad), file=sys.stderr)
        return 3
    for name, (value, limit) in result["checks"].items():
        rel = "at least" if name == "rows" else "limit"
        print(f"{name} {value:.6g} {rel} {limit:.6g}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
