"""Walker2D's and Crab2D's training rate with split impulse on one NVIDIA
GPU: the training CLI's ``main`` with ``--split-impulse`` at 4096 envs,
then the batched env step alone, the engine's launches counted by instance.

Run from the root of a checkout on a machine with a CUDA card:

    python3 split_train_rate.py [--updates N] [--horizon H] [--steps S] [--calls C]

It drives the port's package beside it, so two checkouts are compared by
copying it into both and running them in turns on one machine (A, B, B,
A). Prints the card, then for each family every update's env-steps/s with
its rollout and PPO update seconds, and the env step's ms over ``--steps``
steps of uniform random actions; then the host µs of one call of the
split planar K1 wrapper (its checks, its output tensors and the launch),
for the instance the families run and for its thread-per-env twin, in
turns; then, in this one process, each family's training and env step
with that instance and with its twin in turns (where the checkout has no
warp instance for the key, both sides run the same one), and one traced
Walker2D update on each side (``torch.profiler``: the device's busy
share and its time per kernel); last, one JSON line of the medians over
the updates after each run's first. The PPO
update does not run the engine, so its seconds show how fast the host
ran. It imports nothing of JAX. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke

FAMILIES = ("Walker2DCustomEnv", "Crab2DCustomEnv")
B = 4096
SEED = 0


def train_rates(train, engine, env_id: str, updates: int, horizon: int, workdir: Path) -> dict:
    """``updates`` updates of ``horizon`` steps through the CLI: each
    update's metrics line, and the launches by instance."""
    metrics = workdir / f"{env_id}.jsonl"
    torch.cuda.synchronize()
    engine.INSTANCE_LAUNCHES.clear()
    train.main(["--env", env_id, "--split-impulse", "--num-envs", str(B), "--horizon",
                str(horizon), "--updates", str(updates), "--log-every", "1", "--seed", str(SEED),
                "--metrics", str(metrics)])
    torch.cuda.synchronize()
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    return {"lines": lines, "launches": dict(engine.INSTANCE_LAUNCHES)}


def step_ms(port, train, engine, env_id: str, steps: int) -> tuple:
    """ms per batched env step over ``steps`` steps after ten, and the
    launches by instance over those steps."""
    env = port.make(env_id, config=train.split_config(env_id))
    batch = port.BatchedEnv(env, B, seed=SEED)
    state = batch.init()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)

    def run(n):
        nonlocal state
        for _ in range(n):
            actions = torch.rand((B, env.act_dim), generator=gen, device="cuda") * 2.0 - 1.0
            state = batch.step(state, actions).state

    run(10)
    torch.cuda.synchronize()
    engine.INSTANCE_LAUNCHES.clear()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps, dict(engine.INSTANCE_LAUNCHES)


def launch_host_us(engine, calls: int) -> dict:
    """Median host µs of one ``launch`` of Walker2D's split K1 wrapper on
    near-stand states at B, each call timed alone after the card is idle,
    for the instance the families run (``pick``) and its thread-per-env
    twin, in turns (pick, twin, twin, pick), and the instances' names."""
    from mocca_envs_tpu_torch.models import walker2d
    from mocca_envs_tpu_torch.utils.config import EngineConfig

    model = walker2d.make_walker2d("cuda")
    split = EngineConfig(split_impulse=True)
    kernels = {"pick": engine.K1e(model, split, walker2d.planar_spec()),
               "twin": engine.K1e(model, split, walker2d.planar_spec(), thread_per_env=True)}
    rng = np.random.default_rng(SEED)
    args = [torch.as_tensor(x, device="cuda")
            for x in chip_smoke.planar_walker_states(model, 1.22, rng, B)]
    times = {k: [] for k in kernels}
    for which in ("pick", "twin", "twin", "pick"):
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kernels[which].launch(*args)
            times[which].append(1e6 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in times.items()} | {
        f"{k}_instance": kernels[k].name for k in kernels}


@contextlib.contextmanager
def planar_split_twin(engine):
    """Inside, the planar walkers' split key resolves to its thread-per-env
    twin, so the envs built there launch it."""
    key = engine.Key(nl=7, ns=5, nlim=6, substeps=4, iters=4, planar=True, split=True)
    warp = engine.WARP_INSTANCES.pop(key, None)
    try:
        yield
    finally:
        if warp is not None:
            engine.WARP_INSTANCES[key] = warp


def medians(run: dict, ms: float) -> dict:
    """A training run's medians over the updates after its first, and the
    env step's ms."""
    later = run["lines"][1:]
    return {"env_steps_per_s": statistics.median(x["env_steps_per_s"] for x in later),
            "rollout_s": statistics.median(x["rollout_s"] for x in later),
            "update_s": statistics.median(x["update_s"] for x in later),
            "step_ms": ms, "instances": sorted(run["launches"])}


def twin_turns(port, train, engine, env_id: str, args, workdir: Path) -> dict:
    """``env_id``'s training and env step in this process with the
    instance the families run (``pick``) and with its twin, in turns (pick,
    twin, twin, pick): ``{side: [medians of each turn]}``."""
    out = {"pick": [], "twin": []}
    for n, side in enumerate(("pick", "twin", "twin", "pick")):
        with planar_split_twin(engine) if side == "twin" else contextlib.nullcontext():
            turn = workdir / f"{env_id}_{n}_{side}"
            turn.mkdir()
            run = train_rates(train, engine, env_id, args.updates, args.horizon, turn)
            ms, _ = step_ms(port, train, engine, env_id, args.steps)
        out[side].append(medians(run, ms))
        print(f"[turn] {env_id} {side}: {json.dumps(out[side][-1])}")
    return out


def traced_sides(train, engine, workdir: Path) -> dict:
    """One Walker2D training update traced on each side (pick, then twin):
    the device's busy and window ms, and its ms per kernel (the largest
    twelve), from the Chrome trace the CLI writes."""
    from mocca_envs_tpu_torch.harness.profile import TRACE_FILE

    out = {}
    for side in ("pick", "twin"):
        prof = workdir / f"profile_{side}"
        with planar_split_twin(engine) if side == "twin" else contextlib.nullcontext():
            train.main(["--env", "Walker2DCustomEnv", "--split-impulse", "--num-envs", str(B),
                        "--horizon", "32", "--updates", "1", "--seed", str(SEED),
                        "--profile-dir", str(prof)])
        events = json.loads((prof / TRACE_FILE).read_text())["traceEvents"]
        dev, busy, window = chip_smoke.device_busy(events)
        by_name: dict = {}
        for e in dev:
            by_name[e["name"][:70]] = by_name.get(e["name"][:70], 0.0) + float(e["dur"]) / 1e3
        top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
        out[side] = {"events": len(dev), "busy_ms": busy / 1e3, "window_ms": window / 1e3,
                     "kernel_ms": top}
        print(f"[trace] Walker2D update, {side}: {len(dev)} device events, busy "
              f"{busy / 1e3:.3f} of {window / 1e3:.3f} ms")
        for name, ms in top.items():
            print(f"[trace]   {side} {ms:9.3f} ms  {name}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--updates", type=int, default=10)
    p.add_argument("--horizon", type=int, default=32)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--calls", type=int, default=200)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("split_train_rate: no CUDA device", file=sys.stderr)
        return 1
    import mocca_envs_tpu_torch as port
    from mocca_envs_tpu_torch.harness import train
    from mocca_envs_tpu_torch.ops.cuda import engine
    from mocca_envs_tpu_torch.utils.device import pin_fp32

    pin_fp32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    tree = str(Path(__file__).resolve().parent)
    print(f"{card}; {tree}")
    summary = {"tree": tree, "card": card, "families": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for env_id in FAMILIES:
            run = train_rates(train, engine, env_id, args.updates, args.horizon, Path(tmp))
            for line in run["lines"]:
                print(f"[rate] {env_id} update {line['step']}: {line['env_steps_per_s']:.0f} "
                      f"env-steps/s, rollout {line['rollout_s']:.4f} s, PPO update "
                      f"{line['update_s']:.4f} s")
            ms, steps_by = step_ms(port, train, engine, env_id, args.steps)
            print(f"[rate] {env_id}: training launches {run['launches']}; env step {ms:.4f} "
                  f"ms over {args.steps} steps × {B} envs, launches {steps_by}")
            summary["families"][env_id] = medians(run, ms)
        summary["launch_host_us"] = launch_host_us(engine, args.calls)
        print(f"[rate] the split planar K1 wrapper's host µs per call: "
              f"{summary['launch_host_us']}")
        summary["twin_turns"] = {env_id: twin_turns(port, train, engine, env_id, args, Path(tmp))
                                 for env_id in FAMILIES}
        summary["traced"] = traced_sides(train, engine, Path(tmp))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
