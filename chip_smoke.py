"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

1. print the card's name and power limit; build the K1a kernel from
   ``mocca_envs_tpu_torch/csrc/engine_k1a.cu``;
2. K1a vs its plain PyTorch version on B = 4096 walker states near contact:
   per-env median and p99 of |Δq|, |Δqd|, |Δdepth|, |Δimpulse|; the medians
   must stay within q 2e-4, qd 5e-3, depth 2e-4, impulse 5e-3, and the
   largest single-env error within ten times those;
3. the main path: ``BatchedEnv(make("Walker3DCustomEnv-v0"), 4096)`` for 600
   control steps of uniform random actions; the kernel must launch exactly
   once per step, the state stay finite and auto-reset fire;
4. per-call times of the kernel and the plain version (CUDA events), and
   the bound from the operations these inputs need (their active rows);
5. one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

B = 4096
STEPS = 600
SEED = 0
# per-env median tolerances of tests/test_pallas_engine.py (kernel vs oracle)
TOL = {"q": 2e-4, "qd": 5e-3, "depth": 2e-4, "nimp": 5e-3}
# published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def near_contact_states(model, rng):
    """Walker states with the base around 0.9 m: feet in or near contact."""
    q = np.zeros((B, model.nq), np.float32)
    q[:, 2] = 0.9 + 0.05 * rng.standard_normal(B)
    q[:, 3:7] = np.array([1.0, 0.0, 0.0, 0.0]) + 0.03 * rng.standard_normal((B, 4))
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q[:, 7:] = 0.1 * rng.standard_normal((B, model.nj))
    qd = (0.3 * rng.standard_normal((B, model.nv))).astype(np.float32)
    gain = model.power_coef.cpu().numpy()
    tau = (rng.uniform(-1.0, 1.0, (B, model.nj)) * gain).astype(np.float32)
    gz = np.zeros(B, np.float32)
    fric = np.full(B, 0.8, np.float32)
    return [torch.as_tensor(x, device="cuda") for x in (q, qd, tau, gz, fric)]


def time_call(fn, args, n: int) -> float:
    """Mean ms per call over ``n`` calls after two warm-up calls."""
    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import mocca_envs_tpu_torch as port
    from mocca_envs_tpu_torch.models import walker3d
    from mocca_envs_tpu_torch.ops.cuda import engine
    from mocca_envs_tpu_torch.utils.config import EngineConfig
    from mocca_envs_tpu_torch.utils.device import pin_fp32

    pin_fp32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- phase 1: build
    t0 = time.perf_counter()
    engine.build()
    print(f"[build] K1a built in {time.perf_counter() - t0:.1f} s")
    for line in engine._Library.log.splitlines():
        if "registers" in line or "stack frame" in line:
            print(f"[build] {line.strip()}")

    # ---- phase 2: kernel vs plain at the main path's shapes
    config = EngineConfig()
    model = walker3d.make_model("cuda")
    k1a = engine.K1a(model, config)
    args = near_contact_states(model, np.random.default_rng(SEED))
    out = k1a.launch(*args)
    torch.cuda.synchronize()
    ref = k1a.plain(*args)
    torch.cuda.synchronize()
    max_abs = 0.0
    for name, a, b in zip(("q", "qd", "depth", "nimp"), out, ref):
        check(bool(torch.isfinite(a).all()), f"kernel output {name} not finite")
        per_env = (a - b).abs().amax(dim=1).cpu().numpy()
        med, p99 = float(np.median(per_env)), float(np.quantile(per_env, 0.99))
        max_abs = max(max_abs, float(per_env.max()))
        print(f"[compare] {name}: per-env median {med:.3e} p99 {p99:.3e} "
              f"max {per_env.max():.3e} (median tol {TOL[name]:g}, max tol {10 * TOL[name]:g})")
        check(med <= TOL[name], f"K1a {name} median {med:.3e} > {TOL[name]:g}")
        check(per_env.max() <= 10 * TOL[name],
              f"K1a {name} max {per_env.max():.3e} > {10 * TOL[name]:g}")

    # ---- phase 3: the main path through the user entry points
    env = port.make("Walker3DCustomEnv-v0")
    batch = port.BatchedEnv(env, B, seed=SEED)
    state = batch.init()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    dones = torch.zeros((), dtype=torch.int64, device="cuda")
    engine.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        actions = torch.rand((B, env.act_dim), generator=gen, device="cuda") * 2.0 - 1.0
        tr = batch.step(state, actions)
        state = tr.state
        dones += tr.done.sum()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = engine.LAUNCHES["k1a"]
    dones = int(dones)
    print(f"[main] {STEPS} steps × {B} envs in {wall:.3f} s: "
          f"{STEPS * B / wall:.0f} env-steps/s on {card}; K1a launches {launches}")
    check(launches == STEPS, f"K1a launched {launches} times in {STEPS} control steps")
    check(bool(torch.isfinite(state.q).all() and torch.isfinite(state.qd).all()),
          "final state not finite")
    check(tr.obs.shape == (B, env.obs_dim) and bool(torch.isfinite(tr.obs).all()),
          "observations malformed")
    check(dones > 0 and int(state.reset_count.sum()) > 0, "auto-reset never fired")
    print(f"[main] episodes ended {dones}, resets {int(state.reset_count.sum())}, "
          f"blow-ups {int(state.blowup_count.sum())}, mean episode steps now "
          f"{float(state.steps.float().mean()):.1f}")

    # ---- phase 4: per-call times at B = 4096
    ms = time_call(k1a.launch, args, 50)
    plain_ms = time_call(k1a.plain, args, 3)
    lim_act, con_act = engine.k1a_activity(model, config, *args)
    flops = engine.k1a_flops(model, config, lim_act, con_act)
    flops_all = engine.k1a_flops(model, config, torch.ones_like(lim_act),
                                 torch.ones_like(con_act))
    nbytes = engine.k1a_bytes_per_env(model) * B
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    print(f"[bound] active per env and substep: limit rows "
          f"{float(lim_act.float().sum(2).mean()):.3f} of {lim_act.shape[2]}, contacts "
          f"{float(con_act.float().sum(2).mean()):.3f} of {con_act.shape[2]}; "
          f"{flops} fp32 ops needed ({flops / B:.0f} per env), {flops_all} with every row "
          f"active; {nbytes} bytes")
    print(f"[time] K1a {ms:.4f} ms/call, plain {plain_ms:.3f} ms/call at B={B} on {card}; "
          f"bound {bound_ms:.5f} ms by {'operations' if t_ops >= t_bytes else 'bytes'} "
          f"(ops {t_ops:.5f} ms, bytes {t_bytes:.5f} ms); kernel at {bound_ms / ms:.2%} of it")

    print(json.dumps({"kernels": [{
        "name": "k1a_engine_frame",
        "route": "cuda",
        "source": "mocca_envs_tpu_torch/csrc/engine_k1a.cu",
        "replaces": "mocca_envs_tpu/ops/pallas/engine.py:216",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
