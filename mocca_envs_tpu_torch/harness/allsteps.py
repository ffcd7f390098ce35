"""ALLSTEPS curriculum pipeline as a first-class harness.

Counterpart of ``mocca_envs_tpu/harness/allsteps.py``: the training
procedure of "ALLSTEPS: Curriculum-driven Learning of Stepping Stone
Skills" (Xie et al., SCA 2020) over the port's envs, every phase PPO over
the batched env on one device (the CUDA card unless ``device="cpu"``),
checkpoint-resumable, with the JAX package's recipe constants:

  P1  pretrain  — walk-to-target until a speed gate (exploration floor
      −1.0 keeps standing still unstable)
  P2  transfer  — the stepper with a stone-dominated reward (step_bonus 18,
      tall 1.0) and the per-env curriculum (adv_threshold 8); the obs
      prefix is the walker's, so the policy transfers by embedding
      (``harness/transfer.py``)
  P3  high-stage dwell — every env pinned to a hard-stage mixture, the
      log-std floor annealed −1.0 → −2.0
  P4  fixed-stage ladder — deterministic episode-end stones reached at
      pinned stages: the skill statistic

Usage (CLI)::

    python -m mocca_envs_tpu_torch.harness.allsteps --num-envs 4096 --seed 1 \\
        --ckpt-root ckpt/allsteps

or programmatic: ``run_allsteps(AllstepsConfig(...), RunHooks(...),
device=...)``; a script that runs it passes emit / heartbeat / deadline
hooks; the defaults print JSON lines and never stop early.

Unlike the JAX learner, the port's ``train_step`` does not donate its
input: it trains the network, the optimizer and the generators of the
state it is given in place. A phase seeded from an earlier phase's state
(P3 from P2's) therefore consumes that state, as donation does in the JAX
package; P2 seeds from a transfer, which copies P1's network.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Any, Callable

import numpy as np
import torch

from mocca_envs_tpu_torch.harness.checkpoint import CheckpointManager
from mocca_envs_tpu_torch.harness.ppo import PPOConfig, PPOLearner
from mocca_envs_tpu_torch.harness.transfer import transfer_train_state
from mocca_envs_tpu_torch.tasks import walker_stepper as ws
from mocca_envs_tpu_torch.tasks.walker_stepper import StepperParams, make_walker3d_stepper
from mocca_envs_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RunHooks:
    """Side-channel callbacks the calling script owns; defaults are inert."""

    emit: Callable[..., None] = lambda **kw: print(json.dumps(kw), flush=True)
    beat: Callable[[], None] = lambda: None          # liveness heartbeat
    time_left: Callable[[], float] = lambda: float("inf")


@dataclasses.dataclass(frozen=True)
class AllstepsConfig:
    """Every field and default of the JAX package's ``AllstepsConfig``."""

    num_envs: int = 4096
    seed: int = 1
    ckpt_root: str = "ckpt/allsteps"
    # PPO shape (identical across phases so checkpoints / transfer line up)
    horizon: int = 128
    num_epochs: int = 4
    num_minibatches: int = 32
    hidden: tuple = (256, 256)
    lr: float = 3e-4
    reward_scale: float = 0.1
    mirror_coef: float = 4.0
    # P1 pretrain
    pretrain_updates: int = 1200
    pretrain_min_updates: int = 300
    speed_gate: float = 1.2          # m/s batch mean; early stop with...
    done_gate: float = 0.01          # ...episode_done_rate below this
    # P2 stepper transfer
    stepper_updates: int = 2200
    stepper_min_updates: int = 400
    stage_stop: float = 8.5          # early stop at this mean curriculum stage
    adv_threshold: float = 8.0
    step_bonus: float = 18.0
    tall_bonus: float = 1.0
    transfer_log_std: float = -0.5
    orient_obs: bool = True
    # near-miss shaping weight (StepperParams.w_nearmiss); 0.0 = off
    w_nearmiss: float = 0.0
    # P3 pinned high-stage dwell
    highstage_updates: int = 900
    pin_lo: int = 4                  # env i pinned to lo + i % (hi - lo + 1)
    pin_hi: int = 9
    floor_explore: float = -1.0
    floor_final: float = -2.0
    floor_anneal_updates: int = 600
    # P4 ladder
    eval_stages: tuple = (0, 2, 4, 5, 6)
    eval_steps: int = 700
    # bookkeeping
    checkpoint_every: int = 150
    log_every: int = 50
    deadline_margin_s: float = 600.0

    def ppo(self, **over) -> PPOConfig:
        base = dict(
            horizon=self.horizon,
            num_epochs=self.num_epochs,
            num_minibatches=self.num_minibatches,
            hidden=self.hidden,
            lr=self.lr,
            reward_scale=self.reward_scale,
            mirror_coef=self.mirror_coef,
            log_std_min=self.floor_explore,
        )
        base.update(over)
        return PPOConfig(**base)

    def stepper_params(self, pinned: bool = False) -> StepperParams:
        sp = dataclasses.replace(
            StepperParams.default(),
            adv_threshold=99.0 if pinned else float(self.adv_threshold),
            step_bonus=float(self.step_bonus),
            w_nearmiss=float(self.w_nearmiss),
        )
        return dataclasses.replace(
            sp, walker=dataclasses.replace(sp.walker, tall_bonus=float(self.tall_bonus)))


# --------------------------------------------------------------- phases
def _done_marker(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "PHASE_DONE")


def _mark_done(ckpt_dir: str, **info) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(_done_marker(ckpt_dir), "w") as f:
        f.write(json.dumps(info))


def restore_latest(learner: PPOLearner, ckpt_dir: str, seed: int):
    """Newest checkpoint in ``ckpt_dir`` restored into a fresh state, or
    None: the fallback after a crash, when a state a later phase consumed
    is gone from memory and the disk holds the only copy."""
    mgr = CheckpointManager(ckpt_dir, max_to_keep=2)
    try:
        step = mgr.latest_step()
        if step is None:
            return None
        return mgr.restore(learner.init(seed=seed), step)
    except Exception:
        return None
    finally:
        mgr.close()


def train_phase(
    learner: PPOLearner,
    ckpt_dir: str,
    n_updates: int,
    tag: str,
    cfg: AllstepsConfig,
    hooks: RunHooks,
    seed_state=None,
    zero_update_count: bool = False,
    pin_stages=None,
    stop_fn: Callable[[int, dict, Any], bool] | None = None,
):
    """One checkpoint-resumable PPO phase.

    Resume from ``ckpt_dir`` when checkpoints exist (a PHASE_DONE marker
    short-circuits retraining on re-entry; a checkpoint of another
    structure is wiped); otherwise seed from ``seed_state`` (or a fresh
    init), which the phase then trains in place. ``stop_fn(update, row,
    state)`` stops early; a deadline (``hooks.time_left``) truncates WITHOUT
    marking done, so a relaunch continues. Returns (state, finished)."""
    mgr = CheckpointManager(ckpt_dir, max_to_keep=2)
    state = learner.init(seed=cfg.seed)
    start = mgr.latest_step()
    if start is not None:
        try:
            state = mgr.restore(state, start)
            hooks.emit(phase=tag, resumed_from=start)
        except Exception:
            mgr.close()
            shutil.rmtree(ckpt_dir, ignore_errors=True)
            mgr = CheckpointManager(ckpt_dir, max_to_keep=2)
            state = learner.init(seed=cfg.seed)
            start = None
            hooks.emit(phase=tag, resume_failed="structure mismatch — wiped")
    if start is not None and os.path.exists(_done_marker(ckpt_dir)):
        hooks.emit(phase=tag, already_done_at=start)
        mgr.close()
        return state, True
    if start is None:
        start = 0
        if seed_state is not None:
            state = seed_state
            if zero_update_count:
                state = dataclasses.replace(state, update_count=0)
            if pin_stages is not None:
                state = dataclasses.replace(
                    state, env_state=ws.set_stage(state.env_state, pin_stages))
            hooks.emit(phase=tag, seeded=True)
    if start >= n_updates:
        _mark_done(ckpt_dir, at=start)
        mgr.close()
        return state, True

    t0 = time.time()
    u = start
    finished = True
    for u in range(start, n_updates):
        hooks.beat()
        state, metrics = learner.train_step(state)
        if (u + 1) % cfg.log_every == 0 or u == start:
            # each float() waits for the device
            row = {k: round(float(v), 4) for k, v in metrics.items()
                   if not k.startswith(("env/", "ep_end/"))}
            if "ep_end/steps_reached" in metrics and np.isfinite(
                    float(metrics["ep_end/steps_reached"])):
                row["ep_steps"] = round(float(metrics["ep_end/steps_reached"]), 3)
            task = getattr(state.env_state, "task", None)
            if task is not None and hasattr(task, "stage"):
                row["mean_stage"] = round(float(task.stage.mean()), 3)
                row["max_stage"] = float(task.stage.max())
            row["speed"] = round(
                float(torch.linalg.norm(state.env_state.qd[:, 0:2], dim=1).mean()), 3)
            dt = max(time.time() - t0, 1e-9)
            n = cfg.log_every if u > start else 1
            row["env_steps_per_s"] = round(cfg.num_envs * cfg.horizon * n / dt)
            hooks.emit(phase=tag, update=u + 1, **row)
            t0 = time.time()
            if stop_fn is not None and stop_fn(u + 1, row, state):
                hooks.emit(phase=tag, update=u + 1, early_stop=True)
                break
        if (u + 1) % cfg.checkpoint_every == 0:
            mgr.save(u + 1, state)
            mgr.wait()
        if hooks.time_left() < cfg.deadline_margin_s and (u + 1) % cfg.log_every == 0:
            hooks.emit(phase=tag, truncated_at=u + 1, reason="deadline")
            finished = False
            break
    if u + 1 > start and (u + 1) % cfg.checkpoint_every != 0:
        mgr.save(u + 1, state)
        mgr.wait()
    if finished:
        _mark_done(ckpt_dir, at=u + 1)
    mgr.close()
    return state, finished


@torch.no_grad()
def episode_ends(env, net, state, env_state, cfg, hooks: RunHooks, stage, deterministic: bool,
                 noise_seed: int, fields, pinned: bool):
    """Run the policy ``net`` (on ``state``'s obs normalizer) for
    ``cfg.eval_steps`` steps from ``env_state``, and return, for the
    episodes that end, the task values ``fields(task)`` read before their
    last step (numpy arrays), and whether the deadline truncated the run.
    With ``pinned`` only episodes begun under the pinned stage count: the
    first auto-reset after ``set_stage`` replays the carried layout, so
    episodes ending at ``reset_count ≤ start + 1`` are discarded. ``state``
    is left as it was: the env draws from a copy of its env generator, the
    policy noise (``deterministic=False``) from a generator seeded
    ``noise_seed``. The obs is carried (``tr.obs``) as in the training
    rollout, computed once here: recomputing ``obs_fn`` per step would
    re-run the task's contact queries."""
    norm = state.obs_norm
    rc0 = env_state.reset_count.clone()
    env_gen = torch.Generator(device=env.device)
    env_gen.set_state(state.env_key.get_state())
    noise_gen = torch.Generator(device=env.device).manual_seed(noise_seed)
    obs = env.obs_fn(env_state)
    values, dones = [], []
    truncated = False
    for t in range(cfg.eval_steps):
        if t % 50 == 0:
            hooks.beat()
            # a queue's hard timeout must not land mid-eval and drop the row:
            # truncate and report what there is
            if hooks.time_left() < 60.0:
                truncated = True
                hooks.emit(phase="eval_truncated", stage=stage, at_step=t)
                break
        mean, log_std, _ = net(norm.normalize(obs))
        if deterministic:
            a = mean
        else:
            noise = torch.randn(mean.shape, generator=noise_gen, device=mean.device)
            a = mean + torch.exp(torch.clamp(log_std, min=cfg.floor_final)) * noise
        values.append(fields(env_state.task))
        tr = env.step(env_state, a, env_gen)
        env_state, obs = tr.state, tr.obs
        dones.append(tr.done & (env_state.reset_count > rc0 + 1) if pinned else tr.done)
    if not values:
        return [np.zeros(0, np.float32) for _ in fields(env_state.task)], truncated
    ended = torch.stack(dones)
    # each field in its own dtype (the stone and bar indices stay integers)
    return [torch.stack(v)[ended].cpu().numpy() for v in zip(*values)], truncated


def eval_fixed_stage(
    env,
    net,
    state,
    stage: float,
    cfg: AllstepsConfig,
    hooks: RunHooks = RunHooks(),
    deterministic: bool = True,
) -> dict:
    """Episode-end stones reached at a pinned stage (the ALLSTEPS skill
    statistic): only completed episodes count, and only episodes begun under
    the pinned stage (:func:`episode_ends`). ``net`` is the policy module
    (``state.params``); the policy noise is seeded ``97 + stage``."""
    env_state = ws.set_stage(state.env_state, float(stage))
    # full chain = last stone index (stone_top is (B, K, 3))
    last_stone = env_state.task.stone_top.shape[-2] - 1
    (ds,), truncated = episode_ends(env, net, state, env_state, cfg, hooks, stage,
                                    deterministic, 97 + int(stage),
                                    lambda task: (task.next_step,), pinned=True)
    if not ds.size:
        # no fabricated zero-score episode: a no-data eval must be
        # distinguishable from a policy that scores 0
        return dict(
            stage=stage, deterministic=deterministic, truncated=truncated,
            episodes=0,
            ep_end_steps_mean=None, ep_end_steps_p50=None,
            ep_end_steps_p90=None, frac_ge_4=None, frac_ge_8=None,
            frac_complete=None,
        )
    return dict(
        stage=stage,
        deterministic=deterministic,
        truncated=truncated,
        episodes=int(ds.size),
        ep_end_steps_mean=round(float(ds.mean()), 2),
        ep_end_steps_p50=float(np.percentile(ds, 50)),
        ep_end_steps_p90=float(np.percentile(ds, 90)),
        frac_ge_4=round(float((ds >= 4).mean()), 3),
        frac_ge_8=round(float((ds >= 8).mean()), 3),
        frac_complete=round(float((ds >= last_stone).mean()), 3),
    )


# ------------------------------------------------------------------ run
def run_allsteps(cfg: AllstepsConfig, hooks: RunHooks = RunHooks(), device=None) -> dict:
    """Full pipeline on ``device`` (None = the CUDA card, raising without
    one); returns {phase: outcome} including the P4 ladder."""
    import mocca_envs_tpu_torch

    device = resolve_device(device)
    root = os.path.abspath(os.path.join(cfg.ckpt_root, f"s{cfg.seed}"))
    results: dict[str, Any] = {"config": dataclasses.asdict(cfg)}

    # P1 — pretrain the walker
    walker = mocca_envs_tpu_torch.make("Walker3DCustomEnv-v0", device=device)
    pre_learner = PPOLearner(walker, cfg.ppo(), num_envs=cfg.num_envs)

    def pre_stop(u, row, state):
        return (
            u >= cfg.pretrain_min_updates
            and row.get("speed", 0.0) > cfg.speed_gate
            and row.get("episode_done_rate", 1.0) < cfg.done_gate
        )

    pre_state, ok = train_phase(
        pre_learner, f"{root}/pre", cfg.pretrain_updates, "pretrain",
        cfg, hooks, stop_fn=pre_stop,
    )
    results["pretrain_finished"] = ok
    if not ok:
        return results

    # P2 — stepper transfer (the obs tail grows; the prefix is embedded)
    st_env = make_walker3d_stepper(
        params=cfg.stepper_params(), orient_obs=cfg.orient_obs,
        name="AllstepsStepper", device=device,
    )
    st_learner = PPOLearner(st_env, cfg.ppo(), num_envs=cfg.num_envs)
    seeded = transfer_train_state(
        pre_state,
        st_learner.init(seed=cfg.seed),
        reset_log_std=cfg.transfer_log_std,
    )

    def st_stop(u, row, state):
        return (
            u >= cfg.stepper_min_updates
            and float(state.env_state.task.stage.mean()) >= cfg.stage_stop
        )

    st_state, ok = train_phase(
        st_learner, f"{root}/st", cfg.stepper_updates, "stepper",
        cfg, hooks, seed_state=seeded, stop_fn=st_stop,
    )
    results["stepper_finished"] = ok
    if not ok:
        return results

    # P3 — pinned high-stage dwell with the floor anneal; it trains
    # st_state in place (its checkpoints in st/ stay as P2 left them)
    hs_env = make_walker3d_stepper(
        params=cfg.stepper_params(pinned=True), orient_obs=cfg.orient_obs,
        name="AllstepsStepperHS", device=device,
    )
    hs_learner = PPOLearner(
        hs_env,
        cfg.ppo(
            log_std_min=cfg.floor_explore,
            log_std_min_final=cfg.floor_final,
            log_std_anneal_updates=cfg.floor_anneal_updates,
        ),
        num_envs=cfg.num_envs,
    )
    span = cfg.pin_hi - cfg.pin_lo + 1
    pin = cfg.pin_lo + (torch.arange(cfg.num_envs, device=device) % span).to(torch.float32)
    hs_state, ok = train_phase(
        hs_learner, f"{root}/hs", cfg.highstage_updates, "highstage",
        cfg, hooks, seed_state=st_state, zero_update_count=True,
        pin_stages=pin,
    )
    results["highstage_finished"] = ok
    best = hs_state

    # P4 — the fixed-stage ladder
    ladder = []
    for stage in cfg.eval_stages:
        row = eval_fixed_stage(hs_env, best.params, best, stage, cfg, hooks)
        hooks.emit(phase="ladder", **row)
        ladder.append(row)
    results["ladder"] = ladder
    return results


def main(argv=None, device=None) -> None:
    """The CLI; ``device=None`` is the CUDA card (raises without one)."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--ckpt-root", default="ckpt/allsteps")
    p.add_argument("--pretrain-updates", type=int, default=1200)
    p.add_argument("--stepper-updates", type=int, default=2200)
    p.add_argument("--highstage-updates", type=int, default=900)
    p.add_argument("--no-orient-obs", action="store_true")
    p.add_argument("--eval-stages", type=int, nargs="*", default=[0, 2, 4, 5, 6])
    p.add_argument("--horizon", type=int, default=128)
    p.add_argument("--num-epochs", type=int, default=4)
    p.add_argument("--num-minibatches", type=int, default=32)
    p.add_argument("--hidden", type=int, nargs="*", default=[256, 256])
    p.add_argument("--eval-steps", type=int, default=700)
    p.add_argument("--w-nearmiss", type=float, default=0.0,
                   help="swing-foot near-miss shaping weight (0 = off)")
    args = p.parse_args(argv)
    cfg = AllstepsConfig(
        num_envs=args.num_envs,
        seed=args.seed,
        ckpt_root=args.ckpt_root,
        pretrain_updates=args.pretrain_updates,
        stepper_updates=args.stepper_updates,
        highstage_updates=args.highstage_updates,
        orient_obs=not args.no_orient_obs,
        eval_stages=tuple(args.eval_stages),
        horizon=args.horizon,
        num_epochs=args.num_epochs,
        num_minibatches=args.num_minibatches,
        hidden=tuple(args.hidden),
        eval_steps=args.eval_steps,
        w_nearmiss=args.w_nearmiss,
    )
    out = run_allsteps(cfg, device=device)
    print(json.dumps({"ladder": out.get("ladder")}, indent=2))


if __name__ == "__main__":
    main()
