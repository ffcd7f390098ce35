"""Monkey brachiation pipeline as a first-class harness.

Counterpart of ``mocca_envs_tpu/harness/brachiation.py``: the suite's
second headline skill (``Monkey3DStepperEnv``): swing hand over hand along
a generated chain of bars with grab / release dynamics, with the JAX
package's recipe:

- a bar-dominated reward with ``hold_grace`` (the alive bonus stops paying
  60 control steps after the last bar hit) and ``w_swing`` (the CoM's
  speed toward the next bar pays while holding);
- ``progress_timeout``: an episode with no new bar for 120 steps ends;
- the per-env spacing curriculum at ``adv_threshold`` 4;
- a main phase at the exploration floor −1.0, then a fine-tune with the
  floor annealed −1.0 → −2.0; then bar evals, pinned and adaptive.

CLI (the CUDA card; ``run_brachiation(..., device="cpu")`` runs the plain
path)::

    python -m mocca_envs_tpu_torch.harness.brachiation --num-envs 4096 --seed 1
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np

from mocca_envs_tpu_torch.harness.allsteps import (
    RunHooks,
    episode_ends,
    restore_latest,  # noqa: F401  (the crash fallback, as in the JAX module)
    train_phase,
)
from mocca_envs_tpu_torch.harness.ppo import PPOConfig, PPOLearner
from mocca_envs_tpu_torch.tasks.monkey_stepper import (
    MonkeyParams,
    make_monkey3d_stepper,
    set_stage,
)
from mocca_envs_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BrachiationConfig:
    """Every field and default of the JAX package's ``BrachiationConfig``."""

    num_envs: int = 4096
    seed: int = 1
    ckpt_root: str = "ckpt/brachiation"
    horizon: int = 128
    num_epochs: int = 4
    num_minibatches: int = 32
    hidden: tuple = (256, 256)
    lr: float = 3e-4
    reward_scale: float = 0.1
    # the shaping of the JAX package's solved recipe
    adv_threshold: float = 4.0
    alive_bonus: float = 0.3
    hold_grace: int = 60
    w_swing: float = 0.5
    progress_timeout: int = 120
    # phases: the solved schedule, 2500 + 800 updates
    main_updates: int = 2500
    ft_updates: int = 800
    floor_explore: float = -1.0
    floor_final: float = -2.0
    floor_anneal_updates: int = 600
    # eval
    eval_steps: int = 700
    eval_stages: tuple = (9.0,)   # pinned hardest spacing by default
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
            log_std_min=self.floor_explore,
        )
        base.update(over)
        return PPOConfig(**base)

    def monkey_params(self, pinned: bool = False) -> MonkeyParams:
        return dataclasses.replace(
            MonkeyParams(),
            adv_threshold=99.0 if pinned else float(self.adv_threshold),
            alive_bonus=float(self.alive_bonus),
            hold_grace=int(self.hold_grace),
            w_swing=float(self.w_swing),
            progress_timeout=int(self.progress_timeout),
        )


def eval_bars(
    env,
    net,
    state,
    cfg: BrachiationConfig,
    stage: float | None = None,
    hooks: RunHooks = RunHooks(),
    deterministic: bool = True,
) -> dict:
    """Episode-end bars reached (the brachiation skill statistic).
    ``stage`` pins every env's spacing stage; None evaluates at the carried
    per-env stages. With a pinned stage only episodes begun under it count
    (``allsteps.episode_ends``). ``net`` is the policy module
    (``state.params``); the policy noise is seeded ``41 + stage``."""
    env_state = state.env_state
    if stage is not None:
        env_state = set_stage(env_state, float(stage))
    (db, dg), truncated = episode_ends(env, net, state, env_state, cfg, hooks, stage,
                                       deterministic, 41 + int(stage or 0),
                                       lambda task: (task.next_bar, task.stage),
                                       pinned=stage is not None)
    if not db.size:
        return dict(
            stage=stage, deterministic=deterministic, truncated=truncated,
            episodes=0,
            ep_end_bars_mean=None, ep_end_bars_p50=None,
            ep_end_bars_p90=None, frac_ge_4=None, stage_mean=None,
        )
    return dict(
        stage=stage,
        deterministic=deterministic,
        truncated=truncated,
        episodes=int(db.size),
        ep_end_bars_mean=round(float(db.mean()), 2),
        ep_end_bars_p50=float(np.percentile(db, 50)),
        ep_end_bars_p90=float(np.percentile(db, 90)),
        frac_ge_4=round(float((db >= 4).mean()), 3),
        stage_mean=round(float(dg.mean()), 3),
    )


def run_brachiation(cfg: BrachiationConfig, hooks: RunHooks = RunHooks(),
                    device=None) -> dict:
    """Main (spacing curriculum) → floor-anneal fine-tune → bar evals, on
    ``device`` (None = the CUDA card, raising without one). The fine-tune
    trains the main phase's state in place."""
    device = resolve_device(device)
    root = os.path.abspath(os.path.join(cfg.ckpt_root, f"s{cfg.seed}"))
    results: dict[str, Any] = {"config": dataclasses.asdict(cfg)}

    env = make_monkey3d_stepper(params=cfg.monkey_params(), name="BrachiationMonkey",
                                device=device)
    learner = PPOLearner(env, cfg.ppo(), num_envs=cfg.num_envs)
    state, ok = train_phase(
        learner, f"{root}/main", cfg.main_updates, "monkey_main",
        cfg, hooks,
    )
    results["main_finished"] = ok
    if not ok:
        return results

    ft_learner = PPOLearner(
        env,
        cfg.ppo(
            log_std_min=cfg.floor_explore,
            log_std_min_final=cfg.floor_final,
            log_std_anneal_updates=cfg.floor_anneal_updates,
        ),
        num_envs=cfg.num_envs,
    )
    ft_state, ok = train_phase(
        ft_learner, f"{root}/ft", cfg.ft_updates, "monkey_ft",
        cfg, hooks, seed_state=state, zero_update_count=True,
    )
    results["ft_finished"] = ok

    evals = []
    for stage in cfg.eval_stages:
        row = eval_bars(env, ft_state.params, ft_state, cfg, stage, hooks)
        hooks.emit(phase="bar_eval", **row)
        evals.append(row)
    # the adaptive-stage row (what the curriculum parked each env at)
    row = eval_bars(env, ft_state.params, ft_state, cfg, None, hooks)
    hooks.emit(phase="bar_eval", **row)
    evals.append(row)
    results["evals"] = evals
    return results


def main(argv=None, device=None) -> None:
    """The CLI; ``device=None`` is the CUDA card (raises without one)."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--ckpt-root", default="ckpt/brachiation")
    p.add_argument("--main-updates", type=int, default=2500)
    p.add_argument("--ft-updates", type=int, default=800)
    p.add_argument("--horizon", type=int, default=128)
    p.add_argument("--num-epochs", type=int, default=4)
    p.add_argument("--num-minibatches", type=int, default=32)
    p.add_argument("--hidden", type=int, nargs="*", default=[256, 256])
    p.add_argument("--eval-steps", type=int, default=700)
    p.add_argument("--eval-stages", type=float, nargs="*", default=[9.0])
    args = p.parse_args(argv)
    cfg = BrachiationConfig(
        num_envs=args.num_envs,
        seed=args.seed,
        ckpt_root=args.ckpt_root,
        main_updates=args.main_updates,
        ft_updates=args.ft_updates,
        horizon=args.horizon,
        num_epochs=args.num_epochs,
        num_minibatches=args.num_minibatches,
        hidden=tuple(args.hidden),
        eval_steps=args.eval_steps,
        eval_stages=tuple(args.eval_stages),
    )
    out = run_brachiation(cfg, device=device)
    print(json.dumps({"evals": out.get("evals")}, indent=2))


if __name__ == "__main__":
    main()
