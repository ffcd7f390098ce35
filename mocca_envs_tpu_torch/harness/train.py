"""Training CLI: PPO over a batched env, on one device or over a mesh.

Counterpart of ``mocca_envs_tpu/harness/train.py``, with its flags and
defaults:

    python -m mocca_envs_tpu_torch.harness.train \\
        --env Walker3DStepperEnv --num-envs 4096 --updates 1000 \\
        --ckpt-dir /tmp/ckpt --metrics out/metrics.jsonl

It runs on the CUDA card (``main(argv, device="cpu")`` runs the plain path
on the CPU; there is no fallback from one to the other). Features:
checkpointing with resume, the ``--init-from`` transfer, curriculum
reporting and advancement on the stepper families, split impulse
(``--split-impulse``: each family's own config with the flag on), the mixed
suite on one device (a comma-separated ``--env``: ``harness/mixed.py``,
``--num-envs`` split evenly over the families), metrics logging with
env-steps/s and the rollout and update seconds per update (and, for the
mixed suite, each family's rollout seconds, ``rollout_s/<family>``), an
optional profiler trace, and multi-device runs: ``--multihost`` joins the
process group (``parallel/multihost.py``: ``--coordinator host:port
--num-processes N --process-id r``, or a ``torchrun`` launch), and a group
of more than one process trains over the ``env`` mesh (one process per
device, ``--num-envs`` the global batch) unless ``--no-mesh`` is given.
Only the group's rank 0 logs metrics and prints. Under the mesh the
checkpoint holds every rank's shard and restores at the same number of
processes; under ``--no-mesh`` each rank trains on its own and rank 0
alone writes the checkpoint.

    torchrun --nproc-per-node 4 -m mocca_envs_tpu_torch.harness.train \\
        --multihost --env Walker3DCustomEnv,CassieEnv,Monkey3DStepperEnv
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "--env", default="Walker3DCustomEnv",
        help="env ID, or comma-separated IDs for the mixed multi-family "
        "suite (BASELINE config 5), e.g. "
        "'Walker3DCustomEnv,CassieEnv,Monkey3DStepperEnv'",
    )
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--updates", type=int, default=100)
    p.add_argument("--horizon", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--minibatches", type=int, default=4)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    p.add_argument("--log-every", type=int, default=5)
    p.add_argument("--profile-dir", default=None)
    p.add_argument(
        "--curriculum-threshold", type=float, default=None,
        help="HOST-side batch-mean curriculum advance (legacy). Stepper "
        "families advance per-env IN-GRAPH by default (ALLSTEPS adaptive "
        "curriculum — StepperParams.adv_threshold); leave unset for that.",
    )
    p.add_argument("--no-mesh", action="store_true")
    p.add_argument("--init-from", default=None,
                   help="checkpoint dir of a pretrained run to embed")
    p.add_argument("--init-env", default=None,
                   help="env ID the --init-from checkpoint was trained on")
    p.add_argument("--mirror-coef", type=float, default=0.0,
                   help="ALLSTEPS mirror-symmetry loss weight (0 = off)")
    p.add_argument("--log-std-min", type=float, default=-2.0,
                   help="exploration floor on the policy log-std "
                   "(-1.0 during pretrain keeps the standing local optimum "
                   "unstable — see BENCH.md ALLSTEPS notes)")
    p.add_argument("--reward-scale", type=float, default=1.0,
                   help="learner-side reward scaling (0.1 for walker families)")
    p.add_argument("--log-std-min-final", type=float, default=None,
                   help="anneal the exploration floor to this value over "
                   "--log-std-anneal updates (linear in update_count), then "
                   "hold — subsumes the two-phase pretrain/fine-tune recipe")
    p.add_argument("--log-std-anneal", type=int, default=0,
                   help="updates over which the floor anneals (0 = constant)")
    p.add_argument("--reset-log-std", type=float, default=None,
                   help="re-open exploration at --init-from transfer by "
                   "resetting the policy log-std to this value")
    p.add_argument("--lr-final", type=float, default=None,
                   help="anneal the learning rate linearly to this value "
                   "over --lr-anneal updates, then hold")
    p.add_argument("--lr-anneal", type=int, default=0,
                   help="updates over which the LR anneals (0 = constant)")
    p.add_argument("--normalize-reward", action="store_true",
                   help="scale rewards by the running std of the discounted "
                   "return before GAE (subsumes hand-tuned --reward-scale)")
    p.add_argument("--shuffle-mode", default="full", choices=("full", "time"),
                   help="PPO minibatch shuffle: 'full' exact per-sample "
                        "permutation, 'time' horizon-axis only (gather-free "
                        "on TPU; see PPOConfig.shuffle_mode)")
    p.add_argument("--split-impulse", action="store_true",
                   help="split-impulse position correction in the engine "
                        "(Bullet m_splitImpulse; EngineConfig.split_impulse)")
    p.add_argument("--multihost", action="store_true",
                   help="join the torch.distributed process group before building the mesh")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (omit under torchrun)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p.parse_args(argv)


def restore_compat(ckpt, state, num_envs: int):
    """Restore ``state`` tolerating a --normalize-reward flag mismatch.

    ``TrainState.ret_accum`` / ``ret_norm`` are present only when the run
    that saved the checkpoint had normalize_reward on, so a checkpoint
    saved on one side of the flag does not fit a template built on the
    other. Both the ``--ckpt-dir`` resume and the ``--init-from`` transfer
    survive the flip: try the template as it is, then the other shape, and
    attach or drop the reward-norm stats accordingly. ``num_envs`` is this
    process's batch (its shard under a mesh).
    """
    import torch

    from mocca_envs_tpu_torch.harness.checkpoint import CheckpointMismatch
    from mocca_envs_tpu_torch.harness.ppo import RunningNorm

    try:
        return ckpt.restore(state)
    except CheckpointMismatch:
        pass
    if state.ret_accum is not None:
        # the checkpoint predates --normalize-reward: restore the flag-off
        # structure, keep this run's fresh accumulator and normalizer
        bare = dataclasses.replace(state, ret_accum=None, ret_norm=None)
        restored = ckpt.restore(bare)
        return dataclasses.replace(restored, ret_accum=state.ret_accum, ret_norm=state.ret_norm)
    # the checkpoint was saved WITH --normalize-reward but this run is
    # flag-off: restore with placeholder stats of the canonical shapes, then
    # drop them
    device = state.obs_norm.mean.device
    full = dataclasses.replace(state, ret_accum=torch.zeros(num_envs, device=device),
                               ret_norm=RunningNorm.init(1, device))
    restored = ckpt.restore(full)
    return dataclasses.replace(restored, ret_accum=None, ret_norm=None)


def split_config(env_id: str):
    """The engine config of ``--split-impulse``: the family's own timing
    defaults (Cassie's CASSIE_CONFIG, every other family's EngineConfig())
    with only the flag flipped."""
    from mocca_envs_tpu_torch.utils.config import EngineConfig

    if env_id.startswith("Cassie"):
        from mocca_envs_tpu_torch.tasks.cassie_task import CASSIE_CONFIG

        return dataclasses.replace(CASSIE_CONFIG, split_impulse=True)
    return dataclasses.replace(EngineConfig(), split_impulse=True)


def maybe_advance_curriculum(state, metrics: dict, threshold: float | None,
                             pmean=lambda x: x):
    """Curriculum report and (with a ``threshold``) host-side advance: the
    stepper families' states carry a per-env stage. Without a threshold the
    envs advance themselves (StepperParams.adv_threshold) and the mean stage
    is only reported; with one, every env moves a stage up (at most 9) once
    the batch-mean stones reached clears it. Returns ``(state, mean stage
    or None)``. Under a mesh every rank calls it and ``pmean`` (the
    learner's) makes the mean stage the whole batch's, not this rank's
    shard's. The mixed suite's tuple of states has no stage: it passes
    unchanged."""
    task = getattr(state.env_state, "task", None)
    if task is None or not hasattr(task, "stage"):
        return state, None
    reached = metrics.get("env/steps_reached", metrics.get("steps_reached"))
    if threshold is None or reached is None or float(reached) < threshold:
        return state, float(pmean(task.stage.mean()))
    import torch

    new_stage = torch.clamp(task.stage + 1.0, max=9.0)
    env_state = dataclasses.replace(state.env_state,
                                    task=dataclasses.replace(task, stage=new_stage))
    return dataclasses.replace(state, env_state=env_state), float(pmean(new_stage.mean()))


def main(argv=None, device=None):
    """Train as the arguments say; ``device=None`` is the CUDA card (raises
    without one). Returns the final train state."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    if args.multihost:
        # before anything touches the CUDA card
        from mocca_envs_tpu_torch.parallel import multihost

        multihost.initialize(coordinator_address=args.coordinator,
                             num_processes=args.num_processes, process_id=args.process_id,
                             device=device)

    import torch.distributed as dist

    import mocca_envs_tpu_torch as port
    from mocca_envs_tpu_torch.harness.checkpoint import CheckpointManager
    from mocca_envs_tpu_torch.harness.metrics import MetricsLogger
    from mocca_envs_tpu_torch.harness.ppo import PPOConfig, PPOLearner
    from mocca_envs_tpu_torch.parallel.mesh import env_mesh
    from mocca_envs_tpu_torch.utils.device import resolve_device

    mesh = None
    if not args.no_mesh and dist.is_initialized() and dist.get_world_size() > 1:
        mesh = env_mesh(device=device)
        device = mesh.device
    device = resolve_device(device)
    # the process group's rank 0, with or without a mesh: under --no-mesh
    # every rank trains on its own and rank 0 alone logs and checkpoints
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    if mesh is not None and rank0:
        logging.info("mesh over %d devices (%d processes)", mesh.size, dist.get_world_size())
    if "," in args.env:
        if args.split_impulse:
            raise SystemExit("--split-impulse is not wired for mixed suites yet; "
                             "run the families separately")
        from mocca_envs_tpu_torch.harness.mixed import MixedSuite

        ids = tuple(s.strip() for s in args.env.split(","))
        env = MixedSuite(ids, (args.num_envs // len(ids),) * len(ids), device=device)
        args.num_envs = env.num_envs
    else:
        env = (port.make(args.env, device=device, config=split_config(args.env))
               if args.split_impulse else port.make(args.env, device=device))
    family_timer = getattr(env, "timer", None)
    cfg = PPOConfig(
        horizon=args.horizon,
        num_epochs=args.epochs,
        num_minibatches=args.minibatches,
        lr=args.lr,
        mirror_coef=args.mirror_coef,
        log_std_min=args.log_std_min,
        log_std_min_final=args.log_std_min_final,
        log_std_anneal_updates=args.log_std_anneal,
        reward_scale=args.reward_scale,
        lr_final=args.lr_final,
        lr_anneal_updates=args.lr_anneal,
        normalize_reward=args.normalize_reward,
        shuffle_mode=args.shuffle_mode,
    )
    learner = PPOLearner(env, cfg, mesh=mesh, num_envs=args.num_envs)
    state = learner.init(seed=args.seed)

    if args.init_from:
        # ALLSTEPS pretrain → transfer: restore the source family's state and
        # prefix-embed its policy and obs stats into this learner's
        from mocca_envs_tpu_torch.harness.transfer import transfer_train_state

        src_env = port.make(args.init_env or args.env, device=device)
        src_learner = PPOLearner(src_env, dataclasses.replace(cfg, mirror_coef=0.0), mesh=mesh,
                                 num_envs=args.num_envs)
        src_state = restore_compat(CheckpointManager(args.init_from, mesh=mesh),
                                   src_learner.init(seed=args.seed), learner.local_envs)
        state = transfer_train_state(src_state, state, reset_log_std=args.reset_log_std)
        if rank0:
            logging.info("transferred pretrained policy from %s (%s)", args.init_from,
                         src_env.name)

    ckpt = CheckpointManager(args.ckpt_dir, mesh=mesh) if args.ckpt_dir else None
    # a mesh's checkpoint is written by every rank together; without one
    # only rank 0 writes, and every rank reads it back
    save = ckpt is not None and (mesh is not None or rank0)
    start_update = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        state = restore_compat(ckpt, state, learner.local_envs)
        start_update = int(state.update_count)
        if rank0:
            logging.info("resumed from update %d", start_update)
    if ckpt is not None and mesh is None and dist.is_initialized():
        # rank 0 writes only once every rank has looked for a checkpoint
        dist.barrier()

    mlog = MetricsLogger(jsonl_path=args.metrics) if rank0 else None
    steps_per_update = args.num_envs * args.horizon
    prof_ctx = None
    if args.profile_dir:
        from mocca_envs_tpu_torch.harness.profile import trace

        prof_ctx = trace(args.profile_dir)
        prof_ctx.__enter__()

    t0 = time.time()
    stage_s0 = dict(learner.timer.times)
    family_s0 = dict(family_timer.times) if family_timer is not None else {}
    for u in range(start_update, args.updates):
        state, metrics = learner.train_step(state)
        if (u + 1) % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m["env_steps_per_s"] = steps_per_update * args.log_every / max(
                time.time() - t0, 1e-9)
            # seconds per update of the rollouts and of the PPO updates
            for stage in ("rollout", "update"):
                m[f"{stage}_s"] = (learner.timer.times.get(stage, 0.0)
                                   - stage_s0.get(stage, 0.0)) / args.log_every
            if family_timer is not None:
                # the mixed suite: each family's share of the rollout
                for name, secs in family_timer.times.items():
                    m[f"rollout_s/{name}"] = (secs - family_s0.get(name, 0.0)) / args.log_every
                family_s0 = dict(family_timer.times)
            state, stage = maybe_advance_curriculum(state, m, args.curriculum_threshold,
                                                    learner.pmean)
            if stage is not None:
                m["curriculum_stage"] = stage
            t0 = time.time()
            stage_s0 = dict(learner.timer.times)
            if mlog is not None:
                mlog.log(u + 1, m)
        if save and (u + 1) % args.ckpt_every == 0:
            ckpt.save(u + 1, state)

    if prof_ctx is not None:
        prof_ctx.__exit__(None, None, None)
    if save:
        ckpt.save(args.updates, state)
        ckpt.wait()
        ckpt.close()
    if mlog is not None:
        mlog.close()
    return state


if __name__ == "__main__":
    main()
