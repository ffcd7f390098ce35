"""The ranks of the port's multi-process CPU tests (tests/test_torch_multihost_spawn.py).

Each function runs in one process of a group of ``world`` on the CPU
(gloo over localhost), started by :func:`run_ranks` with
``torch.multiprocessing``'s spawn method; it reads its inputs from
``outdir/inputs.pt`` and writes what it computed to ``outdir/rank<r>.pt``
for the test to compare. It imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path

import torch


@contextlib.contextmanager
def cpu_mesh(rank: int, world: int, port: int):
    """Join a gloo group of ``world`` over localhost and yield its mesh."""
    import torch.distributed as dist

    from mocca_envs_tpu_torch.parallel import multihost
    from mocca_envs_tpu_torch.parallel.mesh import env_mesh

    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        yield env_mesh(world, device="cpu")
    finally:
        dist.destroy_process_group()


def run_ranks(fn, outdir: Path, world: int = 2, timeout: float = 300.0) -> list:
    """Run ``fn(rank, world, port, outdir)`` in ``world`` processes and
    return what each wrote, by rank."""
    import torch.multiprocessing as mp

    from mocca_envs_tpu_torch.graft_entry import free_port, join

    ctx = mp.start_processes(fn, args=(world, free_port(), str(outdir)), nprocs=world,
                             join=False, start_method="spawn")
    join(ctx, timeout)
    return [torch.load(Path(outdir) / f"rank{r}.pt", weights_only=False) for r in range(world)]


def step_shard(rank: int, world: int, port: int, outdir: str) -> None:
    """Step this rank's slots of the given walker states with and without
    auto-reset, each from the given states."""
    import mocca_envs_tpu_torch as port_pkg
    from mocca_envs_tpu_torch.parallel.mesh import env_sharding
    from mocca_envs_tpu_torch.parallel.sharded import sharded_env

    inputs = torch.load(Path(outdir) / "inputs.pt", weights_only=False)
    with cpu_mesh(rank, world, port) as mesh:
        env = port_pkg.make(inputs["env_id"], device="cpu")
        shard = env_sharding(mesh)
        state, actions = shard.local(inputs["state"]), shard.local(inputs["actions"])
        gen = torch.Generator().manual_seed(1000 + rank)
        raw = env.step_no_reset(state, actions, gen)
        tr = sharded_env(env, mesh)(state, actions, gen)
        torch.save({"raw": raw, "step": tr}, Path(outdir) / f"rank{rank}.pt")


def _env_part(state) -> dict:
    """A train state's env shard and env generators, as tensors."""
    return {"env_state": state.env_state, "env_key": [g.get_state() for g in state.env_key]}


def update_and_mixed(rank: int, world: int, port: int, outdir: str) -> None:
    """The learner's update on this rank's slice of a given trajectory,
    then the mixed trio trained 2 updates into one learner, saved through
    the mesh's checkpoint and restored into a learner seeded otherwise."""
    import mocca_envs_tpu_torch as port_pkg
    from mocca_envs_tpu_torch.harness.checkpoint import CheckpointManager
    from mocca_envs_tpu_torch.harness.mixed import MixedSuite
    from mocca_envs_tpu_torch.harness.ppo import PPOLearner
    from mocca_envs_tpu_torch.parallel.mesh import env_sharding
    from mocca_envs_tpu_torch.parallel.multihost import check_replica_divergence, fingerprint

    inputs = torch.load(Path(outdir) / "inputs.pt", weights_only=False)
    out = {}
    with cpu_mesh(rank, world, port) as mesh:
        env = port_pkg.make(inputs["env_id"], device="cpu")
        learner = PPOLearner(env, inputs["config"], mesh=mesh, num_envs=inputs["num_envs"])
        traj = inputs["traj"]
        sl = env_sharding(mesh).slots(inputs["num_envs"])
        local = dataclasses.replace(
            traj, obs=traj.obs[:, sl], action=traj.action[:, sl], log_prob=traj.log_prob[:, sl],
            value=traj.value[:, sl], reward=traj.reward[:, sl], done=traj.done[:, sl],
            last_obs=traj.last_obs[sl],
            env_metrics={k: v[:, sl] for k, v in traj.env_metrics.items()})
        state, metrics = learner.update(learner.init(seed=0), local)
        out["update"] = {"params": state.params.state_dict(), "obs_norm": state.obs_norm,
                         "ret_norm": state.ret_norm, "metrics": metrics}

        suite = MixedSuite(MixedSuite.DEFAULT, inputs["family_counts"], device="cpu")
        learner = PPOLearner(suite, inputs["mixed_config"], mesh=mesh)
        state = learner.init(seed=0)
        for _ in range(2):
            state, metrics = learner.train_step(state)
        out["mixed"] = {"fingerprint": fingerprint(state.params),
                        "same": check_replica_divergence(state.params, mesh),
                        "metrics": {k: float(v) for k, v in metrics.items()},
                        "update_count": state.update_count,
                        "local_envs": [int(s.q.shape[0]) for s in state.env_state]}
        ckpt = CheckpointManager(str(Path(outdir) / "ckpt"), mesh=mesh)
        ckpt.save(2, state)
        fresh = learner.init(seed=1)
        out["ckpt"] = {"saved": _env_part(state), "fresh": _env_part(fresh)}
        restored = ckpt.restore(fresh)   # loads the generators and the network in place
        out["ckpt"].update(restored=_env_part(restored), fingerprint=fingerprint(restored.params))
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


def train_cli(rank: int, world: int, port: int, outdir: str) -> None:
    """The training CLI as rank ``rank`` of ``world`` (``--multihost`` over
    localhost, the arguments in ``outdir/inputs.pt``)."""
    import torch.distributed as dist

    from mocca_envs_tpu_torch.harness import train
    from mocca_envs_tpu_torch.parallel.multihost import fingerprint

    torch.set_num_threads(1)
    argv = torch.load(Path(outdir) / "inputs.pt", weights_only=False)["argv"] + [
        "--multihost", "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world),
        "--process-id", str(rank)]
    try:
        state = train.main(argv, device="cpu")
    finally:
        dist.destroy_process_group()
    torch.save({"fingerprint": fingerprint(state.params),
                "local_envs": int(state.env_state.q.shape[0])}, Path(outdir) / f"rank{rank}.pt")


def fail_rank_1(rank: int) -> None:
    if rank == 1:
        raise ValueError("rank 1 fails")


def sleep_60(rank: int) -> None:
    import time

    time.sleep(60)
