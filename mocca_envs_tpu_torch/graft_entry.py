"""Entry hooks: the one-device step and the multi-device dry run.

Counterpart of the JAX package's ``__graft_entry__.py``. :func:`entry`
returns the flagship model's (``Walker3DCustomEnv``) batched step with
example arguments. :func:`dryrun_multichip` runs, over a mesh of N devices
(one process per device, ``parallel/``), one sharded env step, one full
training step (:func:`harness.ppo.dryrun_train_step`) and BASELINE config
5: the mixed trio (Walker3D, Cassie, Monkey3DStepper) feeding one learner,
whose replicated parameters must agree across the ranks.
"""

from __future__ import annotations

import socket

import torch

TRIO = ("Walker3DCustomEnv-v0", "CassieEnv-v0", "Monkey3DStepperEnv-v0")
TIMEOUT_S = 900.0   # the dry run's ranks, started to finished


def entry(device=None):
    """``(fn, (state, actions))``: ``fn(state, actions)`` steps 256 walker
    slots on ``device`` (None = the CUDA card)."""
    import mocca_envs_tpu_torch as port
    from mocca_envs_tpu_torch.core import rng as rng_mod

    env = port.make("Walker3DCustomEnv-v0", device=device)
    B = 256
    gen = rng_mod.generator(0, env.device)
    state = env.init(gen, B)
    actions = torch.zeros((B, env.act_dim), device=env.device)

    def fn(state, actions):
        return env.step(state, actions, gen)

    return fn, (state, actions)


def dryrun(mesh) -> None:
    """The dry run on this rank of ``mesh``; raises if anything fails."""
    import mocca_envs_tpu_torch as port
    from mocca_envs_tpu_torch.harness.mixed import MixedSuite
    from mocca_envs_tpu_torch.harness.ppo import PPOConfig, PPOLearner, dryrun_train_step
    from mocca_envs_tpu_torch.parallel.multihost import check_replica_divergence
    from mocca_envs_tpu_torch.parallel.sharded import sharded_env, sharded_init

    n = mesh.size
    env = port.make("Walker3DCustomEnv-v0", device=mesh.device)
    B = 2 * n
    state, gen = sharded_init(env, mesh, B, seed=0)
    tr = sharded_env(env, mesh)(state, torch.zeros((B // n, env.act_dim), device=mesh.device),
                                gen)
    if not bool(torch.isfinite(tr.state.q).all()):
        raise RuntimeError("the sharded step left a non-finite state")
    dryrun_train_step(env, mesh, B)
    suite = MixedSuite(TRIO, (n,) * 3, device=mesh.device)
    cfg = PPOConfig(horizon=2, num_epochs=1, num_minibatches=1, hidden=(16, 16))
    learner = PPOLearner(suite, cfg, mesh=mesh)
    state, _ = learner.train_step(learner.init(seed=0))
    if not check_replica_divergence(state.params, mesh):
        raise RuntimeError("the learner's parameters parted across the ranks")


def _rank_main(rank: int, world: int, port_: int, device) -> None:
    import torch.distributed as dist

    from mocca_envs_tpu_torch.parallel import multihost
    from mocca_envs_tpu_torch.parallel.mesh import env_mesh

    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port_}", world, rank, device=device)
    try:
        dryrun(env_mesh(world, device=device))
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The dry run over ``n_devices`` processes started here over localhost,
    one per CUDA card (``device=None``) or on the CPU (``device="cpu"``,
    gloo). Raises if a rank fails or the ranks outlast ``TIMEOUT_S``."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_main, args=(n_devices, free_port(), device),
                             nprocs=n_devices, join=False, start_method="spawn")
    join(ctx, TIMEOUT_S)


def join(ctx, timeout: float) -> None:
    """Wait for every process of ``ctx`` (``torch.multiprocessing``); a rank
    that raised raises here, and ranks still running at ``timeout`` seconds
    are killed and raise."""
    import time

    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.001)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(5)
            raise TimeoutError(f"the ranks did not finish in {timeout} s")
