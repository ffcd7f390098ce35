"""Sharded batched env stepping over a mesh.

Counterpart of ``mocca_envs_tpu/parallel/sharded.py``: the env batch is
split over the mesh's ``env`` axis and every rank steps its own shard.
Stepping is embarrassingly parallel (per-env state, per-rank generators,
``core/rng.py``), so a step runs no collective; collectives appear only at
the learner (``harness/ppo.py``).

The JAX package offers two styles: :func:`sharded_env` (``jit`` with
sharding constraints, the partitioning left to GSPMD) and
:func:`shard_mapped_env` (explicit per-shard code under ``shard_map``).
Under one process per device both are the same thing, each rank's step on
its own shard, so both names are kept for readers of either and share one
implementation.
"""

from __future__ import annotations

from mocca_envs_tpu_torch.core import rng as rng_mod
from mocca_envs_tpu_torch.envs.env import EnvState, FnEnv, Transition
from mocca_envs_tpu_torch.parallel.mesh import env_sharding


def sharded_init(env: FnEnv, mesh, num_envs: int, seed: int = 0):
    """This rank's shard of a ``num_envs`` batch of fresh episodes, and the
    generator that drives it (``rng.rank_seed(seed, rank)``: on a mesh of
    one, ``BatchedEnv(env, num_envs, seed)``'s). Returns ``(state, gen)``."""
    if num_envs % mesh.size != 0:
        raise ValueError(f"num_envs={num_envs} must divide evenly over {mesh.size} devices")
    gen = rng_mod.generator(rng_mod.rank_seed(seed, mesh.rank), env.device)
    sl = env_sharding(mesh).slots(num_envs)
    return env.init(gen, sl.stop - sl.start), gen


def sharded_env(env: FnEnv, mesh):
    """The batched step of this rank's shard, ``step(state, actions, gen) →
    Transition``: the actions are the shard's rows, the generator the one
    :func:`sharded_init` returned."""
    del mesh   # every rank steps its own shard: nothing to partition

    def step(state: EnvState, actions, gen) -> Transition:
        if actions.shape[0] != state.q.shape[0]:
            raise ValueError(f"{actions.shape[0]} actions for a shard of {state.q.shape[0]} "
                             "envs: pass this rank's rows")
        return env.step(state, actions, gen)

    return step


# the explicit per-shard style of the JAX package: the same step here
shard_mapped_env = sharded_env
