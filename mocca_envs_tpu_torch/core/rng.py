"""Seeding: the port's documented mapping from a seed to random draws.

The JAX package derives one threefry key per env slot and per episode
(``mocca_envs_tpu/core/rng.py``: seed → fold_in(slot) → fold_in(reset
count)). Threefry cannot be reproduced with torch's generators, so the port
fixes its own mapping and the tests compare reset sampling in distribution,
never bit for bit:

    seed int s  →  one ``torch.Generator`` on the env's device,
                   ``manual_seed(s)``, owned by the batched env.

Every control step draws, for ALL slots at once and in this fixed order:

1. the target resample of ``raw_step`` (distance, then bearing), used by
   the slots that reached their target;
2. the fresh episode of ``reset`` (joint noise, then target distance, then
   bearing), used by the slots that are done.

Other families draw their own fresh episodes in the same way, in the order
their ``reset`` documents (the stepper: joint noise, then the stone chain;
the monkey: joint noise, then the bar chain; the terrain families: the
walker's draws, then, at init only, each slot's pick of a grid from the
family's bank — fresh episodes keep their slot's grid and draw no pick).

Draws happen whether or not a slot uses them, so a trajectory depends only
on the seed, the batch size and the actions: same seed ⇒ same episodes.

Where one seed drives several streams (the mixed suite: one generator per
family), stream i takes the seed :func:`fold_in` ``(s, i)``, numpy's
``SeedSequence([s, i])``, in place of the JAX package's ``fold_in``.

Over a mesh (``parallel/``: one process per device, rank r of W holding
its own shard of every batch) each stream takes :func:`rank_seed`: rank 0
keeps the single-device seed (the env's ``s``, the learner's ``s +
LEARNER_SEED_OFFSET``, family f's ``fold_in(s, f)``), rank r ≥ 1 takes
``fold_in(·, r)`` of it. The JAX learner does the same: its unsharded
step consumes ``fold_in(key, 0)`` to mirror the mesh path, so a mesh of one
device is bit for bit the run without a mesh. The network's initial
parameters come from the seed itself on every rank, and the learner checks
that they agree across ranks (``parallel/multihost.py``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fold_in", "generator", "rank_seed", "uniform"]


def generator(seed: int, device) -> torch.Generator:
    """Map an integer seed to the generator that drives a batched env."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def fold_in(seed: int, index: int) -> int:
    """The seed of stream ``index`` under ``seed``: 64 bits of numpy's
    ``SeedSequence([seed, index])``, so that no two (seed, index) pairs
    share a stream in practice."""
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0])


def rank_seed(seed: int, rank: int) -> int:
    """The seed of a stream on mesh rank ``rank``: ``seed`` itself on rank
    0, ``fold_in(seed, rank)`` on every other rank."""
    return int(seed) if rank == 0 else fold_in(seed, rank)


def uniform(gen: torch.Generator, shape, lo, hi, dtype=torch.float32) -> torch.Tensor:
    """Uniform draw in [lo, hi) on the generator's device."""
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return lo + (hi - lo) * u
