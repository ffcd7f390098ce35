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
"""

from __future__ import annotations

import torch

__all__ = ["generator", "uniform"]


def generator(seed: int, device) -> torch.Generator:
    """Map an integer seed to the generator that drives a batched env."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def uniform(gen: torch.Generator, shape, lo, hi, dtype=torch.float32) -> torch.Tensor:
    """Uniform draw in [lo, hi) on the generator's device."""
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return lo + (hi - lo) * u
