"""Fractal heightfields for uneven-terrain scenes, generated on the host.

Counterpart of ``mocca_envs_tpu/terrain/heightfield.py``. The JAX package
calls ``native/heightfield.cpp`` (diamond-square seeded by SplitMix64)
through ctypes; the port carries its own numpy transcription of that
generator, which gives the same grids bit for bit:

- SplitMix64 is counter based (the k-th draw mixes ``seed + k·γ``), so all
  draws are made at once in uint64;
- every float operation is float32, in the order of the C++ source (one
  diamond or square level at a time: the points of a level read only
  points of earlier levels and of that level's diamond pass);
- the 3×3 box blur adds the in-range neighbours in the source's (dr, dc)
  order and divides by their count;
- the mean is summed one value after the other in float64 (``np.cumsum``,
  not the pairwise ``np.sum``).
"""

from __future__ import annotations

import numpy as np
import torch

from mocca_envs_tpu_torch.terrain.scene import NO_GROUND_Z, Scene

_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def _uniform_draws(seed: int, count: int) -> np.ndarray:
    """The first ``count`` draws of the C++ ``SplitMix64::uniform_pm1``,
    float32: ``float(mix(seed + k·γ) >> 11 · 2⁻⁵²) · 2 − 1``."""
    k = np.arange(1, count + 1, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = np.uint64(seed & (2**64 - 1)) + k * _GAMMA
        z = (z ^ (z >> np.uint64(30))) * _M1
        z = (z ^ (z >> np.uint64(27))) * _M2
    z = z ^ (z >> np.uint64(31))
    u = ((z >> np.uint64(11)).astype(np.float64) * (1.0 / 4503599627370496.0)).astype(np.float32)
    return u * np.float32(2.0) - np.float32(1.0)


def _draw_count(n: int) -> int:
    count, step = 4, n - 1
    while step > 1:
        half = step // 2
        count += len(range(half, n, step)) ** 2
        count += sum(len(range(half if (r // half) % 2 == 0 else 0, n, step))
                     for r in range(0, n, half))
        step //= 2
    return count


def fractal_heightfield(n: int = 129, roughness: float = 0.55, amplitude: float = 0.5,
                        seed: int = 0, smooth_iters: int = 1) -> np.ndarray:
    """Diamond-square fractal terrain, ``(n, n)`` float32, zero mean;
    ``n`` must be 2^k + 1."""
    if n < 3 or ((n - 1) & (n - 2)) != 0:
        raise ValueError(f"n must be a power of two plus one, got {n}")
    f32 = np.float32
    amp, rough = f32(amplitude), f32(roughness)
    draws = _uniform_draws(seed, _draw_count(n))
    used = 0

    def take(count):
        nonlocal used
        used += count
        return draws[used - count:used]

    h = np.zeros((n, n), np.float32)
    corners = take(4) * amp
    h[0, 0], h[0, n - 1], h[n - 1, 0], h[n - 1, n - 1] = corners
    scale = amp
    step = n - 1
    while step > 1:
        half = step // 2
        # diamond: centres in row-major order
        c = np.arange(half, n, step)
        avg = f32(0.25) * (((h[np.ix_(c - half, c - half)] + h[np.ix_(c - half, c + half)])
                            + h[np.ix_(c + half, c - half)]) + h[np.ix_(c + half, c + half)])
        h[np.ix_(c, c)] = avg + take(c.size * c.size).reshape(c.size, c.size) * scale
        # square: edge midpoints row by row, each from its in-range neighbours
        rows, cols = [], []
        for r in range(0, n, half):
            cs = np.arange(half if (r // half) % 2 == 0 else 0, n, step)
            rows.append(np.full(cs.size, r))
            cols.append(cs)
        r, cc = np.concatenate(rows), np.concatenate(cols)
        total = np.zeros(r.size, np.float32)
        cnt = np.zeros(r.size, np.float32)
        for ok, rr, c2 in ((r >= half, r - half, cc), (r + half < n, r + half, cc),
                           (cc >= half, r, cc - half), (cc + half < n, r, cc + half)):
            total = np.where(ok, total + h[np.where(ok, rr, 0), np.where(ok, c2, 0)], total)
            cnt += ok
        h[r, cc] = total / cnt + take(r.size) * scale
        scale = scale * rough
        step //= 2
    for _ in range(smooth_iters):
        p = np.pad(h, 1)
        valid = np.pad(np.ones((n, n), np.float32), 1)
        total = np.zeros((n, n), np.float32)
        cnt = np.zeros((n, n), np.float32)
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                sl = (slice(1 + dr, 1 + dr + n), slice(1 + dc, 1 + dc + n))
                total = np.where(valid[sl] > 0, total + p[sl], total)
                cnt += valid[sl]
        h = total / cnt
    mean = np.cumsum(h.ravel().astype(np.float64))[-1] / h.size
    return h - np.float32(mean)


def with_heightfield(heights: torch.Tensor, extent: float = 20.0,
                     friction: float = 0.8) -> Scene:
    """Scene over per-env heightfields ``heights (B, H, W)`` centred at the
    origin, ``extent`` metres along the grid's first axis. There is no plane:
    its height sinks to ``NO_GROUND_Z``, where it never wins a contact."""
    B, H, _ = heights.shape
    dev = heights.device
    return Scene(
        ground_z=torch.full((B,), NO_GROUND_Z, dtype=torch.float32, device=dev),
        friction=torch.full((B,), friction, dtype=torch.float32, device=dev),
        hf_height=heights,
        hf_xy0=torch.full((B, 2), -extent / 2.0, dtype=torch.float32, device=dev),
        hf_cell=torch.full((B,), extent / (H - 1), dtype=torch.float32, device=dev),
    )
