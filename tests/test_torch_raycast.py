"""PyTorch port vs the JAX package: rays marched over one heightfield grid
(ops/raycast.py, CPU).

The port's plain version against the JAX package's ``raycast_reference`` on
the same rays over a fractal grid: t and h to 1e-5 (the gate
tests/test_raycast.py holds the TPU kernel to). The flat-ground hit and the
miss are checked against their analytic values. The CUDA kernel's own
arithmetic is checked on the host, and on a card against the plain
version, in tests/test_torch_kernel_wrapper.py (which imports no JAX).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocca_envs_tpu.ops.pallas import raycast as jraycast
from mocca_envs_tpu_torch.ops import raycast as traycast
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.terrain.heightfield import fractal_heightfield

from tests import torch_workers  # noqa: F401

T = torch.as_tensor


def fractal_rays(n, B, seed, span=8.0):
    """Rays over a fractal ``n × n`` grid 20 m wide: origins 1–2.5 m above
    the grid's plane over it and past its edges, directions pitched 10–80°
    down in any heading, a few pointing up (misses). Numpy ``(origins,
    directions, grid, xy0, cell)``."""
    rng = np.random.default_rng(seed)
    hf = fractal_heightfield(n, amplitude=0.5, seed=seed)
    origins = np.stack([rng.uniform(-span, span, B), rng.uniform(-span, span, B),
                        rng.uniform(1.0, 2.5, B)], axis=1).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, B)
    pitch = rng.uniform(np.deg2rad(10), np.deg2rad(80), B)
    pitch[: B // 16] *= -1.0
    d = np.stack([np.cos(pitch) * np.cos(yaw), np.cos(pitch) * np.sin(yaw), -np.sin(pitch)],
                 axis=1).astype(np.float32)
    return (origins, d, hf, np.array([-10.0, -10.0], np.float32),
            np.array(20.0 / (n - 1), np.float32))


@pytest.mark.parametrize("n, max_t, steps", [(65, 10.0, 64), (129, 6.0, 37), (17, 4.0, 16)])
def test_reference_matches_jax_over_fractal_terrain(n, max_t, steps):
    o, d, hf, xy0, cell = fractal_rays(n, 1024, n)
    want_t, want_h = jraycast.raycast_reference(jnp.asarray(o), jnp.asarray(d), jnp.asarray(hf),
                                                jnp.asarray(xy0), jnp.asarray(cell), max_t, steps)
    got_t, got_h = traycast.raycast_reference(T(o), T(d), T(hf), T(xy0), T(cell), max_t, steps)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5)
    # hits and misses both (a hit on the last step also gives max_t)
    assert 0.3 < (got_t.numpy() < max_t).mean() < 1.0


def test_reference_hits_flat_ground_and_misses():
    hf = torch.zeros(65, 65)
    xy0, cell = T([-10.0, -10.0]), T(20.0 / 64)
    origins = T([[0.0, 0.0, 1.0]]).repeat(8, 1)
    down45 = T([[np.sqrt(0.5), 0.0, -np.sqrt(0.5)]]).repeat(8, 1)
    t, h = traycast.raycast_reference(origins, down45, hf, xy0, cell, max_t=5.0, num_steps=200)
    # the first march point at or past t = 1/sin 45° = √2
    dt = 5.0 / 200
    assert ((t >= np.sqrt(2.0) - 1e-5) & (t <= np.sqrt(2.0) + dt)).all()
    np.testing.assert_allclose(h.numpy(), 0.0, atol=1e-6)
    up = T([[0.0, 0.0, 1.0]])
    t, h = traycast.raycast_reference(origins[:1], up, hf, xy0, cell, max_t=3.0)
    assert float(t[0]) == 3.0 and float(h[0]) == 0.0


def test_raycaster_runs_the_plain_version_on_cpu_tensors():
    """On CPU tensors ``make_raycaster`` runs the plain version, uncounted,
    at any number of rays (no tile multiple)."""
    o, d, hf, xy0, cell = fractal_rays(33, 37, 1)
    raycast = traycast.make_raycaster((33, 33), max_t=6.0, num_steps=24)
    engine.LAUNCHES.clear()
    got = raycast(T(o), T(d), T(hf), T(xy0), T(cell))
    want = traycast.raycast_reference(T(o), T(d), T(hf), T(xy0), T(cell), 6.0, 24)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    assert got[0].shape == (37,) and sum(engine.LAUNCHES.values()) == 0
