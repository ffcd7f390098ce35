"""The raycast kernel K2's two designs held to each other on the host: the
source (csrc/raycast_k2.cu) built by g++ under ``-DK2_HOST_CHECK``, no card
needed.

- the cooperative march (G lanes per ray: round k's lane ℓ takes step
  k·G + ℓ, the ballot's lowest set bit is the first hit) equals the
  one-thread-per-ray march bit for bit on t and h, at the source's own G
  and at 8, 16 and 32, over 17², 65², 129² and 257² grids, at 16, 37, 64
  and 100 steps (37 and 100 no multiple of G), on 1, 333 and 4,096 rays
  from ``chip_smoke.raycast_inputs``;
- it meets ``chip_smoke.check_rays`` against ``ops/raycast.py``'s plain
  version on the same rays;
- edge rays: an origin under the surface (a hit at step 1), hits on the
  last lane of a round and the first of the next, a hit on the last step
  (``t = num_steps·dt``, h not 0), a ray that never dips;
- the grid's placement: through L1 as shipped; built with
  ``-DK2_PLACE=1``, chosen on the host by its size: staged in each block's
  shared memory where it fits beside the block's counter, else through L1;
- ``make_raycaster(..., thread_per_ray=True)`` on CPU tensors runs the plain
  version, uncounted; on a card (skips elsewhere) the two designs' launches
  give the same bits and count under their own names.

The plain version is held to the JAX package's in tests/test_torch_raycast.py.
"""

import ctypes
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from mocca_envs_tpu_torch.ops import raycast as traycast
from mocca_envs_tpu_torch.ops.cuda import engine

from tests import torch_workers  # noqa: F401
from tests.torch_k1_host import build_raycast

T = torch.as_tensor
# None: the source's own G (and placement); the others by -DK2_G
GROUPS = (None, 8, 16, 32)
SMEM_PER_BLOCK = engine.SM90_SMEM["per_block"]


def host_library(g):
    return build_raycast(() if g is None else (f"-DK2_G={g}",))


@functools.lru_cache(maxsize=None)
def rays(n: int, count: int):
    return chip_smoke.raycast_inputs(np.random.default_rng(1000 * n + count), count, n)


def march(lib, design: str, o, d, hf, xy0, cell, max_t: float, steps: int):
    """``(t, h)`` of ``design`` ("thread" or "group") on numpy inputs."""
    fn = getattr(lib, "k2_raycast_host" if design == "thread" else "k2_raycast_group_host")
    fn.restype = ctypes.c_int
    B = o.shape[0]
    t, h = np.zeros(B, np.float32), np.zeros(B, np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    cell = np.ascontiguousarray(np.asarray(cell, np.float32).reshape(1))
    err = fn(ptr(o), ptr(d), ptr(hf), ctypes.c_int(hf.shape[0]), ctypes.c_int(hf.shape[1]),
             ptr(xy0), ptr(cell), ctypes.c_float(max_t), ctypes.c_float(max_t / steps),
             ctypes.c_int(steps), ptr(t), ptr(h), ctypes.c_int(B))
    assert err == 0
    return t, h


def test_the_source_builds_its_group_width():
    got = [host_library(g).k2_raycast_group() for g in GROUPS]
    assert got[1:] == [8, 16, 32] and got[0] in (8, 16, 32)


@pytest.mark.parametrize("steps", [16, 37, 64, 100])
@pytest.mark.parametrize("n", [17, 65, 129, 257])
@pytest.mark.parametrize("g", GROUPS)
def test_group_march_equals_thread_march_bit_for_bit(g, n, steps):
    lib = host_library(g)
    for count in (1, 333, 4096):
        args = rays(n, count)
        t, h = march(lib, "group", *args, 10.0, steps)
        tw, hw = march(lib, "thread", *args, 10.0, steps)
        assert np.array_equal(t, tw) and np.array_equal(h, hw), (count, int((t != tw).sum()))
    # hits in the first round and, where there is one, in later ones; misses
    dt = np.float32(10.0 / steps)
    G = lib.k2_raycast_group()
    assert (t <= G * dt).any() and (t == 10.0).any()
    assert G >= steps or ((t > G * dt) & (t < 10.0)).any()


@pytest.mark.parametrize("n, max_t, steps, count", [(129, 10.0, 64, 4096), (65, 6.0, 37, 1000),
                                                    (257, 10.0, 100, 2000),
                                                    (17, 4.0, 16, 333)])
@pytest.mark.parametrize("g", GROUPS)
def test_group_march_meets_the_plain_gate(g, n, max_t, steps, count):
    o, d, hf, xy0, cell = rays(n, count)
    t, h = march(host_library(g), "group", o, d, hf, xy0, cell, max_t, steps)
    want_t, want_h = (x.numpy() for x in traycast.raycast_reference(
        *map(T, (o, d, hf, xy0, cell)), max_t, steps))
    chip_smoke.check_rays(t, h, want_t, want_h, max_t / steps)
    assert 0.3 < (want_t < max_t).mean() < 1.0


@pytest.mark.parametrize("steps", [37, 64])
@pytest.mark.parametrize("g", GROUPS)
def test_edge_rays(g, steps):
    """On a level grid at height c: a ray from under the surface hits at
    step 1; rays straight down hit on the last lane of round 0, the first
    lane of round 1 and the last step; a ray upward never dips."""
    lib = host_library(g)
    G = lib.k2_raycast_group()
    max_t, c = 6.0, np.float32(0.25)
    dt = np.float32(max_t / steps)
    t_at = lambda i: np.float32(i + 1) * dt  # noqa: E731  (step i's t, as the kernel rounds it)
    hf = np.full((65, 65), c, np.float32)
    xy0, cell = np.array([-10.0, -10.0], np.float32), np.float32(20.0 / 64)
    down = np.array([0.0, 0.0, -1.0], np.float32)
    first_hit = [0, G - 1, G, steps - 1]                        # the step index of each hit
    o = np.array([[0.3, -0.7, c - 0.5],                        # under the surface
                  [1.1, 2.3, c + t_at(G - 1) - dt / 2],      # round 0's last lane
                  [-3.2, 0.4, c + t_at(G) - dt / 2],          # round 1's first lane
                  [4.7, -5.1, c + t_at(steps - 1) - dt / 2],  # the last step
                  [0.0, 0.0, 1.0]], np.float32)               # upward: no hit
    d = np.stack([np.array([0.6, 0.0, -0.8], np.float32), down, down, down,
                  np.array([0.3, 0.2, 0.93], np.float32)])
    t, h = march(lib, "group", o, d, hf, xy0, cell, max_t, steps)
    tw, hw = march(lib, "thread", o, d, hf, xy0, cell, max_t, steps)
    assert np.array_equal(t, tw) and np.array_equal(h, hw)
    assert [float(x) for x in t[:4]] == [float(t_at(i)) for i in first_hit]
    assert t[3] == np.float32(steps) * dt and (h[:4] != 0).all()
    np.testing.assert_allclose(h[:4], c, atol=1e-6)
    assert t[4] == np.float32(max_t) and h[4] == 0.0
    want_t, want_h = traycast.raycast_reference(*map(T, (o, d, hf, xy0, cell)), max_t, steps)
    assert np.array_equal(t, want_t.numpy())
    np.testing.assert_allclose(h, want_h.numpy(), atol=1e-6)


def staged(H: int, W: int) -> bool:
    """The placement rule: the grid (padded to 16 bytes) beside the block's
    16-byte tile counter within a block's opt-in shared memory on sm_90."""
    return 16 + (H * W * 4 + 15) // 16 * 16 <= SMEM_PER_BLOCK


@pytest.mark.parametrize("place", [None, 0, 1])
def test_grid_placement_by_size(place):
    lib = build_raycast(() if place is None else (f"-DK2_PLACE={place}",))
    shapes = [(17, 17), (65, 65), (129, 129), (241, 241), (242, 242), (257, 257), (513, 513),
              (129, 257), (300, 200), (2, 29_054), (2, 29_055)]
    got = {s: bool(lib.k2_raycast_placement(*s)) for s in shapes}
    if place != 1:
        # the shipped kernel reads every grid through L1
        assert not any(got.values())
        return
    assert got == {s: staged(*s) for s in shapes}
    assert got[(129, 129)] and got[(65, 65)] and got[(241, 241)]
    assert not got[(242, 242)] and not got[(257, 257)]
    assert got[(2, 29_054)] and not got[(2, 29_055)]


def test_thread_twin_raycaster_runs_the_plain_version_on_cpu_tensors():
    o, d, hf, xy0, cell = rays(33, 37)
    engine.LAUNCHES.clear()
    for thread_per_ray in (False, True):
        raycast = traycast.make_raycaster((33, 33), max_t=6.0, num_steps=24,
                                          thread_per_ray=thread_per_ray)
        got = raycast(T(o), T(d), T(hf), T(xy0), T(cell))
        want = traycast.raycast_reference(T(o), T(d), T(hf), T(xy0), T(cell), 6.0, 24)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert sum(engine.LAUNCHES.values()) == 0


@pytest.mark.cuda
def test_designs_bit_for_bit_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K2 kernels have no CPU mode")
    for n in (65, 129, 257):
        args = [T(x, device="cuda") for x in chip_smoke.raycast_inputs(
            np.random.default_rng(n), 5000, n)]
        engine.LAUNCHES.clear()
        t, h = traycast.make_raycaster((n, n))(*args)
        tw, hw = traycast.make_raycaster((n, n), thread_per_ray=True)(*args)
        torch.cuda.synchronize()
        assert dict(engine.LAUNCHES) == {"k2": 1, "k2_thread": 1}
        assert torch.equal(t, tw) and torch.equal(h, hw)
        want_t, want_h = traycast.raycast_reference(*args)
        chip_smoke.check_rays(*(x.cpu().numpy() for x in (t, h, want_t, want_h)), 10.0 / 64)
