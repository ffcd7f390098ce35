"""K2: rays marched over one heightfield grid, its wrapper and its plain
version.

Counterpart of ``mocca_envs_tpu/ops/pallas/raycast.py``: rays ``o + t·d``
take ``num_steps`` fixed steps ``t = (i + 1)·max_t / num_steps`` over a
shared ``H×W`` grid, one bilinear height per step; the first point at or
under the surface gives ``t_hit`` and the height there ``h_hit``; a ray that
never dips under gives ``max_t`` and 0. No env calls it: the LIDAR env
marches per-env windows through ``terrain/scene.py::hf_sample``.

- :func:`raycast_reference` is the plain PyTorch version, on any device.
- :func:`make_raycaster` returns ``raycast``, which runs the plain version
  on CPU tensors and launches the hand-written CUDA kernel
  (``csrc/raycast_k2.cu``, built with the engine kernels by
  ``ops/cuda/engine.py::build``) on CUDA tensors, raising where it cannot;
  it takes any number of rays. The kernel marches each ray with several
  lanes of a warp at once; ``thread_per_ray=True`` launches its
  one-thread-per-ray twin instead, which gives the same bits.
  ``LAUNCHES["k2"]`` (``["k2_thread"]`` for the twin) of
  ``ops/cuda/engine.py`` counts its launches.
- :func:`k2_flops` and :func:`k2_bytes` give the work one call needs, for
  its bound.
"""

from __future__ import annotations

import ctypes

import torch

from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.terrain.scene import Scene, hf_sample


def raycast_reference(origins: torch.Tensor, directions: torch.Tensor, hf: torch.Tensor,
                      xy0: torch.Tensor, cell: torch.Tensor, max_t: float = 10.0,
                      num_steps: int = 64):
    """``origins (B,3), directions (B,3)`` over ``hf (H,W)`` with its corner
    at ``xy0 (2,)`` and cell size ``cell ()`` → ``(t_hit (B,), h_hit (B,))``.
    All march points are sampled at once and the first hit taken."""
    B = origins.shape[0]
    t = torch.arange(1, num_steps + 1, dtype=torch.float32, device=origins.device) * (
        max_t / num_steps)
    p = origins[:, None, :] + t[None, :, None] * directions[:, None, :]      # (B, S, 3)
    grid = Scene(ground_z=hf.new_zeros(1), friction=hf.new_zeros(1), hf_height=hf[None],
                 hf_xy0=xy0.reshape(1, 2), hf_cell=cell.reshape(1))
    h = hf_sample(grid, p[..., :2].reshape(1, -1, 2)).reshape(B, num_steps)
    below = p[..., 2] <= h
    first = torch.argmax(below.to(torch.int8), dim=1, keepdim=True)
    hit = below.any(dim=1)
    t_hit = torch.where(hit, t[first[:, 0]], torch.full_like(t[:1], max_t).expand(B))
    h_hit = torch.where(hit, torch.gather(h, 1, first)[:, 0], h.new_zeros(B))
    return t_hit, h_hit


def make_raycaster(hf_shape: tuple, max_t: float = 10.0, num_steps: int = 64,
                   thread_per_ray: bool = False):
    """Build ``raycast(origins (B,3), directions (B,3), hf (H,W), xy0 (2,),
    cell ()) → (t_hit (B,), h_hit (B,))`` for grids of ``hf_shape``. On CUDA
    tensors it launches the cooperative march of ``csrc/raycast_k2.cu``
    (counted as ``LAUNCHES["k2"]``), or with ``thread_per_ray=True`` its
    one-thread-per-ray twin (``LAUNCHES["k2_thread"]``), which gives the
    same bits; the library's launch is looked up once, at the first CUDA
    call."""
    H, W = hf_shape
    dt = max_t / num_steps
    suffix, count = (("_thread_launch", "k2_thread") if thread_per_ray else ("_launch", "k2"))
    launch = None

    def raycast(origins, directions, hf, xy0, cell):
        nonlocal launch
        if origins.device.type == "cpu":
            return raycast_reference(origins, directions, hf, xy0, cell, max_t, num_steps)
        B = origins.shape[0]
        cell = cell.reshape(1)
        want = {"origins": (origins, (B, 3)), "directions": (directions, (B, 3)),
                "hf": (hf, (H, W)), "xy0": (xy0, (2,)), "cell": (cell, (1,))}
        for name, (x, shape) in want.items():
            if tuple(x.shape) != shape:
                raise ValueError(f"k2: {name} has shape {tuple(x.shape)}, want {shape}")
            if x.dtype != torch.float32:
                raise TypeError(f"k2: {name} must be float32, got {x.dtype}")
            if x.device != origins.device or x.device.type != "cuda":
                raise ValueError(f"k2: {name} must be on {origins.device} (CUDA), got {x.device}")
            if not x.is_contiguous():
                raise ValueError(f"k2: {name} must be contiguous")
        if launch is None:
            launch = getattr(engine.build()[engine.RAYCAST_SYMBOL], engine.RAYCAST_SYMBOL + suffix)
        t_hit = torch.empty(B, dtype=torch.float32, device=origins.device)
        h_hit = torch.empty_like(t_hit)
        stream = torch.cuda.current_stream(origins.device).cuda_stream
        with torch.cuda.device(origins.device):
            err = launch(origins.data_ptr(), directions.data_ptr(), hf.data_ptr(), H, W,
                         xy0.data_ptr(), cell.data_ptr(), ctypes.c_float(max_t),
                         ctypes.c_float(dt), num_steps, t_hit.data_ptr(), h_hit.data_ptr(), B,
                         stream)
        if err != 0:
            raise RuntimeError(f"k2 launch failed: cudaError {err}")
        engine.LAUNCHES[count] += 1
        return t_hit, h_hit

    return raycast


# fp32 operations of one march step: t (1), the point (6), the cell (2
# subtractions, 2 divisions, 2 clamps of 2), the floors and fractions (4),
# 1 − f (2), the bilinear sum (8 products, 3 sums) and the compare (1)
K2_OPS_PER_STEP = 33


def k2_flops(t_hit: torch.Tensor, max_t: float, num_steps: int) -> int:
    """Operations one call needs on these rays: a ray's march ends at its
    first hit, ``t_hit / dt`` steps in, or runs all ``num_steps``."""
    steps = torch.clamp(torch.round(t_hit / (max_t / num_steps)), 1, num_steps)
    return int(steps.double().sum()) * K2_OPS_PER_STEP


def k2_bytes(num_rays: int, hf_shape: tuple) -> int:
    """Bytes one call must move: origins and directions in, t and h out,
    the grid and its corner and cell read once."""
    H, W = hf_shape
    return 4 * (num_rays * (6 + 2) + H * W + 3)
