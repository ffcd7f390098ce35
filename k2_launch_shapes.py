"""Designs of the raycast kernel K2's cooperative march on one NVIDIA GPU:
lanes per ray G ∈ {8, 16, 32} × the grid read through L1 or staged in each
block's shared memory, against its one-thread-per-ray twin.

Run from the root of a checkout on a machine with a CUDA card:

    python3 k2_launch_shapes.py

Prints the card's name and power limit, then builds
``mocca_envs_tpu_torch/csrc/raycast_k2.cu`` once per design (``-DK2_G``,
``-DK2_PLACE``) into ``build/k2_shapes/``, one nvcc process each, side by
side; prints each kernel's ptxas registers and spills and each design's
blocks resident per SM and shared memory per block over a 129² grid. Then,
on rays from ``chip_smoke.raycast_inputs`` (4,096, 32,768 and 262,144 rays
over 129², 32,768 over 65² and 257²; 64 steps to ``max_t`` 10), holds every
design to the twin bit for bit on t and h and the twin to the plain version
(``chip_smoke.check_rays``), and times them all in turns (the twin, the six
designs, the twin): the kernel's own time on the device
(``chip_smoke.kernel_times``, 50 launches each) and its ctypes launch alone
(CUDA events over 50 calls), beside the bound of the march steps these rays
need and the lane-steps each design issues and keeps active a ray. It names
the fastest design at 32,768 rays over 129². It imports nothing of JAX.
Exits non-zero without a card or if a design disagrees.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke

GROUPS = (8, 16, 32)
PLACES = {0: "L1", 1: "staged"}
# (rays, grid side) of each timed input set; the first picks the design
SETS = ((32768, 129), (4096, 129), (262144, 129), (32768, 65), (32768, 257))


def shipped(engine) -> tuple:
    """(G, placement) the source builds without flags."""
    src = engine.RAYCAST_SOURCE.read_text()
    return (int(re.search(r"#define K2_G (\d+)", src).group(1)),
            int(re.search(r"#define K2_PLACE (\d+)", src).group(1)))


def build_designs(engine, out: Path) -> dict:
    """``{(G, place): (CDLL, {kernel: ptxas readings})}`` of every design."""
    out.mkdir(parents=True, exist_ok=True)
    running = []
    for g in GROUPS:
        for place in PLACES:
            lib = out / f"libk2_g{g}_p{place}.so"
            cmd = [engine.nvcc_path(), *engine.NVCC_FLAGS, f"-DK2_G={g}", f"-DK2_PLACE={place}",
                   "-o", str(lib), str(engine.RAYCAST_SOURCE)]
            running.append(((g, place), lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for design, lib, proc in running:
        log = proc.communicate()[0]
        chip_smoke.check(proc.returncode == 0, f"k2 {design}: nvcc failed:\n{log}")
        handle = ctypes.CDLL(str(lib.resolve()))
        engine.raycast_signatures(handle)
        libs[design] = (handle, chip_smoke.ptxas_kernels(log))
    return libs


def lane_steps(t: torch.Tensor, g: int, num_steps: int = 64, max_t: float = 10.0) -> tuple:
    """(issued, active) lane-steps a ray of a march of ``g`` lanes per ray
    (``g`` = 1: the twin, one thread per ray) on rays that stopped at ``t``:
    a warp issues its rays' slowest round count on all 32 lanes; a ray's
    lanes are active until its round with the first hit, every lane of it."""
    steps = torch.clamp(torch.round(t / (max_t / num_steps)), 1, num_steps).long()
    rounds = (steps + g - 1) // g
    per_warp = 32 // g
    pad = (-rounds.numel()) % per_warp
    warp = torch.cat([rounds, rounds.new_zeros(pad)]).view(-1, per_warp).amax(dim=1)
    return float(32 * warp.sum()) / t.numel(), float(g * rounds.sum()) / t.numel()


def label(design) -> str:
    return f"G={design[0]} {PLACES[design[1]]}"


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_launch_shapes: no CUDA device", file=sys.stderr)
        return 1
    from mocca_envs_tpu_torch.ops.cuda import engine
    from mocca_envs_tpu_torch.ops.raycast import K2_OPS_PER_STEP, raycast_reference

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    libs = build_designs(engine, Path("build/k2_shapes"))
    ship = shipped(engine)
    print(f"[k2] the source's own design: {label(ship)}")
    for design, (lib, kernels) in libs.items():
        for name, got in kernels.items():
            print(f"[k2] {label(design)} {chip_smoke.k2_kernel_label(name)}: {got['registers']} "
                  f"registers, spills {got['spill_stores']} / {got['spill_loads']} bytes")
        occ = engine.raycast_occupancy(lib, (129, 129))
        print(f"[k2] {label(design)} over 129²: grid "
              f"{'staged' if occ['staged'] else 'through L1'}, {occ['blocks_per_sm']} blocks of "
              f"{occ['threads']} threads per SM, {occ['smem_per_block']} bytes of shared memory "
              "per block")
    rng = np.random.default_rng(chip_smoke.SEED + 24)
    twin_lib = libs[ship][0]
    picked = None
    for rays, n in SETS:
        o, d, hf, xy0, cell = (torch.as_tensor(x, device="cuda")
                               for x in chip_smoke.raycast_inputs(rng, rays, n))
        cell = cell.reshape(1)
        outs, calls = {}, {}
        for key, (lib, suffix) in [("twin", (twin_lib, "_thread_launch")),
                                   *((design, (lib, "_launch"))
                                     for design, (lib, _) in libs.items())]:
            t = torch.empty(rays, dtype=torch.float32, device="cuda")
            h = torch.empty_like(t)
            fn = getattr(lib, engine.RAYCAST_SYMBOL + suffix)
            head = (o.data_ptr(), d.data_ptr(), hf.data_ptr(), n, n, xy0.data_ptr(),
                    cell.data_ptr(), 10.0, 10.0 / 64, 64, t.data_ptr(), h.data_ptr(), rays)
            calls[key] = lambda fn=fn, head=head: fn(*head, torch.cuda.current_stream().cuda_stream)
            chip_smoke.check(calls[key]() == 0, f"k2 {key}: the launch failed")
            outs[key] = (t, h)
        torch.cuda.synchronize()
        want_t, want_h = raycast_reference(o, d, hf, xy0, cell, 10.0, 64)
        share, dt_err, h_err = chip_smoke.check_rays(
            *(x.cpu().numpy() for x in (*outs["twin"], want_t, want_h)), 10.0 / 64)
        print(f"[k2] {rays} rays over {n}²: the twin vs plain: t equal on {share:.5f}, largest "
              f"|Δt| {dt_err:.3e}, |Δh| {h_err:.3e}")
        for design in libs:
            same = all(bool(torch.equal(a, b)) for a, b in zip(outs[design], outs["twin"]))
            print(f"[k2] {label(design)} at {rays} rays over {n}²: the twin's bits: {same}")
            chip_smoke.check(same, f"k2 {label(design)}: parts from the twin over {n}²")
        bound_ms, bound_by, flops, _ = chip_smoke.raycast_bound(outs["twin"][0],
                                                                (o, d, hf, xy0, cell))
        order = ["twin", *libs, "twin"]
        device, how = chip_smoke.kernel_times([calls[k] for k in order], "k2_", 50)
        launch = [chip_smoke.time_call(calls[k], (), 50) for k in order]
        print(f"[k2] {rays} rays over {n}²: lane-steps a ray, issued / active: " + ", ".join(
            f"{'twin' if g == 1 else f'G={g}'} {i:.2f} / {a:.2f}"
            for g in (1, *GROUPS) for i, a in [lane_steps(outs["twin"][0], g)]))
        print(f"[k2] {rays} rays over {n}² on {card}: {flops / rays / K2_OPS_PER_STEP:.2f} march "
              f"steps a ray; bound {bound_ms:.6f} ms by {bound_by}; in turns, device ms ({how}) "
              "/ ctypes launch ms:")
        for key, dev, lau in zip(order, device, launch):
            name = "twin (one thread per ray)" if key == "twin" else label(key)
            print(f"[k2]   {name:28s} {dev:.5f} / {lau:.5f}  ({dev / bound_ms:.1f}× the bound)")
        if picked is None:
            mine = {key: dev for key, dev in zip(order[1:-1], device[1:-1])}
            picked = min(mine, key=mine.get)
            twin = (device[0] + device[-1]) / 2
            print(f"[k2] fastest at {rays} rays over {n}²: {label(picked)} {mine[picked]:.5f} ms, "
                  f"{twin / mine[picked]:.2f}× the twin's {twin:.5f}; the source's "
                  f"{label(ship)} {mine[ship]:.5f} ({mine[ship] / mine[picked]:.3f}× the fastest)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
