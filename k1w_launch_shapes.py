"""Launch shapes of the warp-per-env K1e (Cassie, Cassie2D) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 k1w_launch_shapes.py

Builds Cassie's and Cassie2D's instances of
``mocca_envs_tpu_torch/csrc/engine_k1w.cu`` at each launch shape of
:data:`SHAPES` (envs per block × blocks per SM, the ``__launch_bounds__``
minimum; the shipped shape first) into ``build/shapes/``, one nvcc process
each, side by side; prints each one's ptxas registers and spills and the
blocks resident per SM; holds each shape's outputs to the shipped shape's
on Cassie states near the stand (the same code: equal up to the
compiler's register allocation); and times the shapes in turns (shipped,
the others, shipped; CUDA events) at B = 4096 and 16,384. It imports
nothing of JAX. Exits non-zero without a card or if a shape disagrees.
"""

from __future__ import annotations

import ctypes
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke

# (envs per block, blocks per SM): one block of 32 (shipped), two of 16,
# four of 8 (the same 32 envs per SM), three of 8 (24 per SM)
SHAPES = [(32, 1), (16, 2), (8, 4), (8, 3)]
BATCHES = {4096: 10, 16384: 5}
INSTANCE = re.compile(r"(K1W_INSTANCE\((k1w_nl17\w*),(?:[^,()]*,){9})\s*(\d+),\s*(\d+)\)")


def build_shapes(engine, out: Path) -> dict:
    """``{(envs, blocks, symbol): (CDLL, ptxas report)}`` of every shape of
    both Cassie instances."""
    src = engine.SOURCE_W.read_text()
    found = {m.group(2): (int(m.group(3)), int(m.group(4))) for m in INSTANCE.finditer(src)}
    chip_smoke.check(len(found) == 2 and set(found.values()) == {SHAPES[0]},
                     f"the source's Cassie instances are not at {SHAPES[0]}: {found}")
    out.mkdir(parents=True, exist_ok=True)
    running = []
    for envs, blocks in SHAPES:
        path = out / f"engine_k1w_e{envs}_b{blocks}.cu"
        path.write_text(INSTANCE.sub(lambda m: f"{m.group(1)} {envs}, {blocks})", src))
        for inst in engine.WARP_INSTANCES.values():
            if inst.symbol not in found:
                continue
            lib = out / f"lib{inst.symbol}_e{envs}_b{blocks}.so"
            cmd = [engine.nvcc_path(), *engine.NVCC_FLAGS, f"-I{engine.SOURCE_W.parent}",
                   *engine.compile_flags(inst), "-o", str(lib), str(path)]
            running.append(((envs, blocks, inst.symbol), lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for key, lib, proc in running:
        log = proc.communicate()[0]
        chip_smoke.check(proc.returncode == 0, f"{key}: nvcc failed:\n{log}")
        handle = ctypes.CDLL(str(lib.resolve()))
        sym = key[2]
        getattr(handle, sym + "_launch").argtypes = [ctypes.c_void_p] * 15 + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        getattr(handle, sym + "_launch").restype = ctypes.c_int
        getattr(handle, sym + "_layout").argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        getattr(handle, sym + "_occupancy").argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        getattr(handle, sym + "_occupancy").restype = ctypes.c_int
        libs[key] = (handle, chip_smoke.ptxas(log))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k1w_launch_shapes: no CUDA device", file=sys.stderr)
        return 1
    from mocca_envs_tpu_torch.models import cassie
    from mocca_envs_tpu_torch.ops.cuda import engine
    from mocca_envs_tpu_torch.tasks.cassie_task import CASSIE_CONFIG
    from mocca_envs_tpu_torch.utils.device import pin_fp32

    pin_fp32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    libs = build_shapes(engine, Path("build/shapes"))
    model = cassie.make_model("cuda")
    rng = np.random.default_rng(chip_smoke.SEED)
    for planar in (False, True):
        spec = dataclasses.replace(cassie.constraints(), planar=planar)
        kernels = {}
        for envs, blocks in SHAPES:
            k = engine.K1e(model, CASSIE_CONFIG, spec, pd_mode=True,
                           extra_damping=model.actuated * model.kd)
            lib, report = libs[(envs, blocks, k.name)]
            # the wrapper launches this shape's library (its checks unchanged)
            k._lib, k._layout = lib, engine.layout(lib, k.name)
            occ = engine.occupancy(lib, k.name)
            print(f"[shape] {k.name} {envs} envs × {blocks} blocks: {report['registers']} "
                  f"registers, spills {report['spill_stores']} / {report['spill_loads']} bytes; "
                  f"{occ['blocks_per_sm']} blocks = {occ['envs_per_sm']} envs resident per SM, "
                  f"{occ['smem_per_block']} bytes of shared memory per block")
            chip_smoke.check(report["spill_stores"] == 0, f"{k.name} {envs}×{blocks} spills")
            kernels[(envs, blocks)] = k
        shipped = kernels[SHAPES[0]]
        for batch, calls in BATCHES.items():
            args = [torch.as_tensor(x, device="cuda") for x in chip_smoke.cassie_states(
                model, cassie.stand_q(model), cassie.initial_z(), rng, planar, batch)]
            ref = shipped.launch(*args)
            for shape, k in kernels.items():
                out = k.launch(*args)
                for name, a, b in zip(("q", "qd", "depth", "nimp"), out, ref):
                    per_env = (a - b).abs().amax(dim=1)
                    med = float(per_env.median())
                    print(f"[shape] {k.name} {shape[0]}×{shape[1]} vs the shipped shape {name}: "
                          f"per-env median {med:.3e}, max {float(per_env.max()):.3e}")
                    chip_smoke.check(med <= chip_smoke.TOL_TWIN[name],
                                     f"{k.name} {shape}: {name} median {med:.3e}")
            order = [SHAPES[0], *SHAPES[1:], SHAPES[0]]
            t = [chip_smoke.time_call(kernels[s].launch, args, calls) for s in order]
            print(f"[shape] {shipped.name} at B={batch} on {card}: " + ", ".join(
                f"{s[0]}×{s[1]} {ms:.4f}" for s, ms in zip(order, t)) + f" ms/call ({calls} "
                f"calls each, in this order); vs the shipped shape's mean "
                + ", ".join(f"{s[0]}×{s[1]} {2 * ms / (t[0] + t[-1]):.3f}×"
                            for s, ms in zip(order[1:-1], t[1:-1])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
