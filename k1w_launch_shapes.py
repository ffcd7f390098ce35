"""Launch shapes of the warp-per-env K1 instances on one NVIDIA GPU: Cassie's
and Cassie2D's K1e, the PD walkers' K1b, the terrain walkers' K1f, the
stepper's K1c, the stairs' K1g, the split twins of the stairs, the terrain
walkers, the stepper, the PD walkers and the walker on the plane, K1h-g,
K1h-f, K1h-c, K1h-b and K1h-si, the monkey's K1d and its split twin K1h-d,
the planar walkers' K1e and its split twin, the planar K1h-e, the walker's
split key in the A-form, the walker's key in the A-form, alone and with
all four PGS options off, the walker's key with scalar friction rows, with
a factor every substep and with a cold start, and the generic warp-per-env
instances of the walker at 2 substeps × 8 sweeps, of the PD walker at two
llc frames (K1b and its split twin K1h-b) and of Cassie at five.

Run from the root of a checkout on a machine with a CUDA card:

    python3 k1w_launch_shapes.py [group ...]

(no group: every group of :data:`GROUPS`). Prints the card's shared memory
per SM, then builds each instance of the groups from
``mocca_envs_tpu_torch/csrc/engine_k1w.cu`` at each launch shape of its
group (envs per block × the ``__launch_bounds__`` minimum of blocks per SM,
which caps the registers; the shipped shape first; the generic instance's
from its ``-DK1W_*`` flags, the host's pick first) into ``build/shapes/``,
one nvcc process each, side by side; prints each one's ptxas registers and
spills and the blocks resident per SM; holds each shape's outputs to the
shipped shape's on its group's states (the same code: equal up to the
compiler's register allocation; whether the bits agree is printed); and
times the shapes in turns (shipped, the others, shipped; CUDA events) at
each B of its group. It imports nothing of JAX. Exits non-zero without a
card or if a shape disagrees.
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

# an instance's name, its nine model and solver arguments, envs per block,
# blocks per SM, and the arguments behind them (window side, stones, faces,
# split impulse, bars, grabs; any of them may be left out)
INSTANCE = re.compile(r"(K1W_INSTANCE\((\w+),(?:[^,()]*,){9})\s*(\d+),\s*(\d+)((?:,\s*\w+)*\))")
W = "k1w_nl22_ns14_nlim21_sub4_it4"
# group → (its symbols, its shapes with the shipped one first, timed calls
# per B). Cassie: one block of 32 (shipped), two of 16, four of 8 (the same
# 32 envs per SM), three of 8 (24 per SM). The walker's keys, at the same
# 16 envs per SM where shared memory allows: blocks of 4 with registers for
# 4 or for 8 blocks (capped at 64; K1f, K1c, K1g and K1h-f ship that, K1b
# the other), two of 8, one of 16 (K1h-g ships that: four blocks of its 4
# envs overrun the SM's shared memory, so its blocks of 4 hold 12 per SM;
# K1h-c and K1h-b too: it ran 3–5% faster than their twins' shapes; and
# K1h-si, 3–4% faster than K1a's 4 × 4). The monkey, its split twin, the
# planar walkers and their split twin: 32 envs per SM as one block of 32,
# two of 16 or four of 8. The A-forms (with split impulse, alone, and with
# all four PGS options off), whose packed A fills most of an env's shared
# memory: one block of 11 envs (the most the SM holds), one of 8, or two
# blocks of 5. Scalar friction, a factor every substep and a cold start,
# K1a's EnvW: one block of 16 (shipped: 1–3% faster at B = 4096), four of 4
# (K1a's), two of 8. The generic instances (no symbols: built from flags,
# :data:`GENERIC`): the walker at 2 × 8, and K1b and K1h-b at two llc
# frames, at the host's pick (``engine.warp_shape``, None here), four blocks
# of 4, two of 8; Cassie at five llc frames at the host's pick and two
# blocks of 16
GROUPS = {
    "cassie": (("k1w_nl17_ns5_nlim16_sub2_it4_llc10_p2p2",
                "k1w_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_planar"),
               [(32, 1), (16, 2), (8, 4), (8, 3)], {4096: 10, 16384: 5}),
    "pd": ((f"{W}_llc1",), [(4, 4), (4, 8), (8, 2), (16, 1)], {4096: 20, 16384: 10}),
    "terrain": ((f"{W}_hf16",), [(4, 8), (4, 4), (8, 2), (16, 1)], {4096: 20, 16384: 10}),
    "stones": ((f"{W}_k6",), [(4, 8), (4, 4), (8, 2), (16, 1)], {4096: 20, 16384: 10}),
    "mesh": ((f"{W}_kt16",), [(4, 8), (4, 4), (8, 2), (16, 1)], {4096: 20, 16384: 10}),
    "mesh_split": ((f"{W}_kt16_si",), [(16, 1), (4, 8), (4, 4), (8, 2)],
                   {4096: 20, 16384: 10}),
    "terrain_split": ((f"{W}_hf16_si",), [(4, 8), (4, 4), (8, 2), (16, 1)],
                      {4096: 20, 16384: 10}),
    "stones_split": ((f"{W}_k6_si",), [(16, 1), (4, 8), (4, 4), (8, 2)],
                     {4096: 20, 16384: 10}),
    "pd_split": ((f"{W}_llc1_si",), [(16, 1), (4, 4), (4, 8), (8, 2)], {4096: 20, 16384: 10}),
    "walker_split": ((f"{W}_si",), [(16, 1), (4, 4), (4, 8), (8, 2)], {4096: 20, 16384: 10}),
    "monkey": (("k1w_nl11_ns5_nlim8_sub4_it4_kb16_ng2",), [(32, 1), (16, 2), (8, 4)],
               {4096: 20, 16384: 10}),
    "monkey_split": (("k1w_nl11_ns5_nlim8_sub4_it4_kb16_ng2_si",), [(32, 1), (16, 2), (8, 4)],
                     {4096: 20, 16384: 10}),
    "planar": (("k1w_nl7_ns5_nlim6_sub4_it4_planar",), [(32, 1), (16, 2), (8, 4)],
               {4096: 20, 16384: 10}),
    "planar_split": (("k1w_nl7_ns5_nlim6_sub4_it4_planar_si",), [(32, 1), (16, 2), (8, 4)],
                     {4096: 20, 16384: 10}),
    "aform_split": ((f"{W}_si_aform",), [(11, 1), (8, 1), (5, 2)], {4096: 10, 16384: 5}),
    "aform": ((f"{W}_aform",), [(11, 1), (8, 1), (5, 2)], {4096: 10, 16384: 5}),
    "aform_off": ((f"{W}_aform_scalar_cold_refactor",), [(11, 1), (8, 1), (5, 2)],
                  {4096: 10, 16384: 5}),
    "scalar_refactor": ((f"{W}_scalar", f"{W}_refactor"), [(16, 1), (4, 4), (8, 2)],
                        {4096: 20, 16384: 10}),
    "cold": ((f"{W}_cold",), [(16, 1), (4, 4), (8, 2)], {4096: 20, 16384: 10}),
    "generic": ((), [None, (4, 4), (8, 2)], {4096: 20, 16384: 10}),
    "llc": ((), [None, (4, 4), (8, 2)], {4096: 20, 16384: 10}),
    "cassie_llc5": ((), [None, (16, 2)], {4096: 10, 16384: 5}),
}
_W = dict(nl=22, ns=14, nlim=21, substeps=4, iters=4)
# group → the engine.Key fields of each of its generic warp-per-env instances
GENERIC = {"generic": [dict(nl=22, ns=14, nlim=21, substeps=2, iters=8)],
           "llc": [dict(_W, pd=True, llc=2), dict(_W, pd=True, llc=2, split=True)],
           "cassie_llc5": [dict(nl=17, ns=5, nlim=16, substeps=2, iters=4, pd=True, llc=5,
                                rods=2)]}


def shapes_of(engine, group, key=None) -> list:
    """``group``'s launch shapes, the host's pick for ``key`` (a generic
    instance's) in place of None."""
    return [engine.warp_shape(key) if shape is None else shape for shape in GROUPS[group][1]]


def _compile(engine, inst, path: Path, lib: Path):
    cmd = [engine.nvcc_path(), *engine.NVCC_FLAGS, f"-I{engine.SOURCE_W.parent}",
           *engine.compile_flags(inst), "-o", str(lib), str(path)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_shapes(engine, out: Path, groups) -> dict:
    """``{(envs, blocks, symbol): (CDLL, ptxas report, the library's
    symbol)}`` of every shape of every instance of ``groups`` (a generic
    instance under its host-picked symbol, each shape's library under its
    own)."""
    src = engine.SOURCE_W.read_text()
    found = {m.group(2): (int(m.group(3)), int(m.group(4))) for m in INSTANCE.finditer(src)}
    out.mkdir(parents=True, exist_ok=True)
    running = []
    for group in groups:
        if group in GENERIC:
            for fields in GENERIC[group]:
                key = engine.Key(**fields)
                picked = engine.warp_instance(key)
                for envs, blocks in shapes_of(engine, group, key):
                    inst = engine.warp_instance(key, envs, blocks)
                    lib = out / f"lib{inst.symbol}.so"
                    running.append(((envs, blocks, picked.symbol), inst.symbol, lib,
                                    _compile(engine, inst, engine.SOURCE_W, lib)))
            continue
        mine, shapes, _ = GROUPS[group]
        chip_smoke.check({found.get(s) for s in mine} == {shapes[0]},
                         f"the source's {group} instances are not at {shapes[0]}: {found}")
        for envs, blocks in shapes:
            path = out / f"engine_k1w_{group}_e{envs}_b{blocks}.cu"
            path.write_text(INSTANCE.sub(
                lambda m: f"{m.group(1)} {envs}, {blocks}{m.group(5)}" if m.group(2) in mine
                else m.group(0), src))
            for inst in engine.WARP_INSTANCES.values():
                if inst.symbol not in mine:
                    continue
                lib = out / f"lib{inst.symbol}_e{envs}_b{blocks}.so"
                running.append(((envs, blocks, inst.symbol), inst.symbol, lib,
                                _compile(engine, inst, path, lib)))
    libs = {}
    for key, sym, lib, proc in running:
        log = proc.communicate()[0]
        chip_smoke.check(proc.returncode == 0, f"{key}: nvcc failed:\n{log}")
        handle = ctypes.CDLL(str(lib.resolve()))
        getattr(handle, sym + "_launch").argtypes = [ctypes.c_void_p] * 15 + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        getattr(handle, sym + "_launch").restype = ctypes.c_int
        getattr(handle, sym + "_layout").argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        getattr(handle, sym + "_occupancy").argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        getattr(handle, sym + "_occupancy").restype = ctypes.c_int
        libs[key] = (handle, chip_smoke.ptxas(log), sym)
    return libs


def cases(engine, rng):
    """``[(group, make a wrapper, states(batch))]``: Cassie and Cassie2D (the
    whole PD control step near the stand), the PD walker (random targets
    near contact), the terrain walker (over the family's grids), the stepper
    (over its culled stones) and the stairs walker (over the culled faces);
    the stairs walker, the terrain walker, the stepper, the PD walker and
    the walker on the plane (near contact) also with split impulse; the
    monkey (hanging from its bars), also with split impulse; Walker2D (near
    contact, a little out of its plane), also with split impulse; the walker
    in the A-form with split impulse, alone and with all four PGS options off,
    with scalar friction rows, with a factor every substep and with a cold
    start, and at 2 substeps × 8 sweeps (near contact); the PD walker at two
    llc frames, alone and with split impulse (random targets near contact),
    and Cassie at five (near the stand)."""
    from mocca_envs_tpu_torch.models import cassie, monkey, walker2d, walker3d
    from mocca_envs_tpu_torch.tasks.cassie_task import CASSIE_CONFIG
    from mocca_envs_tpu_torch.terrain.scene import HF_PATCH
    from mocca_envs_tpu_torch.utils.config import EngineConfig

    cmodel, wmodel = cassie.make_model("cuda"), walker3d.make_model("cuda")
    kp = wmodel.power_coef * (wmodel.actuated > 0).to(torch.float32)
    out = []
    for planar in (False, True):
        spec = dataclasses.replace(cassie.constraints(), planar=planar)
        out.append(("cassie", lambda spec=spec: engine.K1e(
            cmodel, CASSIE_CONFIG, spec, pd_mode=True, extra_damping=cmodel.actuated * cmodel.kd),
            lambda batch, planar=planar: chip_smoke.cassie_states(
                cmodel, cassie.stand_q(cmodel), cassie.initial_z(), rng, planar, batch)))
    out.append(("pd", lambda: engine.K1b(wmodel.replace(kp=kp), EngineConfig(),
                                             extra_damping=kp / 20.0),
                lambda batch: chip_smoke.pd_target_states(wmodel, rng, batch)))
    out.append(("terrain", lambda: engine.K1f(wmodel, EngineConfig(), HF_PATCH),
                lambda batch: chip_smoke.terrain_states(wmodel, rng, batch)))
    out.append(("stones", lambda: engine.K1c(wmodel, EngineConfig()),
                lambda batch: chip_smoke.stepper_states(
                    wmodel, rng, EngineConfig().stone_window, batch)))
    out.append(("mesh", lambda: engine.K1g(wmodel, EngineConfig()),
                lambda batch: chip_smoke.stairs_states(wmodel, rng, batch)))
    split = EngineConfig(split_impulse=True)
    out.append(("mesh_split", lambda: engine.K1g(wmodel, split),
                lambda batch: chip_smoke.stairs_states(wmodel, rng, batch)))
    out.append(("terrain_split", lambda: engine.K1f(wmodel, split, HF_PATCH),
                lambda batch: chip_smoke.terrain_states(wmodel, rng, batch)))
    out.append(("stones_split", lambda: engine.K1c(wmodel, split),
                lambda batch: chip_smoke.stepper_states(wmodel, rng, split.stone_window, batch)))
    out.append(("pd_split", lambda: engine.K1b(wmodel.replace(kp=kp), split,
                                                   extra_damping=kp / 20.0),
                lambda batch: chip_smoke.pd_target_states(wmodel, rng, batch)))
    out.append(("walker_split", lambda: engine.K1hSi(wmodel, split),
                lambda batch: chip_smoke.near_contact_states(wmodel, rng, batch)))
    mmodel = monkey.make_model("cuda")
    out.append(("monkey", lambda: engine.K1d(mmodel, EngineConfig(), monkey.constraints(), 16),
                lambda batch: chip_smoke.monkey_states(mmodel, rng, batch)))
    out.append(("monkey_split", lambda: engine.K1d(mmodel, split, monkey.constraints(), 16),
                lambda batch: chip_smoke.monkey_states(mmodel, rng, batch)))
    pmodel = walker2d.make_walker2d("cuda")
    out.append(("planar", lambda: engine.K1e(pmodel, EngineConfig(), walker2d.planar_spec()),
                lambda batch: chip_smoke.planar_walker_states(pmodel, 1.22, rng, batch)))
    out.append(("planar_split", lambda: engine.K1e(pmodel, split, walker2d.planar_spec()),
                lambda batch: chip_smoke.planar_walker_states(pmodel, 1.22, rng, batch)))
    aform = EngineConfig(**chip_smoke.OPTION_CONFIGS["k1h_si_aform"])
    out.append(("aform_split", lambda: engine.K1hSi(wmodel, aform),
                lambda batch: chip_smoke.near_contact_states(wmodel, rng, batch)))
    for group, label in (("aform", "k1a_aform"), ("aform_off", "k1a_aform_scalar_cold_refactor")):
        config = EngineConfig(**chip_smoke.OPTION_CONFIGS[label])
        out.append((group, lambda config=config: engine.K1a(wmodel, config),
                    lambda batch: chip_smoke.near_contact_states(wmodel, rng, batch)))
    for group, label in [*(("scalar_refactor", v) for v in chip_smoke.MATFREE_OPTIONS),
                         ("cold", "k1a_cold"), ("generic", "k1a_sub2_it8")]:
        config = EngineConfig(**chip_smoke.OPTION_CONFIGS[label])
        out.append((group, lambda config=config: engine.K1a(wmodel, config),
                    lambda batch: chip_smoke.near_contact_states(wmodel, rng, batch)))
    for config in (EngineConfig(llc_frames=2), EngineConfig(llc_frames=2, split_impulse=True)):
        out.append(("llc", lambda config=config: engine.K1b(wmodel.replace(kp=kp), config,
                                                            extra_damping=kp / 20.0),
                    lambda batch: chip_smoke.pd_target_states(wmodel, rng, batch)))
    out.append(("cassie_llc5", lambda: engine.K1e(
        cmodel, dataclasses.replace(CASSIE_CONFIG, llc_frames=5), cassie.constraints(),
        pd_mode=True, extra_damping=cmodel.actuated * cmodel.kd),
        lambda batch: chip_smoke.cassie_states(cmodel, cassie.stand_q(cmodel),
                                               cassie.initial_z(), rng, False, batch)))
    return out


def main(argv=None) -> int:
    groups = list(sys.argv[1:] if argv is None else argv) or list(GROUPS)
    unknown = [g for g in groups if g not in GROUPS]
    if unknown:
        print(f"k1w_launch_shapes: unknown groups {unknown}; the groups are {list(GROUPS)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k1w_launch_shapes: no CUDA device", file=sys.stderr)
        return 1
    from mocca_envs_tpu_torch.ops.cuda import engine
    from mocca_envs_tpu_torch.utils.device import pin_fp32

    pin_fp32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    libs = build_shapes(engine, Path("build/shapes"), groups)
    smem = engine.smem_limits(next(iter(libs.values()))[0])
    print(f"[shape] {card}: {smem['per_sm']} bytes of shared memory per SM, {smem['per_block']} "
          f"per block (opt-in), {smem['reserved_per_block']} reserved per resident block")
    rng = np.random.default_rng(chip_smoke.SEED)
    for group, make, states in cases(engine, rng):
        if group not in groups:
            continue
        shapes, batches = shapes_of(engine, group, make().key), GROUPS[group][2]
        kernels = {}
        for envs, blocks in shapes:
            k = make()
            lib, report, k.name = libs[(envs, blocks, k.name)]
            # the wrapper launches this shape's library (its checks unchanged)
            k._lib, k._layout = lib, engine.layout(lib, k.name)
            occ = engine.occupancy(lib, k.name)
            print(f"[shape] {k.name} {envs} envs × {blocks} blocks: {report['registers']} "
                  f"registers, spills {report['spill_stores']} / {report['spill_loads']} bytes; "
                  f"{occ['blocks_per_sm']} blocks = {occ['envs_per_sm']} envs resident per SM, "
                  f"{occ['smem_per_block']} bytes of shared memory per block")
            kernels[(envs, blocks)] = k
        shipped = kernels[shapes[0]]
        for batch, calls in batches.items():
            args = [torch.as_tensor(x, device="cuda") for x in states(batch)]
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
                print(f"[shape] {k.name} {shape[0]}×{shape[1]} at B={batch}: the same bits as the "
                      f"shipped shape: {all(bool(torch.equal(a, b)) for a, b in zip(out, ref))}")
            order = [shapes[0], *shapes[1:], shapes[0]]
            t = [chip_smoke.time_call(kernels[s].launch, args, calls) for s in order]
            print(f"[shape] {shipped.name} at B={batch} on {card}: " + ", ".join(
                f"{s[0]}×{s[1]} {ms:.4f}" for s, ms in zip(order, t)) + f" ms/call ({calls} "
                f"calls each, in this order); vs the shipped shape's mean "
                + ", ".join(f"{s[0]}×{s[1]} {2 * ms / (t[0] + t[-1]):.3f}×"
                            for s, ms in zip(order[1:-1], t[1:-1])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
