"""A cold start and every other substep and sweep count redesigned for
Hopper (``csrc/engine_k1w.cu``, one warp per env), on the CPU: the walker's
frame with ``warm_start=False`` on its named warp-per-env instance
(``K1W_ONLY`` 23: K1a's ``Cfg`` with WARM false), and any other key the
warp-per-env source holds on the generic warp-per-env instance of its key,
built from ``-DK1W_*`` flags (``ops/cuda/engine.py::warp_instance``). The
source's per-env code is built by g++ under ``-DK1W_HOST_CHECK`` (lane
width 1, the collectives identities) and run as a loop over envs, beside
the thread-per-env twins (``-DK1_HOST_CHECK``: the generic ``engine_k1.cu``
instances of the same keys).

- Routing: the cold key picks ``K1W_ONLY`` 23; the walker at 2 substeps × 8
  sweeps, a one-legged hopper at 2 × 8 and the stepper over its 6 culled
  stones at 2 × 8 pick the generic warp-per-env instance, named by its
  ``-DK1W_NAME`` flag (``k1w``, the tags of its key, the launch shape: as
  many envs per block as an SM's shared memory holds, one block per SM),
  and so do PD keys of several llc frames (Cassie at five, the PD walker at
  two, split or not), and so do models of more than 27 links and several
  scene geometries in one instance; a key whose env fits no SM's shared
  memory stays on ``engine_k1.cu``, and so does a torque key of several
  llc frames; ``thread_per_env=True`` always gives the ``engine_k1.cu``
  instance.
- The env size the host picks the launch shape from
  (``engine.warp_env_bytes``) is the source's own ``sizeof`` of the env
  (``<sym>_env_bytes``), for every named warp-per-env instance and the
  generic ones; a key whose env fits no SM runs its ``engine_k1.cu``
  instance, and its warp-per-env instance, asked for at that shape, is
  refused at build, naming its bytes; a library's identity changes with its
  flags.
- At B = 16 on chip_smoke.py's near-contact walker states and stepper
  states, and with every base lifted 3 m, each new instance agrees with the
  port's plain unit at ``TOL`` and with its thread-per-env twin's host build
  at ``TOL_TWIN`` (per-env medians, the largest env within ten times); near
  contact the twins' per-env median of |Δq̇| lies within three times the
  median by which the twin parts from itself when q̇ is nudged by 1e-7
  (relative, numpy seed 0), the chip's ``rounding_floor``. The cold key
  also agrees with its A-form twin (the generic ``k1_..._aform_cold``) at
  ``TOL_TWIN``. Each parts from the shipped key's warp-per-env build by more
  than the plain gate near contact.

The JAX package's walker control step with a cold start is held against its
warp-per-env host build in tests/test_torch_solver_options.py; the walker at
2 × 8 (the port's plain path) against the JAX package's in
tests/test_torch_physics.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import mocca_envs_tpu_torch
from mocca_envs_tpu_torch.models import cassie, walker3d
from mocca_envs_tpu_torch.models.schema import ModelBuilder
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.tasks.cassie_task import CASSIE_CONFIG
from mocca_envs_tpu_torch.utils.config import EngineConfig

from tests import torch_workers  # noqa: F401
from tests.torch_k1_host import _cached_path, build_host, build_instances, run_on_host

TOL, TOL_TWIN = chip_smoke.TOL, chip_smoke.TOL_TWIN
B = 16
COLD = EngineConfig(warm_start=False)
SUB2_IT8 = EngineConfig(sim_substeps=2, solver_iters=8)
W = "nl22_ns14_nlim21"
# the new keys: a cold start (named), the walker and the stepper at 2 × 8
# (generic); and their thread-per-env twins' symbols
KINDS = ("cold", "walker_2x8", "stepper_2x8")
TWIN = {"cold": f"k1_{W}_sub4_it4_cold", "walker_2x8": f"k1_{W}_sub2_it8",
        "stepper_2x8": f"k1_{W}_sub2_it8_k6"}
KIND = pytest.mark.parametrize("kind", KINDS)
LIFT = pytest.mark.parametrize("lifted", [False, True], ids=["near_contact", "lifted"])


def _kernel(kind, thread_per_env=False, model=None):
    model = model or walker3d.make_model()
    if kind == "stepper_2x8":
        return engine.K1c(model, SUB2_IT8, thread_per_env=thread_per_env)
    return engine.K1a(model, COLD if kind == "cold" else SUB2_IT8, thread_per_env=thread_per_env)


def _shipped(kind, model):
    return (engine.K1c if kind == "stepper_2x8" else engine.K1a)(model, EngineConfig())


def _cold_aform(model):
    return engine.K1a(model, EngineConfig(warm_start=False, matfree_pgs=False),
                      thread_per_env=True)


def _hopper():
    b = ModelBuilder("hopper", floating=True)
    b.base_inertial(5.0, (0, 0, 0), inertia_diag=(0.1, 0.1, 0.1))
    b.add_link("leg", "base", joint_pos=(0, 0, -0.1), joint_axis=(0, 1, 0), mass=1.0,
               com=(0, 0, -0.25), inertia_diag=(0.02, 0.02, 0.002), limit=(-1.5, 1.5))
    b.add_sphere("leg", (0, 0, -0.5), 0.05, foot="foot")
    return b.build()


@pytest.fixture(scope="module")
def libs():
    """The new instances, their thread-per-env twins, the cold key's A-form
    twin and the shipped keys' warp-per-env instances, built by g++ side by
    side."""
    model = walker3d.make_model()
    return build_host([*(_kernel(kind, tpe, model) for kind in KINDS for tpe in (False, True)),
                       _cold_aform(model), engine.K1a(model, EngineConfig()),
                       engine.K1c(model, EngineConfig())])


def _states(kind, lifted=False):
    """(kernel, numpy inputs) on chip_smoke.py's near-contact walker states
    (the stepper's over its culled stones); ``lifted`` raises every base 3 m."""
    kernel = _kernel(kind)
    rng = np.random.default_rng(121)
    if kind == "stepper_2x8":
        arrays = chip_smoke.stepper_states(kernel.model, rng, kernel.num_stones, B)
    else:
        arrays = chip_smoke.near_contact_states(kernel.model, rng, B)
    arrays = [np.ascontiguousarray(x) for x in arrays]
    if lifted:
        arrays[0][:, 2] += 3.0
    return kernel, arrays


def _gate(got, want, tol):
    """Per-env medians of the max |Δ| within ``tol``, the largest env within
    ten times."""
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        per_env = np.abs(g - w).max(axis=1)
        assert np.median(per_env) <= tol[name], (name, float(np.median(per_env)))
        assert per_env.max() <= 10 * tol[name], (name, float(per_env.max()))


def test_cold_key_picks_its_named_warp_instance():
    new, old = _kernel("cold"), _kernel("cold", thread_per_env=True)
    assert new.name == f"k1w_{W}_sub4_it4_cold" and new.instance.source == engine.SOURCE_W
    assert engine.compile_flags(new.instance) == ["-DK1W_ONLY=23"]
    assert engine.WARP_INSTANCES[new.key] is new.instance and new.variant == "k1a_cold"
    assert old.name == TWIN["cold"] == engine.canonical_symbol(old.key)
    assert old.instance.source == engine.SOURCE and old.instance.index is None
    aform = _cold_aform(new.model)
    assert aform.name == f"k1_{W}_sub4_it4_aform_cold" and aform.instance.source == engine.SOURCE
    # the walker's model as make() builds its unit under the configuration
    model = mocca_envs_tpu_torch.make("Walker3DCustomEnv-v0", device="cpu", config=COLD).model
    assert engine.make_kernel(model, COLD).instance is new.instance


def _generic_cases():
    """label → (the wrapper, its thread-per-env twin's symbol)."""
    return {"walker_2x8": (_kernel("walker_2x8"), TWIN["walker_2x8"]),
            "hopper_2x8": (engine.K1a(_hopper(), SUB2_IT8), "k1_nl2_ns1_nlim1_sub2_it8"),
            "stepper_2x8": (_kernel("stepper_2x8"), TWIN["stepper_2x8"])}


@pytest.mark.parametrize("label", ["walker_2x8", "hopper_2x8", "stepper_2x8"])
def test_other_keys_pick_the_generic_warp_instance(label):
    kernel, twin_symbol = _generic_cases()[label]
    inst = kernel.instance
    assert inst.source == engine.SOURCE_W and inst.index is None and engine.warp_holds(kernel.key)
    assert inst == engine.warp_instance(kernel.key)
    envs, blocks = engine.warp_shape(kernel.key)
    assert (inst.envs, inst.blocks) == (envs, blocks) and blocks == 1 and 1 <= envs <= 32
    assert kernel.name == "k1w" + twin_symbol.removeprefix("k1") + f"_{envs}x{blocks}"
    flags = engine.compile_flags(inst)
    assert flags[0] == f"-DK1W_NAME={kernel.name}"
    assert {f"-DK1W_ENVS={envs}", f"-DK1W_BLOCKS={blocks}", "-DK1W_NSUB=2",
            "-DK1W_ITERS=8"} <= set(flags)
    assert not any(f.startswith("-DK1_") for f in flags)
    # the walker's envs: as many as the SM's shared memory holds beside the
    # model table, less the block's reserve
    if label != "hopper_2x8":
        assert engine.warp_env_bytes(kernel.key) == (12432 if label == "stepper_2x8" else 12000)
        assert envs == 18
    else:
        assert envs == 32
    twin = type(kernel)(kernel.model, kernel.config, thread_per_env=True)
    assert twin.name == twin_symbol and twin.instance.source == engine.SOURCE
    assert kernel.variant == twin.variant == ("k1c" if label == "stepper_2x8" else "k1a")


@pytest.mark.parametrize("family, config", [("Walker3DCustomEnv-v0", SUB2_IT8),
                                            ("Walker3DStepperEnv-v0", SUB2_IT8)],
                         ids=["walker", "stepper"])
def test_make_builds_the_generic_warp_instance(family, config):
    """The env's unit under the configuration, as make() builds its model,
    picks the generic warp-per-env instance of its key."""
    env = mocca_envs_tpu_torch.make(family, device="cpu", config=config)
    stones = config.stone_window if "Stepper" in family else 0
    picked = engine.make_kernel(env.model, config, num_stones=stones)
    assert picked.instance == engine.warp_instance(picked.key)
    assert picked.name.startswith("k1w_") and picked.name.endswith("_18x1")


@pytest.mark.parametrize("build, symbol, index", [
    (lambda: engine.K1e(cassie.make_model(), dataclasses.replace(CASSIE_CONFIG, llc_frames=5),
                        cassie.constraints(), pd_mode=True),
     "k1_nl17_ns5_nlim16_sub2_it4_llc5_p2p2", None),
    (lambda: engine.K1b(walker3d.make_model(), EngineConfig(llc_frames=2)),
     f"k1b_{W}_sub4_it4_llc2", 3),
    (lambda: engine.K1b(walker3d.make_model(), EngineConfig(llc_frames=2, split_impulse=True)),
     f"k1_{W}_sub4_it4_llc2_si", None),
], ids=["cassie_llc5", "k1b_llc2", "k1h_b_llc2"])
def test_keys_of_several_llc_frames_stay_on_engine_k1(build, symbol, index):
    """PD keys of several llc frames run the generic warp-per-env instance
    of their key (tests/test_torch_k1w_llc_frames.py holds its arithmetic);
    their thread-per-env twins stay on engine_k1.cu: the named ``K1_ONLY`` 3
    for K1b at two frames, the generic instance for the others."""
    kernel = build()
    assert kernel.key.llc > 1 and engine.warp_holds(kernel.key)
    assert kernel.instance == engine.warp_instance(kernel.key)
    assert kernel.instance.source == engine.SOURCE_W and kernel.instance.index is None
    envs, blocks = engine.warp_shape(kernel.key)
    tags = engine.canonical_symbol(kernel.key).removeprefix("k1")
    assert symbol.endswith(tags) and kernel.name == f"k1w{tags}_{envs}x1" and blocks == 1
    assert f"-DK1W_NLLC={kernel.key.llc}" in engine.compile_flags(kernel.instance)
    twin = engine.instance_for(kernel.key, thread_per_env=True)
    assert twin.symbol == symbol and twin.index == index and twin.source == engine.SOURCE


def test_keys_the_warp_source_cannot_hold():
    """A key whose env fits no SM's shared memory (NV 64 and NS 64 in the
    A-form: 210,900 bytes) or a torque key of several llc frames takes the
    engine_k1.cu instance; any other key (more than 32 velocity DOFs, a PD
    key of several llc frames, several scene geometries in one instance)
    one warp per env."""
    base = engine.Key(**engine._W)
    nofit = engine.Key(nl=59, ns=64, nlim=58, substeps=4, iters=4, matfree=False)
    for key, holds in ((dataclasses.replace(base, nl=27, nlim=20), True),
                       (dataclasses.replace(base, nl=28, nlim=20), True),
                       (dataclasses.replace(base, stones=6, hf=16), True),
                       (dataclasses.replace(base, tris=8, bars=4), True),
                       (dataclasses.replace(base, nl=28, nlim=20, stones=6, tris=8), True),
                       (nofit, False), (dataclasses.replace(nofit, matfree=True), True),
                       (dataclasses.replace(base, pd=True, llc=3), True),
                       (dataclasses.replace(base, llc=3), False),
                       (dataclasses.replace(base, pd=True, substeps=2, iters=8), True),
                       (dataclasses.replace(base, rods=2, planar=True, split=True), True)):
        assert engine.warp_holds(key) == holds, key
        inst = engine.instance_for(key)
        assert (inst.source == engine.SOURCE_W) == holds
        if not holds:
            assert inst.symbol == engine.canonical_symbol(key) and inst.index is None


@pytest.mark.parametrize("key", [
    engine.Key(**engine._W), engine.Key(**engine._W, warm=False),
    engine.Key(**{**engine._W, "substeps": 2, "iters": 8}),
    engine.Key(**{**engine._W, "substeps": 2, "iters": 8}, stones=6),
    engine.Key(**engine._C), engine.Key(**engine._M, split=True)],
    ids=["k1a", "cold", "walker_2x8", "stepper_2x8", "cassie", "monkey_split"])
def test_thread_per_env_always_gives_the_thread_instance(key):
    inst = engine.instance_for(key, thread_per_env=True)
    assert inst.source == engine.SOURCE
    assert inst is engine.INSTANTIATIONS.get(key) or inst.symbol == engine.canonical_symbol(key)
    assert engine.instance_for(key).source == engine.SOURCE_W


def test_env_bytes_are_the_sources():
    """The env size and the table size the host counts from a key are the
    ones the source's host build reports, for every named warp-per-env
    instance and for the generic instances of keys over each scene
    geometry, split impulse, the A-form and PD mode."""
    base = engine.Key(**{**engine._W, "substeps": 2, "iters": 8})
    generic = [engine.warp_instance(k) for k in (
        base, dataclasses.replace(base, hf=8), dataclasses.replace(base, tris=8, split=True),
        dataclasses.replace(base, stones=3, matfree=False),
        dataclasses.replace(base, pd=True, split=True, reuse=False),
        engine.Key(**{**engine._M, "iters": 8}), engine.Key(**{**engine._C, "llc": 1}),
        engine.Key(nl=7, ns=5, nlim=6, substeps=4, iters=4, planar=True, grabs=1))]
    insts = [*engine.WARP_INSTANCES.values(), *generic]
    libs = build_instances(insts)
    for inst in insts:
        fn = getattr(libs[inst.symbol], inst.symbol + "_env_bytes")
        assert fn() == engine.warp_env_bytes(inst.key), inst.symbol
        assert engine.layout(libs[inst.symbol], inst.symbol) == (engine.table_floats(inst.key), 0)
    for inst in generic:
        assert (inst.envs, inst.blocks) == engine.warp_shape(inst.key)


def test_a_key_whose_env_fits_no_sm_raises_at_build():
    """A generic warp-per-env instance asked for at a shape that holds no
    whole env in an SM's shared memory is refused at build, naming its
    bytes, before any compiler runs; the key itself runs its engine_k1.cu
    instance (``instance_for``), which is its thread-per-env twin."""
    key = engine.Key(nl=22, ns=120, nlim=21, substeps=2, iters=8, matfree=False)
    inst = engine.warp_instance(key)
    assert inst.source == engine.SOURCE_W and inst.envs == 0
    assert engine.warp_env_bytes(key) > engine.SM90_SMEM["per_sm"]
    with pytest.raises(RuntimeError, match=f"{engine.warp_env_bytes(key)} bytes"):
        engine.build([inst])
    routed = engine.instance_for(key)
    assert routed.source == engine.SOURCE and routed.symbol == engine.canonical_symbol(key)
    assert routed == engine.instance_for(key, thread_per_env=True)


def test_library_identity_changes_with_its_flags():
    """A library is found by its symbol and its flags: another launch shape
    (or other template arguments under one symbol) is another library, on
    the card and in the host cache."""
    key = engine.Key(**{**engine._W, "substeps": 2, "iters": 8})
    picked, other = engine.warp_instance(key), engine.warp_instance(key, 4, 4)
    assert picked.symbol != other.symbol and picked.symbol.endswith("_18x1")
    paths = {engine.library_path(i.symbol, engine.compile_flags(i)) for i in (picked, other)}
    assert len(paths) == 2
    # the same symbol built with other flags is another file
    same = dataclasses.replace(other, symbol=picked.symbol)
    assert engine.library_path(same.symbol, engine.compile_flags(same)) != engine.library_path(
        picked.symbol, engine.compile_flags(picked))
    assert _cached_path("g++", same) != _cached_path("g++", picked)
    assert engine.library_path(picked.symbol, engine.compile_flags(picked)) == \
        engine.library_path(picked.symbol, engine.compile_flags(engine.warp_instance(key)))


@KIND
@LIFT
def test_k1w_matches_plain_and_thread_per_env_on_host(libs, kind, lifted):
    """Both designs against the plain unit at the chip gate, and the two
    designs against each other at ``TOL_TWIN``, within the rounding floor
    near contact."""
    new, inputs = _states(kind, lifted)
    old = _kernel(kind, thread_per_env=True, model=new.model)
    assert old.name == TWIN[kind]
    want = [t.numpy() for t in new.plain(*map(torch.as_tensor, inputs))]
    outs = run_on_host(libs[new.name], new, inputs)
    base = run_on_host(libs[old.name], old, inputs)
    for got in (outs, base):
        assert all(np.isfinite(o).all() for o in got)
        _gate(got, want, TOL)
    _gate(outs, base, TOL_TWIN)
    if lifted:
        assert (want[3] == 0).all() and (outs[3] == 0).all()
    else:
        assert (want[3] > 0).mean() > 0.05                      # contacts carry load
        nudged = list(inputs)
        noise = np.random.default_rng(0).standard_normal(inputs[1].shape)
        nudged[1] = (inputs[1] * (1 + 1e-7 * noise)).astype(np.float32)
        med = lambda a: float(np.median(np.abs(a[1] - base[1]).max(axis=1)))  # noqa: E731
        twin, floor = med(outs), med(run_on_host(libs[old.name], old, nudged))
        assert twin <= 3 * floor, (twin, floor)


@LIFT
def test_cold_matches_its_aform_twin_on_host(libs, lifted):
    """The matrix-free and the A-form cold start are the same iteration: on
    the same inputs they part only by the order of their sums."""
    new, inputs = _states("cold", lifted)
    aform = _cold_aform(new.model)
    assert aform.variant == "k1a_aform_cold"
    outs = run_on_host(libs[new.name], new, inputs)
    _gate(outs, run_on_host(libs[aform.name], aform, inputs), TOL_TWIN)
    if not lifted:
        assert (outs[3] > 0).mean() > 0.05


@KIND
def test_new_instances_part_from_the_shipped_key_on_host(libs, kind):
    """A cold start and 2 × 8 are each another iteration: near contact the
    new instance parts from its shipped key's warp-per-env build by more
    than the plain gate in the per-env medians of q and q̇."""
    new, inputs = _states(kind)
    shipped = _shipped(kind, new.model)
    assert shipped.instance.source == engine.SOURCE_W and shipped.instance.index is not None
    outs = run_on_host(libs[new.name], new, inputs)
    ref = run_on_host(libs[shipped.name], shipped, inputs)
    for name, i in (("q", 0), ("qd", 1)):
        med = float(np.median(np.abs(outs[i] - ref[i]).max(axis=1)))
        assert med > TOL[name], (name, med)
