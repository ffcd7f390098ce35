"""The port's kernel wrapper and entry points: no JAX, no silent CPU path.

- the package imports and steps on the CPU with JAX made unimportable, and
  no module of it (or chip_smoke.py) imports JAX or the JAX package;
- ``make()`` / ``BatchedEnv`` with no device mean the CUDA card and raise
  where there is none;
- the CPU path never launches the kernel; the kernel's launch refuses CPU
  tensors; a key outside the fifteen named instances (other options, sizes,
  windows, split impulse on any variant, and every scene combination the
  TPU kernel composes: PD mode, equality rows or extra damping over any
  geometry, several geometries in one instance) gets the generic instance
  named by the key (a combination no family runs wrapped by ``K1x``);
- the bound's operation count follows the rows these inputs make active;
- the kernel source's per-env arithmetic, compiled for the host, agrees
  with the plain version, for every instantiation (K1a, K1c over stones,
  K1b in PD mode at one and two llc frames, K1e with Cassie's rods, with
  the planar lock added, and with the planar lock alone on Walker2D and
  Crab2D; K1d over the monkey's bars with its grab rows, both hands, one,
  none, bars in contact and not; K1f over the terrain families' windows,
  the grid's border included; K1g over the stairs' culled faces at treads,
  nosings and risers; K1h-si, the walker with split impulse; its split-
  impulse twins K1h-c, K1h-e, K1h-e2d and K1h-d on the stepper's, Cassie's,
  Cassie2D's and the monkey's states), and the packed table has the size the source lays out; so does the raycast
  kernel K2's per-ray code against ops/raycast.py's plain version;
- on a card: each kernel agrees with its plain version (skips elsewhere).

The kernel cases take their inputs from chip_smoke.py's state generators, at
a small batch: the CPU run rehearses the comparison the card makes.
"""

import ast
import copy
import ctypes
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import mocca_envs_tpu_torch
from mocca_envs_tpu_torch.models import cassie, monkey, walker2d, walker3d
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.ops.step import ConstraintSpec
from mocca_envs_tpu_torch.tasks import monkey_stepper as tasks_monkey
from mocca_envs_tpu_torch.tasks.cassie_task import CASSIE_CONFIG
from mocca_envs_tpu_torch.terrain.scene import HF_PATCH, NO_GROUND_Z
from mocca_envs_tpu_torch.utils.config import EngineConfig

from tests import torch_workers  # noqa: F401
from tests.torch_k1_host import HostLibrary, build_host, run_on_host

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "mocca_envs_tpu"}
TOL = {"q": 2e-4, "qd": 5e-3, "depth": 2e-4, "nimp": 5e-3}
TOL_EQ = chip_smoke.TOL_EQ   # over equality rows: q 5e-4, qd 2e-2, depth 5e-4
TOL_GRAB = chip_smoke.TOL_GRAB   # over bars and grab rows: impulse 1e-2
TOL_HF = chip_smoke.TOL_HF   # over a heightfield: qd 1e-2, depth 5e-4, impulse 1e-2


def _near_contact(B, seed):
    return chip_smoke.near_contact_states(walker3d.make_model(), np.random.default_rng(seed), B)


def _kernel_case(case, B, seed, device="cpu"):
    """(kernel wrapper, numpy inputs) of one instantiation, on chip_smoke's
    states: k1a, k1c (stepper states, 6 culled stones), k1b / k1b_llc2 (PD
    targets, the walker's PD gains and implicit derivative gain), k1e_cassie
    / k1e_cassie2d (the whole PD control step with the rods, and the planar
    lock, on the warp-per-env instance the entry points pick; with
    ``_thread`` on the thread-per-env instance of the same key), k1e_planar
    / k1e_crab (one torque frame of Walker2D / Crab2D, which share an
    instantiation), k1d* (one torque frame of the monkey
    hanging from its bars, the hands attached as :data:`K1D_CASES` says, on
    the thread-per-env instance),
    k1f* (one torque frame of the walker over a terrain window, as
    :data:`K1F_CASES` says), k1g (one torque frame of the walker on the
    stairs' 16 culled faces), k1h_si (one torque frame of the walker near
    contact with split impulse), and the split-impulse twins of
    :data:`SPLIT_CASES` (the twin's wrapper and states, ``split_impulse``
    on)."""
    if case in SPLIT_CASES:
        twin, arrays = _kernel_case(SPLIT_CASES[case], B, seed, device)
        split = dataclasses.replace(twin.config, split_impulse=True)
        return engine.make_kernel(
            twin.model, split, num_stones=twin.num_stones, num_bars=twin.num_bars,
            pd_mode=twin.pd_mode, extra_damping=twin.extra_damping,
            constraints=twin.constraints), arrays
    rng = np.random.default_rng(seed)
    if case == "k1g":
        model = walker3d.make_model(device)
        return engine.K1g(model, EngineConfig()), chip_smoke.stairs_states(model, rng, B)
    if case == "k1h_si":
        model = walker3d.make_model(device)
        return (engine.K1hSi(model, EngineConfig(split_impulse=True)),
                chip_smoke.near_contact_states(model, rng, B))
    if case in K1F_CASES:
        model = walker3d.make_model(device)
        return (engine.K1f(model, EngineConfig(), HF_PATCH),
                chip_smoke.terrain_states(model, rng, B, **K1F_CASES[case]))
    if case in K1D_CASES:
        # the thread-per-env instance (the warp-per-env one the entry points
        # pick is held in tests/test_torch_k1w_split_walker_monkey.py)
        model = monkey.make_model(device)
        return (engine.K1d(model, EngineConfig(), monkey.constraints(), 16, thread_per_env=True),
                chip_smoke.monkey_states(model, rng, B, **K1D_CASES[case]))
    if case.startswith("k1e_cassie"):
        model = cassie.make_model(device)
        spec = dataclasses.replace(cassie.constraints(),
                                   planar=case.startswith("k1e_cassie2d"))
        kernel = engine.K1e(model, CASSIE_CONFIG, spec, pd_mode=True,
                            extra_damping=model.actuated * model.kd,
                            thread_per_env=case.endswith("_thread"))
        return kernel, chip_smoke.cassie_states(
            model, cassie.stand_q(model), cassie.initial_z(), rng, spec.planar, B)
    if case in ("k1e_planar", "k1e_crab"):
        make, stand_z = ((walker2d.make_walker2d, 1.22) if case == "k1e_planar"
                         else (walker2d.make_crab2d, 0.42))
        model = make(device)
        return (engine.K1e(model, EngineConfig(), walker2d.planar_spec()),
                chip_smoke.planar_walker_states(model, stand_z, rng, B))
    model = walker3d.make_model(device)
    if case == "k1a":
        return engine.K1a(model, EngineConfig()), chip_smoke.near_contact_states(model, rng, B)
    if case == "k1c":
        config = EngineConfig()
        return (engine.K1c(model, config),
                chip_smoke.stepper_states(model, rng, config.stone_window, B))
    kp = model.power_coef * (model.actuated > 0).float()
    config = EngineConfig(llc_frames=2 if case == "k1b_llc2" else 1)
    return (engine.K1b(model.replace(kp=kp), config, extra_damping=kp / 20.0),
            chip_smoke.pd_target_states(model, rng, B))


KERNEL_CASES = ["k1a", "k1c", "k1b", "k1b_llc2"]
K1E_CASES = ["k1e_cassie", "k1e_cassie2d", "k1e_cassie_thread", "k1e_cassie2d_thread",
             "k1e_planar", "k1e_crab"]
# the right hand always and the left in half of the envs (the main path's
# mix), both hands, none (a free body: every grab row masked), and no bar
# near the feet or the torso
K1D_CASES = {"k1d": {}, "k1d_both_hands": {"left": 1.0},
             "k1d_no_hands": {"left": 0.0, "right": 0.0}, "k1d_no_bar_contact": {"near_bar": 0.0}}
# a tenth of the roots by the grid's edge (the main path's mix), and all
K1F_CASES = {"k1f": {}, "k1f_border": {"border": 1.0}}
NEW_CASES = ["k1g", "k1h_si"]
# the split-impulse instances of the training path, each on its twin's
# wrapper and states
SPLIT_CASES = {"k1h_c": "k1c", "k1h_e": "k1e_cassie", "k1h_e2d": "k1e_cassie2d",
               "k1h_d": "k1d"}
# the split cases (here, in SPLIT_REST and the A-form with split impulse of
# chip_smoke.OPTION_CONFIGS) and the walker's other A-form keys, its scalar
# friction key and its factor-every-substep key there that run a
# warp-per-env instance of csrc/engine_k1w.cu, by its symbol
SPLIT_WARP = {"k1h_c": "k1w_nl22_ns14_nlim21_sub4_it4_k6_si",
              "k1h_e": "k1w_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_si",
              "k1h_e2d": "k1w_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_planar_si",
              "k1h_b": "k1w_nl22_ns14_nlim21_sub4_it4_llc1_si",
              "k1h_f": "k1w_nl22_ns14_nlim21_sub4_it4_hf16_si",
              "k1h_g": "k1w_nl22_ns14_nlim21_sub4_it4_kt16_si",
              "k1h_d": "k1w_nl11_ns5_nlim8_sub4_it4_kb16_ng2_si",
              "k1h_e_planar": "k1w_nl7_ns5_nlim6_sub4_it4_planar_si",
              "k1h_e_crab": "k1w_nl7_ns5_nlim6_sub4_it4_planar_si",
              "k1h_si_aform": "k1w_nl22_ns14_nlim21_sub4_it4_si_aform",
              "k1a_aform": "k1w_nl22_ns14_nlim21_sub4_it4_aform",
              "k1a_aform_scalar_cold_refactor":
                  "k1w_nl22_ns14_nlim21_sub4_it4_aform_scalar_cold_refactor",
              "k1a_scalar": "k1w_nl22_ns14_nlim21_sub4_it4_scalar",
              "k1a_refactor": "k1w_nl22_ns14_nlim21_sub4_it4_refactor"}


def _launch_counted(kernel, case, args):
    """``kernel.launch(*args)``, synchronised, counted once under its variant
    and its symbol; a case of :data:`SPLIT_WARP` by its warp-per-env
    instance."""
    if case in SPLIT_WARP:
        assert kernel.instance.source == engine.SOURCE_W and kernel.name == SPLIT_WARP[case]
    before = engine.LAUNCHES[kernel.variant], engine.INSTANCE_LAUNCHES[kernel.name]
    got = kernel.launch(*args)
    torch.cuda.synchronize()
    assert (engine.LAUNCHES[kernel.variant], engine.INSTANCE_LAUNCHES[kernel.name]) \
        == (before[0] + 1, before[1] + 1)
    return got


def _gate_medians(got, want, tol=TOL, tail="max", tail_envs=None):
    """Per-env medians within ``tol``; ten times ``tol`` for the largest env
    or, with ``tail="p99"`` (the Cassie instances: chip_smoke.py says why),
    for the 99th percentile, over the ``tail_envs`` (bool (B,)) if given."""
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        per_env = np.abs(np.asarray(g) - np.asarray(w)).max(axis=1)
        assert np.median(per_env) <= tol[name], (name, float(np.median(per_env)))
        if tail_envs is not None:
            per_env = per_env[tail_envs]
        worst = np.quantile(per_env, 0.99) if tail == "p99" else per_env.max()
        assert worst <= 10 * tol[name], (name, tail, float(worst))


def test_port_runs_with_jax_unimportable():
    code = """
import sys
for m in ("jax", "jaxlib", "flax", "optax", "orbax", "mocca_envs_tpu"):
    sys.modules[m] = None
import torch
torch.set_num_threads(1)   # as tests/torch_workers.py sets it for the test processes
import mocca_envs_tpu_torch as P
from mocca_envs_tpu_torch import convert  # noqa: F401
from mocca_envs_tpu_torch.ops.cuda import engine  # noqa: F401
for name in P.registered_envs():
    env = P.make(name + "-v0", device="cpu")
    batch = P.BatchedEnv(env, 2, seed=0, device="cpu")
    tr = batch.step(batch.init(), torch.zeros(2, env.act_dim))
    assert tr.obs.shape == (2, env.obs_dim) and bool(torch.isfinite(tr.obs).all()), name
assert len(P.registered_envs()) == 15
from mocca_envs_tpu_torch.harness import (  # noqa: F401
    checkpoint, metrics, ppo, profile, rollout, train, transfer)
state = train.main(["--env", "Walker3DStepperEnv", "--split-impulse", "--num-envs", "4",
                    "--horizon", "2", "--updates", "1", "--minibatches", "1"], device="cpu")
assert state.update_count == 1
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "mocca_envs_tpu")]
assert not loaded, loaded
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=480)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]


def test_sources_import_no_jax():
    files = sorted((REPO / "mocca_envs_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "k1w_launch_shapes.py"]
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


FAMILIES = ["Walker3DCustomEnv-v0", "Walker3DStepperEnv-v0", "Walker3DPDCustomEnv-v0",
            "Child3DCustomEnv-v0", "Child3DPDCustomEnv-v0", "CassieEnv-v0", "Cassie2DEnv-v0",
            "CassiePhaseEnv-v0", "CassiePhase2DEnv-v0", "Walker2DCustomEnv-v0",
            "Crab2DCustomEnv-v0", "Monkey3DStepperEnv-v0", "Walker3DTerrainEnv-v0",
            "Walker3DTerrainLidarEnv-v0", "Walker3DStairsEnv-v0"]


@pytest.mark.parametrize("env_id", FAMILIES)
def test_no_device_means_cuda(env_id):
    cpu_env = mocca_envs_tpu_torch.make(env_id, device="cpu")
    if torch.cuda.is_available():
        assert mocca_envs_tpu_torch.make(env_id).device.type == "cuda"
        with pytest.raises(ValueError):
            mocca_envs_tpu_torch.BatchedEnv(cpu_env, 2)
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mocca_envs_tpu_torch.make(env_id)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mocca_envs_tpu_torch.BatchedEnv(cpu_env, 2)


@pytest.mark.parametrize("env_id", FAMILIES)
def test_cpu_path_never_launches_the_kernel(env_id):
    env = mocca_envs_tpu_torch.make(env_id, device="cpu")
    batch = mocca_envs_tpu_torch.BatchedEnv(env, 3, seed=1, device="cpu")
    engine.LAUNCHES.clear()
    state = batch.init()
    for _ in range(3):
        state = batch.step(state, torch.rand(3, env.act_dim) * 2 - 1).state
    assert sum(engine.LAUNCHES.values()) == 0


def test_split_walker_cpu_path_never_launches_the_kernel():
    """The walker with split impulse runs the plain path on CPU tensors."""
    env = mocca_envs_tpu_torch.make("Walker3DCustomEnv-v0", device="cpu",
                                    config=EngineConfig(split_impulse=True))
    batch = mocca_envs_tpu_torch.BatchedEnv(env, 3, seed=1, device="cpu")
    engine.LAUNCHES.clear()
    state = batch.init()
    for _ in range(3):
        state = batch.step(state, torch.rand(3, env.act_dim) * 2 - 1).state
    assert sum(engine.LAUNCHES.values()) == 0 and bool(torch.isfinite(state.q).all())


@pytest.mark.parametrize("case", KERNEL_CASES + K1E_CASES + ["k1d", "k1f"] + NEW_CASES)
def test_launch_refuses_cpu_tensors(case):
    """No silent CPU path: the kernel's launch refuses CPU tensors; the
    plain version runs on them, uncounted."""
    kernel, arrays = _kernel_case(case, 4, 0)
    args = [torch.as_tensor(x) for x in arrays]
    engine.LAUNCHES.clear()
    with pytest.raises(ValueError, match="CUDA"):
        kernel.launch(*args)
    assert all(bool(torch.isfinite(x).all()) for x in kernel.plain(*args))
    assert sum(engine.LAUNCHES.values()) == 0


def _assert_generic(kernel, symbol, variant=None):
    """``kernel`` runs a generic instance of its key, built from the flags
    that name it (and counts under ``variant``): where ``csrc/engine_k1w.cu``
    holds the key and ``thread_per_env`` was not asked for, the generic
    warp-per-env one (``k1w``, ``symbol``'s tags, the launch shape), else
    the generic ``engine_k1.cu`` one, named ``symbol``, which is the key's
    thread-per-env twin either way."""
    twin = engine.instance_for(kernel.key, thread_per_env=True)
    assert twin.symbol == symbol == engine.canonical_symbol(kernel.key)
    assert twin.index is None and kernel.key not in engine.INSTANTIATIONS
    assert f"-DK1_NAME={symbol}" in engine.compile_flags(twin)
    assert kernel.instance in (engine.instance_for(kernel.key), twin)
    if kernel.instance.source == engine.SOURCE_W:
        assert engine.warp_holds(kernel.key) and kernel.key not in engine.WARP_INSTANCES
        assert kernel.instance == engine.warp_instance(kernel.key) and kernel.instance.envs > 0
        assert kernel.name.startswith("k1w" + symbol.removeprefix("k1") + "_")
        assert f"-DK1W_NAME={kernel.name}" in engine.compile_flags(kernel.instance)
    else:
        assert kernel.name == symbol
    if variant is not None:
        assert kernel.variant == variant


W = "k1_nl22_ns14_nlim21"


K1A_KEYS = (({"warm_start": False}, f"{W}_sub4_it4_cold", "k1a_cold"),
            ({"matfree_pgs": False}, f"{W}_sub4_it4_aform", "k1a_aform"),
            ({"reuse_factor": False}, f"{W}_sub4_it4_refactor", "k1a_refactor"),
            ({"block_pgs": False}, f"{W}_sub4_it4_scalar", "k1a_scalar"),
            ({"split_impulse": True}, None, None), ({"solver_iters": 8}, f"{W}_sub4_it8", "k1a"),
            ({"sim_substeps": 2}, f"{W}_sub2_it4", "k1a"))


@pytest.mark.parametrize("change, symbol, variant",
                         [pytest.param(*c, id=next(iter(c[0]))) for c in K1A_KEYS])
def test_k1a_refuses_what_it_has_no_instantiation_for(change, symbol, variant):
    """K1a takes every PGS option and any substeps or sweeps, counted under
    its option's tag: each PGS option off alone on its named warp-per-env
    instance, other substeps or sweeps on the generic warp-per-env instance
    of their key; the generic engine_k1.cu instance is each one's twin;
    split impulse on the walker's plane stays K1hSi's."""
    if symbol is None:
        with pytest.raises(NotImplementedError, match="split_impulse"):
            engine.K1a(walker3d.make_model(), EngineConfig(**change))
        return
    kernel = engine.K1a(walker3d.make_model(), EngineConfig(**change))
    assert kernel.instance.source == engine.SOURCE_W
    if kernel.key in engine.WARP_INSTANCES:
        assert kernel.instance is engine.WARP_INSTANCES[kernel.key]
        assert kernel.name == "k1w" + symbol.removeprefix("k1") and kernel.variant == variant
    else:
        _assert_generic(kernel, symbol, variant)
    kernel = engine.K1a(walker3d.make_model(), EngineConfig(**change), thread_per_env=True)
    _assert_generic(kernel, symbol, variant)


@pytest.mark.parametrize("build, symbol", [
    (lambda m: engine.K1c(m, EngineConfig(stone_window=8)), f"{W}_sub4_it4_k8"),
    (lambda m: engine.K1c(m, EngineConfig(), num_stones=20), f"{W}_sub4_it4_k20"),
    (lambda m: engine.K1b(m, EngineConfig(llc_frames=3)), f"{W}_sub4_it4_llc3"),
    (lambda m: engine.make_kernel(m, EngineConfig(), num_stones=6, pd_mode=True),
     f"{W}_sub4_it4_k6_llc1"),
    (lambda m: engine.make_kernel(m, EngineConfig(), extra_damping=m.power_coef / 20), None),
], ids=["window8", "unculled20", "llc3", "pd_over_stones", "damped_torque"])
def test_k1_variants_refuse_what_they_have_no_instantiation_for(build, symbol):
    """Other stone windows and llc frames are keys of the generic instance;
    so is PD mode over stones, a K1x counted under its tags; extra damping
    in torque mode is K1a's key with the damping in the table, on K1a's
    named instances, counted as ``k1_damped``."""
    kernel = build(walker3d.make_model())
    if symbol is None:
        assert isinstance(kernel, engine.K1x) and kernel.variant == "k1_damped"
        assert kernel.instance is engine.WARP_INSTANCES[engine.K1a(kernel.model,
                                                                  EngineConfig()).key]
        assert engine.instance_for(kernel.key, thread_per_env=True).symbol \
            == "k1a_nl22_ns14_nlim21_sub4_it4"
        # the damping rides the table: K1a's table with it added
        np.testing.assert_array_equal(
            kernel.table_host, engine.pack_tables(kernel.model, EngineConfig(),
                                                  kernel.extra_damping))
        assert not np.array_equal(kernel.table_host,
                                  engine.pack_tables(kernel.model, EngineConfig()))
        return
    _assert_generic(kernel, symbol)
    if kernel.num_stones and kernel.pd_mode:
        assert isinstance(kernel, engine.K1x) and kernel.variant == "k1_k6_llc1"


C = "k1_nl17_ns5_nlim16"
GRAB_SPEC = ConstraintSpec(planar=True, num_grabs=1, grab_links=(1,),
                           grab_anchors=((0.0, 0.0, 0.0),))


@pytest.mark.parametrize("build, want", [
    (lambda: engine.K1e(cassie.make_model(), CASSIE_CONFIG, ConstraintSpec(planar=True),
                        pd_mode=True), f"{C}_sub2_it4_llc10_planar"),
    (lambda: engine.K1e(cassie.make_model(), CASSIE_CONFIG, cassie.constraints()),
     f"{C}_sub2_it4_p2p2"),
    (lambda: engine.K1e(cassie.make_model(), dataclasses.replace(CASSIE_CONFIG, llc_frames=5),
                        cassie.constraints(), pd_mode=True), f"{C}_sub2_it4_llc5_p2p2"),
    (lambda: engine.K1e(walker2d.make_walker2d(), EngineConfig(), walker2d.planar_spec(),
                        pd_mode=True), "k1_nl7_ns5_nlim6_sub4_it4_llc1_planar"),
    # Cassie's rods name links Walker2D does not have
    (lambda: engine.K1e(walker2d.make_walker2d(), EngineConfig(), cassie.constraints()),
     ValueError),
    (lambda: engine.K1e(walker3d.make_model(), EngineConfig(), walker2d.planar_spec()),
     f"{W}_sub4_it4_planar"),
    (lambda: engine.make_kernel(walker2d.make_walker2d(), EngineConfig(), num_stones=6,
                                constraints=walker2d.planar_spec()),
     "k1_nl7_ns5_nlim6_sub4_it4_k6_planar"),
    # grabs with the planar lock on Walker2D, no bars: the grab rows' input
    # alone
    (lambda: engine.make_kernel(walker2d.make_walker2d(), EngineConfig(),
                                constraints=GRAB_SPEC), "k1_nl7_ns5_nlim6_sub4_it4_planar_ng1"),
], ids=["cassie_lock_without_rods", "cassie_torque_mode", "cassie_llc5", "walker2d_pd",
        "walker2d_rods", "walker3d_planar", "planar_over_stones", "grabs"])
def test_k1e_refuses_what_it_has_no_instantiation_for(build, want):
    """Other equality-row keys (the lock without the rods, torque mode, other
    llc frames, PD on Walker2D, the lock on the 3D walker, grabs without
    bars, equality rows over stones) are keys of the generic instance; rods
    naming links the model lacks are an error."""
    if isinstance(want, type):
        with pytest.raises(want, match="link"):
            build()
        return
    kernel = build()
    _assert_generic(kernel, want)
    if kernel.num_stones:
        assert isinstance(kernel, engine.K1x) and kernel.variant == "k1_k6_planar"
    if kernel.constraints.num_grabs:
        assert kernel.inputs == ("grabs",)


def test_k1e_is_picked_by_the_constraints():
    model, spec = walker2d.make_walker2d(), walker2d.planar_spec()
    assert isinstance(engine.make_kernel(model, EngineConfig(), constraints=spec), engine.K1e)
    cm = cassie.make_model()
    kernel = engine.make_kernel(cm, CASSIE_CONFIG, pd_mode=True, constraints=cassie.constraints(),
                                extra_damping=cm.actuated * cm.kd)
    assert isinstance(kernel, engine.K1e) and kernel.variant == "k1e" and kernel.pd_mode
    with pytest.raises(ValueError, match="equality rows"):
        engine.K1e(model, EngineConfig(), ConstraintSpec())


def test_k1a_refuses_other_model_sizes():
    """Another model size is a key of the generic instances: a one-legged
    hopper (2 links, 1 sphere, 1 limit row) at the JAX package's gate
    configuration, 2 substeps × 8 sweeps, on the generic warp-per-env
    instance and on its generic engine_k1.cu twin, each built for the host,
    against the plain version at K1a's gates."""
    from mocca_envs_tpu_torch.models.schema import ModelBuilder

    b = ModelBuilder("hopper", floating=True)
    b.base_inertial(5.0, (0, 0, 0), inertia_diag=(0.1, 0.1, 0.1))
    b.add_link("leg", "base", joint_pos=(0, 0, -0.1), joint_axis=(0, 1, 0), mass=1.0,
               com=(0, 0, -0.25), inertia_diag=(0.02, 0.02, 0.002), limit=(-1.5, 1.5))
    b.add_sphere("leg", (0, 0, -0.5), 0.05, foot="foot")
    model = b.build()
    kernel = engine.K1a(model, EngineConfig(sim_substeps=2, solver_iters=8))
    _assert_generic(kernel, "k1_nl2_ns1_nlim1_sub2_it8", "k1a")
    rng = np.random.default_rng(4)
    B = 64
    q = np.zeros((B, model.nq), np.float32)
    q[:, 3:7] = np.array([1.0, 0.0, 0.0, 0.0]) + 0.02 * rng.standard_normal((B, 4))
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q[:, 7] = rng.uniform(-1.6, 1.6, B)                 # past its limit in some envs
    # the foot sphere within ±2 cm of the plane (the base nearly upright)
    q[:, 2] = 0.1 + 0.5 * np.cos(q[:, 7]) + 0.05 + rng.uniform(-0.02, 0.02, B)
    qd = (0.3 * rng.standard_normal((B, model.nv))).astype(np.float32)
    tau = rng.uniform(-5.0, 5.0, (B, 1)).astype(np.float32)
    inputs = [q, qd, tau, np.zeros(B, np.float32), np.full(B, 0.8, np.float32)]
    twin = engine.K1a(model, EngineConfig(sim_substeps=2, solver_iters=8), thread_per_env=True)
    _assert_generic(twin, "k1_nl2_ns1_nlim1_sub2_it8", "k1a")
    assert kernel.instance.source == engine.SOURCE_W and twin.instance.source == engine.SOURCE
    libs = build_host([kernel, twin])
    want = [t.numpy() for t in kernel.plain(*map(torch.as_tensor, inputs))]
    for k in (kernel, twin):
        _gate_medians(run_on_host(libs[k.name], k, inputs), want)
    assert (want[3] > 0).mean() > 0.2                 # the foot carries load


def test_k1a_flops_counts_only_the_active_rows():
    model, config = walker3d.make_model(), EngineConfig()
    k1a = engine.K1a(model, config)
    args = [torch.as_tensor(x) for x in _near_contact(16, 3)]
    lim_act, con_act, walk = engine.k1_activity(k1a, *args)
    S = config.sim_substeps
    assert lim_act.shape == (S, 16, 21) and con_act.shape == (S, 16, 14)
    assert walk.shape == (S, 16) and not walk.any()  # no mesh, no walk
    # the last substep's contact mask is the one the plain frame reports
    depth = k1a.plain(*args)[2]
    assert torch.equal(con_act[-1], depth > -config.contact_margin)
    assert 0 < int(con_act.sum()) < con_act.numel()
    none = engine.k1_flops(k1a, torch.zeros_like(lim_act), torch.zeros_like(con_act))
    need = engine.k1_flops(k1a, lim_act, con_act)
    full = engine.k1_flops(k1a, torch.ones_like(lim_act), torch.ones_like(con_act))
    assert none < need < full
    # one more active contact in one substep adds that contact's work only
    extra = con_act.clone()
    s, b, k = (~extra).nonzero()[0].tolist()
    extra[s, b, k] = True
    grown = engine.k1_flops(k1a, lim_act, extra)
    assert 0 < grown - need < (full - none) / (S * 16)


def test_variant_counts_add_their_own_work():
    """K1c counts a box test per (sphere, active stone) and substep, the
    general-normal projection per active contact and 6·11·4 more input
    bytes; K1b counts the PD torque per llc frame and two factorisations at
    two llc frames."""
    B = 8
    k1a, a_in = _kernel_case("k1a", B, 2)
    k1c, c_in = _kernel_case("k1c", B, 2)
    c_args = [torch.as_tensor(x) for x in c_in]
    lim_act, con_act, _ = engine.k1_activity(k1c, *c_args)
    stones = c_args[5]
    assert engine.k1_bytes_per_env(k1c) == engine.k1_bytes_per_env(k1a) + 6 * 11 * 4
    with_stones = engine.k1_flops(k1c, lim_act, con_act, stones)
    plane_only = engine.k1_flops(k1a, lim_act, con_act)
    S, ns, nv = 4, 14, 27
    active = float((engine.unpack_stones(stones)["stone_active"] > 0.5).sum())
    want = S * ns * (55 * active + 64 * B) + float(con_act.sum()) * (15 + 15 * nv)
    assert with_stones - plane_only == pytest.approx(want)
    # an inactive stone is not tested
    fewer = stones.clone()
    fewer[10] = 0.0                                  # stone 0's active flag
    assert engine.k1_flops(k1c, lim_act, con_act, fewer) == pytest.approx(
        with_stones - S * ns * 55 * B)
    # stones round-trip through the packed layout
    scene = engine.make_scene(c_args[3], c_args[4], stones)
    assert scene.stone_pos.shape == (B, 6, 3)
    torch.testing.assert_close(engine.pack_stones(scene), stones, atol=0, rtol=0)

    k1b, b_in = _kernel_case("k1b", B, 2)
    k1b2, _ = _kernel_case("k1b_llc2", B, 2)
    b_args = [torch.as_tensor(x) for x in b_in]
    l1, c1, _ = engine.k1_activity(k1b, *b_args)
    l2, c2, _ = engine.k1_activity(k1b2, *b_args)
    assert l1.shape[0] == 4 and l2.shape[0] == 8
    assert torch.equal(l2[:4], l1) and torch.equal(c2[:4], c1)
    zeros = lambda x: torch.zeros_like(x)  # noqa: E731
    assert engine.k1_flops(k1b, zeros(l1), zeros(c1)) \
        == engine.k1_flops(k1a, zeros(l1), zeros(c1)) + B * 21 * 3
    assert engine.k1_flops(k1b2, zeros(l2), zeros(c2)) \
        == 2 * engine.k1_flops(k1b, zeros(l1), zeros(c1))


def test_equality_rows_count_their_own_work():
    """Equality rows are always active: their work does not depend on the
    masks, grows with the substeps of the call, and the planar lock adds to
    the rods'. They are part of the table, not of the inputs."""
    B = 4
    rods, args = _kernel_case("k1e_cassie", B, 2)
    both, _ = _kernel_case("k1e_cassie2d", B, 2)
    lim_act, con_act, _ = engine.k1_activity(rods, *map(torch.as_tensor, args))
    assert lim_act.shape == (20, B, 16) and con_act.shape == (20, B, 5)
    zeros, ones = torch.zeros_like, torch.ones_like
    lock_needed = engine.k1_flops(both, lim_act, con_act) - engine.k1_flops(rods, lim_act, con_act)
    lock_idle = engine.k1_flops(both, zeros(lim_act), zeros(con_act)) \
        - engine.k1_flops(rods, zeros(lim_act), zeros(con_act))
    assert lock_needed == lock_idle > 0
    # three unit rows on base columns 1, 3, 5 of nv = 22, every substep
    spans = [22 - c for c in (1, 3, 5)]
    per_sub = sum(n * n + 2 * n + 4 * (4 * n + 6) + 6 for n in spans) + 6
    warm = sum(2 * n for n in spans)
    assert lock_idle == B * (20 * per_sub + 19 * warm)
    # the rods: more than the lock (dense rows, two Jacobians each)
    no_rows = copy.copy(rods)
    no_rows.constraints = ConstraintSpec()
    rod_work = engine.k1_flops(rods, zeros(lim_act), zeros(con_act)) \
        - engine.k1_flops(no_rows, zeros(lim_act), zeros(con_act))
    assert rod_work > 2 * lock_idle
    assert engine.k1_bytes_per_env(both) == engine.k1_bytes_per_env(rods) == 4 * (
        23 + 22 + 16 + 2 + 23 + 22 + 5 + 5)
    assert engine.k1_flops(rods, ones(lim_act), ones(con_act)) \
        > engine.k1_flops(rods, lim_act, con_act)


@pytest.fixture(scope="module")
def host_library():
    """The kernel sources (csrc/engine_k1.cu, csrc/engine_k1w.cu) built by the
    host C++ compiler: each instantiation's per-env code as a loop over envs
    (the warp-per-env instances at lane width 1), each instance built at the
    first lookup of its symbol, or taken from the build cache that every
    file and worker shares (tests/torch_k1_host.py)."""
    return HostLibrary()



def test_k1a_source_arithmetic_on_host(host_library):
    """The kernel's per-env code built by the host C++ compiler, run as a
    loop over envs, against the plain version: the warp-per-env K1a the
    walker runs, and the thread-per-env instance kept beside it."""
    k1a = engine.K1a(walker3d.make_model(), EngineConfig())
    old = engine.K1a(k1a.model, EngineConfig(), thread_per_env=True)
    assert k1a.instance.source == engine.SOURCE_W and old.instance.source == engine.SOURCE
    inputs = [np.ascontiguousarray(x) for x in _near_contact(32, 5)]
    want = [t.numpy() for t in k1a.plain(*map(torch.as_tensor, inputs))]
    for kernel in (k1a, old):
        _gate_medians(run_on_host(host_library, kernel, inputs), want)
    assert (want[3] > 0).mean() > 0.1   # contacts carry load


@pytest.mark.parametrize("case", KERNEL_CASES[1:])
def test_k1_variant_source_arithmetic_on_host(host_library, case):
    """K1c (stone boxes, general normals), K1b (PD torque, extra damping)
    and K1b at two llc frames (λ carried across them) against their plain
    versions, at the same gates."""
    kernel, arrays = _kernel_case(case, 32, 5)
    inputs = [np.ascontiguousarray(x) for x in arrays]
    outs = run_on_host(host_library, kernel, inputs)
    want = [t.numpy() for t in kernel.plain(*map(torch.as_tensor, inputs))]
    _gate_medians(outs, want)
    assert (want[3] > 0).mean() > 0.02   # contacts carry load
    if case == "k1c":
        # some spheres rest on stones: their depth is far above the plane's
        plane_depth = 0.2 - (inputs[0][:, 2] + 20.0)
        assert (want[2] > plane_depth[:, None] + 5.0).mean() > 0.3
        assert (want[2].max(axis=1) < -1.0).any()    # ... and some envs are over the gap
    if case == "k1b_llc2":
        # the second frame's torque follows the state: one frame twice
        # from the same targets is another trajectory than two frames
        one, _ = _kernel_case("k1b", 32, 5)
        half = one.plain(*map(torch.as_tensor, inputs))
        assert not np.allclose(half[0].numpy(), want[0], atol=1e-4)


@pytest.mark.parametrize("case", K1E_CASES)
def test_k1e_source_arithmetic_on_host(host_library, case):
    """The equality-row instances (Cassie's whole PD control step with the
    rods: 10 llc frames × 2 substeps, λ carried, the factor refreshed per
    frame; the same with the planar lock; each by its warp-per-env instance
    and by its thread-per-env one; one torque frame of Walker2D and of
    Crab2D with the lock, by their warp-per-env instance) against their
    plain versions, at the equality-row tolerances."""
    kernel, arrays = _kernel_case(case, 64, 5)
    assert (kernel.instance.source == engine.SOURCE_W) == (not case.endswith("_thread"))
    inputs = [np.ascontiguousarray(x) for x in arrays]
    outs = run_on_host(host_library, kernel, inputs)
    want = [t.numpy() for t in kernel.plain(*map(torch.as_tensor, inputs))]
    assert all(np.isfinite(o).all() for o in outs)
    _gate_medians(outs, want, TOL_EQ, tail="p99" if "cassie" in case else "max")
    assert (want[3] > 0).mean() > 0.1   # contacts carry load
    if kernel.constraints.planar:
        # the lock pulls the drift in: |y| shrinks over the unit
        assert np.abs(outs[0][:, 1]).mean() < np.abs(inputs[0][:, 1]).mean()
    if kernel.constraints.num_p2p:
        # the servo and the springs moved the joints: not the input pose
        assert np.abs(outs[0][:, 7:] - inputs[0][:, 7:]).max() > 0.01


@pytest.mark.parametrize("case", list(K1D_CASES))
def test_k1d_source_arithmetic_on_host(host_library, case):
    """The bar-capsule and grab-row instance (one torque frame of the monkey
    hanging from its bars) against its plain version, at the tolerances of
    the bar and grab rows: per-env medians within q 5e-4, qd 2e-2, depth
    5e-4, impulse 1e-2, the largest env within ten times."""
    kernel, arrays = _kernel_case(case, 64, 5)
    inputs = [np.ascontiguousarray(x) for x in arrays]
    outs = run_on_host(host_library, kernel, inputs)
    want = [t.numpy() for t in kernel.plain(*map(torch.as_tensor, inputs))]
    assert all(np.isfinite(o).all() for o in outs)
    _gate_medians(outs, want, TOL_GRAB)
    attached = engine.unpack_grabs(torch.as_tensor(inputs[6]))[0].numpy() > 0.5
    near = (want[2] > -EngineConfig().contact_margin).any(axis=1)
    if case == "k1d_no_bar_contact":
        assert not near.any() and (want[3] == 0).all()    # nothing touches a bar
    else:
        assert near.mean() > 0.3 and (want[3] > 0).mean() > 0.02   # bars carry load
    assert attached[:, 0].all() != (case == "k1d_no_hands")
    assert attached[:, 1].mean() == pytest.approx(
        {"k1d_both_hands": 1.0, "k1d_no_hands": 0.0}.get(case, 0.5), abs=0.2)
    # the grab rows hold the palms: an attached palm ends the frame near its
    # anchor, a free one falls with the body
    palms = tasks_monkey.make_palm_positions(kernel.model, kernel.constraints)(
        torch.as_tensor(outs[0]))
    target = engine.unpack_grabs(torch.as_tensor(inputs[6]))[1]
    gap = torch.linalg.vector_norm(palms - target, dim=2).numpy()
    if attached.any():
        assert np.median(gap[attached]) < 0.01
    if (~attached).any():
        assert np.median(gap[~attached]) > 0.015


def test_k1d_is_picked_by_bars_and_grabs():
    model, spec = monkey.make_model(), monkey.constraints()
    kernel = engine.make_kernel(model, EngineConfig(), num_bars=16, constraints=spec)
    assert isinstance(kernel, engine.K1d) and kernel.variant == "k1d"
    # the warp-per-env instance; the thread-per-env one only when asked for
    assert kernel.inputs == ("bars", "grabs")
    assert kernel.name == "k1w_nl11_ns5_nlim8_sub4_it4_kb16_ng2"
    assert engine.K1d(model, EngineConfig(), spec, 16, thread_per_env=True).name \
        == "k1d_nl11_ns5_nlim8_sub4_it4_kb16_ng2"
    # other bar counts, bars without the grabs, other substeps: the generic
    # instance of their keys; PD mode: a K1x (below)
    for build, symbol in (
            (lambda: engine.make_kernel(model, EngineConfig(), num_bars=8, constraints=spec),
             "k1_nl11_ns5_nlim8_sub4_it4_kb8_ng2"),
            (lambda: engine.make_kernel(model, EngineConfig(), num_bars=16),
             "k1_nl11_ns5_nlim8_sub4_it4_kb16"),
            (lambda: engine.make_kernel(model, EngineConfig(sim_substeps=2), num_bars=16,
                                        constraints=spec), "k1_nl11_ns5_nlim8_sub2_it4_kb16_ng2")):
        _assert_generic(build(), symbol, "k1d")
    assert engine.make_kernel(model, EngineConfig(), num_bars=16).inputs == ("bars",)
    # PD mode: a K1x on the generic instance of its key
    pd = engine.make_kernel(model, EngineConfig(), num_bars=16, pd_mode=True, constraints=spec)
    assert isinstance(pd, engine.K1x) and pd.inputs == ("bars", "grabs")
    _assert_generic(pd, "k1_nl11_ns5_nlim8_sub4_it4_llc1_kb16_ng2", "k1_llc1_kb16_ng2")


@pytest.mark.parametrize("bad", ["bars_rows", "grabs_batch", "missing_grabs", "grabs_dtype",
                                 "cpu"])
def test_k1d_check_inputs_refuses(bad):
    """Wrong shapes, a missing scene input, a wrong dtype and host tensors
    are refused before anything launches."""
    kernel, arrays = _kernel_case("k1d", 8, 1)
    args = [torch.as_tensor(x) for x in arrays]
    want = {"bars_rows": (ValueError, "bars has shape"), "grabs_batch": (ValueError, "grabs has"),
            "missing_grabs": (ValueError, "scene inputs"), "grabs_dtype": (TypeError, "float32"),
            "cpu": (ValueError, "CUDA")}[bad]
    if bad == "bars_rows":
        args[5] = args[5][:-8]
    elif bad == "grabs_batch":
        args[6] = args[6][:, :-1]
    elif bad == "missing_grabs":
        args = args[:6]
    elif bad == "grabs_dtype":
        args[6] = args[6].double()
    engine.LAUNCHES.clear()
    with pytest.raises(want[0], match=want[1]):
        kernel.launch(*args)
    assert sum(engine.LAUNCHES.values()) == 0


def test_bars_and_grabs_count_their_own_work():
    """K1d counts a capsule test per (sphere that may touch a bar, active
    bar) and substep, the general-normal projection per active contact, and
    a grab's rows only where it is attached; bars and grabs are inputs."""
    B = 8
    kernel, arrays = _kernel_case("k1d", B, 2)
    args = [torch.as_tensor(x) for x in arrays]
    lim_act, con_act, _ = engine.k1_activity(kernel, *args)
    assert lim_act.shape == (4, B, 8) and con_act.shape == (4, B, 5)
    bars, grabs = args[5], args[6]
    flops = engine.k1_flops(kernel, lim_act, con_act, bars, grabs)
    # an inactive bar is not tested by the three spheres that may touch bars
    fewer = bars.clone()
    fewer[7] = 0.0                                    # bar 0's active flag
    assert engine.k1_flops(kernel, lim_act, con_act, fewer, grabs) == pytest.approx(
        flops - 4 * 3 * 35 * B)
    # a released grab takes its rows out of the count
    free = grabs.clone()
    free[4] = 0.0                                     # the left hand lets go everywhere
    attached_left = int((grabs[4] > 0.5).sum())
    assert 0 < attached_left < B
    assert engine.k1_flops(kernel, lim_act, con_act, bars, free) < flops
    none = grabs.clone()
    none[0] = none[4] = 0.0
    assert engine.k1_flops(kernel, lim_act, con_act, bars, none) \
        < engine.k1_flops(kernel, lim_act, con_act, bars, free)
    assert engine.k1_bytes_per_env(kernel) == 4 * (17 + 16 + 10 + 2 + 16 * 8 + 2 * 4
                                                   + 17 + 16 + 2 * 5)
    # bars and grabs round-trip through the packed layouts
    scene, active, target = kernel.unpack(args[3], args[4], bars, grabs)
    assert scene.bar_a.shape == (B, 16, 3) and active.shape == (B, 2)
    torch.testing.assert_close(engine.pack_bars(scene), bars, atol=0, rtol=0)
    torch.testing.assert_close(engine.pack_grabs(active, target), grabs, atol=0, rtol=0)


@pytest.mark.parametrize("case", KERNEL_CASES + K1E_CASES + ["k1d", "k1f"] + NEW_CASES
                         + list(SPLIT_CASES))
def test_pack_tables_size_matches_source_layout(host_library, case):
    kernel, _ = _kernel_case(case, 2, 0)
    table_size, ws_per_env = engine.layout(host_library, kernel.name)
    assert table_size == kernel.table_host.size
    m, spec = kernel.model, kernel.constraints
    rows = spec.ne + len(engine.limited_joints(m)) + 3 * m.ns
    nv = m.nv
    # the warp-per-env K1a keeps its workspace in shared memory
    assert ws_per_env == (0 if kernel.instance.source == engine.SOURCE_W
                          else nv * (nv + 1) // 2 + nv + rows * nv + rows + nv)
    # the rods close the table: link a, link b, anchor a, anchor b each
    if spec.num_p2p:
        tail = kernel.table_host[-8 * spec.num_p2p:].reshape(-1, 8)
        np.testing.assert_array_equal(tail[:, 0], spec.p2p_link_a)
        np.testing.assert_array_equal(tail[:, 1], spec.p2p_link_b)
        np.testing.assert_allclose(tail[:, 5:], spec.p2p_anchor_b, rtol=1e-6)
    # the grabs, then the no_bar flags, close the monkey's
    if kernel.num_bars:
        tail = kernel.table_host[-(4 * spec.num_grabs + m.ns):]
        np.testing.assert_array_equal(tail[0:8:4], spec.grab_links)
        np.testing.assert_array_equal(tail[-m.ns:], m.sph_no_bar.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES + K1E_CASES + list(K1D_CASES) + list(K1F_CASES)
                         + NEW_CASES + list(SPLIT_CASES))
def test_k1a_kernel_matches_plain_on_cuda(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    kernel, arrays = _kernel_case(case, 1024, 7, device="cuda")
    args = [torch.as_tensor(x, device="cuda") for x in arrays]
    got = _launch_counted(kernel, case, args)
    want = kernel.plain(*args)
    # K1g: the tail gate holds the envs with no contact on a vertical face
    # (chip_smoke.py::vertical_contacts says why)
    tail_envs = (~chip_smoke.vertical_contacts(kernel, args)).cpu().numpy() \
        if case == "k1g" else None
    twin = SPLIT_CASES.get(case, case)
    _gate_medians([g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want],
                  TOL_GRAB if twin in K1D_CASES else TOL_EQ if twin in K1E_CASES
                  else TOL_HF if twin in K1F_CASES else TOL,
                  tail="p99" if "cassie" in twin or twin == "k1g" else "max",
                  tail_envs=tail_envs)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.launch(args[0].t().contiguous().t(), *args[1:])
    with pytest.raises(ValueError, match="CUDA"):
        kernel.launch(args[0], args[1].cpu(), *args[2:])


@pytest.mark.cuda
def test_k1w_matches_plain_and_thread_per_env_on_cuda():
    """On a card: the warp-per-env K1a against the plain version at K1a's
    gates and against the thread-per-env instance at ``TOL_TWIN``, near
    contact and with every base lifted clear of the plane (every contact
    row skipped); each launch counted under its own symbol; at least one
    block of envs resident per SM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    model = walker3d.make_model("cuda")
    new = engine.K1a(model, EngineConfig())
    old = engine.K1a(model, EngineConfig(), thread_per_env=True)
    args = [torch.as_tensor(x, device="cuda")
            for x in chip_smoke.near_contact_states(model, np.random.default_rng(7), 1024)]
    lifted = [args[0].clone(), *args[1:]]
    lifted[0][:, 2] += 3.0
    for inputs in (args, lifted):
        engine.INSTANCE_LAUNCHES.clear()
        got, ref = new.launch(*inputs), old.launch(*inputs)
        torch.cuda.synchronize()
        assert dict(engine.INSTANCE_LAUNCHES) == {new.name: 1, old.name: 1}
        host = lambda outs: [o.cpu().numpy() for o in outs]  # noqa: E731
        _gate_medians(host(got), host(new.plain(*inputs)))
        _gate_medians(host(got), host(ref), chip_smoke.TOL_TWIN)
    assert engine.occupancy(engine.build()[new.name], new.name)["blocks_per_sm"] >= 1


# the split keys of the PD walker at one and two llc frames, Walker2D,
# Crab2D, terrain and the stairs → (the twin's case, the count it launches
# under, its gate); K1h-b at one llc frame, K1h-f and K1h-g run their
# warp-per-env instances (SPLIT_WARP), the others the generic one
SPLIT_REST = {"k1h_b": ("k1b", "k1h_b", TOL), "k1h_b_llc2": ("k1b_llc2", "k1h_b", TOL),
              "k1h_e_planar": ("k1e_planar", "k1h_e", TOL_EQ),
              "k1h_e_crab": ("k1e_crab", "k1h_e", TOL_EQ), "k1h_f": ("k1f", "k1h_f", TOL_HF),
              "k1h_g": ("k1g", "k1h_g", TOL)}


def _split_kernel(case, B, seed, device="cpu"):
    """(the split instance of ``case``'s twin, its twin, numpy inputs)."""
    twin, arrays = _kernel_case(SPLIT_REST[case][0], B, seed, device)
    kernel = engine.make_kernel(
        twin.model, dataclasses.replace(twin.config, split_impulse=True),
        num_stones=twin.num_stones, num_bars=twin.num_bars, hf_patch=twin.hf_patch,
        num_tris=twin.num_tris, pd_mode=twin.pd_mode, extra_damping=twin.extra_damping,
        constraints=twin.constraints)
    return kernel, twin, arrays


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SPLIT_REST) + list(chip_smoke.OPTION_CONFIGS))
def test_new_instances_match_plain_on_cuda(case):
    """On a card: each split instance on its twin's states (K1h-b at one
    llc frame, K1h-f and K1h-g by their warp-per-env instances) and each of
    the walker's option instances on K1a's, launched once, against the
    plain version at its gate."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    if case in SPLIT_REST:
        kernel, _, arrays = _split_kernel(case, 1024, 7, "cuda")
        tol = SPLIT_REST[case][2]
    else:
        model = walker3d.make_model("cuda")
        kernel = engine.make_kernel(model, EngineConfig(**chip_smoke.OPTION_CONFIGS[case]))
        arrays = chip_smoke.near_contact_states(model, np.random.default_rng(7), 1024)
        tol = TOL
    args = [torch.as_tensor(x, device="cuda") for x in arrays]
    got = _launch_counted(kernel, case, args)
    want = kernel.plain(*args)
    tail = (~chip_smoke.vertical_contacts(kernel, args)).cpu().numpy() if case == "k1h_g" \
        else None
    _gate_medians([g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want], tol,
                  tail="p99" if case == "k1h_g" else "max", tail_envs=tail)


@pytest.mark.parametrize("case", list(K1F_CASES))
def test_k1f_source_arithmetic_on_host(host_library, case):
    """The heightfield instance (one torque frame of the walker over the
    window around its root, no plane) against its plain version, at the
    JAX package's heightfield gates: per-env medians within q 2e-4, qd
    1e-2, depth 5e-4, impulse 1e-2, the largest env within ten times."""
    kernel, arrays = _kernel_case(case, 64, 5)
    inputs = [np.ascontiguousarray(x) for x in arrays]
    outs = run_on_host(host_library, kernel, inputs)
    want = [t.numpy() for t in kernel.plain(*map(torch.as_tensor, inputs))]
    assert all(np.isfinite(o).all() for o in outs)
    _gate_medians(outs, want, TOL_HF)
    assert (want[3] > 0).mean() > 0.05 and (inputs[3] == NO_GROUND_Z).all()
    # windows lie inside the 20 m grid, pinned to its edge by a root near it
    lo = inputs[5][:, HF_PATCH ** 2:HF_PATCH ** 2 + 2]
    hi = lo + (HF_PATCH - 1) * inputs[5][:, -1:]
    assert lo.min() >= -10.0 - 1e-5 and hi.max() <= 10.0 + 1e-5
    pinned = (np.isclose(lo, -10.0) | np.isclose(hi, 10.0)).any(axis=1)
    assert pinned.all() if case == "k1f_border" else 0.05 < pinned.mean() < 0.5


def test_k1f_is_picked_by_a_heightfield_and_counts_its_work():
    """make_kernel picks K1f for a window alone, and a K1x for a window beside
    stones, PD mode or the planar lock;
    the narrowphase is charged per sphere and substep; the window's 259
    floats are an input; the window round-trips through the packed layout;
    a malformed window is refused before anything launches."""
    model, config = walker3d.make_model(), EngineConfig()
    kernel = engine.make_kernel(model, config, hf_patch=HF_PATCH)
    assert isinstance(kernel, engine.K1f) and kernel.inputs == ("hf",)
    # the warp-per-env instance; the thread-per-env one only when asked for
    assert kernel.name == "k1w_nl22_ns14_nlim21_sub4_it4_hf16"
    assert engine.K1f(model, config, HF_PATCH, thread_per_env=True).name \
        == "k1f_nl22_ns14_nlim21_sub4_it4_hf16"
    # another window side is a key of the generic instance
    _assert_generic(engine.make_kernel(model, config, hf_patch=8), f"{W}_sub4_it4_hf8", "k1f")
    # beside stones, in PD mode and under the planar lock: a K1x on the
    # generic instance of its key
    for build, symbol, variant in (
            (lambda: engine.make_kernel(model, config, hf_patch=HF_PATCH, num_stones=6),
             f"{W}_sub4_it4_k6_hf16", "k1_k6_hf16"),
            (lambda: engine.make_kernel(model, config, hf_patch=HF_PATCH, pd_mode=True),
             f"{W}_sub4_it4_llc1_hf16", "k1_llc1_hf16"),
            (lambda: engine.make_kernel(walker2d.make_walker2d(), config, hf_patch=HF_PATCH,
                                        constraints=walker2d.planar_spec()),
             "k1_nl7_ns5_nlim6_sub4_it4_planar_hf16", "k1_planar_hf16")):
        mixed = build()
        assert isinstance(mixed, engine.K1x) and "hf" in mixed.inputs
        _assert_generic(mixed, symbol, variant)
    B = 8
    k1a, _ = _kernel_case("k1a", B, 2)
    _, arrays = _kernel_case("k1f", B, 2)
    args = [torch.as_tensor(x) for x in arrays]
    lim_act, con_act, _ = engine.k1_activity(kernel, *args)
    hf = args[5]
    assert engine.k1_flops(kernel, lim_act, con_act, hf) \
        - engine.k1_flops(k1a, lim_act, con_act) \
        == pytest.approx(4 * 14 * 50 * B + float(con_act.sum()) * (15 + 15 * 27))
    assert engine.k1_bytes_per_env(kernel) == engine.k1_bytes_per_env(k1a) + 4 * (16 * 16 + 3)
    scene, _, _ = kernel.unpack(args[3], args[4], hf)
    assert scene.hf_height.shape == (B, HF_PATCH, HF_PATCH) and scene.hf_xy0.shape == (B, 2)
    torch.testing.assert_close(engine.pack_hf(scene), hf, atol=0, rtol=0)
    for bad, want in (((hf[:, :-1],), (ValueError, "hf has shape")),
                      ((hf.double(),), (TypeError, "float32")), ((), (ValueError, "scene inputs"))):
        engine.LAUNCHES.clear()
        with pytest.raises(want[0], match=want[1]):
            kernel.launch(*args[:5], *bad)
        assert sum(engine.LAUNCHES.values()) == 0


@pytest.fixture(scope="module")
def k2_host_library(tmp_path_factory):
    """The raycast kernel's source (csrc/raycast_k2.cu) built by the host C++
    compiler: its per-ray code as a loop over rays."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source's host check")
    lib_path = tmp_path_factory.mktemp("k2_host") / "k2_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-x", "c++", "-DK2_HOST_CHECK", "-shared",
                    "-fPIC", "-o", str(lib_path), str(engine.RAYCAST_SOURCE)], check=True,
                   timeout=120)
    return ctypes.CDLL(str(lib_path))


@pytest.mark.parametrize("n, max_t, steps, rays", [(129, 10.0, 64, 4096), (65, 2.2, 16, 1000),
                                                   (17, 4.0, 37, 333)])
def test_k2_source_arithmetic_on_host(k2_host_library, n, max_t, steps, rays):
    """K2's per-ray march, built for the host, against the plain version at
    chip_smoke.py's gate: t equal on at least 99.9% of the rays and one
    march step apart on the others, h within 1e-5 where t agrees."""
    o, d, hf, xy0, cell = chip_smoke.raycast_inputs(np.random.default_rng(n), rays, n)
    t = np.zeros(rays, np.float32)
    h = np.zeros(rays, np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    fn = k2_host_library.k2_raycast_host
    fn.restype = ctypes.c_int
    cell_arr = np.ascontiguousarray(cell.reshape(1))
    err = fn(ptr(o), ptr(d), ptr(hf), ctypes.c_int(n), ctypes.c_int(n), ptr(xy0), ptr(cell_arr),
             ctypes.c_float(max_t), ctypes.c_float(max_t / steps), ctypes.c_int(steps), ptr(t),
             ptr(h), ctypes.c_int(rays))
    assert err == 0
    from mocca_envs_tpu_torch.ops.raycast import raycast_reference

    want_t, want_h = (x.numpy() for x in raycast_reference(
        *map(torch.as_tensor, (o, d, hf, xy0, cell)), max_t, steps))
    chip_smoke.check_rays(t, h, want_t, want_h, max_t / steps)
    assert 0.3 < (want_t < max_t).mean() < 1.0


@pytest.mark.cuda
def test_k2_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K2 kernel has no CPU mode")
    from mocca_envs_tpu_torch.ops.raycast import make_raycaster, raycast_reference

    args = [torch.as_tensor(x, device="cuda")
            for x in chip_smoke.raycast_inputs(np.random.default_rng(3), 5000)]
    raycast = make_raycaster((129, 129))
    before = engine.LAUNCHES["k2"]
    t, h = raycast(*args)
    torch.cuda.synchronize()
    assert engine.LAUNCHES["k2"] == before + 1
    want_t, want_h = raycast_reference(*args)
    chip_smoke.check_rays(*(x.cpu().numpy() for x in (t, h, want_t, want_h)), 10.0 / 64)
    with pytest.raises(ValueError, match="shape"):
        raycast(args[0], args[1], args[2][:-1], *args[3:])
    with pytest.raises(ValueError, match="CUDA"):
        raycast(args[0], args[1].cpu(), *args[2:])


def test_k1g_source_arithmetic_on_host(host_library):
    """The mesh instance (one torque frame of the walker on the stairs' 16
    culled faces over the plane, feet at treads, nosings and risers)
    against its plain version: per-env medians within K1a's gates, the
    largest env within ten times those over the envs with no contact on a
    vertical face (chip_smoke.py::vertical_contacts says why), and the JAX
    package's mesh gate, 97% of the q entries within 1e-3."""
    kernel, arrays = _kernel_case("k1g", 96, 5)
    inputs = [np.ascontiguousarray(x) for x in arrays]
    outs = run_on_host(host_library, kernel, inputs)
    args = list(map(torch.as_tensor, inputs))
    want = [t.numpy() for t in kernel.plain(*args)]
    assert all(np.isfinite(o).all() for o in outs)
    vertical = chip_smoke.vertical_contacts(kernel, args).numpy()
    _gate_medians(outs, want, TOL, tail_envs=~vertical)
    assert (np.abs(outs[0] - want[0]) < 1e-3).mean() >= 0.97
    assert 0.1 < vertical.mean() < 0.9 and (want[3] > 0).mean() > 0.05
    # some feet rest on treads above the plane: the mesh carries them
    assert (want[3] > 0).any() and (inputs[0][:, 2] > 1.2).any()


def test_k1h_si_source_arithmetic_on_host(host_library):
    """The split-impulse instance (one torque frame of the walker near
    contact on the plane) against its plain version at K1a's gates; the
    position pass moves the result away from the unsplit frame's."""
    kernel, arrays = _kernel_case("k1h_si", 32, 5)
    inputs = [np.ascontiguousarray(x) for x in arrays]
    outs = run_on_host(host_library, kernel, inputs)
    want = [t.numpy() for t in kernel.plain(*map(torch.as_tensor, inputs))]
    _gate_medians(outs, want)
    assert (want[3] > 0).mean() > 0.1
    k1a = engine.K1a(kernel.model, EngineConfig())
    unsplit = run_on_host(host_library, k1a, inputs)
    assert np.abs(unsplit[1] - outs[1]).max() > 0.05


def test_k1g_and_k1h_si_are_picked_and_refuse_the_rest():
    """make_kernel picks K1g for mesh faces and K1h-si for split impulse on
    the walker's plane; a mesh beside stones, PD mode or a heightfield is a
    K1x on the generic instance of its key; another face window, split
    impulse on another face window and on Cassie's plane are keys of the
    generic instance, each counted under
    its split name; split impulse on the 16-face mesh, in PD mode and on the
    planar walkers are K1h-g's, K1h-b's and the planar K1h-e's warp-per-env
    instances (their generic ones only with ``thread_per_env=True``), and
    K1h-si's (its named one only with ``thread_per_env=True``); K1a
    with split impulse and K1hSi
    without it raise (split impulse over stones is K1h-c:
    test_split_instances_are_picked_and_the_rest_refused)."""
    model, config = walker3d.make_model(), EngineConfig()
    split = EngineConfig(split_impulse=True)
    k1g = engine.make_kernel(model, config, num_tris=16)
    assert isinstance(k1g, engine.K1g) and k1g.inputs == ("tris",)
    # the warp-per-env instance; the thread-per-env one only when asked for
    assert k1g.name == "k1w_nl22_ns14_nlim21_sub4_it4_kt16"
    assert engine.K1g(model, config, thread_per_env=True).name \
        == "k1g_nl22_ns14_nlim21_sub4_it4_kt16"
    si = engine.make_kernel(model, split)
    assert isinstance(si, engine.K1hSi) and si.inputs == () and si.variant == "k1h_si"
    assert si.name == "k1w_nl22_ns14_nlim21_sub4_it4_si"
    assert engine.K1hSi(model, split, thread_per_env=True).name \
        == "k1h_nl22_ns14_nlim21_sub4_it4_si"
    for build in (lambda: engine.make_kernel(model, split, num_tris=16),
                  lambda: engine.K1g(model, split)):
        k1h_g = build()
        assert isinstance(k1h_g, engine.K1g) and k1h_g.variant == "k1h_g"
        assert k1h_g.name == "k1w_nl22_ns14_nlim21_sub4_it4_kt16_si"
        assert k1h_g.instance.source == engine.SOURCE_W
    _assert_generic(engine.K1g(model, split, thread_per_env=True), f"{W}_sub4_it4_kt16_si",
                    "k1h_g")
    for build, symbol, variant in (
            (lambda: engine.make_kernel(model, config, num_tris=16, num_stones=6),
             f"{W}_sub4_it4_k6_kt16", "k1_k6_kt16"),
            (lambda: engine.make_kernel(model, config, num_tris=16, pd_mode=True),
             f"{W}_sub4_it4_llc1_kt16", "k1_llc1_kt16"),
            (lambda: engine.make_kernel(model, config, num_tris=16, hf_patch=HF_PATCH),
             f"{W}_sub4_it4_hf16_kt16", "k1_hf16_kt16")):
        mixed = build()
        assert isinstance(mixed, engine.K1x) and mixed.inputs[-1] == "tris"
        _assert_generic(mixed, symbol, variant)
    for build, symbol, variant in (
            (lambda: engine.make_kernel(model, config, num_tris=8), f"{W}_sub4_it4_kt8", "k1g"),
            (lambda: engine.make_kernel(model, split, num_tris=8), f"{W}_sub4_it4_kt8_si",
             "k1h_g"),
            (lambda: engine.K1b(model, split, thread_per_env=True), f"{W}_sub4_it4_llc1_si",
             "k1h_b"),
            (lambda: engine.K1e(walker2d.make_walker2d(), split, walker2d.planar_spec(),
                                thread_per_env=True),
             "k1_nl7_ns5_nlim6_sub4_it4_planar_si", "k1h_e"),
            (lambda: engine.K1hSi(cassie.make_model(), split), "k1_nl17_ns5_nlim16_sub4_it4_si",
             "k1h_si"),
            # the other solver options, split or not
            (lambda: engine.K1hSi(model, EngineConfig(split_impulse=True, warm_start=False)),
             f"{W}_sub4_it4_si_cold", "k1h_si_cold")):
        _assert_generic(build(), symbol, variant)
    for build in (lambda: engine.K1a(model, split), lambda: engine.K1hSi(model, config)):
        with pytest.raises(NotImplementedError, match="split_impulse"):
            build()


def test_k1g_and_k1h_si_count_their_own_work():
    """K1g counts each sphere's walk over each active face, as far as the
    region that holds its center, plus the winner's normal; its 160 face
    floats are an input and round-trip through the packed layout, and a
    malformed window is refused. K1h-si counts the position pass over the
    active limit rows and contact normals."""
    B = 8
    k1a, a_in = _kernel_case("k1a", B, 2)
    kernel, arrays = _kernel_case("k1g", B, 2)
    args = [torch.as_tensor(x) for x in arrays]
    lim_act, con_act, walk = engine.k1_activity(kernel, *args)
    assert walk.shape == (4, B)
    per_pair = walk.sum() / (4 * B * 14 * 16)
    assert engine.TRI_WALK_OPS[0] + engine.TRI_TAIL_OPS <= per_pair \
        <= engine.TRI_WALK_OPS[-1] + engine.TRI_TAIL_OPS
    tris = args[5]
    with_mesh = engine.k1_flops(kernel, lim_act, con_act, tris, tri_walk=walk)
    assert with_mesh - engine.k1_flops(k1a, lim_act, con_act) == pytest.approx(
        float(walk.double().sum()) + 4 * B * 14 * 6 + float(con_act.sum()) * (15 + 15 * 27))
    with pytest.raises(ValueError, match="tri_walk"):
        engine.k1_flops(kernel, lim_act, con_act, tris)
    # an inactive face is not walked
    fewer = tris.clone()
    fewer[9] = 0.0                                   # face 0's active flag
    assert float(engine.k1_activity(kernel, *args[:5], fewer)[2].sum()) \
        < float(walk.sum())
    assert engine.k1_bytes_per_env(kernel) == engine.k1_bytes_per_env(k1a) + 4 * 16 * 10
    scene, _, _ = kernel.unpack(args[3], args[4], tris)
    assert scene.tri_a.shape == (B, 16, 3) and scene.tri_active.shape == (B, 16)
    torch.testing.assert_close(engine.pack_tris(scene), tris, atol=0, rtol=0)
    for bad, want in (((tris[:-10],), (ValueError, "tris has shape")),
                      ((tris.double(),), (TypeError, "float32")), ((), (ValueError, "scene inputs"))):
        engine.LAUNCHES.clear()
        with pytest.raises(want[0], match=want[1]):
            kernel.launch(*args[:5], *bad)
        assert sum(engine.LAUNCHES.values()) == 0

    si, _ = _kernel_case("k1h_si", B, 2)
    a_args = [torch.as_tensor(x) for x in a_in]
    lim_act, con_act, _ = engine.k1_activity(si, *a_args)
    extra = engine.k1_flops(si, lim_act, con_act) - engine.k1_flops(k1a, lim_act, con_act)
    span = torch.tensor([27.0 - (6 + j) for j in engine.limited_joints(si.model)],
                        dtype=torch.float64)
    any_pos = (lim_act.any(dim=2) | con_act.any(dim=2)).double().sum()
    assert extra == pytest.approx(float((lim_act.double() * 4 * (4 * span + 7)).sum())
                                  + float(con_act.sum()) * 4 * (4 * 27 + 7)
                                  + float(any_pos) * (27 * 27 + 27))
    assert engine.k1_bytes_per_env(si) == engine.k1_bytes_per_env(k1a)


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_instances_source_arithmetic_on_host(host_library, case):
    """The split-impulse twins of the training path (K1h-c over the
    stepper's stones, K1h-e / K1h-e2d on Cassie's whole PD control step with
    the rods and the planar lock, by their warp-per-env instances, K1h-d on
    the monkey's bars with its grab rows) against their plain versions, at their twins' gates (K1c: K1a's;
    Cassie: the equality-row gates, the 99th percentile for the tail; the
    monkey: the bar and grab gates); and the position pass moves the result
    away from the unsplit twin's on the same inputs."""
    kernel, arrays = _kernel_case(case, 32 if case == "k1h_c" else 64, 5)
    twin, _ = _kernel_case(SPLIT_CASES[case], 2, 0)
    assert kernel.split and type(kernel) is type(twin)
    assert kernel.variant == ("k1h_e" if case.startswith("k1h_e") else case)
    inputs = [np.ascontiguousarray(x) for x in arrays]
    outs = run_on_host(host_library, kernel, inputs)
    want = [t.numpy() for t in kernel.plain(*map(torch.as_tensor, inputs))]
    assert all(np.isfinite(o).all() for o in outs)
    _gate_medians(outs, want, {"k1h_c": TOL, "k1h_d": TOL_GRAB}.get(case, TOL_EQ),
                  tail="p99" if case.startswith("k1h_e") else "max")
    assert (want[3] > 0).mean() > 0.02   # contacts carry load
    unsplit = run_on_host(host_library, twin, inputs)
    assert np.abs(unsplit[1] - outs[1]).max() > 0.05
    if case == "k1h_d":
        # the grab rows stay out of the position pass and still hold the
        # attached palms on their anchors
        attached = engine.unpack_grabs(torch.as_tensor(inputs[6]))[0].numpy() > 0.5
        palms = tasks_monkey.make_palm_positions(kernel.model, kernel.constraints)(
            torch.as_tensor(outs[0]))
        target = engine.unpack_grabs(torch.as_tensor(inputs[6]))[1]
        gap = torch.linalg.vector_norm(palms - target, dim=2).numpy()
        assert np.median(gap[attached]) < 0.01


def test_split_instances_are_picked_and_the_rest_refused():
    """Split impulse takes the variant it would take without it, counted
    under its split name: K1c over stones (k1h_c), Cassie's and Cassie2D's
    K1e (k1h_e) on their warp-per-env instances, the stepper's named twin
    only with ``thread_per_env=True``; the monkey's K1d (k1h_d) on its
    warp-per-env instance; a heightfield (K1f: k1h_f), a
    mesh (K1g: k1h_g) and the PD walker and child (K1b: k1h_b) on their
    warp-per-env instances, their generic ones only with
    ``thread_per_env=True``; the torque planar walkers (K1e: k1h_e) on
    their warp-per-env instance, the generic one only with
    ``thread_per_env=True``."""
    names = {"k1h_c": "k1w_nl22_ns14_nlim21_sub4_it4_k6_si",
             "k1h_e": "k1w_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_si",
             "k1h_e2d": "k1w_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_planar_si",
             "k1h_d": "k1w_nl11_ns5_nlim8_sub4_it4_kb16_ng2_si"}
    for case, twin_case in SPLIT_CASES.items():
        kernel, _ = _kernel_case(case, 2, 0)
        twin, _ = _kernel_case(twin_case, 2, 0)
        assert type(kernel) is type(twin) and kernel.split and not twin.split
        assert kernel.name == names[case] and kernel.variant == ("k1h_e" if "k1h_e" in case
                                                                 else case)
        assert kernel.inputs == twin.inputs and kernel.table_host.size == twin.table_host.size
    model = walker3d.make_model()
    split = EngineConfig(split_impulse=True)
    kp = model.power_coef * (model.actuated > 0).float()
    for build, symbol, variant in (
            (lambda: engine.K1b(model.replace(kp=kp), split, extra_damping=kp / 20.0,
                                thread_per_env=True), f"{W}_sub4_it4_llc1_si", "k1h_b"),
            (lambda: engine.K1f(model, split, HF_PATCH, thread_per_env=True),
             f"{W}_sub4_it4_hf16_si", "k1h_f"),
            (lambda: engine.K1g(model, split, thread_per_env=True), f"{W}_sub4_it4_kt16_si",
             "k1h_g"),
            (lambda: engine.K1e(walker2d.make_walker2d(), split, walker2d.planar_spec(),
                                thread_per_env=True),
             "k1_nl7_ns5_nlim6_sub4_it4_planar_si", "k1h_e"),
            (lambda: engine.K1e(walker2d.make_crab2d(), split, walker2d.planar_spec(),
                                thread_per_env=True),
             "k1_nl7_ns5_nlim6_sub4_it4_planar_si", "k1h_e")):
        _assert_generic(build(), symbol, variant)
    for picked, symbol, index in (
            (engine.make_kernel(model, split, hf_patch=HF_PATCH), "hf16_si", 10),
            (engine.make_kernel(model, split, num_tris=16), "kt16_si", 9),
            (engine.make_kernel(model, split, num_stones=6), "k6_si", 11),
            (engine.make_kernel(model.replace(kp=kp), split, pd_mode=True,
                                extra_damping=kp / 20.0), "llc1_si", 12)):
        assert picked.name == f"k1w_nl22_ns14_nlim21_sub4_it4_{symbol}"
        assert engine.compile_flags(picked.instance) == [f"-DK1W_ONLY={index}"]
    # the walker's scalar friction key and its factor-every-substep key (no
    # split impulse) on their warp-per-env instances too
    for picked, symbol, index in (
            (engine.make_kernel(model, EngineConfig(block_pgs=False)), "scalar", 21),
            (engine.make_kernel(model, EngineConfig(reuse_factor=False)), "refactor", 22)):
        assert type(picked) is engine.K1a and picked.variant == f"k1a_{symbol}"
        assert picked.name == f"k1w_nl22_ns14_nlim21_sub4_it4_{symbol}"
        assert engine.compile_flags(picked.instance) == [f"-DK1W_ONLY={index}"]
    # the torque planar walkers' split key on its warp-per-env instance
    for planar in (walker2d.make_walker2d(), walker2d.make_crab2d()):
        picked = engine.make_kernel(planar, split, constraints=walker2d.planar_spec())
        assert type(picked) is engine.K1e and picked.variant == "k1h_e"
        assert picked.name == "k1w_nl7_ns5_nlim6_sub4_it4_planar_si"
        assert engine.compile_flags(picked.instance) == ["-DK1W_ONLY=17"]
    # the stepper's thread-per-env twin is the named engine_k1.cu instance
    twin = engine.K1c(model, split, thread_per_env=True)
    assert twin.name == "k1h_nl22_ns14_nlim21_sub4_it4_k6_si" and twin.instance.index == 11
    # a split instance is not taken for the unsplit config, nor the reverse
    with pytest.raises(NotImplementedError, match="split_impulse"):
        engine.K1hSi(model, EngineConfig())
    stepper = engine.make_kernel(model, EngineConfig(), num_stones=6)
    assert not stepper.split and stepper.name == "k1w_nl22_ns14_nlim21_sub4_it4_k6"
    assert engine.K1c(model, EngineConfig(), thread_per_env=True).name \
        == "k1c_nl22_ns14_nlim21_sub4_it4_k6"


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_instances_count_the_position_pass(case):
    """k1_flops of a split instance is its twin's plus the position pass:
    per substep and sweep, each active limit row over its span and each
    active contact normal (dense), and where any of them is active the back
    substitution of z_pos and its addition; equality and grab rows add
    nothing to it. Both take the same activity (k1_activity of the split
    unit) and bytes."""
    kernel, arrays = _kernel_case(case, 8, 2)
    twin, _ = _kernel_case(SPLIT_CASES[case], 2, 0)
    args = [torch.as_tensor(x) for x in arrays]
    lim_act, con_act, _ = engine.k1_activity(kernel, *args)
    S = kernel.config.sim_substeps * (kernel.config.llc_frames if kernel.pd_mode else 1)
    assert lim_act.shape[0] == S and con_act.shape[:2] == (S, 8)
    extra = (engine.k1_flops(kernel, lim_act, con_act, *args[5:])
             - engine.k1_flops(twin, lim_act, con_act, *args[5:]))
    m, iters = kernel.model, kernel.config.solver_iters
    span = torch.tensor([m.nv - (6 + j) for j in engine.limited_joints(m)], dtype=torch.float64)
    any_pos = (lim_act.any(dim=2) | con_act.any(dim=2)).double().sum()
    assert extra == pytest.approx(float((lim_act.double() * iters * (4 * span + 7)).sum())
                                  + float(con_act.sum()) * iters * (4 * m.nv + 7)
                                  + float(any_pos) * (m.nv * m.nv + m.nv))
    assert extra > 0 and engine.k1_bytes_per_env(kernel) == engine.k1_bytes_per_env(twin)
