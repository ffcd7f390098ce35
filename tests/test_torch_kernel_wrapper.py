"""The port's kernel wrapper and entry points: no JAX, no silent CPU path.

- the package imports and steps on the CPU with JAX made unimportable, and
  no module of it (or chip_smoke.py) imports JAX or the JAX package;
- ``make()`` / ``BatchedEnv`` with no device mean the CUDA card and raise
  where there is none;
- the CPU path never launches the kernel; the kernel's launch refuses CPU
  tensors and configurations it has no instantiation for;
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
    lock), k1e_planar / k1e_crab (one torque frame of Walker2D / Crab2D,
    which share an instantiation), k1d* (one torque frame of the monkey
    hanging from its bars, the hands attached as :data:`K1D_CASES` says),
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
        model = monkey.make_model(device)
        return (engine.K1d(model, EngineConfig(), monkey.constraints(), 16),
                chip_smoke.monkey_states(model, rng, B, **K1D_CASES[case]))
    if case in ("k1e_cassie", "k1e_cassie2d"):
        model = cassie.make_model(device)
        spec = dataclasses.replace(cassie.constraints(), planar=case == "k1e_cassie2d")
        kernel = engine.K1e(model, CASSIE_CONFIG, spec, pd_mode=True,
                            extra_damping=model.actuated * model.kd)
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
K1E_CASES = ["k1e_cassie", "k1e_cassie2d", "k1e_planar", "k1e_crab"]
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
    files = sorted((REPO / "mocca_envs_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
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


@pytest.mark.parametrize("change", [
    {"warm_start": False}, {"matfree_pgs": False}, {"reuse_factor": False},
    {"block_pgs": False}, {"split_impulse": True}, {"solver_iters": 8},
    {"sim_substeps": 2},
], ids=lambda c: next(iter(c)))
def test_k1a_refuses_what_it_has_no_instantiation_for(change):
    with pytest.raises(NotImplementedError):
        engine.K1a(walker3d.make_model(), EngineConfig(**change))


@pytest.mark.parametrize("build", [
    lambda m: engine.K1c(m, EngineConfig(stone_window=8)),
    lambda m: engine.K1c(m, EngineConfig(), num_stones=20),
    lambda m: engine.K1b(m, EngineConfig(llc_frames=3)),
    lambda m: engine.make_kernel(m, EngineConfig(), num_stones=6, pd_mode=True),
    lambda m: engine.make_kernel(m, EngineConfig(), extra_damping=m.kp),
], ids=["window8", "unculled20", "llc3", "pd_over_stones", "damped_torque"])
def test_k1_variants_refuse_what_they_have_no_instantiation_for(build):
    with pytest.raises(NotImplementedError):
        build(walker3d.make_model())


@pytest.mark.parametrize("build", [
    lambda: engine.K1e(cassie.make_model(), CASSIE_CONFIG, ConstraintSpec(planar=True),
                       pd_mode=True),
    lambda: engine.K1e(cassie.make_model(), CASSIE_CONFIG, cassie.constraints()),
    lambda: engine.K1e(cassie.make_model(), dataclasses.replace(CASSIE_CONFIG, llc_frames=5),
                       cassie.constraints(), pd_mode=True),
    lambda: engine.K1e(walker2d.make_walker2d(), EngineConfig(), walker2d.planar_spec(),
                       pd_mode=True),
    lambda: engine.K1e(walker2d.make_walker2d(), EngineConfig(), cassie.constraints()),
    lambda: engine.K1e(walker3d.make_model(), EngineConfig(), walker2d.planar_spec()),
    lambda: engine.make_kernel(walker2d.make_walker2d(), EngineConfig(), num_stones=6,
                               constraints=walker2d.planar_spec()),
    # grabs with the planar lock on Walker2D: the grab rows have an instance
    # on the monkey only
    lambda: engine.make_kernel(
        walker2d.make_walker2d(), EngineConfig(),
        constraints=ConstraintSpec(planar=True, num_grabs=1, grab_links=(1,),
                                   grab_anchors=((0.0, 0.0, 0.0),))),
], ids=["cassie_lock_without_rods", "cassie_torque_mode", "cassie_llc5", "walker2d_pd",
        "walker2d_rods", "walker3d_planar", "planar_over_stones", "grabs"])
def test_k1e_refuses_what_it_has_no_instantiation_for(build):
    with pytest.raises(NotImplementedError, match="no K1 instantiation"):
        build()


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
    from mocca_envs_tpu_torch.models.schema import ModelBuilder

    b = ModelBuilder("hopper", floating=True)
    b.base_inertial(5.0, (0, 0, 0), inertia_diag=(0.1, 0.1, 0.1))
    b.add_link("leg", "base", joint_pos=(0, 0, -0.1), joint_axis=(0, 1, 0), mass=1.0,
               com=(0, 0, -0.25), inertia_diag=(0.02, 0.02, 0.002), limit=(-1.5, 1.5))
    b.add_sphere("leg", (0, 0, -0.5), 0.05, foot="foot")
    with pytest.raises(NotImplementedError, match="no K1 instantiation"):
        engine.K1a(b.build(), EngineConfig())


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
def host_library(tmp_path_factory):
    """The kernel source (csrc/engine_k1.cu) built by the host C++ compiler:
    every instantiation's per-env code as a loop over envs."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source's host check")
    lib_path = tmp_path_factory.mktemp("k1_host") / "k1_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-x", "c++", "-DK1_HOST_CHECK", "-shared",
                    "-fPIC", "-o", str(lib_path), str(engine.SOURCE)], check=True, timeout=300)
    return ctypes.CDLL(str(lib_path))


def _run_on_host(lib, kernel, inputs):
    B = inputs[0].shape[0]
    table_size, ws_per_env = engine.layout(lib, kernel.name)
    assert table_size == kernel.table_host.size
    m = kernel.model
    outs = [np.zeros((B, m.nq), np.float32), np.zeros((B, m.nv), np.float32),
            np.zeros((B, m.ns), np.float32), np.zeros((B, m.ns), np.float32)]
    ws = np.zeros(ws_per_env * B, np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    fn = getattr(lib, kernel.name + "_host")
    fn.restype = ctypes.c_int
    named = dict(zip(kernel.inputs, inputs[5:]))
    scene = [ptr(named[k]) if k in named else None
             for k in ("stones", "bars", "grabs", "hf", "tris")]
    err = fn(*map(ptr, inputs[:5]), *scene, *map(ptr, outs), ptr(kernel.table_host),
             ctypes.c_int(table_size), ptr(ws), ctypes.c_int(B))
    assert err == 0
    return outs


def test_k1a_source_arithmetic_on_host(host_library):
    """The kernel's per-env code built by the host C++ compiler, run as a
    loop over envs, against the plain version."""
    k1a = engine.K1a(walker3d.make_model(), EngineConfig())
    inputs = [np.ascontiguousarray(x) for x in _near_contact(32, 5)]
    outs = _run_on_host(host_library, k1a, inputs)
    want = [t.numpy() for t in k1a.plain(*map(torch.as_tensor, inputs))]
    _gate_medians(outs, want)
    assert (want[3] > 0).mean() > 0.1   # contacts carry load


@pytest.mark.parametrize("case", KERNEL_CASES[1:])
def test_k1_variant_source_arithmetic_on_host(host_library, case):
    """K1c (stone boxes, general normals), K1b (PD torque, extra damping)
    and K1b at two llc frames (λ carried across them) against their plain
    versions, at the same gates."""
    kernel, arrays = _kernel_case(case, 32, 5)
    inputs = [np.ascontiguousarray(x) for x in arrays]
    outs = _run_on_host(host_library, kernel, inputs)
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
    frame; the same with the planar lock; one torque frame of Walker2D and of
    Crab2D with the lock) against their plain versions, at the equality-row
    tolerances."""
    kernel, arrays = _kernel_case(case, 64, 5)
    inputs = [np.ascontiguousarray(x) for x in arrays]
    outs = _run_on_host(host_library, kernel, inputs)
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
    outs = _run_on_host(host_library, kernel, inputs)
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
    assert kernel.inputs == ("bars", "grabs") and kernel.name.startswith("k1d_")
    # other bar counts, bars without the grabs, PD mode: no instance
    for build in (lambda: engine.make_kernel(model, EngineConfig(), num_bars=8, constraints=spec),
                  lambda: engine.make_kernel(model, EngineConfig(), num_bars=16),
                  lambda: engine.make_kernel(model, EngineConfig(), num_bars=16, pd_mode=True,
                                             constraints=spec),
                  lambda: engine.make_kernel(model, EngineConfig(sim_substeps=2), num_bars=16,
                                             constraints=spec)):
        with pytest.raises(NotImplementedError, match="no K1 instantiation"):
            build()


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
    assert ws_per_env == nv * (nv + 1) // 2 + nv + rows * nv + rows + nv
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
    before = engine.LAUNCHES[kernel.variant]
    got = kernel.launch(*args)
    torch.cuda.synchronize()
    assert engine.LAUNCHES[kernel.variant] == before + 1
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


@pytest.mark.parametrize("case", list(K1F_CASES))
def test_k1f_source_arithmetic_on_host(host_library, case):
    """The heightfield instance (one torque frame of the walker over the
    window around its root, no plane) against its plain version, at the
    JAX package's heightfield gates: per-env medians within q 2e-4, qd
    1e-2, depth 5e-4, impulse 1e-2, the largest env within ten times."""
    kernel, arrays = _kernel_case(case, 64, 5)
    inputs = [np.ascontiguousarray(x) for x in arrays]
    outs = _run_on_host(host_library, kernel, inputs)
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
    """make_kernel picks K1f for a window and nothing else combines with it;
    the narrowphase is charged per sphere and substep; the window's 259
    floats are an input; the window round-trips through the packed layout;
    a malformed window is refused before anything launches."""
    model, config = walker3d.make_model(), EngineConfig()
    kernel = engine.make_kernel(model, config, hf_patch=HF_PATCH)
    assert isinstance(kernel, engine.K1f) and kernel.inputs == ("hf",)
    assert kernel.name == "k1f_nl22_ns14_nlim21_sub4_it4_hf16"
    for build in (lambda: engine.make_kernel(model, config, hf_patch=8),
                  lambda: engine.make_kernel(model, config, hf_patch=HF_PATCH, num_stones=6),
                  lambda: engine.make_kernel(model, config, hf_patch=HF_PATCH, pd_mode=True),
                  lambda: engine.make_kernel(walker2d.make_walker2d(), config, hf_patch=HF_PATCH,
                                             constraints=walker2d.planar_spec())):
        with pytest.raises(NotImplementedError, match="no K1 instantiation"):
            build()
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
    outs = _run_on_host(host_library, kernel, inputs)
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
    outs = _run_on_host(host_library, kernel, inputs)
    want = [t.numpy() for t in kernel.plain(*map(torch.as_tensor, inputs))]
    _gate_medians(outs, want)
    assert (want[3] > 0).mean() > 0.1
    k1a = engine.K1a(kernel.model, EngineConfig())
    unsplit = _run_on_host(host_library, k1a, inputs)
    assert np.abs(unsplit[1] - outs[1]).max() > 0.05


def test_k1g_and_k1h_si_are_picked_and_refuse_the_rest():
    """make_kernel picks K1g for mesh faces and K1h-si for split impulse on
    the walker's plane; a mesh with anything else, split impulse on a mesh,
    in PD mode or on the planar walkers, and K1a / K1g with split impulse
    raise, naming what is missing (split impulse over stones is K1h-c:
    test_split_instances_are_picked_and_the_rest_refused)."""
    model, config = walker3d.make_model(), EngineConfig()
    split = EngineConfig(split_impulse=True)
    k1g = engine.make_kernel(model, config, num_tris=16)
    assert isinstance(k1g, engine.K1g) and k1g.inputs == ("tris",)
    assert k1g.name == "k1g_nl22_ns14_nlim21_sub4_it4_kt16"
    si = engine.make_kernel(model, split)
    assert isinstance(si, engine.K1hSi) and si.inputs == () and si.variant == "k1h_si"
    for build in (lambda: engine.make_kernel(model, config, num_tris=8),
                  lambda: engine.make_kernel(model, config, num_tris=16, num_stones=6),
                  lambda: engine.make_kernel(model, config, num_tris=16, pd_mode=True),
                  lambda: engine.make_kernel(model, config, num_tris=16, hf_patch=HF_PATCH),
                  lambda: engine.make_kernel(model, split, num_tris=16),
                  lambda: engine.make_kernel(model, split, pd_mode=True),
                  lambda: engine.make_kernel(walker2d.make_walker2d(), split,
                                             constraints=walker2d.planar_spec()),
                  lambda: engine.K1hSi(cassie.make_model(), split)):
        with pytest.raises(NotImplementedError, match="no K1 instantiation"):
            build()
    for build in (lambda: engine.K1g(model, split), lambda: engine.K1a(model, split),
                  lambda: engine.K1hSi(model, config)):
        with pytest.raises(NotImplementedError, match="split_impulse"):
            build()
    # the other solver options stay unported, split or not
    with pytest.raises(NotImplementedError, match="shipped solver options"):
        engine.K1hSi(model, EngineConfig(split_impulse=True, warm_start=False))


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
    the rods and the planar lock, K1h-d on the monkey's bars with its grab
    rows) against their plain versions, at their twins' gates (K1c: K1a's;
    Cassie: the equality-row gates, the 99th percentile for the tail; the
    monkey: the bar and grab gates); and the position pass moves the result
    away from the unsplit twin's on the same inputs."""
    kernel, arrays = _kernel_case(case, 32 if case == "k1h_c" else 64, 5)
    twin, _ = _kernel_case(SPLIT_CASES[case], 2, 0)
    assert kernel.split and type(kernel) is type(twin)
    assert kernel.variant == ("k1h_e" if case.startswith("k1h_e") else case)
    inputs = [np.ascontiguousarray(x) for x in arrays]
    outs = _run_on_host(host_library, kernel, inputs)
    want = [t.numpy() for t in kernel.plain(*map(torch.as_tensor, inputs))]
    assert all(np.isfinite(o).all() for o in outs)
    _gate_medians(outs, want, {"k1h_c": TOL, "k1h_d": TOL_GRAB}.get(case, TOL_EQ),
                  tail="p99" if case.startswith("k1h_e") else "max")
    assert (want[3] > 0).mean() > 0.02   # contacts carry load
    unsplit = _run_on_host(host_library, twin, inputs)
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
    K1e (k1h_e), the monkey's K1d (k1h_d), K1hSi on the walker's plane; every
    family without an instance raises NotImplementedError naming it: the PD
    walker and child (K1b), the torque planar walkers (K1e), a heightfield
    (K1f) and a mesh (K1g)."""
    names = {"k1h_c": "k1h_nl22_ns14_nlim21_sub4_it4_k6_si",
             "k1h_e": "k1h_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_si",
             "k1h_e2d": "k1h_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_planar_si",
             "k1h_d": "k1h_nl11_ns5_nlim8_sub4_it4_kb16_ng2_si"}
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
    for build, what in (
            (lambda: engine.make_kernel(model.replace(kp=kp), split, pd_mode=True,
                                        extra_damping=kp / 20.0), "k1b"),
            (lambda: engine.make_kernel(walker3d.make_model(), split, hf_patch=HF_PATCH), "k1f"),
            (lambda: engine.make_kernel(model, split, num_tris=16), "k1g"),
            (lambda: engine.make_kernel(walker2d.make_walker2d(), split,
                                        constraints=walker2d.planar_spec()), "split impulse"),
            (lambda: engine.make_kernel(walker2d.make_crab2d(), split,
                                        constraints=walker2d.planar_spec()), "split impulse")):
        with pytest.raises(NotImplementedError, match="no K1 instantiation") as err:
            build()
        assert what in str(err.value)
    # a split instance is not taken for the unsplit config, nor the reverse
    with pytest.raises(NotImplementedError, match="split_impulse"):
        engine.K1hSi(model, EngineConfig())
    assert not engine.make_kernel(model, EngineConfig(), num_stones=6).split


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
