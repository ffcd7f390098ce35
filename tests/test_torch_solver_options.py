"""The walker's PGS options on the CPU: the JAX package, the port's plain
path and the K1 kernel source, per ``EngineConfig`` option turned off.

``matfree_pgs=False`` (the A-form), ``block_pgs=False`` (scalar friction
rows), ``warm_start=False`` (λ from zero every substep) and
``reuse_factor=False`` (a factor every substep) are reached through
``make(id, config=EngineConfig(...))``; so are other substeps and sweeps.

- One walker control step of the port's plain path under each option off
  alone, all four off, and the A-form with split impulse, against the JAX
  package's ``make_control_step`` (its XLA path) on the same numpy states
  and actions, B = 8, at tests/test_pallas_engine.py's kernel gates: per-env
  medians within q 2e-4, qd 5e-3, depth 2e-4, normal impulse 5e-3, the
  largest env within ten times. Each case compiles its own JAX step, once
  per process.
- The thread-per-env twin (the generic ``engine_k1.cu`` instance) of each
  of those keys, and of the walker at the JAX gates' 2 substeps × 8 sweeps,
  built for the host (``-DK1_HOST_CHECK``), against the port's plain
  version at the same gates;
  each A-form against its matrix-free twin at the JAX package's gate
  between the two forms: per-env medians within q 2e-5, qd 5e-4, depth
  2e-5, impulse 5e-4, the largest env within ten times. The A-form, alone,
  with split impulse and with all four options off, runs a warp-per-env
  instance of ``csrc/engine_k1w.cu`` (``-DK1W_HOST_CHECK``), held so beside
  its generic twin, to its matrix-free twin (the A-form's and the split
  A-form's: K1a's and K1h-si's warp-per-env instances), and to the JAX
  package's control step on the same inputs at the same gates; so do scalar
  friction rows alone and a factor every substep alone, in the matrix-free
  form, each held beside its generic twin and to the JAX package's control
  step; and so does a cold start alone, on its named warp-per-env instance,
  and the walker at 2 × 8 on the generic warp-per-env instance of its key
  (``-DK1W_*`` flags), each held beside its generic twin to the plain
  version (the port's plain path at 2 × 8 is held to the JAX package's in
  tests/test_torch_physics.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mocca_envs_tpu.models import walker3d as jwalker
from mocca_envs_tpu.ops.step import make_control_step as jcontrol
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu.utils.config import EngineConfig as JConfig
from mocca_envs_tpu_torch.models import walker3d as twalker
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.ops.step import make_control_step as tcontrol
from mocca_envs_tpu_torch.terrain import scene as tscene
from mocca_envs_tpu_torch.utils.config import EngineConfig as TConfig

from tests import torch_workers  # noqa: F401
from tests.torch_k1_host import build_host, run_on_host

TOL = chip_smoke.TOL            # q 2e-4, qd 5e-3, depth 2e-4, impulse 5e-3
TOL_TWIN = chip_smoke.TOL_TWIN  # q 2e-5, qd 5e-4, depth 2e-5, impulse 5e-4
OPTIONS = {k: v for k, v in chip_smoke.OPTION_CONFIGS.items() if k != "k1a_sub2_it8"}
T = torch.as_tensor


def _gate(got, want, tol):
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        per_env = np.abs(np.asarray(g) - np.asarray(w)).reshape(len(g), -1).max(axis=1)
        assert np.median(per_env) <= tol[name], (name, float(np.median(per_env)))
        assert per_env.max() <= 10 * tol[name], (name, float(per_env.max()))


@functools.lru_cache(maxsize=None)
def _inputs():
    """B = 8 near-contact walker states with uniform random actions, and the
    walker's torque gains: ``(q, qd, action, gain)``."""
    jm = jwalker.make_model()
    B = 8
    q, qd, _, _, _ = chip_smoke.near_contact_states(twalker.make_model(),
                                                    np.random.default_rng(31), B)
    action = np.random.default_rng(32).uniform(-1, 1, (B, jm.nj)).astype(np.float32)
    gain = np.array(jm.power_coef * jm.actuated)
    return q, qd, action, gain


@functools.lru_cache(maxsize=None)
def _jax_step(label):
    """The JAX package's walker control step under the option configuration
    ``label`` on :func:`_inputs` (numpy outputs), compiled once per
    process."""
    q, qd, action, gain = _inputs()
    step = jcontrol(jwalker.make_model(), JConfig(**OPTIONS[label]),
                    actuation=lambda q_, qd_, a: gain * jnp.clip(a, -1, 1))

    def one(a, b, c):
        qq, dd, info = step(a, b, c, jscene.flat())
        return qq, dd, info.contacts.depth, info.normal_impulse

    return [np.asarray(x) for x in jax.jit(jax.vmap(one))(q, qd, action)]


@pytest.mark.parametrize("label", list(OPTIONS))
def test_walker_option_control_step_matches_jax(label):
    """The port's plain control step under one option configuration against
    the JAX package's on the same inputs."""
    q, qd, action, gain = _inputs()
    want = _jax_step(label)
    tgain = T(gain)
    step = tcontrol(twalker.make_model(), TConfig(**OPTIONS[label]),
                    actuation=lambda q_, qd_, a: tgain * torch.clamp(a, -1, 1))
    tq, tqd, info = step(T(q), T(qd), T(action), tscene.flat(len(q)))
    got = [x.numpy() for x in (tq, tqd, info.contacts.depth, info.normal_impulse)]
    _gate(got, want, TOL)
    assert (want[3] > 0).mean() > 0.05                  # contacts carry load
    kernel = engine.make_kernel(twalker.make_model(), TConfig(**OPTIONS[label]))
    if kernel.instance.source == engine.SOURCE_W:
        # its warp-per-env instance, built for the host, on the same torques
        # (one llc frame is the walker's control step)
        flat = tscene.flat(len(q))
        host = [np.ascontiguousarray(x.numpy()) for x in (
            T(q), T(qd), tgain * torch.clamp(T(action), -1, 1), flat.ground_z, flat.friction)]
        outs = run_on_host(build_host([kernel])[kernel.name], kernel, host)
        assert all(np.isfinite(o).all() for o in outs)
        _gate(outs, want, TOL)


def test_options_change_the_step():
    """Each option but the A-form is a different iteration: the port's step
    under it parts from the port's shipped step on the same inputs by more
    than the gate it is held to (per-env medians of q and qd), so that gate
    tells the two apart; the A-form parts only by the order of its sums."""
    q, qd, action, gain = _inputs()
    tgain = T(gain)

    def port_step(fields):
        step = tcontrol(twalker.make_model(), TConfig(**fields),
                        actuation=lambda q_, qd_, a: tgain * torch.clamp(a, -1, 1))
        return [x.numpy() for x in step(T(q), T(qd), T(action), tscene.flat(len(q)))[:2]]

    shipped = port_step({})
    for label in ("k1a_scalar", "k1a_cold", "k1a_refactor", "k1a_aform_scalar_cold_refactor"):
        for name, got, want in zip(("q", "qd"), port_step(OPTIONS[label]), shipped):
            assert np.median(np.abs(got - want).max(axis=1)) > TOL[name], (label, name)
    _gate(port_step(OPTIONS["k1a_aform"]), shipped, TOL_TWIN)


@pytest.fixture(scope="module")
def host_cases():
    """(kernel wrapper, numpy inputs, host library) per option configuration
    and the walker at 2 substeps × 8 sweeps, on chip_smoke.py's near-contact
    states at B = 64, with the shipped K1a and K1h-si (the matrix-free twins
    of the A-forms) and the thread-per-env twin of each key that runs one
    warp per env."""
    model = twalker.make_model()
    inputs = [np.ascontiguousarray(x) for x in chip_smoke.near_contact_states(
        model, np.random.default_rng(5), 64)]
    kernels = {v: engine.make_kernel(model, TConfig(**f))
               for v, f in chip_smoke.OPTION_CONFIGS.items()}
    kernels["k1a"] = engine.K1a(model, TConfig())
    kernels["k1h_si"] = engine.K1hSi(model, TConfig(split_impulse=True))
    # the thread-per-env twins of the keys that run one warp per env (the
    # options' and 2 × 8's: generic; K1a's and K1h-si's: named)
    for v, kernel in list(kernels.items()):
        if kernel.instance.source == engine.SOURCE_W:
            kernels[f"{v}_thread"] = type(kernel)(model, kernel.config, thread_per_env=True)
    libs = build_host(kernels.values())
    return {v: (k, inputs, libs[k.name]) for v, k in kernels.items()}


@pytest.mark.parametrize("label", list(chip_smoke.OPTION_CONFIGS))
def test_option_instance_source_arithmetic_on_host(host_cases, label):
    """The instance of each option key, one warp per env (named for each
    option off alone, the A-form with split impulse and all four off; the
    generic warp-per-env one for 2 × 8), and beside it its generic
    thread-per-env twin, built for the host,
    against the port's plain version at K1a's gates; the generic workspace
    holds the A-form's NR × NR matrix and residual where the A-form runs,
    the warp-per-env instance has none."""
    kernel, inputs, lib = host_cases[label]
    held = [(kernel, lib)]
    if kernel.instance.source == engine.SOURCE_W:
        # its named warp-per-env instance, or (2 × 8) the generic one
        named = "k1w" + engine.canonical_symbol(kernel.key).removeprefix("k1")
        if kernel.key in engine.WARP_INSTANCES:
            assert kernel.name == named and kernel.instance is engine.WARP_INSTANCES[kernel.key]
        else:
            assert kernel.instance == engine.warp_instance(kernel.key)
            assert kernel.name == f"{named}_{kernel.instance.envs}x{kernel.instance.blocks}"
        assert engine.layout(lib, kernel.name) == (kernel.table_host.size, 0)
        twin, _, twin_lib = host_cases[f"{label}_thread"]
        assert twin.key == kernel.key
        held = [(twin, twin_lib)]
        outs = run_on_host(lib, kernel, inputs)
        assert all(np.isfinite(o).all() for o in outs)
        _gate(outs, [t.numpy() for t in kernel.plain(*map(T, inputs))], TOL)
    for kernel, lib in held:
        assert kernel.name == engine.canonical_symbol(kernel.key)
        assert kernel.instance.index is None
        outs = run_on_host(lib, kernel, inputs)
        want = [t.numpy() for t in kernel.plain(*map(T, inputs))]
        assert all(np.isfinite(o).all() for o in outs)
        _gate(outs, want, TOL)
        assert (want[3] > 0).mean() > 0.05
        nv, nr = 27, 21 + 3 * 14
        ws = nv * (nv + 1) // 2 + nv + nr * nv + nr + nv
        assert engine.layout(lib, kernel.name) == (
            kernel.table_host.size, ws + (0 if kernel.config.matfree_pgs else nr * nr + nr))


@pytest.mark.parametrize("label", ["k1a_scalar", "k1a_cold", "k1a_refactor",
                                   "k1a_aform_scalar_cold_refactor", "k1a_sub2_it8"])
def test_option_instance_parts_from_the_shipped_one_on_host(host_cases, label):
    """The host build of an option's instance parts from the shipped K1a
    instance's on the same inputs by more than the gate it is held to
    (per-env medians of q and qd): an instance that ignored its option would
    fail that gate."""
    kernel, inputs, lib = host_cases[label]
    shipped, _, shipped_lib = host_cases["k1a"]
    outs, ref = run_on_host(lib, kernel, inputs), run_on_host(shipped_lib, shipped, inputs)
    for name, got, want in zip(("q", "qd"), outs, ref):
        assert np.median(np.abs(got - want).max(axis=1)) > TOL[name], name


@pytest.mark.parametrize("label, twin", [("k1a_aform", "k1a"), ("k1h_si_aform", "k1h_si"),
                                         ("k1a_aform_thread", "k1a_thread"),
                                         ("k1h_si_aform_thread", "k1h_si_thread")])
def test_aform_matches_its_matrix_free_twin_on_host(host_cases, label, twin):
    """The A-form and the matrix-free form are the same iteration: on the
    same inputs they part only by the order of their sums (the split pair
    in each design: one warp per env, one thread per env)."""
    kernel, inputs, lib = host_cases[label]
    other, _, other_lib = host_cases[twin]
    _gate(run_on_host(lib, kernel, inputs), run_on_host(other_lib, other, inputs), TOL_TWIN)


def test_option_counts_add_their_own_work():
    """``k1_flops`` per option on one activity: the A-form adds its A build
    over the active rows (and drops nothing it does not replace); a cold
    start drops the warm start; scalar friction drops the 2×2 blocks; a
    factor every substep adds three factorisations per frame; the counts
    follow the activity."""
    model = twalker.make_model()
    args = [T(x) for x in chip_smoke.near_contact_states(model, np.random.default_rng(2), 8)]
    base = engine.K1a(model, TConfig())
    lim_act, con_act, _ = engine.k1_activity(base, *args)
    flops = {v: engine.k1_flops(engine.make_kernel(model, TConfig(**f)), lim_act, con_act)
             for v, f in OPTIONS.items()}
    shipped = engine.k1_flops(base, lim_act, con_act)
    B, S, nv, iters = 8, 4, 27, 4
    n_con = float(con_act.sum())
    assert flops["k1a_scalar"] == pytest.approx(shipped - n_con * (2 * nv + 8 + 4 * iters))
    assert flops["k1a_cold"] < shipped
    nj, nl = 21, 22
    anc = model.anc.numpy() > 0.5
    pairs = 21 + nj * 7 + int(sum(anc[j + 1, :j].sum() for j in range(nj)))
    crba = nl * 40 + (nl - 1) * 13 + (6 + nj) * 39 + pairs * 11
    chol = sum((nv - j) * 2 * j for j in range(nv)) + nv * 4
    assert flops["k1a_refactor"] == shipped + (S - 1) * B * (crba + chol)
    assert shipped < flops["k1a_aform"] < 2 * shipped
    # the A build grows with the square of the active rows
    ones = engine.k1_flops(engine.make_kernel(model, TConfig(matfree_pgs=False)),
                           torch.ones_like(lim_act), torch.ones_like(con_act))
    mf_ones = engine.k1_flops(base, torch.ones_like(lim_act), torch.ones_like(con_act))
    assert ones - mf_ones > flops["k1a_aform"] - shipped
