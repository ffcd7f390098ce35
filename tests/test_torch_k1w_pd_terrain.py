"""K1b and K1f redesigned for Hopper (``csrc/engine_k1w.cu``, one warp per
env) on the CPU: the warp-per-env source's per-env code built by g++ under
``-DK1W_HOST_CHECK`` (lane width 1, the collectives identities) and run as a
loop over envs, beside the thread-per-env instances of the same keys
(``-DK1_HOST_CHECK``), the four built side by side.

- ``pd``: the PD walker's and the PD child's key (one llc frame per control
  step, the walker's PD gains, the implicit derivative gain kp / 20);
  ``terrain``: the terrain walkers' key (one torque frame over the 16 × 16
  heightfield window);
- the four families' keys pick the warp-per-env instance; only
  ``thread_per_env=True`` reaches the ``engine_k1.cu`` twin; K1b at two
  llc frames runs the generic warp-per-env instance of its key, the PD
  walkers' and the terrain walkers' split twins run one warp per env too;
  the global
  workspace is empty;
- at B = 64 on chip_smoke.py's PD-target and terrain states each agrees with
  the port's plain unit at its chip gate (K1b ``TOL``: q 2e-4, qd 5e-3,
  depth 2e-4, impulse 5e-3; K1f ``TOL_HF``: q 2e-4, qd 1e-2, depth 5e-4,
  impulse 1e-2) on the per-env medians, the largest env within ten times;
- each agrees with its thread-per-env twin at ``TOL_TWIN`` (q 2e-5, qd
  5e-4, depth 2e-5, impulse 5e-4), the largest env within ten times, near
  contact, lifted 3 m clear (every contact row skipped) and with every row
  active (nothing skipped);
- at B = 8 each agrees with the JAX package's control step
  (``mocca_envs_tpu/ops/step.py::make_control_step``: the PD walker with
  ``pd_targets`` and ``extra_damping``, as tests/test_torch_pd_child.py runs
  it; the walker over each env's window as a heightfield scene with no
  plane, as tests/test_torch_terrain_step.py runs it) at the same gates;
- K1f's entry refuses a null window.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import mocca_envs_tpu_torch
from mocca_envs_tpu.models import walker3d as jwalker
from mocca_envs_tpu.ops.step import make_control_step as jcontrol
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu.utils.config import EngineConfig as JConfig
from mocca_envs_tpu_torch.models import walker3d
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.terrain.scene import HF_PATCH, NO_GROUND_Z
from mocca_envs_tpu_torch.utils.config import EngineConfig

from tests import torch_workers  # noqa: F401
from tests.torch_k1_host import build_host, run_on_host

TOL = {"pd": chip_smoke.TOL, "terrain": chip_smoke.TOL_HF}
TOL_TWIN = chip_smoke.TOL_TWIN
B = 64
KIND = pytest.mark.parametrize("kind", ["pd", "terrain"])
SYMBOL = {"pd": "nl22_ns14_nlim21_sub4_it4_llc1", "terrain": "nl22_ns14_nlim21_sub4_it4_hf16"}
FAMILIES = {"pd": ("Walker3DPDCustomEnv-v0", "Child3DPDCustomEnv-v0"),
            "terrain": ("Walker3DTerrainEnv-v0", "Walker3DTerrainLidarEnv-v0")}


def _pd_model():
    """The walker with the PD families' gains: kp = power_coef on the
    actuated joints."""
    model = walker3d.make_model()
    return model.replace(kp=model.power_coef * (model.actuated > 0).float())


def _kernel(kind, model=None, thread_per_env=False, **config):
    if kind == "pd":
        model = model or _pd_model()
        return engine.K1b(model, EngineConfig(**config), extra_damping=model.kp / 20.0,
                          thread_per_env=thread_per_env)
    return engine.K1f(model or walker3d.make_model(), EngineConfig(**config), HF_PATCH,
                      thread_per_env=thread_per_env)


def _pair(kind, **config):
    """(warp-per-env, thread-per-env) wrappers of one key."""
    return _kernel(kind, **config), _kernel(kind, thread_per_env=True, **config)


@pytest.fixture(scope="module")
def libs():
    """The four instances built by g++, side by side."""
    return build_host([k for kind in ("pd", "terrain") for k in _pair(kind)])


def _states(kind, batch=B, lifted=False):
    """Numpy ``(q, qd, targets or tau, ground_z, friction[, hf])`` of
    chip_smoke.py's PD-target or terrain states; ``lifted`` raises every base
    3 m (the window, cut around the root's xy, stays)."""
    rng = np.random.default_rng(13 if kind == "pd" else 17)
    make = chip_smoke.pd_target_states if kind == "pd" else chip_smoke.terrain_states
    arrays = [np.ascontiguousarray(x) for x in make(walker3d.make_model(), rng, batch)]
    if lifted:
        arrays[0][:, 2] += 3.0
    return arrays


def _gate(got, want, tol):
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        per_env = np.abs(np.asarray(g) - np.asarray(w)).max(axis=1)
        assert np.median(per_env) <= tol[name], (name, float(np.median(per_env)))
        assert per_env.max() <= 10 * tol[name], (name, float(per_env.max()))


@KIND
def test_families_pick_the_warp_per_env_instance(libs, kind):
    new, old = _pair(kind)
    assert new.name == f"k1w_{SYMBOL[kind]}" and new.instance.source == engine.SOURCE_W
    assert old.name == f"k1{'b' if kind == 'pd' else 'f'}_{SYMBOL[kind]}"
    assert old.instance.source == engine.SOURCE
    assert new.key == old.key and new.variant == old.variant
    assert engine.WARP_INSTANCES[new.key] is new.instance
    assert engine.compile_flags(new.instance) == [f"-DK1W_ONLY={3 if kind == 'pd' else 4}"]
    # each family's model at the shipped EngineConfig, as its control step
    # builds the unit (the child shares the walker's sizes)
    for env_id in FAMILIES[kind]:
        model = mocca_envs_tpu_torch.make(env_id, device="cpu").model
        if kind == "pd":
            assert bool((model.kp > 0).any())
            picked = engine.make_kernel(model, EngineConfig(), pd_mode=True,
                                        extra_damping=model.kp / 20.0)
        else:
            picked = engine.make_kernel(model, EngineConfig(), hf_patch=HF_PATCH)
        assert picked.name == new.name and type(picked) is type(new), env_id
    # K1b at two llc frames runs the generic warp-per-env instance of its key
    # (tests/test_torch_k1w_llc_frames.py); the PD walkers' and the terrain
    # walkers' split twins run one warp per env too
    # (tests/test_torch_k1w_split_stones_pd.py, _split_mesh_terrain.py)
    split = _kernel(kind, split_impulse=True)
    assert split.instance.source == engine.SOURCE_W and split.name == f"k1w_{SYMBOL[kind]}_si"
    if kind == "pd":
        two = _kernel(kind, llc_frames=2)
        assert two.instance == engine.warp_instance(two.key) and two.instance.index is None
    # the same table; no global workspace
    assert engine.layout(libs[new.name], new.name) == (new.table_host.size, 0)
    assert engine.layout(libs[old.name], old.name)[1] > 0


@KIND
def test_k1w_matches_plain_on_host(libs, kind):
    new, _ = _pair(kind)
    inputs = _states(kind)
    outs = run_on_host(libs[new.name], new, inputs)
    want = [t.numpy() for t in new.plain(*map(torch.as_tensor, inputs))]
    assert all(np.isfinite(o).all() for o in outs)
    _gate(outs, want, TOL[kind])
    assert (want[3] > 0).mean() > 0.05   # contacts carry load
    if kind == "pd":
        # the servo moved the joints: not the zero-torque trajectory
        assert np.abs(outs[0][:, 7:] - inputs[0][:, 7:]).max() > 0.02
    else:
        # on the terrain: the plane is sunk, and no depth is measured from it
        assert (inputs[3] == NO_GROUND_Z).all() and outs[2].min() > -10.0


@KIND
@pytest.mark.parametrize("case", ["near_contact", "lifted", "all_rows_active"])
def test_k1w_matches_thread_per_env_on_host(libs, kind, case):
    """The same iteration as the thread-per-env instance, whether rows are
    skipped (lifted: all 42 contact rows) or not (every row active)."""
    config = {"contact_margin": 1e3, "limit_margin": 1e3} if case == "all_rows_active" else {}
    new, old = _pair(kind, **config)
    inputs = _states(kind, lifted=case == "lifted")
    outs = run_on_host(libs[new.name], new, inputs)
    _gate(outs, run_on_host(libs[old.name], old, inputs), TOL_TWIN)
    lim_act, con_act, _ = engine.k1_activity(new, *map(torch.as_tensor, inputs))
    if case == "lifted":
        assert not con_act.any() and (outs[3] == 0).all()
    elif case == "all_rows_active":
        assert lim_act.all() and con_act.all()
    else:
        assert 0.05 < float(con_act.float().mean()) < 0.95   # some rows skipped, some not


def _jax_pd(q, qd, targets, fric):
    """The JAX package's PD control step on the same targets."""
    jm = jwalker.make_model()
    kp = np.asarray(jm.power_coef * jm.actuated)
    jstep = jcontrol(jm.replace(kp=jnp.asarray(kp)), JConfig(), pd_targets=lambda a: a,
                     extra_damping=jnp.asarray(kp / 20.0))
    assert (fric == 0.8).all()
    return jax.jit(jax.vmap(lambda a, b, c: jstep(a, b, c, jscene.flat())))(q, qd, targets)


def _jax_terrain(q, qd, tau, fric, hf):
    """The JAX package's torque control step over each env's window, a
    heightfield scene with no plane."""
    jstep = jcontrol(jwalker.make_model(), JConfig(), actuation=lambda q_, qd_, a: a)
    P = HF_PATCH

    def one(q1, qd1, t1, f1, w):
        sc = jscene.Scene(has_ground=False, has_hf=True, hf_height=w[:P * P].reshape(P, P),
                          hf_xy0=w[P * P:P * P + 2], hf_cell=w[P * P + 2], friction=f1)
        return jstep(q1, qd1, t1, sc)

    return jax.jit(jax.vmap(one))(q, qd, tau, fric, hf)


@KIND
def test_k1w_matches_jax_control_step(libs, kind):
    """The JAX package's control step on the same inputs."""
    inputs = _states(kind, 8)
    q, qd, act, _, fric = inputs[:5]
    wq, wqd, info = (_jax_pd(q, qd, act, fric) if kind == "pd"
                     else _jax_terrain(q, qd, act, fric, inputs[5]))
    want = [np.asarray(w) for w in (wq, wqd, info.contacts.depth, info.normal_impulse)]
    new, _ = _pair(kind)
    outs = run_on_host(libs[new.name], new, inputs)
    _gate(outs, want, TOL[kind])
    assert (want[3] > 0).mean() > 0.02   # contacts carry load


def test_k1f_refuses_a_null_window(libs):
    """K1f's entry refuses a null heightfield pointer and writes nothing."""
    new, _ = _pair("terrain")
    inputs = _states("terrain", 2)
    table_size, _ = engine.layout(libs[new.name], new.name)
    outs = [np.full((2, n), 7.0, np.float32) for n in (28, 27, 14, 14)]
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    fn = getattr(libs[new.name], new.name + "_host")
    fn.restype = ctypes.c_int
    err = fn(*map(ptr, inputs[:5]), None, None, None, None, None, *map(ptr, outs),
             ptr(new.table_host), ctypes.c_int(table_size), None, ctypes.c_int(2))
    assert err != 0 and all((o == 7.0).all() for o in outs)
    # with the window the same entry runs
    assert run_on_host(libs[new.name], new, inputs)[0].shape == (2, 28)
