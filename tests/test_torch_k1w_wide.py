"""K1 past 32 velocity DOFs on the warp-per-env design (``csrc/engine_k1w.cu``,
a lane holding ⌈NV / 32⌉ DOFs), on the CPU.

- H35 (``chip_smoke.py::H35_URDF``: Walker3D with a neck and split forearms,
  30 links, 35 velocity DOFs, 15 spheres, 29 limit rows) through
  ``make("Walker3DCustomEnv", model=...)`` in both packages, one control
  step from the same numpy states (``convert.env_state_from_numpy``): the
  port's plain path against the JAX package's step under the env gates
  (obs within 1e-4 on the per-env median and 1e-3 in the largest env,
  rewards within 1e-4, done flags equal; q and q̇ at the physics gate
  ``chip_smoke.TOL``). The JAX functions are compiled with XLA's fusion
  pass off: on the CPU it recomputes the unrolled link chain
  (``mocca_envs_tpu/ops/kinematics.py``) in every consumer it fuses, so a
  call's cost grows exponentially with the tree's depth; H35's arms hang 9
  links deep (Walker3D's 6), and with the pass on its control step is far
  too slow for a test. The pass changes how XLA schedules the same
  operations, not what they compute; the JAX step compiles once per module
  (~25 s).
- The g++ host builds (``-DK1W_HOST_CHECK`` / ``-DK1_HOST_CHECK``,
  ``tests/torch_k1_host.py``) of H35's torque key, its PD key, its torque
  key with a factor every substep and R64 (``chip_smoke.py::r64_model``: 59
  links, 64 velocity DOFs, 34 spheres, 58 limit rows), each warp-per-env
  instance and its ``engine_k1.cu`` twin, against the port's plain unit at
  B = 16 within ``TOL`` (per-env medians, the largest env within ten
  times), and the two designs within ``TOL_TWIN``, near contact and with
  every base lifted 3 m. The host check runs the lane width 1: the split of
  a DOF vector over two lane slots is held on the card (``chip_smoke.py``
  phase ``wide``).
- ``engine.warp_env_bytes`` is each library's ``<sym>_env_bytes``, and the
  table size its layout's.
- Routing by fit (``engine.warp_holds``): every key past 32 DOFs whose env
  fits an SM runs its generic warp-per-env instance; one that fits no SM
  (NV 64, NS 64 in the A-form: 210,900 bytes an env) runs its
  ``engine_k1.cu`` instance and does not raise; ``thread_per_env=True``
  still gives the twin.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import mocca_envs_tpu
import mocca_envs_tpu_torch
from mocca_envs_tpu.core import rng as jrng
from mocca_envs_tpu.models.urdf import parse_urdf as jparse_urdf
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.core import rng as trng
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.utils.config import EngineConfig

from tests import torch_workers  # noqa: F401
from tests.torch_k1_host import build_host, run_on_host

TOL, TOL_TWIN = chip_smoke.TOL, chip_smoke.TOL_TWIN
B = 16
ENV_B = 8
AHEAD = 3.0   # the walk target [m] ahead of the start: out of reach in one step
REFACTOR = EngineConfig(reuse_factor=False)
LABELS = ("h35", "h35_pd", "h35_refactor", "r64")
LIFT = pytest.mark.parametrize("lifted", [False, True], ids=["near_contact", "lifted"])


@functools.lru_cache(maxsize=None)
def _models():
    return chip_smoke.h35_model("cpu"), chip_smoke.r64_model("cpu")


def _kernels(label):
    """(the warp-per-env wrapper, its engine_k1.cu twin) of ``label``, as
    ``chip_smoke.wide_kernels`` makes them (and H35 with a factor every
    substep: the generic instance without REGCHOL past 32 DOFs)."""
    if label == "h35_refactor":
        h35 = _models()[0]
        return tuple(engine.K1a(h35, REFACTOR, thread_per_env=tpe) for tpe in (False, True))
    kernel, twin, _ = chip_smoke.wide_kernels(engine, EngineConfig(), "cpu")[label]
    return kernel, twin


@pytest.fixture(scope="module")
def libs():
    return build_host([k for label in LABELS for k in _kernels(label)])


def _states(label, kernel, lifted):
    rng = np.random.default_rng(28)
    make = {"h35_pd": chip_smoke.pd_target_states,
            "r64": chip_smoke.r64_states}.get(label, chip_smoke.near_contact_states)
    arrays = [np.ascontiguousarray(x) for x in make(kernel.model, rng, B)]
    if lifted:
        arrays[0][:, 2] += 3.0
    return arrays


def _gate(got, want, tol):
    """Per-env medians of the max |Δ| within ``tol``, the largest env within
    ten times."""
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        per_env = np.abs(g - w).max(axis=1)
        assert np.median(per_env) <= tol[name], (name, float(np.median(per_env)))
        assert per_env.max() <= 10 * tol[name], (name, float(per_env.max()))


@pytest.mark.parametrize("label", LABELS)
def test_keys_past_32_dofs_take_the_generic_warp_instance(label):
    kernel, twin = _kernels(label)
    key = kernel.key
    assert key.nl + 5 > 32 and engine.warp_holds(key) and key not in engine.WARP_INSTANCES
    assert kernel.instance == engine.warp_instance(key) and kernel.instance.index is None
    envs, blocks = engine.warp_shape(key)
    assert kernel.name == "k1w" + twin.name.removeprefix("k1") + f"_{envs}x{blocks}"
    assert (envs, blocks) == ({"r64": 3}.get(label, 12), 1)
    assert twin.instance.source == engine.SOURCE and twin.name == engine.canonical_symbol(key)
    assert f"-DK1W_NL={key.nl}" in engine.compile_flags(kernel.instance)
    if label in chip_smoke.WIDE_NAMES:
        # chip_smoke.py's WARP_BUILDS row: the shared memory of the host's
        # shape (the table, then the envs) and the envs resident per SM
        table = ((engine.table_floats(key) + key.nl) * 4 + 15) // 16 * 16
        assert chip_smoke.WARP_BUILDS[kernel.name][1:] == (
            table + envs * engine.warp_env_bytes(key), envs)


@pytest.mark.parametrize("label", LABELS)
@LIFT
def test_warp_and_twin_match_plain_on_host(libs, label, lifted):
    """Both designs' host builds against the plain unit at the chip gate, and
    against each other at ``TOL_TWIN``; near contact the contacts carry load,
    lifted none is active."""
    kernel, twin = _kernels(label)
    inputs = _states(label, kernel, lifted)
    want = [t.numpy() for t in kernel.plain(*map(torch.as_tensor, inputs))]
    outs = run_on_host(libs[kernel.name], kernel, inputs)
    base = run_on_host(libs[twin.name], twin, inputs)
    for got in (outs, base):
        assert all(np.isfinite(o).all() for o in got)
        _gate(got, want, TOL)
    _gate(outs, base, TOL_TWIN)
    if lifted:
        assert (want[3] == 0).all() and (outs[3] == 0).all()
    else:
        assert (want[3] > 0).mean() > 0.02


def test_env_bytes_and_tables_are_the_sources(libs):
    for label in LABELS:
        kernel, _ = _kernels(label)
        lib = libs[kernel.name]
        assert getattr(lib, kernel.name + "_env_bytes")() == engine.warp_env_bytes(kernel.key)
        assert engine.layout(lib, kernel.name) == (engine.table_floats(kernel.key), 0)
        assert kernel.table_host.size == engine.table_floats(kernel.key)


def test_a_key_whose_env_fits_no_sm_runs_engine_k1():
    """NV 64 and NS 64 in the A-form: 210,900 bytes an env, so no SM holds
    one beside its table. The key runs its engine_k1.cu instance (a wrapper
    is made, nothing raises); a warp-per-env instance asked for at that
    shape is refused at build, naming its bytes."""
    key = engine.Key(nl=59, ns=64, nlim=58, substeps=4, iters=4, matfree=False)
    assert engine.warp_env_bytes(key) == 210900 and engine.warp_shape(key) == (0, 1)
    assert not engine.warp_holds(key)
    inst = engine.instance_for(key)
    assert inst.source == engine.SOURCE and inst.symbol == engine.canonical_symbol(key)
    assert engine.instance_for(key, thread_per_env=True) == inst
    # R64 with 30 more spheres, one on each hinge link past the hips
    r64 = _models()[1]
    extra = r64.replace(
        sph_link=torch.cat([r64.sph_link, torch.arange(29, 59)]),
        sph_pos=torch.cat([r64.sph_pos, torch.zeros(30, 3)]),
        sph_radius=torch.cat([r64.sph_radius, torch.full((30,), 0.02)]),
        sph_foot=torch.cat([r64.sph_foot, torch.zeros(30, r64.sph_foot.shape[1])]),
        sph_no_bar=torch.cat([r64.sph_no_bar, torch.zeros(30)]))
    kernel = engine.K1a(extra, EngineConfig(matfree_pgs=False))
    assert kernel.key == key and kernel.instance == inst and kernel.name.startswith("k1_nl59")
    with pytest.raises(RuntimeError, match="210900 bytes"):
        engine.build([engine.warp_instance(key)])


# --------------------------------------------------------------- H35 in make
NO_FUSION = {"xla_disable_hlo_passes": "fusion"}


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_FUSION)


@pytest.fixture(scope="module")
def h35_envs():
    """The two envs, the JAX states of ``ENV_B`` fresh episodes and the JAX
    step compiled for them."""
    jmodel = jparse_urdf(chip_smoke.H35_URDF, foot_link_keywords=())
    jenv = mocca_envs_tpu.make("Walker3DCustomEnv", model=jmodel)
    penv = mocca_envs_tpu_torch.make("Walker3DCustomEnv", model=_models()[0], device="cpu")
    keys = jrng.env_keys(jrng.root_key(0), ENV_B)
    js = _compiled(jax.vmap(jenv.init), keys)(keys)
    a = jnp.zeros((ENV_B, jenv.act_dim), jnp.float32)
    return jenv, penv, js, _compiled(jax.vmap(jenv.step), js, a)


def _to_port(js):
    n = np.asarray
    return convert.env_state_from_numpy(
        q=n(js.q), qd=n(js.qd), steps=n(js.steps), reset_count=n(js.reset_count),
        done=n(js.done), blowup_count=n(js.blowup_count), target=n(js.task.target),
        potential=n(js.task.potential), ground_z=n(js.scene.ground_z),
        friction=n(js.scene.friction))


def test_h35_env_step_matches_jax(h35_envs):
    """One control step of H35 through make in both packages, from the same
    states and actions: 29 actions, 68 observations."""
    jenv, penv, js, jstep = h35_envs
    assert jenv.act_dim == penv.act_dim == 29 and penv.obs_dim == 68
    assert penv.model.nv == 35 and penv.model.ns == 15
    target = js.q[:, :3].at[:, 0].add(AHEAD).at[:, 2].set(0.0)
    dist = jnp.linalg.norm(target[:, :2] - js.q[:, :2], axis=1)
    js = js.replace(task=js.task.replace(target=target, potential=-dist / jenv.control_dt))
    a = np.random.default_rng(0).uniform(-1, 1, (ENV_B, jenv.act_dim)).astype(np.float32)
    jtr = jstep(js, jnp.asarray(a))
    ptr = penv.step(_to_port(js), torch.as_tensor(a), trng.generator(0, "cpu"))
    jdone = np.asarray(jtr.done)
    np.testing.assert_array_equal(ptr.done.numpy(), jdone)
    np.testing.assert_allclose(ptr.reward.numpy(), np.asarray(jtr.reward), atol=1e-4)
    live = ~jdone
    assert live.all()
    per_env = np.abs(ptr.obs.numpy() - np.asarray(jtr.obs))[live].max(axis=1)
    assert np.median(per_env) <= 1e-4 and per_env.max() <= 1e-3, per_env
    for name, got, want in (("q", ptr.state.q, jtr.state.q), ("qd", ptr.state.qd, jtr.state.qd)):
        err = np.abs(got.numpy() - np.asarray(want)).max(axis=1)
        assert np.median(err) <= TOL[name] and err.max() <= 10 * TOL[name], (name, err)
