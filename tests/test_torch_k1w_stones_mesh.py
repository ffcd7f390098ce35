"""K1c and K1g redesigned for Hopper (``csrc/engine_k1w.cu``, one warp per
env) on the CPU: the warp-per-env source's per-env code built by g++ under
``-DK1W_HOST_CHECK`` (lane width 1, the collectives identities) and run as a
loop over envs, beside the thread-per-env instances of the same keys
(``-DK1_HOST_CHECK``), the four built side by side.

- ``stones``: the stepper's key (one torque frame over the 6 culled stone
  boxes); ``mesh``: the stairs' key (one torque frame over the 16 culled
  faces of the staircase, above the plane z = 0);
- the two families' keys pick the warp-per-env instance; only
  ``thread_per_env=True`` reaches the ``engine_k1.cu`` twin; the stepper's
  and the stairs' split twins run one warp per env too; the global
  workspace is empty;
- at B = 64 on chip_smoke.py's stepper and stairs states each agrees with
  the port's plain unit at ``TOL`` (q 2e-4, qd 5e-3, depth 2e-4, impulse
  5e-3) on the per-env medians, the largest env within ten times; over the
  mesh the tail gate holds the envs with no contact on a vertical face
  (chip_smoke.py::vertical_contacts says why: the riser rule);
- each agrees with its thread-per-env twin at ``TOL_TWIN`` (q 2e-5, qd
  5e-4, depth 2e-5, impulse 5e-4), the largest env within ten times (over
  the mesh by the riser rule), near contact, lifted 3 m clear (every contact
  row skipped), lifted with no row active and with every row active
  (nothing skipped), off near contact also with the plain unit at ``TOL``;
  over the mesh
  the twins' |Δq̇| lies within three times the 1e-7 q̇-nudge floor, the
  measurement behind chip_smoke.py's p99 tail for K1g's twins at B = 4096;
- at B = 8 each agrees with the JAX package's control step
  (``mocca_envs_tpu/ops/step.py::make_control_step``, torque actuation: over
  each env's culled stones above the plane at −20 m, as
  tests/test_torch_stones.py runs it; over the whole 24-face staircase, which
  the JAX step culls itself, as tests/test_torch_trimesh.py runs it) at the
  same gates;
- each entry refuses a null ``stones`` / ``tris``.
"""

import ctypes

import jax
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
from mocca_envs_tpu_torch.utils.config import EngineConfig

from tests import torch_workers  # noqa: F401
from tests.torch_k1_host import build_host, run_on_host

TOL, TOL_TWIN = chip_smoke.TOL, chip_smoke.TOL_TWIN
B = 64
KIND = pytest.mark.parametrize("kind", ["stones", "mesh"])
SYMBOL = {"stones": "nl22_ns14_nlim21_sub4_it4_k6", "mesh": "nl22_ns14_nlim21_sub4_it4_kt16"}
FAMILY = {"stones": "Walker3DStepperEnv-v0", "mesh": "Walker3DStairsEnv-v0"}
# the stairs family's staircase, as chip_smoke.stairs_states builds it
STAIRS = dict(n_steps=6, rise=0.12, run=0.35, width=4.0, start_x=0.6)


def _kernel(kind, thread_per_env=False, **config):
    make = engine.K1c if kind == "stones" else engine.K1g
    return make(walker3d.make_model(), EngineConfig(**config), thread_per_env=thread_per_env)


def _pair(kind, **config):
    """(warp-per-env, thread-per-env) wrappers of one key."""
    return _kernel(kind, **config), _kernel(kind, thread_per_env=True, **config)


@pytest.fixture(scope="module")
def libs():
    """The four instances built by g++, side by side."""
    return build_host([k for kind in ("stones", "mesh") for k in _pair(kind)])


def _states(kind, batch=B, lifted=False):
    """Numpy ``(q, qd, tau, ground_z, friction, stones or tris)`` of
    chip_smoke.py's stepper or stairs states; ``lifted`` raises every base
    3 m (the packed scene stays)."""
    model = walker3d.make_model()
    rng = np.random.default_rng(19 if kind == "stones" else 23)
    arrays = (chip_smoke.stepper_states(model, rng, EngineConfig().stone_window, batch)
              if kind == "stones" else chip_smoke.stairs_states(model, rng, batch))
    arrays = [np.ascontiguousarray(x) for x in arrays]
    if lifted:
        arrays[0][:, 2] += 3.0
    return arrays


def _tail_envs(kernel, inputs):
    """The envs the tail gate holds (bool (B,)): over the mesh those with no
    contact on a vertical face in the plain run (the riser rule), else all."""
    if not kernel.num_tris:
        return np.ones(inputs[0].shape[0], bool)
    return ~chip_smoke.vertical_contacts(kernel, list(map(torch.as_tensor, inputs))).numpy()


def _gate(got, want, tol, held):
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        per_env = np.abs(np.asarray(g) - np.asarray(w)).max(axis=1)
        assert np.median(per_env) <= tol[name], (name, float(np.median(per_env)))
        assert per_env[held].max() <= 10 * tol[name], (name, float(per_env[held].max()))


@KIND
def test_families_pick_the_warp_per_env_instance(libs, kind):
    new, old = _pair(kind)
    assert new.name == f"k1w_{SYMBOL[kind]}" and new.instance.source == engine.SOURCE_W
    assert old.name == f"k1{'c' if kind == 'stones' else 'g'}_{SYMBOL[kind]}"
    assert old.instance.source == engine.SOURCE
    assert new.key == old.key and new.variant == old.variant
    assert engine.WARP_INSTANCES[new.key] is new.instance
    assert engine.compile_flags(new.instance) == [f"-DK1W_ONLY={5 if kind == 'stones' else 6}"]
    # the family's model at the shipped EngineConfig, as its control step
    # builds the unit (the culled window of each)
    model = mocca_envs_tpu_torch.make(FAMILY[kind], device="cpu").model
    config = EngineConfig()
    window = ({"num_stones": config.stone_window} if kind == "stones"
              else {"num_tris": config.tri_window})
    picked = engine.make_kernel(model, config, **window)
    assert picked.name == new.name and type(picked) is type(new)
    # the stepper's and the stairs' split twins run one warp per env too
    # (tests/test_torch_k1w_split_stones_pd.py, _split_mesh_terrain.py)
    split = _kernel(kind, split_impulse=True)
    assert split.variant == ("k1h_c" if kind == "stones" else "k1h_g")
    assert split.instance.source == engine.SOURCE_W
    assert split.name == f"k1w_{SYMBOL[kind]}_si"
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
    held = _tail_envs(new, inputs)
    _gate(outs, want, TOL, held)
    assert (want[3] > 0).mean() > 0.05   # contacts carry load
    if kind == "stones":
        # some spheres rest on stones, far above the plane at −20 m; some
        # envs are over a gap, with nothing near
        plane_depth = 0.2 - (inputs[0][:, 2] + 20.0)
        assert (want[2] > plane_depth[:, None] + 5.0).mean() > 0.3
        assert (want[2].max(axis=1) < -1.0).any()
    else:
        # the JAX package's mesh gate; risers touched in some envs, not all
        assert (np.abs(outs[0] - want[0]) < 1e-3).mean() >= 0.97
        assert 0.1 < (~held).mean() < 0.9
        assert (want[3] > 0).any() and (inputs[0][:, 2] > 1.2).any()   # treads carry feet


@KIND
@pytest.mark.parametrize("case", ["near_contact", "lifted", "all_rows_active", "no_rows"])
def test_k1w_matches_thread_per_env_on_host(libs, kind, case):
    """The same iteration as the thread-per-env instance, whether rows are
    skipped (lifted: all 42 contact rows; no rows: lifted, and a limit
    margin no joint reaches) or not (every row active: 63, so that a lane
    takes a second row); off near contact also the plain unit's."""
    config = {"all_rows_active": {"contact_margin": 1e3, "limit_margin": 1e3},
              "no_rows": {"limit_margin": -1e3}}.get(case, {})
    new, old = _pair(kind, **config)
    inputs = _states(kind, lifted=case in ("lifted", "no_rows"))
    outs = run_on_host(libs[new.name], new, inputs)
    held = _tail_envs(new, inputs)
    _gate(outs, run_on_host(libs[old.name], old, inputs), TOL_TWIN, held)
    lim_act, con_act, _ = engine.k1_activity(new, *map(torch.as_tensor, inputs))
    if case in ("lifted", "no_rows"):
        assert not con_act.any() and (outs[3] == 0).all()
        assert lim_act.any() == (case == "lifted")
    elif case == "all_rows_active":
        assert lim_act.all() and con_act.all()
    else:
        assert 0.05 < float(con_act.float().mean()) < 0.95   # some rows skipped, some not
    if case != "near_contact":   # near contact: test_k1w_matches_plain_on_host
        want = [t.numpy() for t in new.plain(*map(torch.as_tensor, inputs))]
        _gate(outs, want, TOL, held)


def test_the_mesh_twin_gap_is_the_rounding_floor(libs):
    """Why chip_smoke.py holds K1g's twins at the 99th percentile of the envs
    with no contact on a vertical face, not at their largest (at B = 4096 a
    few of them part beyond ten times ``TOL_TWIN``'s qd): at B = 512 the
    twins' per-env |Δq̇| median, and its 99th percentile over those envs,
    lie within three times those by which the thread-per-env instance parts
    from itself when q̇ is nudged by 1e-7 (relative, numpy seed 0) — rounding,
    amplified where a sphere's nearest face changes, not another iteration."""
    new, old = _pair("mesh")
    inputs = _states("mesh", 512)
    held = _tail_envs(new, inputs)
    nudged = list(inputs)
    noise = np.random.default_rng(0).standard_normal(inputs[1].shape)
    nudged[1] = (inputs[1] * (1 + 1e-7 * noise)).astype(np.float32)
    base = run_on_host(libs[old.name], old, inputs)
    gap, floor = (np.abs(x[1] - base[1]).max(axis=1) for x in (
        run_on_host(libs[new.name], new, inputs), run_on_host(libs[old.name], old, nudged)))
    for stat in (lambda x: np.median(x), lambda x: np.quantile(x[held], 0.99)):
        assert 0 < stat(gap) <= 3 * stat(floor), (stat(gap), stat(floor))
    assert np.quantile(floor[held], 0.99) > TOL_TWIN["qd"]   # the floor is not zero


def _jax_stones(q, qd, tau, fric, stones):
    """The JAX package's torque control step over each env's stones (the
    window the port culled: the JAX step keeps a window it is given whole)."""
    jstep = jcontrol(jwalker.make_model(), JConfig(), actuation=lambda q_, qd_, a: a)
    st = {k: v.numpy() for k, v in engine.unpack_stones(torch.as_tensor(stones)).items()}
    assert (fric == 0.8).all()

    def one(q1, qd1, t1, sp, sq, sh, sa):
        return jstep(q1, qd1, t1, jscene.with_stones(sp, sq, sh, sa, ground_z=-20.0))

    return jax.jit(jax.vmap(one))(q, qd, tau, st["stone_pos"], st["stone_quat"],
                                  st["stone_half"], st["stone_active"])


def _jax_mesh(q, qd, tau, fric):
    """The JAX package's torque control step over the whole staircase (its
    step culls the 24 faces to its window itself)."""
    jstep = jcontrol(jwalker.make_model(), JConfig(), actuation=lambda q_, qd_, a: a)
    jsc = jscene.stairs_trimesh(**STAIRS)
    assert (fric == 0.8).all()
    return jax.jit(jax.vmap(lambda a, b, c: jstep(a, b, c, jsc)))(q, qd, tau)


@KIND
def test_k1w_matches_jax_control_step(libs, kind):
    """The JAX package's control step on the same inputs."""
    inputs = _states(kind, 8)
    q, qd, tau, _, fric = inputs[:5]
    wq, wqd, info = (_jax_stones(q, qd, tau, fric, inputs[5]) if kind == "stones"
                     else _jax_mesh(q, qd, tau, fric))
    want = [np.asarray(w) for w in (wq, wqd, info.contacts.depth, info.normal_impulse)]
    new, _ = _pair(kind)
    outs = run_on_host(libs[new.name], new, inputs)
    _gate(outs, want, TOL, _tail_envs(new, inputs))
    assert (want[3] > 0).mean() > 0.02   # contacts carry load


@KIND
def test_k1w_refuses_a_null_scene(libs, kind):
    """The entry refuses a null stones / tris pointer and writes nothing."""
    new, _ = _pair(kind)
    inputs = _states(kind, 2)
    table_size, _ = engine.layout(libs[new.name], new.name)
    outs = [np.full((2, n), 7.0, np.float32) for n in (28, 27, 14, 14)]
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    fn = getattr(libs[new.name], new.name + "_host")
    fn.restype = ctypes.c_int
    err = fn(*map(ptr, inputs[:5]), None, None, None, None, None, *map(ptr, outs),
             ptr(new.table_host), ctypes.c_int(table_size), None, ctypes.c_int(2))
    assert err != 0 and all((o == 7.0).all() for o in outs)
    # with its scene the same entry runs
    assert run_on_host(libs[new.name], new, inputs)[0].shape == (2, 28)
