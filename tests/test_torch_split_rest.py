"""Split impulse on the PD walker, the torque planar walkers, terrain and the
stairs (CPU): the JAX package, the port's plain path and the K1 kernel
source.

``python -m mocca_envs_tpu_torch.harness.train --split-impulse`` builds each
family's ``EngineConfig()`` with the flag on; on the card the PD walkers,
the torque planar walkers, the terrain walkers and the stairs run the
warp-per-env instances of ``csrc/engine_k1w.cu`` (K1h-b, the planar K1h-e,
K1h-f, K1h-g).

- One control step of each through the port's plain path and the JAX
  package's ``make_control_step`` (its XLA path) on the same numpy states,
  at the tolerances of that family's non-split step test: the PD walker
  (tests/test_torch_pd_child.py's targets and gates: per-env medians within
  q 2e-4, qd 5e-3, depth 2e-4, normal impulse 5e-3, the largest env within
  ten times), Walker2D (the equality-row gates: q 5e-4, qd 2e-2, depth 5e-4,
  impulse 5e-3), the terrain walker over its 16 × 16 window (the
  heightfield gates: q 2e-4, qd 1e-2, depth 5e-4, impulse 1e-2) and the
  stairs (K1a's gates; the tail over the envs with no riser contact, and
  the JAX mesh gate, 97% of q within 1e-3). Each family compiles its own
  JAX step, once per process. Each checks that the position pass has work. For
  each family the warp-per-env instance's host build (``-DK1W_HOST_CHECK``)
  runs the same step (one llc frame) on the targets, the torques, the
  window and the culled faces the port's step packs, and is held to the
  same JAX outputs at the same gates.
- The instance of each split key, built for the host (``-DK1W_HOST_CHECK``:
  the generic warp-per-env one for the PD walker at two llc frames, the
  others' named warp-per-env one), against the port's plain version on
  chip_smoke.py's states at its twin's gates (the PD walker at one and two
  llc frames, Walker2D and Crab2D, the terrain walker, the stairs).

The card-only comparisons of these instances are in
tests/test_torch_kernel_wrapper.py (``-m cuda``), which imports no JAX.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mocca_envs_tpu.models import walker2d as jwalker2d
from mocca_envs_tpu.models import walker3d as jwalker
from mocca_envs_tpu.ops.step import make_control_step as jcontrol
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu.utils.config import EngineConfig as JConfig
from mocca_envs_tpu_torch.models import walker2d as twalker2d
from mocca_envs_tpu_torch.models import walker3d as twalker
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.ops.step import make_control_step as tcontrol
from mocca_envs_tpu_torch.terrain import scene as tscene
from mocca_envs_tpu_torch.terrain.heightfield import with_heightfield
from mocca_envs_tpu_torch.terrain.scene import HF_PATCH
from mocca_envs_tpu_torch.utils.config import EngineConfig as TConfig

from tests import torch_workers  # noqa: F401
from tests.test_torch_kernel_wrapper import SPLIT_REST, _split_kernel
from tests.test_torch_terrain_step import EXTENT, walker_over_terrain
from tests.test_torch_trimesh import STAIRS
from tests.torch_k1_host import build_host, run_on_host

TOL, TOL_EQ, TOL_HF = chip_smoke.TOL, chip_smoke.TOL_EQ, chip_smoke.TOL_HF
T = torch.as_tensor


def _gate(got, want, tol, tail_envs=None):
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        per_env = np.abs(np.asarray(g) - np.asarray(w)).reshape(len(g), -1).max(axis=1)
        assert np.median(per_env) <= tol[name], (name, float(np.median(per_env)))
        held = per_env if tail_envs is None else per_env[tail_envs]
        assert held.max() <= 10 * tol[name], (name, float(held.max()))


def _parts(step_out):
    q, qd, info = step_out
    return [x.numpy() for x in (q, qd, info.contacts.depth, info.normal_impulse)]


def _torque(jm):
    gain = np.array(jm.power_coef * jm.actuated)
    return gain, (lambda q_, qd_, a: gain * jnp.clip(a, -1, 1)), (
        lambda q_, qd_, a: T(gain) * torch.clamp(a, -1, 1))


def _pd_walker():
    """The PD walker's step (tests/test_torch_pd_child.py's targets, kp / 20
    implicit) on B = 32 near-contact states."""
    jm = jwalker.make_model()
    B = 32
    q, qd, _, _, _ = chip_smoke.near_contact_states(twalker.make_model(),
                                                    np.random.default_rng(41), B)
    action = np.random.default_rng(42).uniform(-1, 1, (B, 21)).astype(np.float32)
    kp = np.array(jm.power_coef * jm.actuated)
    mid = np.array(0.5 * (jm.limit_lo + jm.limit_hi))
    amp = np.array(0.5 * (jm.limit_hi - jm.limit_lo))
    jstep = jcontrol(jm.replace(kp=jnp.asarray(kp)), JConfig(split_impulse=True),
                     pd_targets=lambda a: mid + amp * jnp.clip(a, -1, 1),
                     extra_damping=jnp.asarray(kp / 20.0))

    def port(split):
        step = tcontrol(twalker.make_model().replace(kp=T(kp)), TConfig(split_impulse=split),
                        pd_targets=lambda a: T(mid) + T(amp) * torch.clamp(a, -1, 1),
                        extra_damping=T(kp / 20.0))
        return _parts(step(T(q), T(qd), T(action), tscene.flat(B)))

    def one(a, b, c):
        qq, dd, info = jstep(a, b, c, jscene.flat())
        return qq, dd, info.contacts.depth, info.normal_impulse

    flat = tscene.flat(B)
    targets = T(mid) + T(amp) * torch.clamp(T(action), -1, 1)
    host = [np.ascontiguousarray(x.numpy()) for x in (
        T(q), T(qd), targets, flat.ground_z, flat.friction)]
    return one, (q, qd, action), port, TOL, None, host


def _walker2d():
    """Walker2D's torque step with the planar lock on B = 32 states by its
    stand height (chip_smoke.planar_walker_states)."""
    jm, tm = jwalker2d.make_walker2d(), twalker2d.make_walker2d()
    B = 32
    q, qd, _, _, _ = chip_smoke.planar_walker_states(tm, 1.22, np.random.default_rng(43), B)
    action = np.random.default_rng(44).uniform(-1, 1, (B, tm.nj)).astype(np.float32)
    _, jact, tact = _torque(jm)
    jstep = jcontrol(jm, JConfig(split_impulse=True), constraints=jwalker2d.planar_spec(),
                     actuation=jact)

    def port(split):
        step = tcontrol(tm, TConfig(split_impulse=split), constraints=twalker2d.planar_spec(),
                        actuation=tact)
        return _parts(step(T(q), T(qd), T(action), tscene.flat(B)))

    def one(a, b, c):
        qq, dd, info = jstep(a, b, c, jscene.flat())
        return qq, dd, info.contacts.depth, info.normal_impulse

    flat = tscene.flat(B)
    host = [np.ascontiguousarray(x.numpy()) for x in (
        T(q), T(qd), tact(None, None, T(action)), flat.ground_z, flat.friction)]
    return one, (q, qd, action), port, TOL_EQ, None, host


def _kernel_inputs(q, qd, tau, scene):
    """Numpy K1 inputs of one llc frame over ``scene`` as the port's step
    packs them: the faces culled to the window nearest the root, the
    heightfield cut to the window around it."""
    q, config = T(q), TConfig()
    scene = tscene.cull_tris(scene, q[:, 0:2], config.tri_window)
    if scene.has_hf:
        scene = tscene.extract_patch(scene, q[:, 0:2], HF_PATCH)
    packed = engine.pack_hf(scene) if scene.has_hf else engine.pack_tris(scene)
    return [np.ascontiguousarray(x.numpy()) for x in (
        q, T(qd), tau, scene.ground_z, scene.friction, packed)]


def _terrain():
    """The walker over the terrain bank's grids
    (tests/test_torch_terrain_step.py's states), B = 16."""
    jm, tm = jwalker.make_model(), twalker.make_model()
    B = 16
    q, qd, heights = walker_over_terrain(B, 45)
    action = np.random.default_rng(46).uniform(-1, 1, (B, 21)).astype(np.float32)
    _, jact, tact = _torque(jm)
    jstep = jcontrol(jm, JConfig(split_impulse=True), actuation=jact)
    cell = EXTENT / (heights.shape[1] - 1)

    def port(split):
        step = tcontrol(tm, TConfig(split_impulse=split), actuation=tact)
        return _parts(step(T(q), T(qd), T(action), with_heightfield(T(heights), extent=EXTENT)))

    host = _kernel_inputs(q, qd, tact(None, None, T(action)),
                          with_heightfield(T(heights), extent=EXTENT))

    def one(a, b, c, h):
        sc = jscene.Scene(has_ground=False, has_hf=True, hf_height=h,
                          hf_xy0=jnp.full(2, -EXTENT / 2), hf_cell=jnp.asarray(cell),
                          friction=jnp.asarray(0.8))
        qq, dd, info = jstep(a, b, c, jscene.extract_patch(sc, a[0:2], tscene.HF_PATCH))
        return qq, dd, info.contacts.depth, info.normal_impulse

    return one, (q, qd, action, heights), port, TOL_HF, None, host


def _stairs():
    """The walker at treads, nosings and risers of the stairs
    (chip_smoke.stairs_states), B = 48; the tail is held over the envs with
    no riser contact."""
    jm, tm = jwalker.make_model(), twalker.make_model()
    B = 48
    arrays = chip_smoke.stairs_states(tm, np.random.default_rng(47), B)
    q, qd = arrays[0], arrays[1]
    action = np.random.default_rng(48).uniform(-1, 1, (B, 21)).astype(np.float32)
    gain, jact, tact = _torque(jm)
    jstep = jcontrol(jm, JConfig(split_impulse=True), actuation=jact)
    jsc = jscene.stairs_trimesh(**STAIRS)

    def port(split):
        step = tcontrol(tm, TConfig(split_impulse=split), actuation=tact)
        return _parts(step(T(q), T(qd), T(action),
                           tscene.broadcast_scene(tscene.stairs_trimesh(**STAIRS), B)))

    def one(a, b, c):
        qq, dd, info = jstep(a, b, c, jsc)
        return qq, dd, info.contacts.depth, info.normal_impulse

    kernel_args = [T(x) for x in arrays]
    kernel_args[2] = T(gain) * torch.clamp(T(action), -1, 1)
    vertical = chip_smoke.vertical_contacts(engine.K1g(tm, TConfig(split_impulse=True)),
                                            kernel_args).numpy()
    host = _kernel_inputs(q, qd, kernel_args[2],
                          tscene.broadcast_scene(tscene.stairs_trimesh(**STAIRS), B))
    return one, (q, qd, action), port, TOL, ~vertical, host


FAMILIES = {"pd_walker": _pd_walker, "walker2d": _walker2d, "terrain": _terrain,
            "stairs": _stairs}


@functools.lru_cache(maxsize=None)
def _jax_step(family):
    """One family's (JAX outputs, the port's step with and without split
    impulse, its gate, the envs its tail gate holds, the warp-per-env
    instance's inputs or None), its JAX step compiled once per process."""
    one, inputs, *rest = FAMILIES[family]()
    return ([np.asarray(x) for x in jax.jit(jax.vmap(one))(*inputs)], *rest)


# the split key whose warp-per-env instance runs a family's step on the card
WARP_CASE = {"pd_walker": "k1h_b", "walker2d": "k1h_e_planar", "terrain": "k1h_f",
             "stairs": "k1h_g"}
# the split cases on a warp-per-env instance: those and Crab2D's
WARP_SPLIT = {*WARP_CASE.values(), "k1h_e_crab"}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_split_control_step_matches_jax(request, family):
    """One control step with split impulse, port against JAX, at the
    family's gate; the split step parts from the unsplit one. The PD
    walker's, Walker2D's, the terrain walker's and the stairs' warp-per-env
    instance, built for the host, is held to the same JAX outputs at the
    same gates."""
    want, port, tol, tail_envs, host = _jax_step(family)
    got, unsplit = port(True), port(False)
    _gate(got, want, tol, tail_envs)
    assert (want[3] > 0).mean() > 0.03                      # contacts carry load
    assert np.abs(got[1] - unsplit[1]).max() > 0.05         # the position pass has work
    if family == "stairs":
        assert (np.abs(got[0] - want[0]) < 1e-3).mean() >= 0.97
        assert 0.1 < (~tail_envs).mean() < 0.9
    if family in WARP_CASE:
        cases, libs = request.getfixturevalue("host_split")
        kernel = cases[WARP_CASE[family]][0]
        assert kernel.instance.source == engine.SOURCE_W
        outs = run_on_host(libs[kernel.name], kernel, host)
        assert all(np.isfinite(o).all() for o in outs)
        _gate(outs, want, tol, tail_envs)
        if family == "stairs":
            assert (np.abs(outs[0] - want[0]) < 1e-3).mean() >= 0.97


@pytest.fixture(scope="module")
def host_split():
    cases = {case: _split_kernel(case, 96 if case == "k1h_g" else 48, 5) for case in SPLIT_REST}
    libs = build_host([k for kernel, twin, _ in cases.values() for k in (kernel, twin)])
    return cases, libs


@pytest.mark.parametrize("case", list(SPLIT_REST))
def test_split_rest_source_arithmetic_on_host(host_split, case):
    """Each split key's instance (the generic warp-per-env one at two llc
    frames; the named warp-per-env one of K1h-b, the planar K1h-e, K1h-f and
    K1h-g), built for the host, against the plain
    version at its twin's gate, counted under its split name; the position
    pass moves the result away from the unsplit twin's."""
    cases, libs = host_split
    kernel, twin, arrays = cases[case]
    assert kernel.split and type(kernel) is type(twin) and kernel.variant == SPLIT_REST[case][1]
    if case in WARP_SPLIT:
        assert kernel.instance is engine.WARP_INSTANCES[kernel.key]
    else:
        assert kernel.instance == engine.warp_instance(kernel.key)
        assert kernel.instance.index is None
    inputs = [np.ascontiguousarray(x) for x in arrays]
    outs = run_on_host(libs[kernel.name], kernel, inputs)
    args = list(map(T, inputs))
    want = [t.numpy() for t in kernel.plain(*args)]
    assert all(np.isfinite(o).all() for o in outs)
    tail = ~chip_smoke.vertical_contacts(kernel, args).numpy() if case == "k1h_g" else None
    _gate(outs, want, SPLIT_REST[case][2], tail)
    assert (want[3] > 0).mean() > 0.02
    unsplit = run_on_host(libs[twin.name], twin, inputs)
    assert np.abs(unsplit[1] - outs[1]).max() > 0.05
