"""Every scene combination the TPU kernel composes, on the CPU: K1 with PD
mode, equality rows or extra damping over any geometry, and several
geometries (stones, a heightfield window, mesh faces, bars) in one
instance, the keys a–m of chip_smoke.py's :data:`COMBINATIONS`.

- Routing: ``make_kernel`` wraps each key in ``K1x`` (one class for every
  combination no shipped family runs), counted under ``k1_`` or, with split
  impulse, ``k1h_`` and the key's scene tags; it runs the key's generic
  warp-per-env instance of ``csrc/engine_k1w.cu`` (``warp_holds``: any mix
  of geometries), the walker's torque key with extra damping K1a's named
  one; ``thread_per_env=True`` gives the generic ``engine_k1.cu`` twin; each
  key has a bound (operations per geometry's narrowphase, bytes per input).
- Both sources built by g++ (``-DK1W_HOST_CHECK``, ``-DK1_HOST_CHECK``),
  with and without split impulse, at B = 64 on chip_smoke.py's states
  (:func:`chip_smoke.combination_states`): the warp build's env is
  ``warp_env_bytes``; it agrees with its thread twin at ``TOL_TWIN`` and
  with the port's plain unit at the key's gate (per-env medians, the
  largest env within ten times; over mesh faces the tail holds the envs
  with no contact on a vertical face, chip_smoke.py::vertical_contacts, and
  where that rule leaves envs out, the twins' median |Δq̇| lies within three
  times the 1e-7 q̇-nudge floor).
- The normal rule: in the states of every key with several geometries, an
  earlier geometry wins a sphere on a slope or a tilted face while a later
  one has an active, shallower candidate; the merge keeps the winner's
  normal (a per-geometry reset to +z fails the holds above by orders of
  magnitude).
- Cassie's factor is made afresh in every llc frame: at ten and five
  frames per call, both builds agree with the plain unit, whose frame loop
  makes it at each frame's first substep, within ``STALE_GATE`` on the
  per-env medians; a factor kept from the call's first frame parts by
  4–40 times that.
- Against the JAX package (two compiles): its narrowphase over a
  heightfield, tilted stones and mesh faces (run op by op); and
  ``make("Walker3DStairsEnv", pd_control=True)`` stepped in both packages
  at B = 8, where each step's physics, the JAX package's control step with
  PD targets and extra damping over the culled staircase (key a), also
  holds the port's plain unit and key a's warp build.
"""

import ctypes
import dataclasses
import fcntl
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
from mocca_envs_tpu.models import walker3d as jwalker
from mocca_envs_tpu.ops.collide import collide as jcollide
from mocca_envs_tpu.ops.kinematics import forward_kinematics as jfk
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.core import rng as trng
from mocca_envs_tpu_torch.models import cassie
from mocca_envs_tpu_torch.ops.collide import collide
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.ops.kinematics import forward_kinematics
from mocca_envs_tpu_torch.tasks.cassie_task import CASSIE_CONFIG
from mocca_envs_tpu_torch.terrain import scene as scene_mod
from mocca_envs_tpu_torch.utils.config import EngineConfig

from tests import torch_workers  # noqa: F401
from tests.torch_k1_host import CACHE, build_host, run_on_host

B = 64
LABELS = list(chip_smoke.COMBINATIONS)
KEY = pytest.mark.parametrize("label", LABELS)
SPLIT = pytest.mark.parametrize("split", [False, True], ids=["unsplit", "split"])
# keys with several geometries, where the merge order matters
MIXED = [v for v in LABELS if sum(map(bool, chip_smoke.COMBINATIONS[v][1:5])) > 1]
# a stale factor across Cassie's llc frames parts from the plain unit by
# per-env medians of 2e-5–1e-4 in q and 4e-3–1e-2 in q̇ at ten and five
# frames; a fresh one by 1e-6–3e-6 and 2e-4–6e-4 (B = 64)
STALE_GATE = {"q": 2e-5, "qd": 2e-3}
# Scene fields per geometry, in the narrowphase's merge order
GEOMETRY = {"hf": ("hf_height", "hf_xy0", "hf_cell"), "stones": scene_mod.STONE_FIELDS,
            "tris": scene_mod.TRI_FIELDS, "bars": scene_mod.BAR_FIELDS}


@functools.lru_cache(maxsize=None)
def _models():
    return chip_smoke.combination_models("cpu")


@functools.lru_cache(maxsize=None)
def _kernels(label: str, split: bool):
    """(warp-per-env kernel, thread-per-env twin) of a key."""
    config = EngineConfig(split_impulse=split)
    return tuple(chip_smoke.combination_kernel(engine, label, _models(), config,
                                               thread_per_env=tpe) for tpe in (False, True))


@functools.lru_cache(maxsize=None)
def _case(label: str, split: bool):
    """(warp-per-env kernel, thread-per-env twin, numpy inputs) of a key."""
    kernel, twin = _kernels(label, split)
    inputs = chip_smoke.combination_states(kernel, label, np.random.default_rng(7), B)
    return kernel, twin, tuple(np.ascontiguousarray(x) for x in inputs)


@pytest.fixture(scope="module")
def libs():
    """Both builds of every key, split or not, compiled side by side once; a
    lock file keeps test workers from compiling the same libraries at once
    (the next one finds them in the cache)."""
    CACHE.mkdir(parents=True, exist_ok=True)
    with open(CACHE / "k1_combinations.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return build_host([k for label in LABELS for split in (False, True)
                           for k in _kernels(label, split)])


def _held(kernel, inputs):
    """The envs the tail gate holds: over mesh faces those with no contact
    on a vertical face in the plain run (the riser rule), else all."""
    if not kernel.num_tris:
        return np.ones(inputs[0].shape[0], bool)
    return ~chip_smoke.vertical_contacts(kernel, list(map(torch.as_tensor, inputs))).numpy()


def _gate(got, want, tol, held, names=("q", "qd", "depth", "nimp")):
    for name, g, w in zip(names, got, want):
        per_env = np.abs(g - w).max(axis=1)
        assert np.median(per_env) <= tol[name], (name, float(np.median(per_env)))
        assert per_env[held].max() <= 10 * tol[name], (name, float(per_env[held].max()))


@KEY
def test_make_kernel_composes_the_key(label):
    """Each key is a K1x on its generic warp-per-env instance (the damped
    torque key on K1a's named one), its twin the generic engine_k1.cu
    instance; its launches count under the tags of what it composes; its
    bound counts each geometry's narrowphase and each input's bytes."""
    kernel, twin, inputs = _case(label, False)
    _, stones, bars, hf, tris, pd, eq, damped, _ = chip_smoke.COMBINATIONS[label]
    assert isinstance(kernel, engine.K1x) and type(twin) is engine.K1x
    key = kernel.key
    assert (key.stones, key.bars, key.hf, key.tris, key.pd) == (stones, bars, hf, tris, pd)
    assert engine.warp_holds(key) and kernel.instance.source == engine.SOURCE_W
    if damped:
        assert kernel.instance is engine.WARP_INSTANCES[key]
        assert kernel.name == "k1w_nl22_ns14_nlim21_sub4_it4" and kernel.variant == "k1_damped"
    else:
        inst = kernel.instance
        assert inst == engine.warp_instance(key) and inst.envs >= 17 and inst.blocks == 1
        assert kernel.variant == "_".join(["k1", *engine.scene_tags(key)])
        # chip_smoke.py's WARP_BUILDS row: the shared memory of the host's
        # shape (the table, then the envs) and the envs resident per SM
        table = ((engine.table_floats(key) + key.nl) * 4 + 15) // 16 * 16
        assert chip_smoke.WARP_BUILDS[inst.symbol][1:] == (
            table + inst.envs * engine.warp_env_bytes(key), inst.envs)
    # the twin: the generic engine_k1.cu instance (the damped torque key: K1a's named one)
    assert twin.instance == engine.instance_for(key, thread_per_env=True)
    assert twin.instance.source == engine.SOURCE
    assert twin.name == ("k1a_nl22_ns14_nlim21_sub4_it4" if damped
                         else engine.canonical_symbol(key))
    assert twin.variant == kernel.variant
    split = _case(label, True)[0]
    assert split.split and split.variant == "k1h" + kernel.variant.removeprefix("k1")
    assert split.key == dataclasses.replace(key, split=True) and engine.warp_holds(split.key)
    # every input and output counted once; each geometry's narrowphase in
    # the operations (without it, fewer)
    args = list(map(torch.as_tensor, inputs))
    lim_act, con_act, walk = engine.k1_activity(kernel, *args)
    flops = engine.k1_flops(kernel, lim_act, con_act, *args[5:], tri_walk=walk)
    if stones or bars or hf or tris:
        plane = engine.make_kernel(kernel.model, kernel.config, pd_mode=pd,
                                   extra_damping=kernel.extra_damping if pd else None,
                                   constraints=kernel.constraints)
        named = dict(zip(kernel.inputs, args[5:]))
        assert flops > engine.k1_flops(plane, lim_act, con_act,
                                       *(named[x] for x in plane.inputs))
    m = kernel.model
    assert engine.k1_bytes_per_env(kernel) == 4 * (
        m.nq + m.nv + m.nj + 2 + sum(x.size for x in inputs[5:]) // B + m.nq + m.nv + 2 * m.ns)


@KEY
@SPLIT
def test_warp_instance_holds_its_twin_and_the_plain_unit(libs, label, split):
    """The host builds of both sources against each other (``TOL_TWIN``)
    and against the plain unit (the key's gate)."""
    kernel, twin, inputs = _case(label, split)
    env_bytes = getattr(libs[kernel.name], kernel.name + "_env_bytes")
    env_bytes.restype = ctypes.c_int
    assert env_bytes() == engine.warp_env_bytes(kernel.key)
    assert engine.layout(libs[kernel.name], kernel.name) == (kernel.table_host.size, 0)
    outs = run_on_host(libs[kernel.name], kernel, inputs)
    base = run_on_host(libs[twin.name], twin, inputs)
    want = [t.numpy() for t in kernel.plain(*map(torch.as_tensor, inputs))]
    assert all(np.isfinite(o).all() for o in outs)
    held = _held(kernel, inputs)
    tol = chip_smoke.COMBINATIONS[label][-1]
    _gate(outs, want, tol, held)
    _gate(base, want, tol, held)
    _gate(outs, base, chip_smoke.TOL_TWIN, held)
    assert (want[3] > 0).mean() > 0.02   # contacts carry load
    if kernel.num_tris:
        assert (np.abs(outs[0] - want[0]) < 1e-3).mean() >= 0.97   # the JAX mesh gate
    if not held.all():
        # the twins part by rounding, as far as a 1e-7 nudge of q̇ parts the
        # twin from itself
        nudged = list(inputs)
        noise = np.random.default_rng(0).standard_normal(inputs[1].shape)
        nudged[1] = (inputs[1] * (1 + 1e-7 * noise)).astype(np.float32)
        med = lambda a: float(np.median(np.abs(a[1] - base[1]).max(axis=1)))  # noqa: E731
        assert med(outs) <= 3 * med(run_on_host(libs[twin.name], twin, nudged))


def _without(scene, geometries, plane=True):
    """``scene`` with the fields of ``geometries`` dropped (and the plane
    sunk where ``plane`` is false)."""
    fields = {f: None for g in geometries for f in GEOMETRY[g]}
    if not plane:
        fields["ground_z"] = torch.full_like(scene.ground_z, scene_mod.NO_GROUND_Z)
    return dataclasses.replace(scene, **fields)


@pytest.mark.parametrize("label", MIXED)
def test_states_exercise_the_normal_rule(label):
    """In a share of the envs some active sphere's contact is an earlier
    geometry's, on a slope or a tilted face (n_z < 0.999), while a later
    geometry of the key offers it an active, shallower candidate: there a
    later geometry that reset the normal to +z would keep the winner's
    depth under the plane's normal."""
    kernel, _, inputs = _case(label, False)
    args = list(map(torch.as_tensor, inputs))
    model, margin = kernel.model, kernel.config.contact_margin
    scene, _, _ = kernel.unpack(args[3], args[4], *args[5:])
    fd = forward_kinematics(model, args[0], args[1])
    full = collide(model, fd, scene, margin)
    present = [g for g in GEOMETRY if getattr(scene, f"has_{g}")]
    hazard = torch.zeros_like(full.depth, dtype=torch.bool)
    for i in range(len(present) - 1):
        first = collide(model, fd, _without(scene, present[i + 1:]), margin)
        later = collide(model, fd, _without(scene, present[:i + 1], plane=False), margin)
        won = (first.depth == full.depth) & (first.normal == full.normal).all(dim=2) \
            & (full.normal[..., 2] < 0.999) & (full.active > 0.5)
        hazard |= won & (later.depth > -margin) & (later.depth < full.depth)
    share = float(hazard.any(dim=1).float().mean())
    assert share >= 0.15, share


@pytest.mark.parametrize("llc", [10, 5])
def test_cassie_factor_is_fresh_in_every_llc_frame(llc):
    """Cassie's K1e at ``llc`` frames per call, both builds against the
    plain unit, which makes the factor at each frame's first substep, on
    the per-env medians within ``STALE_GATE`` (a tenth of ``TOL_EQ``'s qd,
    ``TOL_TWIN``'s q)."""
    model = cassie.make_model()
    config = dataclasses.replace(CASSIE_CONFIG, llc_frames=llc)
    kernels = [engine.K1e(model, config, cassie.constraints(), pd_mode=True,
                          extra_damping=model.actuated * model.kd, thread_per_env=tpe)
               for tpe in (False, True)]
    assert kernels[0].instance.source == engine.SOURCE_W
    inputs = chip_smoke.cassie_states(model, cassie.stand_q(model), cassie.initial_z(),
                                      np.random.default_rng(3), False, 64)
    libs = build_host(kernels)
    want = [t.numpy() for t in kernels[0].plain(*map(torch.as_tensor, inputs))]
    for kernel in kernels:
        outs = run_on_host(libs[kernel.name], kernel, inputs)
        for name, g, w in zip(("q", "qd"), outs, want):
            med = float(np.median(np.abs(g - w).max(axis=1)))
            assert med <= STALE_GATE[name], (kernel.name, name, med)


def _jax_scene(scene, b, has_ground):
    """Env ``b`` of a port Scene as the JAX package's."""
    n = lambda x: jnp.asarray(x[b].numpy())  # noqa: E731
    fields = {f: n(getattr(scene, f)) for g in GEOMETRY if getattr(scene, f"has_{g}")
              for f in GEOMETRY[g]}
    return jscene.Scene(has_ground=has_ground, has_stones=scene.has_stones, has_hf=scene.has_hf,
                        has_bars=scene.has_bars, ground_z=n(scene.ground_z),
                        friction=n(scene.friction), **fields)


def test_narrowphase_matches_jax_over_three_geometries():
    """The port's narrowphase over a heightfield window, tilted stones and
    mesh faces (key m's states) against the JAX package's, per sphere within
    the margin: the same active set, depth within 2e-6, point within 2e-5,
    normal within 2e-5 on 99% of them and 2e-3 on all (a center within
    millimetres of a tile takes its normal from that short offset, which
    the two round apart)."""
    kernel, _, inputs = _case("m_hf_stones_mesh", False)
    args = list(map(torch.as_tensor, inputs))
    model = kernel.model
    scene, _, _ = kernel.unpack(args[3], args[4], *args[5:])
    got = collide(model, forward_kinematics(model, args[0], args[1]), scene, 0.02)
    jm = jwalker.make_model()
    stacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                                     *[_jax_scene(scene, b, False) for b in range(B)])
    want = jax.vmap(lambda q, qd, sc: jcollide(jm, jfk(jm, q, qd), sc, 0.02))(
        jnp.asarray(inputs[0]), jnp.asarray(inputs[1]), stacked)
    near = got.active.numpy() > 0.5
    assert near.mean() > 0.2
    np.testing.assert_array_equal(near, np.asarray(want.active) > 0.5)
    err = {name: np.abs(getattr(got, name).numpy() - np.asarray(getattr(want, name)))[near]
           for name in ("depth", "normal", "pos")}
    assert err["depth"].max() <= 2e-6 and err["pos"].max() <= 2e-5, err
    normal = err["normal"].max(axis=1)
    assert (normal <= 2e-5).mean() >= 0.99 and normal.max() <= 2e-3, normal.max()
    # slopes and tilted faces win most of them
    assert (got.normal[..., 2].numpy()[near] < 0.999).mean() > 0.3


def _to_port(js):
    n = np.asarray
    sc = js.scene
    return convert.env_state_from_numpy(
        q=n(js.q), qd=n(js.qd), steps=n(js.steps), reset_count=n(js.reset_count),
        done=n(js.done), blowup_count=n(js.blowup_count), target=n(js.task.target),
        potential=n(js.task.potential), ground_z=n(sc.ground_z), friction=n(sc.friction),
        **{f: n(getattr(sc, f)) for f in scene_mod.TRI_FIELDS})


def test_pd_stairs_env_matches_jax(libs):
    """``make("Walker3DStairsEnv", pd_control=True)`` in both packages:
    from the JAX package's fresh episodes, half of them raised onto the
    treads, the port re-synced from the JAX state each step, 8 steps of the
    same random actions at B = 8. Done flags equal, rewards and
    observations within 1e-4 on the per-env median and 1e-3 on the largest
    env of those with no riser contact (tests/test_torch_stairs_env.py's
    gates). Each step's physics is key a's unit: the JAX control step
    inside it (PD targets, the derivative gain as extra damping, over the
    culled staircase) holds the port's plain unit and key a's warp build on
    the same inputs at K1g's gate in the envs that did not end."""
    ident = "Walker3DStairsEnv-v0"
    jenv = mocca_envs_tpu.make(ident, pd_control=True)
    penv = mocca_envs_tpu_torch.make(ident, device="cpu", pd_control=True)
    n = 8
    js = jax.jit(jax.vmap(jenv.init))(jrng.env_keys(jrng.root_key(0), n))
    q = np.array(js.q)
    k = np.arange(n) % 4
    q[4:, 0] = 0.6 + 0.35 * k[4:] + 0.12
    q[4:, 2] += 0.12 * (k[4:] + 1)
    target = np.zeros((n, 3), np.float32)
    target[:, :2] = q[:, :2]
    target[:, 0] += 3.0
    dist = np.linalg.norm(target[:, :2] - q[:, :2], axis=1)
    js = js.replace(q=jnp.asarray(q), task=js.task.replace(
        target=jnp.asarray(target), potential=jnp.asarray(-dist / jenv.control_dt)))
    jstep = jax.jit(jax.vmap(jenv.step))
    model = penv.model
    kernel = engine.make_kernel(model, EngineConfig(), num_tris=16, pd_mode=True,
                                extra_damping=model.kp / 20.0)
    assert kernel.variant == "k1_llc1_kt16" and kernel.instance.source == engine.SOURCE_W
    lib = libs[kernel.name]
    mid, amp = 0.5 * (model.limit_lo + model.limit_hi), 0.5 * (model.limit_hi - model.limit_lo)
    gen = trng.generator(0, "cpu")
    rng = np.random.default_rng(0)
    loaded = 0.0
    for t in range(8):
        a = rng.uniform(-1, 1, (n, jenv.act_dim)).astype(np.float32)
        ps = _to_port(js)
        jtr = jstep(js, jnp.asarray(a))
        ptr = penv.step(ps, torch.as_tensor(a), gen)
        jdone = np.array(jtr.done)
        np.testing.assert_array_equal(ptr.done.numpy(), jdone, err_msg=f"step {t}")
        window = scene_mod.cull_tris(ps.scene, ps.q[:, 0:2], 16)
        unit = [ps.q, ps.qd, mid + amp * torch.clamp(torch.as_tensor(a), -1, 1),
                window.ground_z, window.friction, engine.pack_tris(window)]
        vertical = chip_smoke.vertical_contacts(kernel, unit).numpy()
        r_err = np.abs(ptr.reward.numpy() - np.asarray(jtr.reward))
        assert np.median(r_err) <= 1e-4 and r_err[~vertical].max() <= 1e-3, (t, r_err)
        live = ~jdone
        per_env = np.abs(ptr.obs.numpy() - np.asarray(jtr.obs)).max(axis=1)
        assert np.median(per_env[live]) <= 1e-4, (t, per_env)
        assert per_env[live & ~vertical].max() <= 1e-3, (t, per_env, vertical)
        # the control step: the JAX package's against the plain unit and the
        # warp build on the same inputs, where the episode goes on
        want = [np.asarray(jtr.state.q), np.asarray(jtr.state.qd)]
        plain = [x.numpy() for x in kernel.plain(*unit)]
        built = run_on_host(lib, kernel, [np.ascontiguousarray(x.numpy()) for x in unit])
        for got in (plain, built):
            _gate([g[live] for g in got[:2]], [w[live] for w in want], chip_smoke.TOL,
                  ~vertical[live], names=("q", "qd"))
        loaded += float((plain[3] > 0).mean()) / 8
        js = jtr.state
    assert loaded > 0.0   # contacts carry load
    # the treads carry the raised bodies
    assert (scene_mod.tri_surface_z(ps.scene, ps.q[:, 0:2]).numpy()[4:] > 0.1).any()


def test_walker_over_stones_and_faces_resets_and_steps():
    """``make("Walker3DCustomEnv", scene_builder=...)`` over the staircase
    and six tilted boxes (chip_smoke.py::stairs_scene), the key i entry
    path: every slot views the one static scene, a fresh episode keeps its
    slot's, the control step's kernel key is stones 6 + faces 16, and the
    fall test measures the base over the faces under it (the JAX task's
    surface rule: the heightfield, else the faces, else the plane)."""
    env = mocca_envs_tpu_torch.make("Walker3DCustomEnv-v0", device="cpu",
                                    scene_builder=lambda device: chip_smoke.stairs_scene(
                                        device, boxes=True))
    batch = mocca_envs_tpu_torch.BatchedEnv(env, 8, seed=0, device="cpu")
    state = batch.init()
    scene = state.scene
    assert scene.has_stones and scene.has_tris and not scene.has_hf
    assert scene.stone_pos.shape == (8, 6, 3) and scene.tri_a.shape == (8, 24, 3)
    assert scene.stone_pos.stride(0) == 0 and scene.tri_a.stride(0) == 0
    kernel = engine.make_kernel(env.model, EngineConfig(), num_stones=6, num_tris=16)
    assert kernel.variant == "k1_k6_kt16" and kernel.key.stones == 6
    rng = np.random.default_rng(0)
    for _ in range(12):
        tr = batch.step(state, torch.as_tensor(rng.uniform(-1, 1, (8, env.act_dim)),
                                               dtype=torch.float32))
        state = tr.state
        assert torch.isfinite(state.q).all() and torch.isfinite(tr.reward).all()
        assert state.scene.stone_pos.data_ptr() == scene.stone_pos.data_ptr()
        assert state.scene.tri_a.data_ptr() == scene.tri_a.data_ptr()
    # a base 0.75 m high over the second tread (0.24 m) stands 0.51 m over
    # its surface, under the 0.7 m fall height: the episode ends
    q = state.q.clone()
    q[:, 0:3] = torch.tensor([1.2, 0.0, 0.75])
    over = scene_mod.tri_surface_z(scene, q[:, 0:2])
    torch.testing.assert_close(over, torch.full((8,), 0.24), atol=1e-6, rtol=0)
    step = env.step_no_reset(dataclasses.replace(state, q=q, qd=torch.zeros_like(state.qd)),
                             torch.zeros(8, env.act_dim), batch.generator)
    assert step.done.all()
