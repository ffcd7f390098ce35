"""K1h-si and K1d redesigned for Hopper (``csrc/engine_k1w.cu``, one warp per
env): the walker's frame on the plane with split impulse, and the monkey's
frame over its 16 bar capsules with its two grab rows, on the CPU. The
warp-per-env source's per-env code is built by g++ under
``-DK1W_HOST_CHECK`` (lane width 1, the collectives identities) and run as
a loop over envs, beside the thread-per-env twins (``-DK1_HOST_CHECK``: the
named ``engine_k1.cu`` instances ``k1h_..._si`` and ``k1d_..._kb16_ng2``) and
K1a's warp-per-env instance, the five built side by side once per module.

- The keys pick the warp-per-env instances (``K1W_ONLY`` 13 / 14), as
  ``make`` builds them for the walker and the child with split impulse and
  for the monkey; ``thread_per_env=True`` picks the twin. The monkey's split
  key K1h-d picks its own warp-per-env instance (``K1W_ONLY`` 15,
  tests/test_torch_k1w_split_monkey_planar.py).
- At B = 16 on chip_smoke.py's states (the walker near contact; the monkey
  hanging from its bars in the four mixes of
  tests/test_torch_kernel_wrapper.py::K1D_CASES: the main path's, both
  hands, none, and no bar near the feet or the torso), and with every base
  lifted 3 m, against the port's plain unit at the chip gate (``TOL``; the
  monkey's ``TOL_GRAB`` with the 99th percentile as the tail, as
  chip_smoke.py holds K1d), and against the twin's host build at
  ``TOL_TWIN``; near contact the twins' per-env median of |Δq̇| lies within
  three times the median by which the twin parts from itself when q̇ is
  nudged by 1e-7 (relative, numpy seed 0), the chip's ``rounding_floor``.
- K1h-si against K1a's warp-per-env build: bit for bit where every
  push-out bias is 0 (every base lifted 3 m, every joint inside its
  limits), parting by more than the plain gate near contact.
- A grab that is not attached is masked out: moving its target changes
  nothing, bit for bit. A palm flagged ``no_bar`` ignores a bar through its
  center, bit for bit, where the torso would not.
- The bar narrowphase (the sphere-bar pairs over the lanes, each sphere's
  deepest active bar then picked in index order): an inactive bar through
  the torso changes nothing, bit for bit; of two bars through it, the
  deeper one decides, in either order, bit for bit as if it were alone.
- The monkey's entry refuses a null ``bars`` or ``grabs`` and writes
  nothing.

The JAX package's monkey control step is held against the warp-per-env
host build in tests/test_torch_monkey_step.py.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import mocca_envs_tpu_torch
from mocca_envs_tpu_torch.models import monkey, walker3d
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.utils.config import EngineConfig

from tests import torch_workers  # noqa: F401
from tests.torch_k1_host import build_host, run_on_host

TOL = chip_smoke.TOL
TOL_GRAB = chip_smoke.TOL_GRAB
TOL_TWIN = chip_smoke.TOL_TWIN
B = 16
SPLIT = EngineConfig(split_impulse=True)
SYMBOL = {"walker_split": "k1w_nl22_ns14_nlim21_sub4_it4_si",
          "monkey": "k1w_nl11_ns5_nlim8_sub4_it4_kb16_ng2"}
ONLY = {"walker_split": 13, "monkey": 14}
TWIN = {"walker_split": ("k1h_nl22_ns14_nlim21_sub4_it4_si", 10),
        "monkey": ("k1d_nl11_ns5_nlim8_sub4_it4_kb16_ng2", 7)}
# the monkey's state mixes, as tests/test_torch_kernel_wrapper.py's K1D_CASES
MIXES = {"main_mix": {}, "both_hands": {"left": 1.0}, "no_hands": {"left": 0.0, "right": 0.0},
         "no_bar_contact": {"near_bar": 0.0}}
CASES = [("walker_split", "near_contact"), *(("monkey", m) for m in MIXES)]
LIFT = pytest.mark.parametrize("lifted", [False, True], ids=["near_contact", "lifted"])


def _kernel(kind, thread_per_env=False):
    if kind == "walker_split":
        return engine.K1hSi(walker3d.make_model(), SPLIT, thread_per_env=thread_per_env)
    return engine.K1d(monkey.make_model(), EngineConfig(), monkey.constraints(), 16,
                      thread_per_env=thread_per_env)


@pytest.fixture(scope="module")
def libs():
    """The two warp-per-env instances, their twins and K1a's warp-per-env
    instance built by g++, side by side."""
    kernels = [_kernel(kind, tpe) for kind in SYMBOL for tpe in (False, True)]
    kernels.append(engine.K1a(walker3d.make_model(), EngineConfig()))
    return build_host(kernels)


def _states(kind, mix="main_mix", batch=B, lifted=False):
    """Numpy ``(q, qd, tau, ground_z, friction[, bars, grabs])`` of
    chip_smoke.py's walker or monkey states; ``lifted`` raises every base
    3 m (the packed bars and grab targets stay)."""
    if kind == "walker_split":
        arrays = chip_smoke.near_contact_states(walker3d.make_model(),
                                                np.random.default_rng(75), batch)
    else:
        arrays = chip_smoke.monkey_states(monkey.make_model(), np.random.default_rng(77), batch,
                                          **MIXES[mix])
    arrays = [np.ascontiguousarray(x) for x in arrays]
    if lifted:
        arrays[0][:, 2] += 3.0
    return arrays


def _gate(got, want, tol, tail="max"):
    """Per-env medians of the max |Δ| within ``tol``, the largest env (or the
    99th percentile) within ten times."""
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        per_env = np.abs(g - w).max(axis=1)
        worst = np.quantile(per_env, 0.99) if tail == "p99" else per_env.max()
        assert np.median(per_env) <= tol[name], (name, float(np.median(per_env)))
        assert worst <= 10 * tol[name], (name, tail, float(worst))


def _plain_gate(kind):
    return (TOL, "max") if kind == "walker_split" else (TOL_GRAB, "p99")


@pytest.mark.parametrize("kind", list(SYMBOL))
def test_keys_pick_the_warp_per_env_instance(libs, kind):
    new, old = _kernel(kind), _kernel(kind, thread_per_env=True)
    assert new.name == SYMBOL[kind] and new.instance.source == engine.SOURCE_W
    assert engine.compile_flags(new.instance) == [f"-DK1W_ONLY={ONLY[kind]}"]
    assert engine.WARP_INSTANCES[new.key] is new.instance
    assert (old.name, old.instance.index) == TWIN[kind] and old.instance.source == engine.SOURCE
    assert new.key == old.key and new.variant == old.variant == (
        "k1h_si" if kind == "walker_split" else "k1d")
    # each family's model as make() builds its unit
    if kind == "walker_split":
        for env_id in ("Walker3DCustomEnv-v0", "Child3DCustomEnv-v0"):
            model = mocca_envs_tpu_torch.make(env_id, device="cpu").model
            picked = engine.make_kernel(model, dataclasses.replace(EngineConfig(),
                                                                   split_impulse=True))
            assert type(picked) is engine.K1hSi and picked.name == new.name, env_id
    else:
        model = mocca_envs_tpu_torch.make("Monkey3DStepperEnv-v0", device="cpu").model
        picked = engine.make_kernel(model, EngineConfig(), num_bars=16,
                                    constraints=monkey.constraints())
        assert type(picked) is engine.K1d and picked.name == new.name
        # the monkey's split key picks its own warp-per-env instance
        split = engine.make_kernel(model, SPLIT, num_bars=16, constraints=monkey.constraints())
        assert split.variant == "k1h_d" and split.instance.source == engine.SOURCE_W
        assert (split.name, split.instance.index) == ("k1w_nl11_ns5_nlim8_sub4_it4_kb16_ng2_si",
                                                      15)
    # the same table; no global workspace
    assert engine.layout(libs[new.name], new.name) == (new.table_host.size, 0)
    assert new.table_host.size == old.table_host.size
    assert engine.layout(libs[old.name], old.name)[1] > 0


@pytest.mark.parametrize("kind, mix", CASES)
@LIFT
def test_k1w_matches_plain_and_thread_per_env_on_host(libs, kind, mix, lifted):
    """Both designs against the plain unit at the chip gate, and the two
    designs against each other at ``TOL_TWIN``, within the rounding floor
    near contact with a hand attached."""
    new, old = _kernel(kind), _kernel(kind, thread_per_env=True)
    inputs = _states(kind, mix, lifted=lifted)
    want = [t.numpy() for t in new.plain(*map(torch.as_tensor, inputs))]
    outs = run_on_host(libs[new.name], new, inputs)
    base = run_on_host(libs[old.name], old, inputs)
    for got in (outs, base):
        assert all(np.isfinite(o).all() for o in got)
        _gate(got, want, *_plain_gate(kind))
    _gate(outs, base, TOL_TWIN)
    if lifted:
        assert (want[3] == 0).all() and (outs[3] == 0).all()
    else:
        assert ((want[3] > 0).mean() > 0.05) != (mix == "no_bar_contact")   # contacts carry load
    if not lifted and mix != "no_hands":
        # the twins part by rounding, as far as a 1e-7 nudge of q̇ parts
        # the twin from itself (a free body, no hand attached, parts by a few
        # ulp of q̇, far within TOL_TWIN, where the nudge moves it by one)
        nudged = list(inputs)
        noise = np.random.default_rng(0).standard_normal(inputs[1].shape)
        nudged[1] = (inputs[1] * (1 + 1e-7 * noise)).astype(np.float32)
        med = lambda a: float(np.median(np.abs(a[1] - base[1]).max(axis=1)))  # noqa: E731
        twin, floor = med(outs), med(run_on_host(libs[old.name], old, nudged))
        assert twin <= 3 * floor, (twin, floor)
    if kind == "monkey" and not lifted:
        # the grab rows hold the attached palms on their anchors
        attached, target = (x.numpy() for x in engine.unpack_grabs(torch.as_tensor(inputs[6])))
        palms = monkey_palms(outs[0])
        gap = np.linalg.norm(palms - target, axis=2)
        if (attached > 0.5).any():
            assert np.median(gap[attached > 0.5]) < 0.01
        if (attached < 0.5).any():
            assert np.median(gap[attached < 0.5]) > 0.015


def monkey_palms(q):
    """The monkey's two palm points (B, 2, 3) at poses ``q`` (numpy)."""
    from mocca_envs_tpu_torch.tasks.monkey_stepper import make_palm_positions

    return make_palm_positions(monkey.make_model(), monkey.constraints())(
        torch.as_tensor(q)).numpy()


def test_k1h_si_equals_k1a_where_every_bias_is_zero(libs):
    new, k1a = _kernel("walker_split"), engine.K1a(walker3d.make_model(), EngineConfig())
    inputs = _states("walker_split", lifted=True)
    model = new.model
    lo, hi = model.limit_lo.numpy(), model.limit_hi.numpy()
    inputs[0][:, 7:] = np.clip(inputs[0][:, 7:], lo + 0.05, hi - 0.05)
    _, con_act, _ = engine.k1_activity(new, *map(torch.as_tensor, inputs))
    assert not con_act.any()   # no contact row in any of the 4 substeps
    for got, want in zip(run_on_host(libs[new.name], new, inputs),
                         run_on_host(libs[k1a.name], k1a, inputs)):
        np.testing.assert_array_equal(got, want)
    # near contact the position pass moves the frame beyond the plain gate
    inputs = _states("walker_split")
    outs = run_on_host(libs[new.name], new, inputs)
    ref = run_on_host(libs[k1a.name], k1a, inputs)
    for name, i in (("q", 0), ("qd", 1)):
        med = float(np.median(np.abs(outs[i] - ref[i]).max(axis=1)))
        assert med > TOL[name], (name, med)


def test_k1d_inactive_grab_target_changes_nothing(libs):
    """The left hand is free in about half of the envs: moving its target
    there moves nothing; moving it where the hand is attached does."""
    new = _kernel("monkey")
    inputs = _states("monkey")
    grabs = inputs[6]
    free = grabs[4] < 0.5                       # grab 1's activity row
    assert 0 < free.sum() < B
    moved = list(inputs)
    moved[6] = grabs.copy()
    moved[6][5:8, free] += 0.5                  # grab 1's target rows
    for got, want in zip(run_on_host(libs[new.name], new, moved),
                         run_on_host(libs[new.name], new, inputs)):
        np.testing.assert_array_equal(got, want)
    moved[6][5:8] = grabs[5:8] + 0.5
    got = run_on_host(libs[new.name], new, moved)[0]
    want = run_on_host(libs[new.name], new, inputs)[0]
    assert np.abs(got - want).max(axis=1)[~free].min() > 1e-4


def _sphere_centers(model, q):
    """(B, NS, 3) numpy sphere centers at poses ``q``."""
    from mocca_envs_tpu_torch.ops.collide import sphere_centers
    from mocca_envs_tpu_torch.ops.kinematics import forward_kinematics

    return sphere_centers(model, forward_kinematics(
        model, torch.as_tensor(q), torch.zeros(q.shape[0], model.nv))).numpy()


def _bar_through(bars, center, k, below, active=1.0):
    """``bars`` (8·KB, B) with bar ``k`` along x through ``center`` (B, 3),
    ``below`` m under it."""
    bars[8 * k:8 * k + 3] = (center - [0.3, 0.0, below]).T
    bars[8 * k + 3:8 * k + 6] = (center + [0.3, 0.0, -below]).T
    bars[8 * k + 7] = active
    return bars


def test_k1d_no_bar_palm_ignores_a_bar_through_it(libs):
    """Bar 15 moved through a palm's sphere, 1 cm under its center, changes
    no motion, no impulse and not the palm's depth (the palm is flagged
    no_bar; the other spheres' depths report their nearest bar, which was
    bar 15); through the torso's sphere it makes a contact that moves the
    body."""
    new = _kernel("monkey")
    model = new.model
    inputs = _states("monkey", mix="no_bar_contact")
    centers = _sphere_centers(model, inputs[0])
    no_bar = model.sph_no_bar.numpy() > 0.5
    palm, torso = int(np.flatnonzero(no_bar)[0]), int(np.flatnonzero(~no_bar)[0])
    ref = run_on_host(libs[new.name], new, inputs)
    for s, ignored in ((palm, True), (torso, False)):
        moved = list(inputs)
        moved[5] = _bar_through(inputs[5].copy(), centers[:, s], 15, 0.01)
        got = run_on_host(libs[new.name], new, moved)
        want = [t.numpy() for t in new.plain(*map(torch.as_tensor, moved))]
        _gate(got, want, TOL_GRAB, "p99")
        if ignored:
            for i in (0, 1, 3):
                np.testing.assert_array_equal(got[i], ref[i])
            np.testing.assert_array_equal(got[2][:, s], ref[2][:, s])
        else:
            # in contact in every env, and pushed: the motion parts from the
            # reference's
            assert (got[2][:, s] > 0).all() and (got[3][:, s] > 0).any()
            assert np.median(np.abs(got[0] - ref[0]).max(axis=1)) > 1e-2


@pytest.mark.parametrize("case", ["inactive", "deeper_first", "deeper_second"])
def test_k1d_bars_through_the_torso(libs, case):
    """The pairs' pick of each sphere's bar. An inactive bar 15 through the
    torso's sphere changes nothing, bit for bit. Bars 14 and 15 both through
    it, 1 cm and 3 cm under its center in either order: the deeper (nearer)
    bar decides the motion, the impulses and the torso's depth, bit for bit
    as if it were the only one moved (the other spheres' depths report
    their nearest bar, which may be the other), and the frame meets the
    plain unit's."""
    new = _kernel("monkey")
    model = new.model
    inputs = _states("monkey", mix="no_bar_contact")
    torso = int(np.flatnonzero(model.sph_no_bar.numpy() < 0.5)[0])
    center = _sphere_centers(model, inputs[0])[:, torso]
    run = lambda bars: run_on_host(libs[new.name], new, [*inputs[:5], bars, inputs[6]])  # noqa: E731
    if case == "inactive":
        want = run_on_host(libs[new.name], new, inputs)
        got = run(_bar_through(inputs[5].copy(), center, 15, 0.01, active=0.0))
    else:
        near, far = (14, 15) if case == "deeper_first" else (15, 14)
        both = _bar_through(_bar_through(inputs[5].copy(), center, near, 0.01), center, far, 0.03)
        got = run(both)
        want = run(_bar_through(inputs[5].copy(), center, near, 0.01))
        plain = [t.numpy() for t in new.plain(*map(torch.as_tensor, [*inputs[:5], both,
                                                                      inputs[6]]))]
        _gate(got, plain, TOL_GRAB, "p99")
        assert (got[2][:, torso] > 0).all()
        got[2], want[2] = got[2][:, torso], want[2][:, torso]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("missing", [5, 6], ids=["bars", "grabs"])
def test_k1d_refuses_null_scene_inputs(libs, missing):
    """The monkey's entry refuses a null bars or grabs pointer and writes
    nothing."""
    new = _kernel("monkey")
    inputs = _states("monkey", batch=2)
    table_size, _ = engine.layout(libs[new.name], new.name)
    m = new.model
    outs = [np.full((2, n), 7.0, np.float32) for n in (m.nq, m.nv, m.ns, m.ns)]
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    scene = [None, ptr(inputs[5]), ptr(inputs[6]), None, None]
    scene[missing - 4] = None
    fn = getattr(libs[new.name], new.name + "_host")
    fn.restype = ctypes.c_int
    err = fn(*map(ptr, inputs[:5]), *scene, *map(ptr, outs), ptr(new.table_host),
             ctypes.c_int(table_size), None, ctypes.c_int(2))
    assert err != 0 and all((o == 7.0).all() for o in outs)
    # with both the same entry runs
    assert run_on_host(libs[new.name], new, inputs)[0].shape == (2, m.nq)
