"""K1h-d and the planar K1e redesigned for Hopper (``csrc/engine_k1w.cu``,
one warp per env): the monkey's frame over its 16 bars with its two grab rows
and split impulse, and Walker2D's and Crab2D's torque frame with the planar
lock, on the CPU. The warp-per-env source's per-env code is built by g++
under ``-DK1W_HOST_CHECK`` (lane width 1, the collectives identities) and run
as a loop over envs, beside the thread-per-env twins (``-DK1_HOST_CHECK``:
the named ``engine_k1.cu`` instances ``k1h_..._kb16_ng2_si`` and
``k1e_nl7_..._planar``) and K1d's warp-per-env instance.

- The keys pick the warp-per-env instances (``K1W_ONLY`` 15 / 16), as
  ``make`` builds them for the monkey with split impulse and for Walker2D
  and Crab2D; ``thread_per_env=True`` picks the twins.
- At B = 16 on chip_smoke.py's states (the monkey hanging from its bars in
  the four mixes of tests/test_torch_kernel_wrapper.py::K1D_CASES; Walker2D
  and Crab2D near contact, a little out of their plane), and with every
  base lifted 3 m, against the port's plain unit at the chip gate (K1h-d's
  ``TOL_GRAB`` with the 99th percentile as the tail, as chip_smoke.py holds
  it; the planar K1e's ``TOL_EQ``) and against the twin's host build at
  ``TOL_TWIN``; near contact with a hand attached the twins' per-env median
  of |Δq̇| lies within three times the median by which the twin parts from
  itself when q̇ is nudged by 1e-7 (relative, numpy seed 0), the chip's
  ``rounding_floor``.
- K1h-d against K1d's warp-per-env build: bit for bit where every push-out
  bias is 0 (every base lifted 3 m clear of every bar, every joint inside
  its limits, the grabs as drawn), parting by more than the plain gate near
  the bars.
- A grab that is not attached is masked out of K1h-d: moving its target
  changes nothing, bit for bit. The position pass starts behind the listed
  equality rows (3 per attached grab): a pass that started at the first
  grab row or behind both grabs' rows, whatever is attached, fails the twin
  and plain gates above with one hand attached.
- The planar walker stays in its plane through the warp build: over 10
  frames of random torques from a drift out of the plane, the lock's rates
  (ẏ, ω_x, ω_z) stay within ``max_push_vel`` and its measures (y, 2(wx+yz),
  2(wz+xy)) shrink.

The JAX package's split monkey step is held against the K1h-d host build in
tests/test_torch_split_families.py, its Walker2D and Crab2D steps against
the planar K1e host build in tests/test_torch_planar_env.py.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import mocca_envs_tpu_torch
from mocca_envs_tpu_torch.models import monkey, walker2d
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.utils.config import EngineConfig

from tests import torch_workers  # noqa: F401
from tests.torch_k1_host import build_host, run_on_host

TOL_GRAB = chip_smoke.TOL_GRAB
TOL_EQ = chip_smoke.TOL_EQ
TOL_TWIN = chip_smoke.TOL_TWIN
B = 16
SPLIT = EngineConfig(split_impulse=True)
SYMBOL = {"monkey_split": "k1w_nl11_ns5_nlim8_sub4_it4_kb16_ng2_si",
          "planar": "k1w_nl7_ns5_nlim6_sub4_it4_planar"}
ONLY = {"monkey_split": 15, "planar": 16}
TWIN = {"monkey_split": ("k1h_nl11_ns5_nlim8_sub4_it4_kb16_ng2_si", 14),
        "planar": ("k1e_nl7_ns5_nlim6_sub4_it4_planar", 6)}
# the monkey's state mixes, as tests/test_torch_kernel_wrapper.py's K1D_CASES
MIXES = {"main_mix": {}, "both_hands": {"left": 1.0}, "no_hands": {"left": 0.0, "right": 0.0},
         "no_bar_contact": {"near_bar": 0.0}}
# ... and a bar by each foot and the torso in every env
NEAR_BARS = {"near_bar": 1.0}
# the planar models and their stand heights (chip_smoke.py's)
PLANAR = {"walker2d": (walker2d.make_walker2d, 1.22), "crab2d": (walker2d.make_crab2d, 0.42)}
CASES = [*(("monkey_split", m) for m in MIXES), *(("planar", m) for m in PLANAR)]
LIFT = pytest.mark.parametrize("lifted", [False, True], ids=["near_contact", "lifted"])


def _kernel(kind, thread_per_env=False, model=None):
    if kind == "monkey_split":
        return engine.K1d(monkey.make_model(), SPLIT, monkey.constraints(), 16,
                          thread_per_env=thread_per_env)
    return engine.K1e(model or walker2d.make_walker2d(), EngineConfig(), walker2d.planar_spec(),
                      thread_per_env=thread_per_env)


def _k1d():
    return engine.K1d(monkey.make_model(), EngineConfig(), monkey.constraints(), 16)


@pytest.fixture(scope="module")
def libs():
    """The two warp-per-env instances, their twins and K1d's warp-per-env
    instance built by g++, side by side (Crab2D shares Walker2D's)."""
    return build_host([*(_kernel(kind, tpe) for kind in SYMBOL for tpe in (False, True)),
                       _k1d()])


def _states(kind, mix, batch=B, lifted=False):
    """(kernel, numpy ``(q, qd, tau, ground_z, friction[, bars, grabs])``) of
    chip_smoke.py's monkey or planar states; ``lifted`` raises every base 3 m
    (the packed bars and grab targets stay)."""
    if kind == "monkey_split":
        kernel = _kernel(kind)
        arrays = chip_smoke.monkey_states(monkey.make_model(), np.random.default_rng(77), batch,
                                          **(NEAR_BARS if mix == "near_bars" else MIXES[mix]))
    else:
        make, stand_z = PLANAR[mix]
        kernel = _kernel(kind, model=make())
        arrays = chip_smoke.planar_walker_states(kernel.model, stand_z,
                                                 np.random.default_rng(81), batch)
    arrays = [np.ascontiguousarray(x) for x in arrays]
    if lifted:
        arrays[0][:, 2] += 3.0
    return kernel, arrays


def _gate(got, want, tol, tail="max"):
    """Per-env medians of the max |Δ| within ``tol``, the largest env (or the
    99th percentile) within ten times."""
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        per_env = np.abs(g - w).max(axis=1)
        worst = np.quantile(per_env, 0.99) if tail == "p99" else per_env.max()
        assert np.median(per_env) <= tol[name], (name, float(np.median(per_env)))
        assert worst <= 10 * tol[name], (name, tail, float(worst))


def _plain_gate(kind):
    return (TOL_GRAB, "p99") if kind == "monkey_split" else (TOL_EQ, "max")


@pytest.mark.parametrize("kind", list(SYMBOL))
def test_keys_pick_the_warp_per_env_instance(libs, kind):
    new, old = _kernel(kind), _kernel(kind, thread_per_env=True)
    assert new.name == SYMBOL[kind] and new.instance.source == engine.SOURCE_W
    assert engine.compile_flags(new.instance) == [f"-DK1W_ONLY={ONLY[kind]}"]
    assert engine.WARP_INSTANCES[new.key] is new.instance
    assert (old.name, old.instance.index) == TWIN[kind] and old.instance.source == engine.SOURCE
    assert new.key == old.key and new.variant == old.variant == (
        "k1h_d" if kind == "monkey_split" else "k1e")
    # each family's model as make() builds its unit
    if kind == "monkey_split":
        model = mocca_envs_tpu_torch.make("Monkey3DStepperEnv-v0", device="cpu").model
        picked = engine.make_kernel(model, SPLIT, num_bars=16, constraints=monkey.constraints())
        assert type(picked) is engine.K1d and picked.name == new.name
    else:
        for env_id in ("Walker2DCustomEnv-v0", "Crab2DCustomEnv-v0"):
            model = mocca_envs_tpu_torch.make(env_id, device="cpu").model
            picked = engine.make_kernel(model, EngineConfig(), constraints=walker2d.planar_spec())
            assert type(picked) is engine.K1e and picked.name == new.name, env_id
        # the planar split key runs its own warp-per-env instance
        split = engine.K1e(walker2d.make_walker2d(), SPLIT, walker2d.planar_spec())
        assert split.instance is engine.WARP_INSTANCES[split.key]
        assert split.name == "k1w_nl7_ns5_nlim6_sub4_it4_planar_si"
    # the same table; no global workspace
    assert engine.layout(libs[new.name], new.name) == (new.table_host.size, 0)
    assert new.table_host.size == old.table_host.size
    assert engine.layout(libs[old.name], old.name)[1] > 0


@pytest.mark.parametrize("kind, mix", CASES)
@LIFT
def test_k1w_matches_plain_and_thread_per_env_on_host(libs, kind, mix, lifted):
    """Both designs against the plain unit at the chip gate, and the two
    designs against each other at ``TOL_TWIN``, within the rounding floor
    near contact (the monkey's with a hand attached)."""
    new, inputs = _states(kind, mix, lifted=lifted)
    old = _kernel(kind, thread_per_env=True, model=new.model)
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
        # the twin from itself
        nudged = list(inputs)
        noise = np.random.default_rng(0).standard_normal(inputs[1].shape)
        nudged[1] = (inputs[1] * (1 + 1e-7 * noise)).astype(np.float32)
        med = lambda a: float(np.median(np.abs(a[1] - base[1]).max(axis=1)))  # noqa: E731
        twin, floor = med(outs), med(run_on_host(libs[old.name], old, nudged))
        assert twin <= 3 * floor, (twin, floor)


def _clear_of_every_bias(kernel, inputs):
    """``inputs`` with every base lifted 3 m and every joint 0.05 rad inside
    its limits: no contact row and no push-out bias in any substep."""
    lo, hi = kernel.model.limit_lo.numpy(), kernel.model.limit_hi.numpy()
    inputs[0][:, 2] += 3.0
    inputs[0][:, 7:] = np.clip(inputs[0][:, 7:], lo + 0.05, hi - 0.05)
    _, con_act, _ = engine.k1_activity(kernel, *map(torch.as_tensor, inputs))
    assert not con_act.any()
    return inputs


def test_k1h_d_equals_k1d_where_every_bias_is_zero(libs):
    new, inputs = _states("monkey_split", "main_mix")
    k1d = _k1d()
    inputs = _clear_of_every_bias(new, inputs)
    grabs = inputs[6]
    assert 0 < (grabs[4] > 0.5).sum() < B        # the grabs as drawn: one hand or two
    outs = run_on_host(libs[new.name], new, inputs)
    for got, want in zip(outs, run_on_host(libs[k1d.name], k1d, inputs)):
        np.testing.assert_array_equal(got, want)
    assert not (outs[3] != 0).any()
    # near the bars (one by each foot and the torso in every env) the
    # position pass moves the frame beyond the plain gate
    _, inputs = _states("monkey_split", "near_bars")
    outs = run_on_host(libs[new.name], new, inputs)
    ref = run_on_host(libs[k1d.name], k1d, inputs)
    for name, i in (("q", 0), ("qd", 1)):
        med = float(np.median(np.abs(outs[i] - ref[i]).max(axis=1)))
        assert med > TOL_GRAB[name], (name, med)


def test_k1h_d_inactive_grab_target_changes_nothing(libs):
    """The left hand is free in about half of the envs: moving its target
    there moves nothing; moving it where the hand is attached does."""
    new, inputs = _states("monkey_split", "main_mix")
    grabs = inputs[6]
    free = grabs[4] < 0.5                       # grab 1's activity row
    assert 0 < free.sum() < B
    moved = list(inputs)
    moved[6] = grabs.copy()
    moved[6][5:8, free] += 0.5                  # grab 1's target rows
    ref = run_on_host(libs[new.name], new, inputs)
    for got, want in zip(run_on_host(libs[new.name], new, moved), ref):
        np.testing.assert_array_equal(got, want)
    moved[6][5:8] = grabs[5:8] + 0.5
    got = run_on_host(libs[new.name], new, moved)[0]
    assert np.abs(got - ref[0]).max(axis=1)[~free].min() > 1e-4


@pytest.mark.parametrize("mix", list(PLANAR))
def test_planar_k1e_holds_the_plane_on_host(libs, mix):
    """10 frames of random torques from a drift out of the plane (y ±1 cm,
    roll and yaw ±0.02 rad) through the warp build: the lock's rates stay
    within max_push_vel in every env and frame, and its measures shrink."""
    kernel, inputs = _states("planar", mix)
    rng = np.random.default_rng(83)
    q = inputs[0]
    q[:, 1] = rng.uniform(-0.01, 0.01, B)
    half = rng.uniform(-0.01, 0.01, (B, 2))
    q[:, 4], q[:, 6] = half[:, 0], half[:, 1]     # roll and yaw quaternion parts
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)

    def drift(q):
        w, x, y, z = q[:, 3:7].T
        return np.abs(np.stack([q[:, 1], 2 * (w * x + y * z), 2 * (w * z + x * y)], axis=1))

    start = drift(q)
    maxpush = kernel.config.max_push_vel
    for _ in range(10):
        inputs[2] = (rng.uniform(-1, 1, inputs[2].shape)
                     * kernel.model.power_coef.numpy()).astype(np.float32)
        qn, qdn, _, _ = run_on_host(libs[kernel.name], kernel, inputs)
        assert np.isfinite(qn).all() and np.isfinite(qdn).all()
        assert np.abs(qdn[:, [1, 3, 5]]).max() <= maxpush
        inputs[0], inputs[1] = qn, qdn
    end = drift(inputs[0])
    assert (np.median(end, axis=0) < 0.5 * np.median(start, axis=0)).all(), (start, end)
    assert np.abs(inputs[0][:, 0] - q[:, 0]).max() > 1e-3    # the free coordinates move

