"""K1h-c and K1h-b redesigned for Hopper (``csrc/engine_k1w.cu``, one warp
per env): the stepper's frame over its 6 culled stones and the PD walkers'
control step (one llc frame), with split impulse, on the CPU. The
warp-per-env source's per-env code is built by g++ under
``-DK1W_HOST_CHECK`` (lane width 1, the collectives identities) and run as
a loop over envs, beside its thread-per-env twin (``-DK1_HOST_CHECK``: the
named ``engine_k1.cu`` instance ``k1h_..._k6_si`` for the stepper, the
generic ``k1_..._llc1_si`` for the PD walkers) and the unsplit warp-per-env
instance, the six built side by side once per module.

- The split keys pick the warp-per-env instance (``K1W_ONLY`` 11 / 12), as
  the training CLI's ``--split-impulse`` builds them; ``thread_per_env=True``
  picks the twin.
- At B = 16 on chip_smoke.py's stepper and PD-target states, near contact
  and with every base lifted 3 m (every contact row skipped), against the
  port's plain unit at the chip gate ``TOL`` (q 2e-4, qd 5e-3, depth 2e-4,
  impulse 5e-3) on the per-env medians, the largest env within ten times.
  The thread-per-env twin is held to the same gates.
- Against the twin's host build on the same states at ``TOL_TWIN`` (q 2e-5,
  qd 5e-4, depth 2e-5, impulse 5e-4), the largest env within ten times;
  near contact the twins' per-env median of |Δq̇| lies within three times
  the median by which the twin parts from itself when q̇ is nudged by 1e-7
  (relative, numpy seed 0), the chip's ``rounding_floor``.
- Lifted, with every joint inside its limits: no contact is active in any
  substep, and the limit backstop keeps every joint within the slop of its
  limits, so every push-out bias is 0 through the call; the split instance
  then equals the unsplit one bit for bit (its targets differ only by the
  zero bias, and the pseudo-velocity is 0). In PD mode the torque of the
  frame's target and the implicit damping in the factor enter both alike.
- Near contact the position pass moves the step: the split instance parts
  from the unsplit one by more than its plain gate in the per-env medians
  of q and q̇, so that gate would catch a kernel that ignored the pass.
- The stepper's entry refuses a null ``stones``.

The JAX package's split control step is held against these host builds in
tests/test_torch_split_families.py (the stepper) and
tests/test_torch_split_rest.py (the PD walker), on the JAX outputs those
tests compute.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import mocca_envs_tpu_torch
from mocca_envs_tpu_torch.models import walker3d
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.ops.integrate import LIMIT_SLOP
from mocca_envs_tpu_torch.utils.config import EngineConfig

from tests import torch_workers  # noqa: F401
from tests.torch_k1_host import build_host, run_on_host

TOL = chip_smoke.TOL
TOL_TWIN = chip_smoke.TOL_TWIN
B = 16
KIND = pytest.mark.parametrize("kind", ["stones", "pd"])
LIFT = pytest.mark.parametrize("lifted", [False, True], ids=["near_contact", "lifted"])
SYMBOL = {"stones": "nl22_ns14_nlim21_sub4_it4_k6", "pd": "nl22_ns14_nlim21_sub4_it4_llc1"}
ONLY = {"stones": 11, "pd": 12}
TWIN = {"stones": "k1h_nl22_ns14_nlim21_sub4_it4_k6_si",
        "pd": "k1_nl22_ns14_nlim21_sub4_it4_llc1_si"}
FAMILIES = {"stones": ("Walker3DStepperEnv-v0",),
            "pd": ("Walker3DPDCustomEnv-v0", "Child3DPDCustomEnv-v0")}
SPLIT = EngineConfig(split_impulse=True)


def _pd_model():
    """The walker with the PD families' gains: kp = power_coef on the
    actuated joints."""
    model = walker3d.make_model()
    return model.replace(kp=model.power_coef * (model.actuated > 0).float())


def _kernel(kind, config=SPLIT, thread_per_env=False):
    if kind == "stones":
        return engine.K1c(walker3d.make_model(), config, thread_per_env=thread_per_env)
    model = _pd_model()
    return engine.K1b(model, config, extra_damping=model.kp / 20.0,
                      thread_per_env=thread_per_env)


def _kernels(kind):
    """(warp-per-env split, thread-per-env split, warp-per-env unsplit)."""
    return _kernel(kind), _kernel(kind, thread_per_env=True), _kernel(kind, EngineConfig())


@pytest.fixture(scope="module")
def libs():
    """The six instances built by g++, side by side."""
    return build_host([k for kind in ("stones", "pd") for k in _kernels(kind)])


def _states(kind, batch=B, lifted=False):
    """Numpy ``(q, qd, tau or targets, ground_z, friction[, stones])`` of
    chip_smoke.py's stepper or PD-target states; ``lifted`` raises every
    base 3 m (the packed stones stay)."""
    rng = np.random.default_rng(71 if kind == "stones" else 73)
    model = walker3d.make_model()
    if kind == "stones":
        arrays = chip_smoke.stepper_states(model, rng, SPLIT.stone_window, batch)
    else:
        arrays = chip_smoke.pd_target_states(model, rng, batch)
    arrays = [np.ascontiguousarray(x) for x in arrays]
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


@KIND
def test_split_keys_pick_the_warp_per_env_instance(libs, kind):
    new, old, unsplit = _kernels(kind)
    assert new.name == f"k1w_{SYMBOL[kind]}_si" and new.instance.source == engine.SOURCE_W
    assert engine.compile_flags(new.instance) == [f"-DK1W_ONLY={ONLY[kind]}"]
    assert engine.WARP_INSTANCES[new.key] is new.instance
    # the twin: the named engine_k1.cu instance (the stepper) or the generic
    # one (the PD walkers) of the same key
    assert old.name == TWIN[kind] and old.instance.source == engine.SOURCE
    assert (old.instance.index is None) == (kind == "pd")
    assert new.key == old.key and new.key.split
    assert new.variant == old.variant == ("k1h_c" if kind == "stones" else "k1h_b")
    assert unsplit.name == f"k1w_{SYMBOL[kind]}" and not unsplit.split
    # each family's model with the training CLI's --split-impulse config, as
    # its control step builds the unit
    for env_id in FAMILIES[kind]:
        model = mocca_envs_tpu_torch.make(env_id, device="cpu").model
        config = dataclasses.replace(EngineConfig(), split_impulse=True)
        if kind == "stones":
            picked = engine.make_kernel(model, config, num_stones=config.stone_window)
        else:
            assert bool((model.kp > 0).any())
            picked = engine.make_kernel(model, config, pd_mode=True,
                                        extra_damping=model.kp / 20.0)
        assert picked.name == new.name and type(picked) is type(new), env_id
    # K1b at two llc frames with split impulse runs the generic warp-per-env
    # instance of its key (tests/test_torch_k1w_llc_frames.py); its twin is
    # the generic engine_k1.cu one
    if kind == "pd":
        two = _kernel(kind, EngineConfig(llc_frames=2, split_impulse=True))
        assert two.instance == engine.warp_instance(two.key) and two.instance.index is None
        assert engine.instance_for(two.key, thread_per_env=True).symbol \
            == "k1_nl22_ns14_nlim21_sub4_it4_llc2_si"
    # the same table; no global workspace
    assert engine.layout(libs[new.name], new.name) == (new.table_host.size, 0)
    assert new.table_host.size == old.table_host.size
    assert engine.layout(libs[old.name], old.name)[1] > 0


@KIND
@LIFT
def test_k1w_split_matches_plain_on_host(libs, kind, lifted):
    """Both designs against the plain unit at the chip gate."""
    new, old, _ = _kernels(kind)
    inputs = _states(kind, lifted=lifted)
    want = [t.numpy() for t in new.plain(*map(torch.as_tensor, inputs))]
    for kernel in (new, old):
        outs = run_on_host(libs[kernel.name], kernel, inputs)
        assert all(np.isfinite(o).all() for o in outs)
        _gate(outs, want, TOL)
    if lifted:
        assert (want[3] == 0).all()
    else:
        assert (want[3] > 0).mean() > 0.05   # contacts carry load


@KIND
@LIFT
def test_k1w_split_matches_thread_per_env_on_host(libs, kind, lifted):
    new, old, _ = _kernels(kind)
    inputs = _states(kind, lifted=lifted)
    outs = run_on_host(libs[new.name], new, inputs)
    base = run_on_host(libs[old.name], old, inputs)
    _gate(outs, base, TOL_TWIN)
    if lifted:
        assert (outs[3] == 0).all()
    else:
        # the twins part by rounding, as far as a 1e-7 nudge of q̇ parts
        # the twin from itself
        nudged = list(inputs)
        noise = np.random.default_rng(0).standard_normal(inputs[1].shape)
        nudged[1] = (inputs[1] * (1 + 1e-7 * noise)).astype(np.float32)
        med = lambda a: float(np.median(np.abs(a[1] - base[1]).max(axis=1)))  # noqa: E731
        twin, floor = med(outs), med(run_on_host(libs[old.name], old, nudged))
        assert twin <= 3 * floor, (twin, floor)


@KIND
def test_k1w_split_equals_unsplit_where_every_bias_is_zero(libs, kind):
    new, _, unsplit = _kernels(kind)
    inputs = _states(kind, lifted=True)
    model = new.model
    lo, hi = model.limit_lo.numpy(), model.limit_hi.numpy()
    inputs[0][:, 7:] = np.clip(inputs[0][:, 7:], lo + 0.05, hi - 0.05)
    args = list(map(torch.as_tensor, inputs))
    _, con_act, _ = engine.k1_activity(new, *args)
    assert not con_act.any()   # no contact row in any of the 4 substeps
    outs = run_on_host(libs[new.name], new, inputs)
    # the limit backstop keeps each joint within the slop of its limits, so
    # a limit row's violation never passes the slop and its push-out is 0
    lim = list(engine.limited_joints(model))
    qj = outs[0][:, 7:][:, lim]
    assert ((qj >= lo[lim] - LIMIT_SLOP) & (qj <= hi[lim] + LIMIT_SLOP)).all()
    for got, want in zip(outs, run_on_host(libs[unsplit.name], unsplit, inputs)):
        np.testing.assert_array_equal(got, want)


@KIND
def test_k1w_split_parts_from_unsplit_near_contact(libs, kind):
    new, _, unsplit = _kernels(kind)
    inputs = _states(kind)
    outs = run_on_host(libs[new.name], new, inputs)
    ref = run_on_host(libs[unsplit.name], unsplit, inputs)
    for name, i in (("q", 0), ("qd", 1)):
        med = float(np.median(np.abs(outs[i] - ref[i]).max(axis=1)))
        assert med > TOL[name], (name, med)


def test_k1w_split_stones_refuses_null_stones(libs):
    """The stepper's entry refuses a null stones pointer and writes nothing."""
    new, _, _ = _kernels("stones")
    inputs = _states("stones", 2)
    table_size, _ = engine.layout(libs[new.name], new.name)
    outs = [np.full((2, n), 7.0, np.float32) for n in (28, 27, 14, 14)]
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    fn = getattr(libs[new.name], new.name + "_host")
    fn.restype = ctypes.c_int
    err = fn(*map(ptr, inputs[:5]), None, None, None, None, None, *map(ptr, outs),
             ptr(new.table_host), ctypes.c_int(table_size), None, ctypes.c_int(2))
    assert err != 0 and all((o == 7.0).all() for o in outs)
    # with its stones the same entry runs
    assert run_on_host(libs[new.name], new, inputs)[0].shape == (2, 28)
