"""K1h-e and K1h-e2d redesigned for Hopper (``csrc/engine_k1w.cu``, one warp
per env): Cassie's and Cassie2D's whole PD control step with split impulse,
on the CPU. The warp-per-env source's per-env code is built by g++ under
``-DK1W_HOST_CHECK`` (lane width 1, the collectives identities) and run as a
loop over envs, beside its thread-per-env twin (``engine_k1.cu`` under
``-DK1_HOST_CHECK``) and the unsplit warp-per-env instance, once per module.

- The split keys pick the warp-per-env instance (``K1W_ONLY`` 7 / 8);
  ``thread_per_env=True`` picks ``engine_k1.cu`` instances 12 / 13.
- At B = 16 on chip_smoke.py's Cassie states, near the stand and with every
  pelvis lifted 1 m (every contact row skipped), against the port's plain
  unit at K1e's chip gate: ``TOL_EQ`` medians (q 5e-4, qd 2e-2, depth 5e-4,
  impulse 5e-3), the 99th percentile within ten times.
- Against the thread-per-env twin's host build on the same states, by K1e's
  rule (the tentpole's twin gate where ``TOL_TWIN`` is missed): ``TOL_EQ``
  medians, the 99th percentile within ten times. Near the stand the twins'
  per-env median of |Δq̇| must lie within three times the median by which
  the twin parts from itself when q̇ is nudged by 1e-7 (relative, numpy seed
  0), as Cassie's unsplit twins do (tests/test_torch_k1w_cassie.py).
- Lifted, with every joint inside its limits: no contact is active in any
  substep, and the limit backstop keeps every joint within the slop of its
  limits, so every push-out bias is 0 through the call; the split instance
  then equals the unsplit one bit for bit (its targets differ only by the
  zero bias, and the pseudo-velocity is 0).
- Near the stand the position pass moves the step: the split instance
  parts from the unsplit one by more than ``TOL_EQ`` in the per-env medians
  of q and q̇, so the gate above would catch a kernel that ignored it.

The JAX package's split control step is held against this host build in
tests/test_torch_split_cassie.py, on the JAX outputs that test computes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from mocca_envs_tpu_torch.models import cassie
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.tasks.cassie_task import CASSIE_CONFIG

from tests import torch_workers  # noqa: F401
from tests.torch_k1_host import build_host, run_on_host

TOL_EQ = chip_smoke.TOL_EQ
B = 16
PLANAR = pytest.mark.parametrize("planar", [False, True], ids=["cassie", "cassie2d"])
LIFT = pytest.mark.parametrize("lifted", [False, True], ids=["near_stand", "lifted"])
SYMBOL = "nl17_ns5_nlim16_sub2_it4_llc10_p2p2"


def _kernels(planar):
    """(warp-per-env split, thread-per-env split, warp-per-env unsplit) K1e
    units of Cassie's whole PD control step, with the planar lock for
    Cassie2D."""
    model = cassie.make_model()
    spec = dataclasses.replace(cassie.constraints(), planar=planar)

    def unit(split, tpe):
        cfg = dataclasses.replace(CASSIE_CONFIG, split_impulse=split)
        return engine.K1e(model, cfg, spec, pd_mode=True,
                          extra_damping=model.actuated * model.kd, thread_per_env=tpe)
    return unit(True, False), unit(True, True), unit(False, False)


@pytest.fixture(scope="module")
def libs():
    """The six instances built by g++, side by side."""
    return build_host([k for planar in (False, True) for k in _kernels(planar)])


def _states(planar, lifted=False):
    """Numpy ``(q, qd, targets, ground_z, friction)`` of chip_smoke.py's
    Cassie states; ``lifted`` raises every pelvis 1 m."""
    model = cassie.make_model()
    arrays = [np.ascontiguousarray(x) for x in chip_smoke.cassie_states(
        model, cassie.stand_q(model), cassie.initial_z(), np.random.default_rng(53 + planar),
        planar, B)]
    if lifted:
        arrays[0][:, 2] += 1.0
    return arrays


def _gate(got, want, tol):
    """Per-env medians of the max |Δ| within ``tol``, the 99th percentile
    within ten times."""
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        per_env = np.abs(g - w).max(axis=1)
        assert np.median(per_env) <= tol[name], (name, float(np.median(per_env)))
        assert np.quantile(per_env, 0.99) <= 10 * tol[name], (name, float(per_env.max()))


@PLANAR
def test_split_keys_pick_the_warp_per_env_instance(libs, planar):
    new, old, unsplit = _kernels(planar)
    tag = "_planar" if planar else ""
    assert new.name == f"k1w_{SYMBOL}{tag}_si" and new.instance.source == engine.SOURCE_W
    assert old.name == f"k1h_{SYMBOL}{tag}_si" and old.instance.source == engine.SOURCE
    assert engine.compile_flags(new.instance) == [f"-DK1W_ONLY={7 + planar}"]
    assert engine.compile_flags(old.instance) == [f"-DK1_ONLY={12 + planar}"]
    assert new.key == old.key and new.key.split and new.variant == old.variant == "k1h_e"
    assert engine.WARP_INSTANCES[new.key] is new.instance
    assert unsplit.name == f"k1w_{SYMBOL}{tag}" and unsplit.variant == "k1e"
    # the entry points' choice (the training CLI's --split-impulse builds this unit)
    model = new.model
    picked = engine.make_kernel(model, new.config, pd_mode=True, constraints=new.constraints,
                                extra_damping=model.actuated * model.kd)
    assert isinstance(picked, engine.K1e) and picked.name == new.name
    # the same table as the twin's; no global workspace
    assert engine.layout(libs[new.name], new.name) == (new.table_host.size, 0)
    assert new.table_host.size == old.table_host.size
    assert engine.layout(libs[old.name], old.name)[1] > 0


@PLANAR
@LIFT
def test_k1w_split_matches_plain_on_host(libs, planar, lifted):
    new, _, _ = _kernels(planar)
    inputs = _states(planar, lifted)
    outs = run_on_host(libs[new.name], new, inputs)
    want = [t.numpy() for t in new.plain(*map(torch.as_tensor, inputs))]
    assert all(np.isfinite(o).all() for o in outs)
    _gate(outs, want, TOL_EQ)
    if lifted:
        assert (want[3] == 0).all() and (outs[3] == 0).all()
    else:
        assert (want[3] > 0).mean() > 0.1   # the feet carry load
    assert np.abs(outs[0][:, 7:] - inputs[0][:, 7:]).max() > 0.01   # the servo moved the joints


@PLANAR
@LIFT
def test_k1w_split_matches_thread_per_env_on_host(libs, planar, lifted):
    new, old, _ = _kernels(planar)
    inputs = _states(planar, lifted)
    outs = run_on_host(libs[new.name], new, inputs)
    base = run_on_host(libs[old.name], old, inputs)
    _gate(outs, base, TOL_EQ)
    if not lifted:
        # the twins part by rounding, as far as a 1e-7 nudge of q̇ parts
        # the twin from itself
        nudged = list(inputs)
        noise = np.random.default_rng(0).standard_normal(inputs[1].shape)
        nudged[1] = (inputs[1] * (1 + 1e-7 * noise)).astype(np.float32)
        med = lambda a: float(np.median(np.abs(a[1] - base[1]).max(axis=1)))  # noqa: E731
        twin, floor = med(outs), med(run_on_host(libs[old.name], old, nudged))
        assert 0 < twin <= 3 * floor, (twin, floor)


@PLANAR
def test_k1w_split_equals_unsplit_where_every_bias_is_zero(libs, planar):
    new, _, unsplit = _kernels(planar)
    inputs = _states(planar, lifted=True)
    model = new.model
    lim = list(engine.limited_joints(model))
    qj = inputs[0][:, 7:][:, lim]
    assert ((qj > model.limit_lo.numpy()[lim]) & (qj < model.limit_hi.numpy()[lim])).all()
    _, con_act, _ = engine.k1_activity(new, *map(torch.as_tensor, inputs))
    assert not con_act.any()   # no contact row in any of the 20 substeps
    outs = run_on_host(libs[new.name], new, inputs)
    for got, want in zip(outs, run_on_host(libs[unsplit.name], unsplit, inputs)):
        np.testing.assert_array_equal(got, want)


@PLANAR
def test_k1w_split_parts_from_unsplit_near_the_stand(libs, planar):
    new, _, unsplit = _kernels(planar)
    inputs = _states(planar)
    outs = run_on_host(libs[new.name], new, inputs)
    ref = run_on_host(libs[unsplit.name], unsplit, inputs)
    for name, i in (("q", 0), ("qd", 1)):
        med = float(np.median(np.abs(outs[i] - ref[i]).max(axis=1)))
        assert med > TOL_EQ[name], (name, med)
