"""PyTorch port vs the JAX package: Cassie's PD control unit (CPU).

The whole control step as one unit (10 llc frames × 2 substeps at 600 Hz,
the PD torque refreshed per frame, k_d implicit, λ carried over all 20
substeps, the two achilles rods, and for ``Cassie2DEnv`` the planar lock) at
B = 16 on shared states and joint targets near the stand pose, the JAX spec
on both sides. Per-env medians within the walker's tolerances (q 2e-4,
qd 5e-3, depth 2e-4, normal impulse 5e-3); the largest single env is held
to twenty times those, not ten: over 20 stiff substeps two roundings of one
iteration part further than over the walker's four (measured here: medians
q 5e-6 / 7e-6, qd 7e-4 / 1.5e-3, the largest env's qd 7e-2 / 3e-2).
Both packages keep the rods closed and, with the
lock, the base in its plane, within the same bounds.

The JAX side runs one env per call: under ``vmap`` this unit takes the CPU
backend twice as long per env. The calls (~5 s each) run on threads of
their own, which XLA's CPU client executes side by side.
"""

import concurrent.futures
import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from mocca_envs_tpu.models import cassie as jcassie
from mocca_envs_tpu.ops.step import ConstraintSpec as JSpec
from mocca_envs_tpu.ops.step import make_control_step as jcontrol
from mocca_envs_tpu.tasks.cassie_task import CASSIE_CONFIG as JCASSIE_CONFIG
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.core import quat as quat_ops
from mocca_envs_tpu_torch.models import cassie as tcassie
from mocca_envs_tpu_torch.ops.kinematics import forward_kinematics
from mocca_envs_tpu_torch.ops.step import make_control_step as tcontrol
from mocca_envs_tpu_torch.tasks.cassie_task import CASSIE_CONFIG as TCASSIE_CONFIG
from mocca_envs_tpu_torch.terrain import scene as tscene

from tests import torch_workers  # noqa: F401

TOL = {"q": 2e-4, "qd": 5e-3, "depth": 2e-4, "nimp": 5e-3}
B = 16


def run_per_env(fn, *batched):
    """``fn``, a jitted function compiled ahead of time for one env (so that
    no call compiles), on each env's slice of ``batched``, the calls on a
    pool of threads; each result is waited for."""
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
        return list(pool.map(lambda args: jax.block_until_ready(fn(*args)), zip(*batched)))


@functools.lru_cache(maxsize=None)
def _unit_results(planar: bool):
    """(inputs, JAX outputs, port outputs, port spec) of one control unit."""
    jm, tm = jcassie.make_model(), tcassie.make_model()
    jspec = jcassie.constraints()
    if planar:
        jspec = JSpec(**{**dataclasses.asdict(jspec), "planar": True})
    tspec = convert.constraint_spec_from_numpy(dataclasses.asdict(jspec))
    q, qd, targets, _, _ = chip_smoke.cassie_states(
        tm, tcassie.stand_q(tm), tcassie.initial_z(), np.random.default_rng(31 + planar),
        planar, B)
    jstep = jcontrol(jm, JCASSIE_CONFIG, constraints=jspec, pd_targets=lambda a: a,
                     extra_damping=jm.actuated * jm.kd)
    jit_step = jax.jit(lambda a, b, c: jstep(a, b, c, jscene.flat()))
    want = run_per_env(jit_step.lower(q[0], qd[0], targets[0]).compile(), q, qd, targets)
    want = [np.stack([np.asarray(f(w)) for w in want]) for f in (
        lambda w: w[0], lambda w: w[1], lambda w: w[2].contacts.depth,
        lambda w: w[2].normal_impulse, lambda w: w[2].foot_contact)]
    tstep = tcontrol(tm, TCASSIE_CONFIG, constraints=tspec, pd_targets=lambda a: a,
                     extra_damping=tm.actuated * tm.kd)
    tq, tqd, info = tstep(*map(torch.as_tensor, (q, qd, targets)), tscene.flat(B))
    got = [x.numpy() for x in (tq, tqd, info.contacts.depth, info.normal_impulse,
                               info.foot_contact)]
    return (q, qd, targets), want, got, tspec


def _rod_gaps(tm, spec, q):
    """|anchor a − anchor b| of each rod: (B, rods)."""
    q = torch.as_tensor(q)
    fd = forward_kinematics(tm, q, torch.zeros(q.shape[0], tm.nv))
    gaps = []
    for la, lb, aa, ab in zip(spec.p2p_link_a, spec.p2p_link_b, spec.p2p_anchor_a,
                              spec.p2p_anchor_b):
        xa = fd.pos[:, la] + fd.rot[:, la] @ torch.tensor(aa, dtype=torch.float32)
        xb = fd.pos[:, lb] + fd.rot[:, lb] @ torch.tensor(ab, dtype=torch.float32)
        gaps.append(torch.linalg.vector_norm(xa - xb, dim=1))
    return torch.stack(gaps, dim=1).numpy()


@pytest.mark.parametrize("planar", [False, True], ids=["CassieEnv", "Cassie2DEnv"])
def test_cassie_pd_unit_matches_jax(planar):
    (q, _, targets), want, got, _ = _unit_results(planar)
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        per_env = np.abs(g - w).reshape(B, -1).max(axis=1)
        assert np.median(per_env) <= TOL[name], (name, float(np.median(per_env)))
        assert per_env.max() <= 20 * TOL[name], (name, float(per_env.max()))
    # foot flags: equal but where a sphere rests within rounding of the surface
    assert (got[4] != want[4]).mean() <= 1 / 16
    # the unit did something: the servo moved the motors toward their targets
    motors = tcassie.make_model().actuated.numpy() > 0.5
    before = np.abs(targets - q[:, 7:])[:, motors].mean()
    after = np.abs(targets - got[0][:, 7:])[:, motors].mean()
    assert after < before
    assert (want[3] > 0).mean() > 0.1   # the feet carry load


@pytest.mark.parametrize("planar", [False, True], ids=["CassieEnv", "Cassie2DEnv"])
def test_rods_stay_closed_and_the_lock_holds_in_both_packages(planar):
    """After the unit the rod gaps are no wider than 2.5 times their (small)
    initial closure error or 5 cm, the bound of the JAX package's own slow
    test; with the lock |y| < 0.02 m, |roll| and |yaw| < 0.05 rad."""
    (q, _, _), want, got, spec = _unit_results(planar)
    tm = tcassie.make_model()
    g0 = _rod_gaps(tm, spec, q)
    assert 1e-4 < g0.mean() < 0.02     # the states start with the rods slightly open
    for out in (want, got):
        g1 = _rod_gaps(tm, spec, out[0])
        assert (g1 < np.maximum(2.5 * g0, 0.05)).all(), float(g1.max())
        if planar:
            rpy = quat_ops.to_rpy(torch.as_tensor(out[0][:, 3:7])).numpy()
            assert np.abs(out[0][:, 1]).max() < 0.02
            assert np.abs(rpy[:, 0]).max() < 0.05 and np.abs(rpy[:, 2]).max() < 0.05
    if planar:
        # and the drift shrank: the inputs start a little out of the plane
        assert np.abs(got[0][:, 1]).mean() < np.abs(q[:, 1]).mean()
