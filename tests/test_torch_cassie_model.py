"""PyTorch port vs the JAX package: the Cassie and planar-walker models (CPU).

- every array and the static topology of the Cassie, Walker2D and Crab2D
  models against the JAX package's;
- ``stand_q`` equal, ``initial_z()`` and the solved rod anchors of
  ``constraints()`` within 1e-6 (the two packages' float32 FKs round in
  another order);
- the leaf springs act: one substep from a deflected shin spring, airborne,
  in both packages (q within 5e-4, qd within 2e-2), the spring joint driven
  back and by the implicit-spring amount;
- ``GaitTable.at_phase`` (two gathered rows and a lerp here, one-hot row
  weights there) on a grid of phases, wrap-around included, and the
  synthesized walk's arrays equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocca_envs_tpu.models import cassie as jcassie
from mocca_envs_tpu.models import cassie_gait as jgait
from mocca_envs_tpu.models import walker2d as jwalker2d
from mocca_envs_tpu.ops.step import make_substep as jsubstep
from mocca_envs_tpu.tasks.cassie_task import CASSIE_CONFIG as JCASSIE_CONFIG
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.models import cassie as tcassie
from mocca_envs_tpu_torch.models import cassie_gait as tgait
from mocca_envs_tpu_torch.models import walker2d as twalker2d
from mocca_envs_tpu_torch.models.schema import ARRAY_FIELDS, STATIC_FIELDS
from mocca_envs_tpu_torch.ops.step import limited_joints
from mocca_envs_tpu_torch.ops.step import make_substep as tsubstep
from mocca_envs_tpu_torch.tasks.cassie_task import CASSIE_CONFIG as TCASSIE_CONFIG
from mocca_envs_tpu_torch.terrain import scene as tscene

from tests import torch_workers  # noqa: F401

MODELS = {
    "cassie": (jcassie.make_model, tcassie.make_model, (17, 5, 16)),
    "walker2d": (jwalker2d.make_walker2d, twalker2d.make_walker2d, (7, 5, 6)),
    "crab2d": (jwalker2d.make_crab2d, twalker2d.make_crab2d, (7, 5, 6)),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name):
    jmake, tmake, (nl, ns, nlim) = MODELS[name]
    jm, tm = jmake(), tmake()
    for f in STATIC_FIELDS:
        assert getattr(tm, f) == getattr(jm, f), f
    for f in ARRAY_FIELDS:
        np.testing.assert_allclose(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                   rtol=1e-6, atol=0, err_msg=f)
    # the sizes the kernel instances are built for
    assert (tm.nl, tm.ns, len(limited_joints(tm))) == (nl, ns, nlim)
    assert tm.nv == nl + 5 and tm.nq == nl + 6


def test_planar_constants_and_spec():
    assert twalker2d.WALKER2D_INITIAL_Z == jwalker2d.WALKER2D_INITIAL_Z
    assert twalker2d.CRAB2D_INITIAL_Z == jwalker2d.CRAB2D_INITIAL_Z
    spec = twalker2d.planar_spec()
    assert dataclasses.asdict(spec) == dataclasses.asdict(jwalker2d.planar_spec())
    assert spec.ne == 3 and spec.num_p2p == 0


def test_cassie_stand_pose_height_and_rods_match_jax():
    jm, tm = jcassie.make_model(), tcassie.make_model()
    np.testing.assert_array_equal(tcassie.stand_q(tm), jcassie.stand_q(jm))
    assert tcassie.initial_z() == pytest.approx(jcassie.initial_z(), abs=1e-6)
    jspec, tspec = jcassie.constraints(), tcassie.constraints()
    assert (tspec.p2p_link_a, tspec.p2p_link_b) == (jspec.p2p_link_a, jspec.p2p_link_b)
    np.testing.assert_allclose(tspec.p2p_anchor_a, jspec.p2p_anchor_a, atol=0)
    np.testing.assert_allclose(tspec.p2p_anchor_b, jspec.p2p_anchor_b, atol=1e-6)
    assert tspec.num_p2p == 2 and tspec.ne == 6 and not tspec.planar
    # the JAX spec crosses the seam unchanged
    assert dataclasses.asdict(convert.constraint_spec_from_numpy(dataclasses.asdict(jspec))) \
        == dataclasses.asdict(jspec)
    assert dataclasses.asdict(TCASSIE_CONFIG) == {
        f.name: getattr(JCASSIE_CONFIG, f.name) for f in dataclasses.fields(TCASSIE_CONFIG)}
    assert float(tm.stiffness.max()) == 1500.0 and int(tm.actuated.sum()) == 10


@pytest.mark.parametrize("deflection", [0.1, -0.1])
def test_springs_resist_deflection(deflection):
    """One substep, airborne, from the stand pose with the right shin spring
    deflected: τ = −k·Δ = ∓150 N·m on a joint whose implicit diagonal holds
    dt²·k. Both packages, the JAX spec on both sides."""
    jm, tm = jcassie.make_model(), tcassie.make_model()
    jspec = jcassie.constraints()
    tspec = convert.constraint_spec_from_numpy(dataclasses.asdict(jspec))
    shin = tm.joint_names.index("right_shin")
    q = np.zeros(tm.nq, np.float32)
    q[2], q[3] = 2.0, 1.0
    q[7:] = tcassie.stand_q(tm)
    q[7 + shin] += deflection
    qd = np.zeros(tm.nv, np.float32)
    tau = np.zeros(tm.nj, np.float32)
    jsub = jsubstep(jm, JCASSIE_CONFIG, constraints=jspec)
    jq, jqd, _, jlam = jax.jit(lambda a, b, c: jsub(a, b, c, jscene.flat()))(q, qd, tau)
    tsub = tsubstep(tm, TCASSIE_CONFIG, tspec)
    tq, tqd, _, tlam = tsub(*(torch.as_tensor(x)[None] for x in (q, qd, tau)), tscene.flat(1))
    np.testing.assert_allclose(tq[0].numpy(), np.asarray(jq), atol=5e-4)
    np.testing.assert_allclose(tqd[0].numpy(), np.asarray(jqd), atol=2e-2)
    assert tlam.shape == (1, 6 + 16 + 15) and jlam.shape == (37,)
    # the spring drives its joint back: dt·τ = 0.25 N·m·s over the reduced
    # inertia about the joint in free fall (a few 1e-2 kg·m², the implicit
    # dt²·k = 0.004 included) is some rad/s
    rate = float(tqd[0, 6 + shin])
    assert rate * deflection < 0 and 1.0 < abs(rate) < 20.0, rate
    # ... and without the stiffness nothing of that size moves it
    slack = tm.replace(stiffness=torch.zeros_like(tm.stiffness))
    _, fqd, _, _ = tsubstep(slack, TCASSIE_CONFIG, tspec)(
        *(torch.as_tensor(x)[None] for x in (q, qd, tau)), tscene.flat(1))
    assert abs(float(fqd[0, 6 + shin])) < 0.2 * abs(rate)


def test_rod_rows_at_the_stand_pose():
    """The rods' x and z rows move the tree; their y rows cannot (every joint
    between a rod's two links turns about y), so the y rows' Jacobians vanish
    and their Delassus diagonal is the cfm floor: rows that constrain nothing
    and amplify rounding in their residual by 1 / cfm."""
    from mocca_envs_tpu_torch.ops.dynamics import mass_matrix
    from mocca_envs_tpu_torch.ops.kinematics import forward_kinematics, point_jacobian

    tm, spec = tcassie.make_model(), tcassie.constraints()
    q = torch.zeros(1, tm.nq)
    q[0, 2], q[0, 3] = tcassie.initial_z(), 1.0
    q[0, 7:] = torch.as_tensor(tcassie.stand_q(tm), dtype=torch.float32)
    fd = forward_kinematics(tm, q, torch.zeros(1, tm.nv))
    la, lb = torch.tensor(spec.p2p_link_a), torch.tensor(spec.p2p_link_b)
    xa = fd.pos[:, la] + torch.einsum("bkij,kj->bki", fd.rot[:, la],
                                      torch.tensor(spec.p2p_anchor_a, dtype=torch.float32))
    xb = fd.pos[:, lb] + torch.einsum("bkij,kj->bki", fd.rot[:, lb],
                                      torch.tensor(spec.p2p_anchor_b, dtype=torch.float32))
    assert float((xa - xb).abs().max()) < 1e-6          # the chain starts closed
    J = (point_jacobian(tm, fd, la, xa) - point_jacobian(tm, fd, lb, xb)).reshape(6, -1)
    assert float(J[:, :3].abs().max()) == 0.0           # the base's linear columns cancel
    diag = torch.diagonal(J @ torch.linalg.solve(mass_matrix(tm, fd)[0], J.T))
    assert float(diag[[0, 2, 3, 5]].min()) > 1.0 and float(diag[[1, 4]].max()) < 1e-9


def test_synthesized_walk_and_at_phase_match_jax():
    jg, tg = jgait.synthesized_walk(), tgait.synthesized_walk()
    np.testing.assert_array_equal(tg.q_motors.numpy(), np.asarray(jg.q_motors))
    np.testing.assert_array_equal(tg.stance.numpy(), np.asarray(jg.stance))
    assert tg.period_steps == float(jg.period_steps) == 40.0 and tg.length == 64
    via_numpy = convert.gait_table_from_numpy(
        np.asarray(jg.q_motors), np.asarray(jg.stance), np.asarray(jg.period_steps))
    assert torch.equal(via_numpy.q_motors, tg.q_motors) and via_numpy.period_steps == 40.0
    # a grid through the whole cycle, the last rows (which wrap to row 0),
    # exact row phases, and phases beyond one period
    phases = np.concatenate([
        np.linspace(0.0, 40.0, 97, endpoint=False), [39.4, 39.7, 39.99, 39.9999],
        40.0 * np.arange(64) / 64, [40.0, 47.3, 95.1],
    ]).astype(np.float32)
    jq, jst = jax.vmap(jg.at_phase)(jnp.asarray(phases))
    tq, tst = tg.at_phase(torch.as_tensor(phases))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), atol=1e-6)
    # the wrap: between the last row and the first
    last = 40.0 * 63.5 / 64
    q_wrap, _ = tg.at_phase(torch.tensor([last]))
    np.testing.assert_allclose(q_wrap[0].numpy(),
                               0.5 * (tg.q_motors[63] + tg.q_motors[0]).numpy(), atol=1e-5)


def test_gait_table_from_npz(tmp_path):
    g = tgait.synthesized_walk(rows=16)
    path = tmp_path / "gait.npz"
    np.savez(path, q_motors=g.q_motors.numpy())
    jl, tl = jgait.from_npz(str(path), 30.0), tgait.from_npz(str(path), 30.0)
    np.testing.assert_array_equal(tl.q_motors.numpy(), np.asarray(jl.q_motors))
    np.testing.assert_array_equal(tl.stance.numpy(), np.asarray(jl.stance))
    assert tl.period_steps == 30.0
