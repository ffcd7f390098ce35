"""PyTorch port vs the JAX package: equality rows of the solver (CPU).

- ``pgs_solve`` with ``ne > 0`` unbounded rows in front, on fixed arrays;
- one llc frame of the hopper with one rod plus the planar lock (the spec of
  tests/test_pallas_engine.py's equality-row case without its grab), the rod
  alone and the lock alone, B = 32, against ``ops/step.py::make_substep``
  with the same spec. Tolerances: per-env medians within q 5e-4, qd 2e-2,
  depth 5e-4 (those the JAX package holds its own kernel to over equality
  rows) and normal impulse 5e-3, the largest single env within ten times;
- the rows do what they are for: the rod's gap and the out-of-plane drift
  shrink over the frame;
- the grab rows: the hopper with the rod, the lock and one grab of
  tests/test_pallas_engine.py, half of the envs attached, over 4 substeps,
  at the same gates; the attached feet are pulled toward the target, the
  others are not.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocca_envs_tpu.ops import kinematics as jkin
from mocca_envs_tpu.ops import solver as jsolver
from mocca_envs_tpu.ops.step import ConstraintSpec as JSpec
from mocca_envs_tpu.ops.step import limited_joints as jlimited
from mocca_envs_tpu.ops.step import make_substep as jsubstep
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu.utils.config import EngineConfig as JConfig
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.ops import kinematics as tkin
from mocca_envs_tpu_torch.ops import solver as tsolver
from mocca_envs_tpu_torch.ops.step import ConstraintSpec as TSpec
from mocca_envs_tpu_torch.ops.step import make_control_step as tcontrol
from mocca_envs_tpu_torch.ops.step import make_plain_llc
from mocca_envs_tpu_torch.ops.step import make_substep as tsubstep
from mocca_envs_tpu_torch.terrain import scene as tscene
from mocca_envs_tpu_torch.utils.config import EngineConfig as TConfig

from tests import torch_workers  # noqa: F401
from tests.models_util import hopper

TOL = {"q": 5e-4, "qd": 2e-2, "depth": 5e-4, "nimp": 5e-3}
LEG = 1   # the hopper's one moving link
ROD = dict(p2p_link_a=(0,), p2p_link_b=(LEG,), p2p_anchor_a=((0.2, 0.0, -0.3),),
           p2p_anchor_b=((0.15, 0.0, -0.1),))
SPECS = {"rod_and_planar": dict(ROD, planar=True), "rod": ROD, "planar": dict(planar=True)}


def spec_to_port(jspec) -> TSpec:
    return convert.constraint_spec_from_numpy(dataclasses.asdict(jspec))


def _port_model(jmodel):
    fields = {f.name: getattr(jmodel, f.name) for f in dataclasses.fields(jmodel)}
    fields = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in fields.items()}
    return convert.robot_model_from_numpy(fields)


def _gate(name, got, want):
    per_env = np.abs(np.asarray(got) - np.asarray(want)).reshape(len(got), -1).max(axis=1)
    assert np.median(per_env) <= TOL[name], (name, float(np.median(per_env)))
    assert per_env.max() <= 10 * TOL[name], (name, float(per_env.max()))


@pytest.mark.parametrize("block", [False, True], ids=["row", "block"])
def test_pgs_solve_with_equality_rows_matches_jax(block):
    rng = np.random.default_rng(7)
    B, nv, ne, nlim, nc = 4, 12, 6, 3, 3
    nr = ne + nlim + 3 * nc
    X = rng.standard_normal((B, nv, nv)).astype(np.float32)
    Minv = (np.einsum("bij,bkj->bik", X, X) / nv + 0.5 * np.eye(nv)).astype(np.float32)
    J = rng.standard_normal((B, nr, nv)).astype(np.float32)
    c = rng.standard_normal((B, nr)).astype(np.float32)
    act = (rng.uniform(size=(B, nr)) > 0.2).astype(np.float32)
    act[:, :ne] = 1.0
    mu = rng.uniform(0.3, 1.0, (B, nc)).astype(np.float32)
    lam0 = rng.standard_normal((B, nr)).astype(np.float32)
    lam0[:, ne:] = np.abs(lam0[:, ne:])
    jA, _ = jax.vmap(lambda m, j: jsolver.delassus(m, j, 1e-6))(Minv, J)
    tA, _ = tsolver.delassus(torch.as_tensor(Minv), torch.as_tensor(J), 1e-6)
    jl = jax.vmap(lambda a, cc, ac, m, l0: jsolver.pgs_solve(
        a, cc, ac, m, ne, nc, 6, nlim=nlim, block=block, lam0=l0))(jA, c, act, mu, lam0)
    tl = tsolver.pgs_solve(tA, *map(torch.as_tensor, (c, act, mu)), ne, nc, 6, nlim=nlim,
                           block=block, lam0=torch.as_tensor(lam0))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3, atol=2e-4)
    # equality rows are unbounded: some of their impulses are negative,
    # while no limit or normal impulse is
    assert float(tl[:, :ne].min()) < 0.0
    assert float(tl[:, ne:ne + nlim].min()) >= 0.0
    assert float(tl[:, ne + nlim::3].min()) >= 0.0


def _hopper_states(B, seed):
    rng = np.random.default_rng(seed)
    q = np.zeros((B, 8), np.float32)
    q[:, 2] = 0.55
    q[:, 3] = 1.0
    q += 0.03 * rng.standard_normal((B, 8)).astype(np.float32)
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    qd = (0.3 * rng.standard_normal((B, 7))).astype(np.float32)
    tau = (0.2 * rng.standard_normal((B, 1))).astype(np.float32)
    return q, qd, tau


def _rod_gap(tm, spec: TSpec, q):
    fd = tkin.forward_kinematics(tm, q, torch.zeros(q.shape[0], tm.nv))
    aa, ab = (torch.tensor(a[0], dtype=torch.float32) for a in
              (spec.p2p_anchor_a, spec.p2p_anchor_b))
    la, lb = spec.p2p_link_a[0], spec.p2p_link_b[0]
    xa = fd.pos[:, la] + fd.rot[:, la] @ aa
    xb = fd.pos[:, lb] + fd.rot[:, lb] @ ab
    return torch.linalg.vector_norm(xa - xb, dim=1)


@pytest.mark.parametrize("case", list(SPECS))
def test_hopper_frame_with_equality_rows_matches_jax(case):
    """One llc frame at the shipped options, λ (equality rows included) and
    the frame-start factor threaded on both sides."""
    jm = hopper()
    tm = _port_model(jm)
    jspec = JSpec(**SPECS[case])
    tspec = spec_to_port(jspec)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec) and tspec.ne == jspec.ne
    jcfg, tcfg = JConfig(), TConfig()
    B = 32
    q, qd, tau = _hopper_states(B, 9)
    nr = jspec.ne + len(jlimited(jm)) + 3 * jm.ns
    sub = jsubstep(jm, jcfg, constraints=jspec)
    scene = jscene.flat()

    def jax_path(q1, qd1, t1):
        qq, dd = q1, qd1
        lam = jnp.zeros(nr)
        Minv0 = sub.minv_of(jkin.forward_kinematics(jm, qq, dd))
        for _ in range(jcfg.sim_substeps):
            qq, dd, info, lam = sub(qq, dd, t1, scene, Minv_in=Minv0, lam_in=lam)
        return qq, dd, info.contacts.depth, info.normal_impulse

    want = jax.jit(jax.vmap(jax_path))(q, qd, tau)
    port_sub = tsubstep(tm, tcfg, tspec)
    assert port_sub.num_rows == nr
    unit = make_plain_llc(tm, tcfg, port_sub)
    tq, tqd, info = unit(*map(torch.as_tensor, (q, qd, tau)), tscene.flat(B))
    for name, g, w in zip(("q", "qd", "depth", "nimp"),
                          (tq, tqd, info.contacts.depth, info.normal_impulse), want):
        _gate(name, g.numpy(), w)
    # contact rows stay in play (the rod swings the leg, which lifts most feet)
    assert float((info.contacts.depth > -tcfg.contact_margin).float().mean()) > 0.2
    if not tspec.num_p2p:
        assert float((info.normal_impulse > 0).float().mean()) > 0.1
    # the rows pull where they should: the rod closes, the drift shrinks
    if tspec.num_p2p:
        before, after = _rod_gap(tm, tspec, torch.as_tensor(q)), _rod_gap(tm, tspec, tq)
        assert float(after.mean()) < float(before.mean())
    if tspec.planar:
        # the y rate is driven against the y drift, and the drift shrinks
        assert float((tqd[:, 1] * torch.as_tensor(q[:, 1]) < 0).float().mean()) > 0.9
        assert float(tq[:, 1].abs().mean()) < 0.8 * float(np.abs(q[:, 1]).mean())


def test_grab_rows_raise_until_their_variant_is_ported():
    """Grab rows were refused until their kernel variant (K1d) came; now
    they run on the plain path and agree with the JAX package: the spec of
    tests/test_pallas_engine.py's equality-row case (rod, planar lock, one
    grab of the leg's foot point onto a fixed target), half of the envs
    attached, one llc frame of 4 substeps with λ and the frame-start factor
    threaded on both sides, B = 32."""
    jm = hopper()
    tm = _port_model(jm)
    jspec = JSpec(**ROD, planar=True, num_grabs=1, grab_links=(LEG,),
                  grab_anchors=((0.0, 0.0, -0.5),))
    tspec = spec_to_port(jspec)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec) and tspec.ne == 9
    jcfg, tcfg = JConfig(), TConfig()
    B = 32
    q, qd, tau = _hopper_states(B, 9)
    ga = (np.arange(B) % 2).astype(np.float32)[:, None]            # half attached
    gt = np.tile(np.array([[[0.1, 0.0, 0.2]]], np.float32), (B, 1, 1))
    nr = jspec.ne + len(jlimited(jm)) + 3 * jm.ns
    sub = jsubstep(jm, jcfg, constraints=jspec)
    scene = jscene.flat()

    def jax_path(q1, qd1, t1, ga1, gt1):
        qq, dd = q1, qd1
        lam = jnp.zeros(nr)
        Minv0 = sub.minv_of(jkin.forward_kinematics(jm, qq, dd))
        for _ in range(jcfg.sim_substeps):
            qq, dd, info, lam = sub(qq, dd, t1, scene, ga1, gt1, Minv_in=Minv0, lam_in=lam)
        return qq, dd, info.contacts.depth, info.normal_impulse

    want = jax.jit(jax.vmap(jax_path))(q, qd, tau, ga, gt)
    unit = make_plain_llc(tm, tcfg, tsubstep(tm, tcfg, tspec))
    tq, tqd, info = unit(*map(torch.as_tensor, (q, qd, tau)), tscene.flat(B),
                         torch.as_tensor(ga), torch.as_tensor(gt))
    for name, g, w in zip(("q", "qd", "depth", "nimp"),
                          (tq, tqd, info.contacts.depth, info.normal_impulse), want):
        _gate(name, g.numpy(), w)
    # the whole control step takes the grab state too
    step = tcontrol(tm, tcfg, constraints=tspec)
    sq, sqd, _ = step(*map(torch.as_tensor, (q, qd, tau)), tscene.flat(B),
                      torch.as_tensor(ga), torch.as_tensor(gt))
    torch.testing.assert_close(sq, tq, atol=0, rtol=0)
    # the attached feet close on the target more than the free ones do
    def gap(qq):
        fd = tkin.forward_kinematics(tm, qq, torch.zeros(B, tm.nv))
        foot = fd.pos[:, LEG] + fd.rot[:, LEG] @ torch.tensor([0.0, 0.0, -0.5])
        return torch.linalg.vector_norm(foot - torch.as_tensor(gt[:, 0]), dim=1)

    closer = gap(tq) - gap(torch.as_tensor(q))
    on = torch.as_tensor(ga[:, 0]) > 0.5
    assert float(closer[on].mean()) < float(closer[~on].mean())
