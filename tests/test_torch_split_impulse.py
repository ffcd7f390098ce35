"""PyTorch port vs the JAX package: split-impulse position correction
(``EngineConfig(split_impulse=True)``) on the CPU.

- the hopper's llc frame at the pinned-off solver options and at the
  shipped defaults, spawned low so that the position pass carries bias on
  contact and limit rows, and one walker control step at the configuration
  ``python -m mocca_envs_tpu.harness.train --split-impulse`` builds for it,
  against ``mocca_envs_tpu/ops/step.py`` at the kernel-vs-oracle gates of
  tests/test_pallas_engine.py (per-env medians within q 2e-4, qd 5e-3,
  depth 2e-4, normal impulse 5e-3, the largest env within ten times);
- the physical cases of tests/test_split_impulse.py on the port's plain
  path: depenetration without an energy kick, resting contact at the slop,
  and limit recovery without a velocity spike, with the JAX test's bounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mocca_envs_tpu.models import walker3d as jwalker
from mocca_envs_tpu.ops import kinematics as jkin
from mocca_envs_tpu.ops.step import limited_joints as jlimited
from mocca_envs_tpu.ops.step import make_control_step as jcontrol
from mocca_envs_tpu.ops.step import make_substep as jsubstep
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu.utils.config import EngineConfig as JConfig
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.models import walker3d as twalker
from mocca_envs_tpu_torch.ops.step import make_control_step as tcontrol
from mocca_envs_tpu_torch.ops.step import make_plain_llc, make_substep as tsubstep
from mocca_envs_tpu_torch.terrain import scene as tscene
from mocca_envs_tpu_torch.utils.config import EngineConfig as TConfig

from tests import torch_workers  # noqa: F401
from tests.models_util import ball, free_q, free_qd, hopper

TOL = {"q": 2e-4, "qd": 5e-3, "depth": 2e-4, "nimp": 5e-3}
PINNED = dict(sim_substeps=2, solver_iters=8, warm_start=False, reuse_factor=False,
              matfree_pgs=False, split_impulse=True)
T = torch.as_tensor


def _port_model(jmodel):
    fields = {f.name: getattr(jmodel, f.name) for f in dataclasses.fields(jmodel)}
    return convert.robot_model_from_numpy(
        {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in fields.items()})


def _gate(name, got, want):
    per_env = np.abs(np.asarray(got) - np.asarray(want)).reshape(len(got), -1).max(axis=1)
    assert np.median(per_env) <= TOL[name], (name, float(np.median(per_env)))
    assert per_env.max() <= 10 * TOL[name], (name, float(per_env.max()))


@pytest.mark.parametrize("shipped", [False, True], ids=["pinned_off", "shipped_defaults"])
def test_hopper_split_frame_matches_jax(shipped):
    """Two substeps (pinned-off options) or one shipped llc frame (λ and the
    frame-start Minv threaded), the hopper spawned at z ≈ 0.5, its foot
    penetrating and its leg near the limit in some envs."""
    jm = hopper()
    tm = _port_model(jm)
    jcfg = JConfig(split_impulse=True) if shipped else JConfig(**PINNED)
    tcfg = TConfig(split_impulse=True) if shipped else TConfig(**PINNED)
    B = 32
    rng = np.random.default_rng(3)
    q = np.zeros((B, jm.nq), np.float32)
    q[:, 2], q[:, 3] = 0.5, 1.0
    q += 0.03 * rng.standard_normal((B, jm.nq)).astype(np.float32)
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q[:8, 7] = rng.uniform(1.42, 1.56, 8)            # leg in the limit margin or past it
    qd = (0.3 * rng.standard_normal((B, jm.nv))).astype(np.float32)
    tau = (0.5 * rng.standard_normal((B, jm.nj))).astype(np.float32)
    sub = jsubstep(jm, jcfg)
    nr = len(jlimited(jm)) + 3 * jm.ns

    def jax_path(q1, qd1, t1):
        qq, dd, lam = q1, qd1, jnp.zeros(nr)
        Minv0 = sub.minv_of(jkin.forward_kinematics(jm, qq, dd)) if shipped else None
        for _ in range(jcfg.sim_substeps):
            qq, dd, info, lam_out = sub(qq, dd, t1, jscene.flat(), Minv_in=Minv0,
                                        lam_in=lam if shipped else None)
            lam = lam_out
        return qq, dd, info.contacts.depth, info.normal_impulse

    want = jax.jit(jax.vmap(jax_path))(q, qd, tau)
    unit = make_plain_llc(tm, tcfg, tsubstep(tm, tcfg))
    tq, tqd, info = unit(T(q), T(qd), T(tau), tscene.flat(B))
    for name, g, w in zip(("q", "qd", "depth", "nimp"), (tq, tqd, info.contacts.depth,
                                                         info.normal_impulse), want):
        _gate(name, g.numpy(), w)
    # the position pass has work: penetrating feet, joints past the limit
    assert float((info.contacts.depth > tcfg.slop).float().mean()) > 0.2
    assert (q[:, 7] > 1.5 + 5e-3).any()
    # and it moves positions, not velocities: the same frame without it
    plain = make_plain_llc(tm, dataclasses.replace(tcfg, split_impulse=False),
                           tsubstep(tm, dataclasses.replace(tcfg, split_impulse=False)))
    bq, bqd, _ = plain(T(q), T(qd), T(tau), tscene.flat(B))
    assert float((bqd[:, 2] - tqd[:, 2]).max()) > 0.1     # Baumgarte pushes up harder


def test_walker_split_control_step_matches_jax():
    """One walker control step at ``EngineConfig(split_impulse=True)`` (what
    the training harness's --split-impulse builds for Walker3DCustomEnv)
    from chip_smoke.py's near-contact states, B = 32."""
    jm, tm = jwalker.make_model(), twalker.make_model()
    B = 32
    q, qd, _, _, _ = chip_smoke.near_contact_states(tm, np.random.default_rng(8), B)
    action = np.random.default_rng(9).uniform(-1, 1, (B, jm.nj)).astype(np.float32)
    gain = np.array(jm.power_coef * jm.actuated)
    jstep = jcontrol(jm, JConfig(split_impulse=True),
                     actuation=lambda q_, qd_, a: gain * jnp.clip(a, -1, 1))
    want_q, want_qd, winfo = jax.jit(jax.vmap(
        lambda a, b, c: jstep(a, b, c, jscene.flat())))(q, qd, action)
    tgain = T(gain)
    tstep = tcontrol(tm, TConfig(split_impulse=True),
                     actuation=lambda q_, qd_, a: tgain * torch.clamp(a, -1, 1))
    tq, tqd, tinfo = tstep(T(q), T(qd), T(action), tscene.flat(B))
    _gate("q", tq.numpy(), want_q)
    _gate("qd", tqd.numpy(), want_qd)
    _gate("depth", tinfo.contacts.depth.numpy(), winfo.contacts.depth)
    _gate("nimp", tinfo.normal_impulse.numpy(), winfo.normal_impulse)
    np.testing.assert_array_equal(tinfo.foot_contact.numpy(), np.asarray(winfo.foot_contact))
    assert float((tinfo.normal_impulse > 0).float().mean()) > 0.05


def _ball_drop(cfg, n_sub=40, z0=0.07):
    """The ball (r = 0.1) spawned 3 cm deep at rest: the peak base vz over
    ``n_sub`` substeps, and the final z, vz and depth."""
    model = _port_model(ball())
    sub = tsubstep(model, cfg)
    q, qd = T(free_q(pos=(0.0, 0.0, z0)))[None], T(free_qd())[None]
    tau, scene = torch.zeros(1, 0), tscene.flat(1)
    peak = 0.0
    for _ in range(n_sub):
        q, qd, info, _ = sub(q, qd, tau, scene)
        peak = max(peak, float(qd[0, 2]))
    return peak, float(q[0, 2]), float(qd[0, 2]), float(info.contacts.depth[0, 0])


def test_split_impulse_no_energy_injection():
    """Baumgarte depenetration kicks the ball up at ~max_push_vel; split
    impulse resolves the same penetration with a real velocity at least
    20× smaller (tests/test_split_impulse.py::
    test_split_impulse_no_energy_injection)."""
    peak_b, _, _, _ = _ball_drop(TConfig(warm_start=False))
    cfg = TConfig(split_impulse=True, warm_start=False)
    peak_s, _, vz_s, depth_s = _ball_drop(cfg)
    assert peak_b > 0.3, peak_b
    assert peak_s < 0.05 * peak_b, (peak_s, peak_b)
    assert depth_s < cfg.slop + 2e-3, depth_s
    assert abs(vz_s) < 0.05, vz_s


def test_split_impulse_resting_contact():
    """A dropped ball settles at depth ≈ slop and stays, λ warm-started
    (tests/test_split_impulse.py::test_split_impulse_resting_contact)."""
    cfg = TConfig(split_impulse=True)
    model = _port_model(ball())
    sub = tsubstep(model, cfg)
    q, qd = T(free_q(pos=(0.0, 0.0, 0.12)))[None], T(free_qd())[None]
    tau, scene = torch.zeros(1, 0), tscene.flat(1)
    lam = torch.zeros(1, 3 * model.ns)
    for _ in range(240):
        q, qd, _, lam = sub(q, qd, tau, scene, lam_in=lam)
    assert 0.1 - cfg.slop - 2e-3 < float(q[0, 2]) < 0.1 + 1e-3, float(q[0, 2])
    assert abs(float(qd[0, 2])) < 0.05


def test_split_impulse_limit_rows():
    """A hopper leg parked past its bound (1.56 of ±1.5) returns to the
    limit band through the position pass, its speed under 0.12 rad/s
    (tests/test_split_impulse.py::test_split_impulse_limit_rows)."""
    model = _port_model(hopper())
    sub = tsubstep(model, TConfig(split_impulse=True, warm_start=False))
    q = T(free_q(pos=(0.0, 0.0, 5.0), joints=(1.56,)))[None]
    qd = T(free_qd(joints=(0.0,)))[None]
    tau, scene = torch.zeros(1, model.nj), tscene.flat(1)
    peak = 0.0
    for _ in range(30):
        q, qd, _, _ = sub(q, qd, tau, scene)
        peak = max(peak, abs(float(qd[0, 6])))
    assert float(q[0, 7]) < 1.5 + 0.01, float(q[0, 7])
    assert peak < 0.12, peak
