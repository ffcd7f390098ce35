"""PyTorch port vs the JAX package: the physics step on the CPU.

The port's plain path against ``mocca_envs_tpu/ops/step.py`` on the same
inputs, made from numpy seeds (the modules one by one are in
tests/test_torch_ops.py): the hopper llc frame at the pinned-off solver
options and at the shipped EngineConfig() (λ warm start and frame-start
Minv threaded as in
tests/test_pallas_engine.py::test_pallas_shipped_defaults_match), then one
walker control step at B = 32.

Tolerances: the kernel-vs-oracle gates of tests/test_pallas_engine.py
(q 2e-4, qd 5e-3, depth 2e-4, normal impulse 5e-3) on the per-env median,
and 10× those on the maximum over the batch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocca_envs_tpu.models import walker3d as jwalker
from mocca_envs_tpu.ops import kinematics as jkin
from mocca_envs_tpu.ops.step import limited_joints as jlimited
from mocca_envs_tpu.ops.step import make_control_step as jcontrol
from mocca_envs_tpu.ops.step import make_substep as jsubstep
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu.utils.config import EngineConfig as JConfig
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.models import walker3d as twalker
from mocca_envs_tpu_torch.ops.step import limited_joints as tlimited
from mocca_envs_tpu_torch.ops.step import make_control_step as tcontrol
from mocca_envs_tpu_torch.ops.step import make_plain_llc, make_substep as tsubstep
from mocca_envs_tpu_torch.terrain import scene as tscene
from mocca_envs_tpu_torch.utils.config import EngineConfig as TConfig

from tests import torch_workers  # noqa: F401
from tests.models_util import hopper

TOL = {"q": 2e-4, "qd": 5e-3, "depth": 2e-4, "nimp": 5e-3}
CFG_KW = dict(sim_substeps=2, solver_iters=8, warm_start=False, reuse_factor=False,
              matfree_pgs=False)


def _port_model(jmodel):
    fields = {f.name: getattr(jmodel, f.name) for f in dataclasses.fields(jmodel)}
    fields = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in fields.items()}
    return convert.robot_model_from_numpy(fields)


def _states(nq, nv, nj, B, seed, z=0.58, noise=0.03, gain=0.5):
    """Random states near contact: base at ``z``, small pose noise."""
    rng = np.random.default_rng(seed)
    q = np.zeros((B, nq), np.float32)
    q[:, 2] = z
    q[:, 3] = 1.0
    q += noise * rng.standard_normal((B, nq)).astype(np.float32)
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    qd = (0.3 * rng.standard_normal((B, nv))).astype(np.float32)
    tau = (gain * rng.standard_normal((B, nj))).astype(np.float32)
    return q, qd, tau


def _gate(name, got, want):
    per_env = np.abs(np.asarray(got) - np.asarray(want)).reshape(len(got), -1).max(axis=1)
    tol = TOL[name]
    assert np.median(per_env) <= tol, (name, float(np.median(per_env)), tol)
    assert per_env.max() <= 10 * tol, (name, float(per_env.max()), 10 * tol)


@pytest.mark.parametrize("shipped", [False, True], ids=["pinned_off", "shipped_defaults"])
def test_hopper_llc_frame_matches_jax(shipped):
    """Two substeps at the pinned-off solver options (no carry), and the
    shipped EngineConfig() with λ and the frame-start Minv threaded."""
    jm = hopper()
    tm = _port_model(jm)
    jcfg = JConfig() if shipped else JConfig(**CFG_KW)
    tcfg = TConfig() if shipped else TConfig(**CFG_KW)
    B = 32
    q, qd, tau = _states(jm.nq, jm.nv, jm.nj, B, seed=41 if shipped else 0)
    nr = len(jlimited(jm)) + 3 * jm.ns
    sub = jsubstep(jm, jcfg)
    scene = jscene.flat()

    def jax_path(q1, qd1, t1):
        qq, dd = q1, qd1
        lam = jnp.zeros(nr)
        Minv0 = sub.minv_of(jkin.forward_kinematics(jm, qq, dd)) if shipped else None
        for _ in range(jcfg.sim_substeps):
            if shipped:
                qq, dd, info, lam = sub(qq, dd, t1, scene, Minv_in=Minv0, lam_in=lam)
            else:
                qq, dd, info, _ = sub(qq, dd, t1, scene)
        return qq, dd, info.contacts.depth, info.normal_impulse

    want = jax.jit(jax.vmap(jax_path))(q, qd, tau)
    unit = make_plain_llc(tm, tcfg, tsubstep(tm, tcfg))
    tq, tqd, info = unit(*map(torch.as_tensor, (q, qd, tau)), tscene.flat(B))
    got = (tq, tqd, info.contacts.depth, info.normal_impulse)
    assert tlimited(tm) == jlimited(jm)
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        _gate(name, g.numpy(), w)
    # the port's plain frame must see contact at all for this gate to mean much
    assert float((info.normal_impulse > 0).float().mean()) > 0.1


def test_walker_control_step_matches_jax():
    """One walker control step (torque actuation, shipped config) at B = 32."""
    jm = jwalker.make_model()
    tm = twalker.make_model()
    B = 32
    rng = np.random.default_rng(11)
    q, qd, _ = _states(jm.nq, jm.nv, jm.nj, B, seed=11, z=0.9, noise=0.1)
    action = rng.uniform(-1, 1, (B, jm.nj)).astype(np.float32)
    gain = np.array(jm.power_coef * jm.actuated)
    jstep = jcontrol(jm, JConfig(), actuation=lambda q_, qd_, a: gain * jnp.clip(a, -1, 1))
    want_q, want_qd, winfo = jax.jit(jax.vmap(
        lambda a, b, c: jstep(a, b, c, jscene.flat())))(q, qd, action)
    tgain = torch.as_tensor(gain)
    tstep = tcontrol(tm, TConfig(), actuation=lambda q_, qd_, a: tgain * torch.clamp(a, -1, 1))
    tq, tqd, tinfo = tstep(*map(torch.as_tensor, (q, qd, action)), tscene.flat(B))
    _gate("q", tq.numpy(), want_q)
    _gate("qd", tqd.numpy(), want_qd)
    _gate("depth", tinfo.contacts.depth.numpy(), winfo.contacts.depth)
    _gate("nimp", tinfo.normal_impulse.numpy(), winfo.normal_impulse)
    np.testing.assert_array_equal(tinfo.foot_contact.numpy(), np.asarray(winfo.foot_contact))
    np.testing.assert_array_equal(tinfo.link_contact.numpy(), np.asarray(winfo.link_contact))
