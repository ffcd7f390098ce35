"""PyTorch port vs the JAX package: prismatic joints and fixed bases on the
plain path, on the CPU.

On a floating rig whose first joint is a tilted prismatic slide (from URDF
and from MJCF ``slide``), on the fixed-base pendulum of
tests/test_model_compilers.py and on its MJCF hopper, from seeded q and q̇:
FK (``pos``, ``rot``, ``omega``, ``vel``, ``jp``, ``ja``), ``link_jacobians``,
``point_jacobian`` of the sphere centers, ``bias_forces`` and
``mass_matrix`` within 1e-5 of the JAX package's; then 50 substeps of
``make_substep`` in both (solver options pinned off, so that no state
carries between substeps) within the plain gate (q 2e-4, q̇ 5e-3 on the
per-env median, ten times that on the largest env).
``ops/cuda/engine.supports`` equals the JAX kernel's ``supports`` for every
shipped model and rig.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocca_envs_tpu.models import assets as jassets
from mocca_envs_tpu.models.mjcf import parse_mjcf as jparse_mjcf
from mocca_envs_tpu.models.urdf import parse_urdf as jparse_urdf
from mocca_envs_tpu.ops import dynamics as jdyn
from mocca_envs_tpu.ops import kinematics as jkin
from mocca_envs_tpu.ops.collide import sphere_centers as jcenters
from mocca_envs_tpu.ops.pallas.engine import supports as jsupports
from mocca_envs_tpu.ops.step import make_substep as jsubstep
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu.utils.config import EngineConfig as JConfig
from mocca_envs_tpu_torch.models import assets
from mocca_envs_tpu_torch.models.mjcf import parse_mjcf
from mocca_envs_tpu_torch.models.urdf import parse_urdf
from mocca_envs_tpu_torch.ops import dynamics as tdyn
from mocca_envs_tpu_torch.ops import kinematics as tkin
from mocca_envs_tpu_torch.ops.collide import sphere_centers as tcenters
from mocca_envs_tpu_torch.ops.cuda.engine import supports
from mocca_envs_tpu_torch.ops.step import make_substep as tsubstep
from mocca_envs_tpu_torch.terrain import scene as tscene
from mocca_envs_tpu_torch.utils.config import EngineConfig as TConfig

from tests import torch_workers  # noqa: F401
from tests.test_model_compilers import MJCF_HOPPER, PENDULUM_URDF

# a floating rig: a torso, a slide along a tilted axis, a knee and an ankle
SLIDER_URDF = """
<robot name="slider">
  <link name="torso">
    <inertial><mass value="4"/><origin xyz="0 0 0.05"/>
      <inertia ixx="0.08" iyy="0.07" izz="0.04" ixy="0.001" ixz="0" iyz="0"/></inertial>
    <collision><geometry><sphere radius="0.1"/></geometry></collision>
  </link>
  <link name="slide">
    <inertial><mass value="1.5"/><origin xyz="0 0.02 -0.1"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.004" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 -0.15"/><geometry><sphere radius="0.05"/></geometry></collision>
  </link>
  <link name="shin">
    <inertial><mass value="1"/><origin xyz="0 0 -0.2"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.002" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 -0.2"/>
      <geometry><capsule radius="0.04" length="0.3"/></geometry></collision>
  </link>
  <link name="foot">
    <inertial><mass value="0.4"/><origin xyz="0.04 0 0"/>
      <inertia ixx="0.001" iyy="0.002" izz="0.002" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0.04 0 -0.02"/><geometry><box size="0.18 0.08 0.04"/></geometry></collision>
  </link>
  <joint name="lift" type="prismatic">
    <parent link="torso"/><child link="slide"/>
    <origin xyz="0 0 -0.1" rpy="0 0.1 0"/><axis xyz="0.3 0 1"/>
    <limit lower="-0.2" upper="0.2" effort="100"/>
    <dynamics damping="0.5"/>
  </joint>
  <joint name="knee" type="revolute">
    <parent link="slide"/><child link="shin"/>
    <origin xyz="0 0 -0.2" rpy="0.1 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-1.2" upper="1.2" effort="60"/>
  </joint>
  <joint name="ankle" type="revolute">
    <parent link="shin"/><child link="foot"/>
    <origin xyz="0 0 -0.4"/><axis xyz="1 0 0"/>
    <limit lower="-0.5" upper="0.5" effort="20"/>
  </joint>
</robot>
"""

# the same kind of rig in MJCF: a slide under the torso, then a hinge
SLIDER_MJCF = """
<mujoco model="slider">
  <compiler angle="radian"/>
  <worldbody>
    <body name="torso" pos="0 0 1">
      <freejoint/>
      <inertial mass="4" pos="0 0 0.05" diaginertia="0.08 0.07 0.04"/>
      <geom type="sphere" size="0.1"/>
      <body name="slide" pos="0 0 -0.1" euler="0 0.1 0">
        <joint name="lift" type="slide" axis="0.3 0 1" range="-0.2 0.2" damping="0.5"/>
        <inertial mass="1.5" pos="0 0.02 -0.1" diaginertia="0.01 0.01 0.004"/>
        <geom type="sphere" pos="0 0 -0.15" size="0.05"/>
        <body name="shin" pos="0 0 -0.2">
          <joint name="knee" type="hinge" axis="0 1 0" range="-1.2 1.2"/>
          <inertial mass="1" pos="0 0 -0.2" diaginertia="0.01 0.01 0.002"/>
          <geom type="capsule" fromto="0 0 -0.05 0 0 -0.35" size="0.04"/>
          <body name="foot" pos="0 0 -0.4">
            <joint name="ankle" type="hinge" axis="1 0 0" range="-0.5 0.5"/>
            <inertial mass="0.4" pos="0.04 0 0" diaginertia="0.001 0.002 0.002"/>
            <geom type="box" pos="0.04 0 -0.02" size="0.09 0.04 0.02"/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor joint="lift" gear="100"/>
    <motor joint="knee" gear="60"/>
    <motor joint="ankle" gear="20"/>
  </actuator>
</mujoco>
"""

RIGS = {
    "slider_urdf": lambda p: p[0](SLIDER_URDF),
    "slider_mjcf": lambda p: p[1](SLIDER_MJCF),
    "pendulum": lambda p: p[0](PENDULUM_URDF, floating=False),
    "hopper_mjcf": lambda p: p[1](MJCF_HOPPER),
}
PORT, JAX = (parse_urdf, parse_mjcf), (jparse_urdf, jparse_mjcf)
TOL = {"q": 2e-4, "qd": 5e-3}
CFG_KW = dict(warm_start=False, reuse_factor=False, matfree_pgs=False)


def _states(model, B, seed, z=0.75):
    """Seeded states: a floating base around ``z`` over the plane, tilted a
    little; joints inside their limits; q̇ and torques random."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(model.limit_lo), np.asarray(model.limit_hi)
    q = np.zeros((B, model.nq), np.float32)
    nb = 7 if model.floating else 0
    if model.floating:
        q[:, 2] = z + 0.03 * rng.standard_normal(B)
        q[:, 3:7] = np.array([1.0, 0, 0, 0]) + 0.05 * rng.standard_normal((B, 4))
        q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q[:, nb:] = np.clip(0.3 * rng.standard_normal((B, model.nj)), lo, hi)
    qd = (0.5 * rng.standard_normal((B, model.nv))).astype(np.float32)
    tau = (0.3 * np.asarray(model.power_coef) * rng.uniform(-1, 1, (B, model.nj))).astype(
        np.float32)
    return q, qd, tau


def _jax_quantities(jm):
    """FK, the link and sphere-center Jacobians, M and the bias of one env,
    vmapped and compiled as one function."""
    def one(q, qd):
        fd = jkin.forward_kinematics(jm, q, qd)
        centers = jcenters(jm, fd)
        P = jax.vmap(lambda l, x: jkin.point_jacobian(jm, fd, l, x))(jm.sph_link, centers)
        return (fd, jkin.link_jacobians(jm, fd), P, jdyn.mass_matrix(jm, fd),
                jdyn.bias_forces(jm, fd, qd))

    return jax.jit(jax.vmap(one))


@pytest.mark.parametrize("rig", list(RIGS))
def test_kinematics_and_dynamics_match_jax(rig):
    jm, tm = RIGS[rig](JAX), RIGS[rig](PORT)
    q, qd, _ = _states(jm, 12, seed=3)
    jfd, jJ, jP, jM, jb = _jax_quantities(jm)(q, qd)
    tfd = tkin.forward_kinematics(tm, torch.as_tensor(q), torch.as_tensor(qd))
    for f in ("pos", "rot", "omega", "vel", "jp", "ja", "com_w", "inertia_w"):
        np.testing.assert_allclose(getattr(tfd, f).numpy(), np.asarray(getattr(jfd, f)),
                                   rtol=0, atol=1e-5, err_msg=f)
    for a, b in zip(tkin.link_jacobians(tm, tfd), jJ):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    # the sphere centers' point Jacobians (the contact rows)
    tP = tkin.point_jacobian(tm, tfd, tm.sph_link, tcenters(tm, tfd))
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tdyn.mass_matrix(tm, tfd).numpy(), np.asarray(jM), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tdyn.bias_forces(tm, tfd, torch.as_tensor(qd)).numpy(),
                               np.asarray(jb), rtol=0, atol=1e-5)


def test_link_poses_follow_the_slide():
    """``make_link_poses`` (the task-side FK of a few links) moves a link
    along the slide's axis and leaves its rotation, as the full FK does."""
    tm = parse_urdf(SLIDER_URDF)
    q, qd, _ = _states(tm, 12, seed=9)
    fd = tkin.forward_kinematics(tm, torch.as_tensor(q), torch.as_tensor(qd))
    pos, rot = tkin.make_link_poses(tm, (1, 2, 3))(torch.as_tensor(q))
    torch.testing.assert_close(pos, fd.pos[:, 1:], rtol=0, atol=1e-6)
    torch.testing.assert_close(rot, fd.rot[:, 1:], rtol=0, atol=1e-6)


@pytest.mark.parametrize("rig", list(RIGS))
def test_fifty_substeps_match_jax(rig):
    jm, tm = RIGS[rig](JAX), RIGS[rig](PORT)
    B = 16
    q, qd, tau = _states(jm, B, seed=17)
    ground = 0.0 if jm.floating else -2.0
    jsub = jax.jit(jax.vmap(lambda a, b, c: jsubstep(jm, JConfig(**CFG_KW))(
        a, b, c, jscene.flat(ground_z=ground))[:2]))
    tsub = tsubstep(tm, TConfig(**CFG_KW))
    scene = tscene.flat(B, ground_z=ground)
    jq, jqd = jnp.asarray(q), jnp.asarray(qd)
    tq, tqd, ttau = map(torch.as_tensor, (q, qd, tau))
    active = 0.0
    for _ in range(50):
        jq, jqd = jsub(jq, jqd, tau)
        tq, tqd, info, _ = tsub(tq, tqd, ttau, scene)
        active += float(info.contacts.active.sum()) / 50
    assert bool(torch.isfinite(tq).all() and torch.isfinite(tqd).all())
    for name, got, want in (("q", tq, jq), ("qd", tqd, jqd)):
        per_env = np.abs(got.numpy() - np.asarray(want)).max(axis=1)
        assert np.median(per_env) <= TOL[name], (name, float(np.median(per_env)))
        assert per_env.max() <= 10 * TOL[name], (name, float(per_env.max()))
    if jm.floating:
        assert active > 0.0, "the rig never touched the plane"


def test_supports_matches_jax():
    """The port's kernel coverage equals the JAX kernel's: the shipped
    models (all floating, all revolute) are covered; the fixed-base
    pendulum and the prismatic rigs are not."""
    for name in assets.names():
        assert supports(assets.load(name, device="cpu")) == jsupports(jassets.load(name))
        assert supports(assets.load(name, device="cpu"))
    for rig in RIGS:
        assert supports(RIGS[rig](PORT)) == jsupports(RIGS[rig](JAX)), rig
    assert not supports(RIGS["slider_urdf"](PORT))
    assert not supports(RIGS["pendulum"](PORT))
    assert supports(RIGS["hopper_mjcf"](PORT))
