"""PyTorch port vs the JAX package: the physics modules one by one (CPU).

Forward kinematics and point Jacobians, the mass matrix and bias forces on
the walker, the unrolled Cholesky and its solves, the Delassus build and the
PGS solver (row and block mode, warm-started): the port's batched functions
against the JAX functions vmapped, on the same inputs made from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocca_envs_tpu.models import walker3d as jwalker
from mocca_envs_tpu.ops import dynamics as jdyn
from mocca_envs_tpu.ops import kinematics as jkin
from mocca_envs_tpu.ops import linalg as jlinalg
from mocca_envs_tpu.ops import solver as jsolver
from mocca_envs_tpu_torch.models import walker3d as twalker
from mocca_envs_tpu_torch.ops import dynamics as tdyn
from mocca_envs_tpu_torch.ops import kinematics as tkin
from mocca_envs_tpu_torch.ops import linalg as tlinalg
from mocca_envs_tpu_torch.ops import solver as tsolver

from tests import torch_workers  # noqa: F401
from tests.test_torch_physics import _states


@pytest.fixture(scope="module")
def walker():
    jm = jwalker.make_model()
    q, qd, tau = _states(jm.nq, jm.nv, jm.nj, 8, seed=3, z=0.9, noise=0.1)
    return jm, twalker.make_model(), q, qd


def test_kinematics_matches_jax(walker):
    jm, tm, q, qd = walker
    jfd = jax.vmap(lambda a, b: jkin.forward_kinematics(jm, a, b))(q, qd)
    tfd = tkin.forward_kinematics(tm, torch.as_tensor(q), torch.as_tensor(qd))
    for f in dataclasses.fields(tfd):
        np.testing.assert_allclose(getattr(tfd, f.name).numpy(), np.asarray(getattr(jfd, f.name)),
                                   atol=2e-6, err_msg=f.name)
    link = np.asarray(jm.sph_link)
    pts = np.asarray(jfd.pos)[:, link] + 0.05
    jJ = jax.vmap(lambda fd, p: jax.vmap(lambda l, x: jkin.point_jacobian(jm, fd, l, x))(
        jnp.asarray(link), p))(jfd, pts)
    tJ = tkin.point_jacobian(tm, tfd, tm.sph_link, torch.as_tensor(pts))
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), atol=2e-6)


def test_dynamics_matches_jax(walker):
    jm, tm, q, qd = walker
    jfd = jax.vmap(lambda a, b: jkin.forward_kinematics(jm, a, b))(q, qd)
    tfd = tkin.forward_kinematics(tm, torch.as_tensor(q), torch.as_tensor(qd))
    jM = jax.vmap(lambda fd: jdyn.mass_matrix(jm, fd))(jfd)
    np.testing.assert_allclose(tdyn.mass_matrix(tm, tfd).numpy(), np.asarray(jM),
                               rtol=1e-5, atol=1e-5)
    jb = jax.vmap(lambda fd, v: jdyn.bias_forces(jm, fd, v))(jfd, qd)
    tb = tdyn.bias_forces(tm, tfd, torch.as_tensor(qd))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-4)


def test_linalg_matches_jax():
    rng = np.random.default_rng(5)
    X = rng.standard_normal((6, 12, 12)).astype(np.float32)
    M = (np.einsum("bij,bkj->bik", X, X) + 0.1 * np.eye(12)).astype(np.float32)
    b = rng.standard_normal((6, 12)).astype(np.float32)
    jL = jax.vmap(jlinalg.chol_factor)(M)
    tL = tlinalg.chol_factor(torch.as_tensor(M))
    np.testing.assert_allclose(tL.numpy(), np.asarray(jL), rtol=1e-4, atol=1e-5)
    jx = jax.vmap(jlinalg.cho_solve)(jL, b)
    np.testing.assert_allclose(tlinalg.cho_solve(tL, torch.as_tensor(b)).numpy(),
                               np.asarray(jx), rtol=1e-3, atol=1e-4)
    jinv = jax.vmap(jlinalg.chol_inverse)(jL)
    np.testing.assert_allclose(tlinalg.chol_inverse(tL).numpy(), np.asarray(jinv),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("block", [False, True])
def test_pgs_matches_jax(block):
    """Delassus + PGS over [limits | contacts] rows, with warm start."""
    rng = np.random.default_rng(7)
    B, nv, nlim, nc = 4, 12, 3, 4
    nr = nlim + 3 * nc
    X = rng.standard_normal((B, nv, nv)).astype(np.float32)
    Minv = (np.einsum("bij,bkj->bik", X, X) / nv + 0.5 * np.eye(nv)).astype(np.float32)
    J = rng.standard_normal((B, nr, nv)).astype(np.float32)
    c = rng.standard_normal((B, nr)).astype(np.float32)
    act = (rng.uniform(size=(B, nr)) > 0.2).astype(np.float32)
    mu = rng.uniform(0.3, 1.0, (B, nc)).astype(np.float32)
    lam0 = np.abs(rng.standard_normal((B, nr))).astype(np.float32)
    jA, _ = jax.vmap(lambda m, j: jsolver.delassus(m, j, 1e-6))(Minv, J)
    tA, _ = tsolver.delassus(torch.as_tensor(Minv), torch.as_tensor(J), 1e-6)
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), rtol=1e-5, atol=1e-5)
    jl = jax.vmap(lambda a, cc, ac, m, l0: jsolver.pgs_solve(
        a, cc, ac, m, 0, nc, 6, nlim=nlim, block=block, lam0=l0))(jA, c, act, mu, lam0)
    tl = tsolver.pgs_solve(tA, *map(torch.as_tensor, (c, act, mu)), 0, nc, 6, nlim=nlim,
                           block=block, lam0=torch.as_tensor(lam0))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3, atol=1e-4)
