"""PyTorch port vs the JAX package: fractal heightfields, their sampling,
the patch window and the heightfield narrowphase (CPU).

The port carries a numpy transcription of the native diamond-square
generator (native/heightfield.cpp); its grids must be the JAX package's
native ones bit for bit. Sampling, normals and the window agree to 1e-6 on
random points, the grid's borders included; the narrowphase to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocca_envs_tpu.models import walker3d as jwalker
from mocca_envs_tpu.ops import collide as jcollide
from mocca_envs_tpu.ops import kinematics as jkin
from mocca_envs_tpu.terrain import heightfield as jhf
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.models import walker3d as twalker
from mocca_envs_tpu_torch.ops import collide as tcollide
from mocca_envs_tpu_torch.ops import kinematics as tkin
from mocca_envs_tpu_torch.terrain import heightfield as thf
from mocca_envs_tpu_torch.terrain import scene as tscene

from tests import torch_workers  # noqa: F401

T = torch.as_tensor
EXTENT = 20.0


@pytest.mark.parametrize("n, seed, amplitude, roughness, smooth", [
    (17, 2, 0.4, 0.55, 1), (65, 0, 0.25, 0.55, 1), (65, 15, 0.25, 0.55, 1),
    (129, 3, 0.5, 0.55, 1), (33, 7, 0.3, 0.7, 0), (33, 2**40 + 5, 0.3, 0.4, 2),
])
def test_generator_is_bit_identical_to_native(n, seed, amplitude, roughness, smooth):
    assert jhf._native_lib() is not None, "the JAX package's native generator did not load"
    want = jhf.fractal_heightfield(n, roughness=roughness, amplitude=amplitude, seed=seed,
                                   smooth_iters=smooth)
    got = thf.fractal_heightfield(n, roughness=roughness, amplitude=amplitude, seed=seed,
                                  smooth_iters=smooth)
    assert got.dtype == np.float32 and got.shape == (n, n)
    np.testing.assert_array_equal(got, want)
    assert abs(float(got.mean())) < 1e-5 and float(got.std()) > 0.01
    with pytest.raises(ValueError, match="power of two"):
        thf.fractal_heightfield(n + 1)


def _grids(B, n, seed):
    return np.stack([thf.fractal_heightfield(n, amplitude=0.25, seed=seed + i)
                     for i in range(B)])


def _jax_scene(h, xy0, cell):
    return jscene.Scene(has_ground=False, has_hf=True, hf_height=h, hf_xy0=xy0, hf_cell=cell,
                        friction=jnp.asarray(0.8))


def _points(rng, B, K, lo=-11.0, hi=11.0):
    """Points over the grid and past its borders (clamped there), a few on
    the border and the corner exactly."""
    xy = rng.uniform(lo, hi, (B, K, 2)).astype(np.float32)
    xy[:, 0] = -EXTENT / 2
    xy[:, 1] = EXTENT / 2
    xy[:, 2, 0] = EXTENT / 2
    return xy


def test_sample_normal_corners_match_jax():
    B, K, n = 6, 64, 65
    rng = np.random.default_rng(0)
    h = _grids(B, n, 40)
    xy0 = np.full((B, 2), -EXTENT / 2, np.float32) + rng.uniform(-0.5, 0.5, (B, 2)).astype(
        np.float32)
    cell = np.full(B, EXTENT / (n - 1), np.float32)
    xy = _points(rng, B, K)
    scene = convert.scene_from_numpy(B, tscene.NO_GROUND_Z, 0.8, hf_height=h, hf_xy0=xy0,
                                     hf_cell=cell)
    assert scene.has_hf and not scene.has_stones

    def jax_path(h1, x01, c1, p):
        sc = _jax_scene(h1, x01, c1)
        return (jscene.hf_sample(sc, p), jscene.hf_normal(sc, p),
                jscene.hf_corners(sc, p), jscene.hf_sample_onehot(sc, p))

    want_h, want_n, want_c, want_oh = jax.jit(jax.vmap(jax_path))(h, xy0, cell, xy)
    np.testing.assert_allclose(tscene.hf_sample(scene, T(xy)).numpy(), want_h, atol=1e-6)
    np.testing.assert_allclose(tscene.hf_normal(scene, T(xy)).numpy(), want_n, atol=1e-6)
    for g, w in zip(tscene.hf_corners(scene, T(xy)), want_c):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    # the one-hot form of the JAX package is the same function
    np.testing.assert_allclose(tscene.hf_sample(scene, T(xy)).numpy(), want_oh, atol=1e-6)
    # a grid point samples its own height; normals are unit and mostly up
    np.testing.assert_allclose(tscene.hf_sample(scene, T(xy0[:, None])).numpy()[:, 0],
                               h[:, 0, 0], atol=1e-6)
    nrm = tscene.hf_normal(scene, T(xy)).numpy()
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=-1), 1.0, atol=1e-6)
    assert (nrm[..., 2] > 0.5).all()
    # (B, 2) points sample as (B,): one point per env
    np.testing.assert_allclose(tscene.hf_sample(scene, T(xy[:, 3])).numpy(), want_h[:, 3],
                               atol=1e-6)


def test_extract_patch_matches_jax_and_the_full_grid():
    """The window of each env around its root, the grid's edges included:
    the same heights and corner as the JAX package's, and samples of the
    window equal samples of the grid within (P/2 − 2)·cell of the root."""
    B, n, P = 32, 65, tscene.HF_PATCH
    rng = np.random.default_rng(1)
    h = _grids(B, n, 7)
    scene = thf.with_heightfield(T(h), extent=EXTENT)
    cell = float(scene.hf_cell[0])
    root = rng.uniform(-10.0, 10.0, (B, 2)).astype(np.float32)
    root[:4] = [[-10.0, -10.0], [9.99, 9.99], [-9.9, 3.0], [0.0, 9.8]]   # at the edges

    def jax_path(h1, c):
        p = jscene.extract_patch(_jax_scene(h1, jnp.full(2, -EXTENT / 2), jnp.asarray(cell)),
                                 c, P)
        return p.hf_height, p.hf_xy0

    want_h, want_xy0 = jax.jit(jax.vmap(jax_path))(h, root)
    patch = tscene.extract_patch(scene, T(root), P)
    assert patch.hf_height.shape == (B, P, P)
    np.testing.assert_array_equal(patch.hf_height.numpy(), want_h)
    np.testing.assert_allclose(patch.hf_xy0.numpy(), want_xy0, atol=1e-6)
    assert patch.hf_cell is scene.hf_cell and patch.ground_z is scene.ground_z
    margin = (P / 2 - 2) * cell
    pts = np.clip(root[:, None] + rng.uniform(-margin, margin, (B, 64, 2)), -10.0, 10.0)
    np.testing.assert_allclose(tscene.hf_sample(patch, T(pts.astype(np.float32))).numpy(),
                               tscene.hf_sample(scene, T(pts.astype(np.float32))).numpy(),
                               atol=1e-6)
    # a grid that already is a window passes through
    assert tscene.extract_patch(patch, T(root), P) is patch


def test_with_heightfield_has_no_plane():
    h = T(_grids(2, 17, 0))
    scene = thf.with_heightfield(h, extent=5.0, friction=0.6)
    assert scene.has_hf and float(scene.ground_z.max()) == tscene.NO_GROUND_Z
    torch.testing.assert_close(scene.hf_cell, torch.full((2,), 5.0 / 16))
    torch.testing.assert_close(scene.hf_xy0, torch.full((2, 2), -2.5))
    torch.testing.assert_close(scene.friction, torch.full((2,), 0.6))


def test_collide_with_heightfield_matches_jax():
    """Spheres vs the heightfield (no plane): the depth along the surface
    normal under each center, the contact point on the surface."""
    B, n = 16, 65
    rng = np.random.default_rng(3)
    jm, tm = jwalker.make_model(), twalker.make_model()
    h = _grids(B, n, 100)
    scene = thf.with_heightfield(T(h), extent=EXTENT)
    cell = float(scene.hf_cell[0])
    q = np.zeros((B, 28), np.float32)
    q[:, 0:2] = rng.uniform(-9.5, 9.5, (B, 2))
    q[:2, 0:2] = [[-9.9, -9.9], [9.9, 0.0]]             # over the border
    q[:, 3:7] = [1.0, 0.0, 0.0, 0.0]
    q[:, 7:] = 0.1 * rng.standard_normal((B, 21))
    surface = tscene.hf_sample(scene, T(q[:, 0:2])).numpy()
    q[:, 2] = surface + 0.93 + 0.05 * rng.standard_normal(B)
    qd = np.zeros((B, 27), np.float32)

    def jax_path(q1, qd1, h1):
        fd = jkin.forward_kinematics(jm, q1, qd1)
        sc = _jax_scene(h1, jnp.full(2, -EXTENT / 2), jnp.asarray(cell))
        c = jcollide.collide(jm, fd, sc, 0.02)
        return c.pos, c.normal, c.depth, c.active

    want = [np.asarray(x) for x in jax.jit(jax.vmap(jax_path))(q, qd, h)]
    c = tcollide.collide(tm, tkin.forward_kinematics(tm, T(q), T(qd)), scene, 0.02)
    np.testing.assert_allclose(c.depth.numpy(), want[2], atol=1e-5)
    np.testing.assert_array_equal(c.active.numpy(), want[3])
    np.testing.assert_allclose(c.pos.numpy(), want[0], atol=1e-5)
    np.testing.assert_allclose(c.normal.numpy(), want[1], atol=1e-5)
    touching = want[3] > 0.5
    assert 0.02 < touching.mean() < 0.5
    assert (c.normal.numpy()[touching][:, 2] < 0.999).any()   # sloped ground
    # the same over the window around the root, as the physics reads it
    patch = tscene.extract_patch(scene, T(q[:, 0:2]))
    cp = tcollide.collide(tm, tkin.forward_kinematics(tm, T(q), T(qd)), patch, 0.02)
    np.testing.assert_allclose(cp.depth.numpy(), want[2], atol=1e-5)


def test_heightfield_scene_crosses_the_numpy_seam():
    B = 3
    h = _grids(B, 17, 5)
    scene = thf.with_heightfield(T(h), extent=4.0)
    fields = convert.scene_to_numpy(scene)
    assert set(fields) == {"ground_z", "friction", "hf_height", "hf_xy0", "hf_cell"}
    back = convert.scene_from_numpy(B, **fields)
    for name in fields:
        torch.testing.assert_close(getattr(back, name), getattr(scene, name), atol=0, rtol=0)
    # a JAX terrain scene (has_ground=False, ground_z 0) sinks its plane
    js = jhf.with_heightfield(h[0], extent=4.0)
    assert not js.has_ground and float(js.ground_z) == 0.0
    conv = convert.scene_from_numpy(
        B, has_ground=js.has_ground, ground_z=np.asarray(js.ground_z),
        friction=np.asarray(js.friction), hf_height=np.broadcast_to(np.asarray(js.hf_height),
                                                                    (B, 17, 17)),
        hf_xy0=np.broadcast_to(np.asarray(js.hf_xy0), (B, 2)),
        hf_cell=np.broadcast_to(np.asarray(js.hf_cell), (B,)))
    assert float(conv.ground_z.max()) == tscene.NO_GROUND_Z
    torch.testing.assert_close(conv.hf_height[0], T(h[0]))
