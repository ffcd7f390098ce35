"""PyTorch port vs the JAX package: the batched Walker3DStairsEnv (CPU).

Both packages get the same states and actions each step: the port is
re-synced from the JAX state through numpy, each slot's mesh included. Half
the slots start at the family's spawn in front of the stairs and half on a
tread, raised onto it, so that the mesh carries the feet; they stand clear
of the risers, where a contact's tangent basis turns with the sign of a
rounded n_z (chip_smoke.py::vertical_contacts), but random actions swing
feet into them.
Done flags must be equal on every step; rewards and observations agree to
1e-4 on the per-env median and 1e-3 on the largest env (the walker on the
plane holds its rewards to 1e-4 in every env: here the closest point on a
4 m wide tread triangle carries ~5e-5 of rounding, tests/test_torch_trimesh.py,
which the contact rows pass on), the largest-env gates over the envs whose
feet touch no riser in that step. Targets are
placed out of reach, so no random target resample happens. The fresh
episodes come from different generators (threefry vs torch) and are checked
for the reset distribution's support; the mesh is built once, on the device,
and every slot keeps the same tensor across its resets.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import mocca_envs_tpu
import mocca_envs_tpu_torch
from mocca_envs_tpu.core import rng as jrng
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.core import rng as trng
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.terrain.scene import TRI_FIELDS, cull_tris, tri_surface_z
from mocca_envs_tpu_torch.utils.config import EngineConfig

from tests import torch_workers  # noqa: F401

B = 8
STEPS = 30
AHEAD = 3.0
ID = "Walker3DStairsEnv-v0"


@pytest.fixture(scope="module")
def envs():
    jenv = mocca_envs_tpu.make(ID)
    return jenv, mocca_envs_tpu_torch.make(ID, device="cpu"), jax.jit(jax.vmap(jenv.init))


def _to_port(js):
    n = np.asarray
    sc = js.scene
    return convert.env_state_from_numpy(
        q=n(js.q), qd=n(js.qd), steps=n(js.steps), reset_count=n(js.reset_count),
        done=n(js.done), blowup_count=n(js.blowup_count), target=n(js.task.target),
        potential=n(js.task.potential), ground_z=n(sc.ground_z), friction=n(sc.friction),
        **{f: n(getattr(sc, f)) for f in TRI_FIELDS})


def _on_treads(jenv, state):
    """Slots 4.. moved onto treads 1–4, raised by the tread's height, the
    root 0.12 m behind the tread's nosing, so that the feet (0.17 m long)
    stand clear of both risers; every target 3 m ahead of its root."""
    q = np.array(state.q)
    k = np.arange(len(q)) % 4
    x = 0.6 + 0.35 * k + 0.12
    q[4:, 0] = x[4:]
    q[4:, 2] += 0.12 * (k[4:] + 1)
    target = np.zeros((len(q), 3), np.float32)
    target[:, :2] = q[:, :2]
    target[:, 0] += AHEAD
    dist = np.linalg.norm(target[:, :2] - q[:, :2], axis=1)
    return state.replace(q=jnp.asarray(q), task=state.task.replace(
        target=jnp.asarray(target), potential=jnp.asarray(-dist / jenv.control_dt)))


def test_env_matches_jax_step_by_step(envs):
    jenv, penv, jinit = envs
    js = _on_treads(jenv, jinit(jrng.env_keys(jrng.root_key(0), B)))
    jstep = jax.jit(jax.vmap(jenv.step))
    gen = trng.generator(0, "cpu")
    rng = np.random.default_rng(0)
    k1g = engine.K1g(penv.model, EngineConfig())
    gain = penv.model.power_coef * penv.model.actuated
    resets, on_mesh, riser = 0, 0, 0
    for t in range(STEPS):
        a = rng.uniform(-1, 1, (B, jenv.act_dim)).astype(np.float32)
        ps = _to_port(js)
        jtr = jstep(js, jnp.asarray(a))
        ptr = penv.step(ps, torch.as_tensor(a), gen)
        jdone = np.array(jtr.done)
        np.testing.assert_array_equal(ptr.done.numpy(), jdone, err_msg=f"step {t}")
        # envs whose feet touch a riser in this step: the tail gates hold the others
        window = cull_tris(ps.scene, ps.q[:, 0:2], 16)
        vertical = chip_smoke.vertical_contacts(k1g, [
            ps.q, ps.qd, gain * torch.clamp(torch.as_tensor(a), -1, 1), window.ground_z,
            window.friction, engine.pack_tris(window)]).numpy()
        riser += int(vertical.sum())
        r_err = np.abs(ptr.reward.numpy() - np.asarray(jtr.reward))
        assert np.median(r_err) <= 1e-4 and r_err[~vertical].max() <= 1e-3, (t, r_err)
        live = ~jdone
        per_env = np.abs(ptr.obs.numpy() - np.asarray(jtr.obs)).max(axis=1)
        assert np.median(per_env[live]) <= 1e-4 and per_env[live & ~vertical].max() <= 1e-3, (
            t, per_env, vertical)
        np.testing.assert_allclose(ptr.state.task.target.numpy()[live],
                                   np.asarray(jtr.state.task.target)[live], atol=1e-5)
        # feet on a tread: the slot's surface is above the plane
        surface = tri_surface_z(ps.scene, ps.q[:, 0:2]).numpy()
        on_mesh += int((surface[live] > 0.1).sum())
        if jdone.any():
            fresh = ptr.state.q.numpy()[jdone]
            np.testing.assert_allclose(fresh[:, :3], [[0.0, 0.0, 0.96]] * len(fresh), atol=1e-6)
            assert (ptr.state.steps.numpy()[jdone] == 0).all()
            np.testing.assert_allclose(ptr.obs.numpy()[jdone][:, -2:], 0.0)   # zero foot flags
            resets += int(jdone.sum())
        assert not np.asarray(jtr.metrics["reached_target"]).any()
        js = jtr.state
    assert resets >= 2, "the horizon should see auto-resets"
    assert on_mesh >= STEPS, "the treads should carry bodies"
    assert riser < STEPS * B // 4, riser


def test_registry_is_the_jax_registry():
    """The stairs are the port's fifteenth family: the two registries hold
    the same ids."""
    assert mocca_envs_tpu_torch.registered_envs() == mocca_envs_tpu.registered_envs()
    assert len(mocca_envs_tpu_torch.registered_envs()) == 15


def test_exact_obs_and_state_roundtrip(envs):
    """``obs_fn`` (exact frame-0 foot flags, the mesh's support height in
    the fall test) agrees with the JAX package's on the same states, some
    feet on a tread; the mesh crosses the numpy seam."""
    jenv, penv, jinit = envs
    js = _on_treads(jenv, jinit(jrng.env_keys(jrng.root_key(5), 8)))
    q = np.array(js.q)
    q[[0, 4, 5], 2] -= 0.08          # feet in the ground, and in a tread
    js = js.replace(q=jnp.asarray(q))
    ps = _to_port(js)
    want = np.asarray(jax.jit(jax.vmap(jenv.obs_fn))(js))
    got = penv.obs_fn(ps).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got[[0, 4, 5], -2:].sum() > 0 and got[[1, 2, 3], -2:].sum() == 0
    back = convert.env_state_from_numpy(**convert.env_state_to_numpy(ps))
    for a, b in zip(convert.env_state_to_numpy(back).values(),
                    convert.env_state_to_numpy(ps).values()):
        np.testing.assert_array_equal(a, b)
    assert back.scene.tri_a.shape == (8, 24, 3)


def test_mesh_built_once_and_kept_across_resets():
    """The env holds one mesh on its device: every slot views it (no copy
    per slot), and a fresh episode keeps its slot's scene, the same
    tensors; the fresh spawn and target are the family's."""
    env = mocca_envs_tpu_torch.make(ID, device="cpu")
    batch = mocca_envs_tpu_torch.BatchedEnv(env, 6, seed=2, device="cpu")
    state = batch.init()
    scene = state.scene
    assert scene.tri_a.shape == (6, 24, 3) and scene.tri_a.stride(0) == 0
    assert float(scene.ground_z.max()) == 0.0
    # the plane and friction go to the kernel as they are: one float per env
    assert scene.ground_z.is_contiguous() and scene.friction.is_contiguous()
    state = dataclasses.replace(state, steps=state.steps + 999)
    tr = batch.step(state, torch.zeros(6, env.act_dim))
    assert bool(tr.done.all()) and bool((tr.state.reset_count == 1).all())
    assert tr.state.scene is scene
    dist = torch.linalg.vector_norm(tr.state.task.target[:, :2] - tr.state.q[:, :2], dim=1)
    assert bool(((dist >= 1.0) & (dist < 2.5)).all())
    assert env.obs_dim == 52 and env.act_dim == 21
