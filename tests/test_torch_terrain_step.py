"""PyTorch port vs the JAX package: one walker control step over fractal
terrain (CPU).

The same walker states, over grids of the family's bank, go through the JAX
package's control step (its XLA path on the CPU, over the window around the
root that its terrain env cuts) and the port's (given the full grid: its
unit cuts the window itself). Gated as the JAX package gates its own
heightfield kernel (tests/test_pallas_engine.py): per-env medians within
q 2e-4, qd 1e-2, depth 5e-4 and normal impulse 1e-2, the largest single-env
error within ten times that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mocca_envs_tpu.models import walker3d as jwalker
from mocca_envs_tpu.ops.step import make_control_step as jcontrol
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu.utils.config import EngineConfig as JConfig
from mocca_envs_tpu_torch.models import walker3d as twalker
from mocca_envs_tpu_torch.ops.step import make_control_step as tcontrol
from mocca_envs_tpu_torch.tasks.walker_terrain import terrain_bank
from mocca_envs_tpu_torch.terrain import scene as tscene
from mocca_envs_tpu_torch.terrain.heightfield import with_heightfield
from mocca_envs_tpu_torch.utils.config import EngineConfig as TConfig

from tests import torch_workers  # noqa: F401

TOL_HF = {"q": 2e-4, "qd": 1e-2, "depth": 5e-4, "nimp": 1e-2}
T = torch.as_tensor
EXTENT = 20.0


def _gate(name, got, want):
    per_env = np.abs(np.asarray(got) - np.asarray(want)).reshape(len(got), -1).max(axis=1)
    assert np.median(per_env) <= TOL_HF[name], (name, float(np.median(per_env)))
    assert per_env.max() <= 10 * TOL_HF[name], (name, float(per_env.max()))


def walker_over_terrain(B, seed):
    """Walker states over grids of the terrain bank: the root anywhere on the
    grid (some slots by its border), its height 0.9 m over the surface
    under it ± 4 cm, so that the feet are in or near contact with sloped
    ground. Numpy ``(q, qd, heights (B, H, W))``."""
    rng = np.random.default_rng(seed)
    bank = terrain_bank()
    heights = bank[rng.integers(0, len(bank), B)]
    scene = with_heightfield(T(heights), extent=EXTENT)
    q = np.zeros((B, 28), np.float32)
    q[:, 0:2] = rng.uniform(-9.6, 9.6, (B, 2))
    q[: B // 4, 0] = rng.choice([-9.8, 9.8], B // 4)        # by the border
    q[:, 3:7] = np.array([1.0, 0.0, 0.0, 0.0]) + 0.03 * rng.standard_normal((B, 4))
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q[:, 7:] = 0.1 * rng.standard_normal((B, 21))
    surface = tscene.hf_sample(scene, T(q[:, 0:2])).numpy()
    q[:, 2] = surface + 0.9 + 0.04 * rng.standard_normal(B)
    qd = (0.3 * rng.standard_normal((B, 27))).astype(np.float32)
    return q, qd, heights


def test_walker_control_step_over_terrain_matches_jax():
    B = 16
    jm, tm = jwalker.make_model(), twalker.make_model()
    q, qd, heights = walker_over_terrain(B, 21)
    action = np.random.default_rng(22).uniform(-1, 1, (B, 21)).astype(np.float32)
    gain = np.array(jm.power_coef * jm.actuated)
    jstep = jcontrol(jm, JConfig(), actuation=lambda q_, qd_, a: gain * jnp.clip(a, -1, 1))
    cell = EXTENT / (heights.shape[1] - 1)
    P = tscene.HF_PATCH

    def jax_path(q1, qd1, a, h):
        sc = jscene.Scene(has_ground=False, has_hf=True, hf_height=h,
                          hf_xy0=jnp.full(2, -EXTENT / 2), hf_cell=jnp.asarray(cell),
                          friction=jnp.asarray(0.8))
        qq, dd, info = jstep(q1, qd1, a, jscene.extract_patch(sc, q1[0:2], P))
        return (qq, dd, info.contacts.depth, info.normal_impulse, info.foot_contact,
                info.contacts.normal)

    want = jax.jit(jax.vmap(jax_path))(q, qd, action, heights)
    tgain = T(gain)
    tstep = tcontrol(tm, TConfig(), actuation=lambda q_, qd_, a: tgain * torch.clamp(a, -1, 1))
    scene = with_heightfield(T(heights), extent=EXTENT)
    tq, tqd, info = tstep(T(q), T(qd), T(action), scene)
    _gate("q", tq.numpy(), want[0])
    _gate("qd", tqd.numpy(), want[1])
    _gate("depth", info.contacts.depth.numpy(), want[2])
    _gate("nimp", info.normal_impulse.numpy(), want[3])
    np.testing.assert_array_equal(info.foot_contact.numpy(), np.asarray(want[4]))
    # the gate means something: the terrain carries load, on sloped normals,
    # and the plane (sunk to −1e9) never wins a contact
    loaded = info.normal_impulse.numpy() > 0
    assert loaded.mean() > 0.05
    assert (info.contacts.normal.numpy()[loaded][:, 2] < 0.995).any()
    assert float(info.contacts.depth.min()) > -10.0
    assert scene.hf_height.shape == (B, 65, 65)


def test_small_grid_runs_the_plain_path_on_the_cpu():
    """A grid smaller than the window takes no window; the plain path
    samples it whole (on the card too: ``unit_route``, below, and
    chip_smoke.py's ``small_grid_plain``)."""
    B = 4
    tm = twalker.make_model()
    q, qd, heights = walker_over_terrain(B, 5)
    small = heights[:, 28:40, 28:40]                           # 12 × 12 around the middle
    cell = EXTENT / 64
    scene = tscene.Scene(
        ground_z=torch.full((B,), tscene.NO_GROUND_Z), friction=torch.full((B,), 0.8),
        hf_height=T(small), hf_xy0=torch.full((B, 2), (28 - 32) * cell),
        hf_cell=torch.full((B,), cell))
    q[:, 0:2] = 0.3
    q[:, 2] = tscene.hf_sample(scene, T(q[:, 0:2])).numpy() + 0.9
    step = tcontrol(tm, TConfig())
    tq, tqd, info = step(T(q), T(qd), torch.zeros(B, 21), scene)
    assert bool(torch.isfinite(tq).all()) and bool((info.normal_impulse > 0).any())


def test_unit_route_sends_a_small_grid_to_the_plain_path():
    """On the card a grid smaller than the 16 × 16 window takes the plain
    path, as the JAX package decides at trace time; the family's 65² grid
    takes K1f; CPU tensors and a model the kernel does not cover take the
    plain path on any grid."""
    from mocca_envs_tpu_torch.ops.cuda import engine
    from mocca_envs_tpu_torch.ops.step import unit_route

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert unit_route(cuda, True, (12, 12)) == "plain"
    assert unit_route(cuda, True, (tscene.HF_PATCH - 1, 65)) == "plain"
    assert unit_route(cuda, True, (65, 65)) == "kernel"
    assert unit_route(cuda, True, (tscene.HF_PATCH,) * 2) == "kernel"
    assert unit_route(cuda, True) == "kernel"
    assert unit_route(cpu, True, (65, 65)) == "plain"
    assert unit_route(cuda, False, (65, 65)) == "plain"
    kernel = engine.make_kernel(twalker.make_model(), TConfig(), hf_patch=tscene.HF_PATCH)
    assert kernel.variant == "k1f" and kernel.inputs == ("hf",)
