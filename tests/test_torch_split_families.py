"""PyTorch port vs the JAX package: split impulse on the families of the
training path (CPU).

``python -m mocca_envs_tpu.harness.train --split-impulse`` builds each
family's own config with the flag on: ``EngineConfig(split_impulse=True)``
for the stepper and the monkey, ``CASSIE_CONFIG`` with it for Cassie and
Cassie2D. One control step of each through the port's plain path and the
JAX package's ``make_control_step`` (its XLA path) on the same numpy
states, at the tolerances of that family's non-split step test (Cassie's
are in tests/test_torch_split_cassie.py):

- the stepper over 20 stones culled to the 6-stone window
  (tests/test_torch_stones.py's states and gates: per-env medians within q
  2e-4, qd 5e-3, depth 2e-4, normal impulse 5e-3, the largest env within
  ten times), B = 32;
- the monkey over its bars with its grab rows (tests/test_torch_monkey_step.py's
  states and gates: medians within q 5e-4, qd 2e-2, depth 5e-4, impulse
  1e-2, the largest env within ten times), B = 16.

Each also checks that the position pass has work: the split step parts
from the unsplit one on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from mocca_envs_tpu.models import monkey as jmonkey
from mocca_envs_tpu.models import walker3d as jwalker
from mocca_envs_tpu.ops.step import make_control_step as jcontrol
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu.utils.config import EngineConfig as JConfig
from mocca_envs_tpu_torch.models import monkey as tmonkey
from mocca_envs_tpu_torch.models import walker3d as twalker
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.ops.step import make_control_step as tcontrol
from mocca_envs_tpu_torch.terrain import scene as tscene
from mocca_envs_tpu_torch.utils.config import EngineConfig as TConfig

from tests.test_torch_stones import _walker_over_stones

TOL = {"q": 2e-4, "qd": 5e-3, "depth": 2e-4, "nimp": 5e-3}
T = torch.as_tensor


def _gate(got, want, tol, tail):
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        per_env = np.abs(np.asarray(g) - np.asarray(w)).reshape(len(g), -1).max(axis=1)
        assert np.median(per_env) <= tol[name], (name, float(np.median(per_env)))
        assert per_env.max() <= tail * tol[name], (name, float(per_env.max()))


def _parts(step_out):
    q, qd, info = step_out
    return [x.numpy() for x in (q, qd, info.contacts.depth, info.normal_impulse)]


def test_stepper_split_control_step_matches_jax():
    jm, tm = jwalker.make_model(), twalker.make_model()
    B = 32
    q, qd, (center, quat, half, active) = _walker_over_stones(B, 21)
    action = np.random.default_rng(22).uniform(-1, 1, (B, 21)).astype(np.float32)
    gain = np.array(jm.power_coef * jm.actuated)
    jstep = jcontrol(jm, JConfig(split_impulse=True),
                     actuation=lambda q_, qd_, a: gain * jnp.clip(a, -1, 1))

    def jax_path(q1, qd1, a, sp, sq, sh, sa):
        qq, dd, info = jstep(q1, qd1, a, jscene.with_stones(sp, sq, sh, sa, ground_z=-20.0))
        return qq, dd, info.contacts.depth, info.normal_impulse

    want = jax.jit(jax.vmap(jax_path))(q, qd, action, center, quat, half, active)
    tgain = T(gain)
    scene = tscene.with_stones(T(center), T(quat), T(half), T(active), ground_z=-20.0)
    got, unsplit = (_parts(tcontrol(tm, TConfig(split_impulse=split),
                                    actuation=lambda q_, qd_, a: tgain * torch.clamp(a, -1, 1))(
        T(q), T(qd), T(action), scene)) for split in (True, False))
    _gate(got, want, TOL, 10)
    assert (got[3] > 0).mean() > 0.05                        # stones carry load
    assert np.abs(got[1] - unsplit[1]).max() > 0.05          # the position pass has work


def test_monkey_split_control_step_matches_jax():
    B = 16
    tm = tmonkey.make_model()
    arrays = chip_smoke.monkey_states(tm, np.random.default_rng(23), B)
    q, qd, tau, gz, fric, bars, grabs = arrays
    kernel = engine.K1d(tm, TConfig(split_impulse=True), tmonkey.constraints(), 16)
    assert kernel.variant == "k1h_d"
    scene, ga, gt = kernel.unpack(T(gz), T(fric), T(bars), T(grabs))
    jstep = jcontrol(jmonkey.make_model(), JConfig(split_impulse=True),
                     constraints=jmonkey.constraints())

    def one(q1, qd1, tau1, a, b, r, act, g_a, g_t):
        sc = jscene.Scene(has_ground=True, has_bars=True, ground_z=jnp.asarray(-8.0),
                          bar_a=a, bar_b=b, bar_r=r, bar_active=act)
        qq, dd, info = jstep(q1, qd1, tau1, sc, g_a, g_t)
        return qq, dd, info.contacts.depth, info.normal_impulse

    want = jax.jit(jax.vmap(one))(q, qd, tau, *(x.numpy() for x in (
        scene.bar_a, scene.bar_b, scene.bar_r, scene.bar_active, ga, gt)))
    got, unsplit = (_parts(tcontrol(tm, TConfig(split_impulse=split),
                                    constraints=tmonkey.constraints())(
        T(q), T(qd), T(tau), scene, ga, gt)) for split in (True, False))
    _gate(got, want, chip_smoke.TOL_GRAB, 10)
    # the wrapper's plain unit is this same frame
    for g, u in zip(got, kernel.plain(*map(T, arrays))):
        np.testing.assert_array_equal(u.numpy(), g)
    assert (want[3] > 0).mean() > 0.05                       # bars carry load
    assert np.abs(got[1] - unsplit[1]).max() > 0.05
