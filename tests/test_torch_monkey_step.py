"""PyTorch port vs the JAX package: one monkey control step over its bars
with its grab rows (CPU).

The states are chip_smoke.py's (hanging from the bars, the right hand
attached everywhere and the left in a share of the envs, anchors at the
palms ±1 cm, bars moved next to the feet and the torso) at B = 16, with
random torques. The same arrays go through the JAX package's
``make_control_step`` (its XLA path on the CPU) and through the port's: its
control step and the plain unit of the K1d wrapper, which is what the kernel
is held against on the card. Gates: per-env medians within q 5e-4, qd 2e-2,
depth 5e-4, normal impulse 1e-2 (the looser of the JAX package's two gates
for what K1d combines: equality rows with grabs, and bars), the largest env
within ten times.

The warp-per-env K1d (``csrc/engine_k1w.cu``, the instance the monkey's
main path launches on the card), built by g++ under ``-DK1W_HOST_CHECK``
once per module, is held to the same JAX outputs at the same gates.

The hang test is the port's counterpart of
tests/test_monkey.py::test_grab_holds_against_gravity, through the env.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import mocca_envs_tpu_torch
from mocca_envs_tpu.models import monkey as jmonkey
from mocca_envs_tpu.ops.step import make_control_step as jcontrol
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu.utils.config import EngineConfig as JConfig
from mocca_envs_tpu_torch.core import rng as trng
from mocca_envs_tpu_torch.models import monkey as tmonkey
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.ops.step import make_control_step as tcontrol
from mocca_envs_tpu_torch.tasks import monkey_stepper as ttask
from mocca_envs_tpu_torch.utils.config import EngineConfig as TConfig

from tests import torch_workers  # noqa: F401
from tests.torch_k1_host import build_host, run_on_host

B = 16
TOL = chip_smoke.TOL_GRAB
T = torch.as_tensor
CASES = {"main_mix": (11, {}), "both_hands": (12, {"left": 1.0, "near_bar": 0.8})}


def _gate(name, got, want):
    per_env = np.abs(np.asarray(got) - np.asarray(want)).reshape(len(got), -1).max(axis=1)
    assert np.median(per_env) <= TOL[name], (name, float(np.median(per_env)))
    assert per_env.max() <= 10 * TOL[name], (name, float(per_env.max()))


@pytest.fixture(scope="module")
def jax_step():
    """The JAX control step (raw joint torques), jitted once for the module."""
    jm = jmonkey.make_model()
    step = jcontrol(jm, JConfig(), constraints=jmonkey.constraints())

    def one(q, qd, tau, a, b, r, act, ga, gt):
        sc = jscene.Scene(has_ground=True, has_bars=True, ground_z=jax.numpy.asarray(-8.0),
                          bar_a=a, bar_b=b, bar_r=r, bar_active=act)
        qq, dd, info = step(q, qd, tau, sc, ga, gt)
        return qq, dd, info.contacts.depth, info.normal_impulse, info.link_contact

    return jax.jit(jax.vmap(one))


@pytest.fixture(scope="module")
def k1w_host():
    """The warp-per-env K1d built by g++ (lane width 1)."""
    kernel = engine.K1d(tmonkey.make_model(), TConfig(), tmonkey.constraints(), 16)
    assert kernel.instance.source == engine.SOURCE_W
    return build_host([kernel])[kernel.name]


@pytest.mark.parametrize("case", list(CASES))
def test_monkey_control_step_matches_jax(jax_step, k1w_host, case):
    seed, mix = CASES[case]
    tm = tmonkey.make_model()
    arrays = chip_smoke.monkey_states(tm, np.random.default_rng(seed), B, **mix)
    q, qd, tau, gz, fric, bars, grabs = arrays
    kernel = engine.K1d(tm, TConfig(), tmonkey.constraints(), 16)
    scene, ga, gt = kernel.unpack(T(gz), T(fric), T(bars), T(grabs))
    want = [np.asarray(w) for w in jax_step(
        q, qd, tau, *(x.numpy() for x in (scene.bar_a, scene.bar_b, scene.bar_r,
                                          scene.bar_active, ga, gt)))]
    # the port's control step (raw torques, as the JAX one here)
    step = tcontrol(tm, TConfig(), constraints=tmonkey.constraints())
    tq, tqd, info = step(T(q), T(qd), T(tau), scene, ga, gt)
    got = (tq, tqd, info.contacts.depth, info.normal_impulse)
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        _gate(name, g.numpy(), w)
    np.testing.assert_array_equal(info.link_contact.numpy(), want[4])
    # the K1d wrapper's plain unit is this same frame
    unit = kernel.plain(*map(T, arrays))
    for g, u in zip(got, unit):
        torch.testing.assert_close(u, g, atol=0, rtol=0)
    # the warp-per-env K1d's per-env code on the same arrays
    outs = run_on_host(k1w_host, kernel, [np.ascontiguousarray(x) for x in arrays])
    for name, g, w in zip(("q", "qd", "depth", "nimp"), outs, want):
        _gate(name, g, w)
    # the gate means something: bars carry load, and the grab rows hold the
    # palms on their anchors while the free hands fall with the body
    assert (want[3] > 0).mean() > 0.05
    attached = ga.numpy() > 0.5
    palms = engine.unpack_grabs(T(grabs))[1]
    palms_now = ttask.make_palm_positions(tm, kernel.constraints)(tq)
    gap = torch.linalg.vector_norm(palms_now - palms, dim=2)
    assert float(gap.numpy()[attached].max()) < 0.02
    if (~attached).any():
        assert float(np.median(gap.numpy()[~attached])) > 0.015


def test_grab_holds_against_gravity():
    """Holding with the right hand (grab signal +1) keeps the monkey from
    free-falling, and its palm near its anchor; releasing both hands drops
    it."""
    env = mocca_envs_tpu_torch.make("Monkey3DStepperEnv-v0", device="cpu")
    gen = trng.generator(1, "cpu")
    state = env.init(gen, 4)
    palms = ttask.make_palm_positions(env.model, tmonkey.constraints())
    z0 = state.q[:, 2].clone()
    hold = torch.zeros(4, env.act_dim)
    hold[:, -2:] = torch.tensor([1.0, -1.0])
    for t in range(30):   # 0.5 s
        state = env.step_no_reset(state, hold, gen).state
        if t == 24:
            palm = palms(state.q)[:, 0]
            gap = torch.linalg.vector_norm(palm - state.task.anchor[:, 0], dim=1)
            assert float(gap.max()) < 0.08, gap
    assert float(state.q[:, 2].min()) > -1.5 and float((z0 - state.q[:, 2]).max()) < 0.5
    assert bool((state.task.attached[:, 0] == 1).all())
    release = torch.full((4, env.act_dim), 0.0)
    release[:, -2:] = -1.0
    done = torch.zeros(4, dtype=torch.bool)
    for _ in range(40):
        tr = env.step_no_reset(state, release, gen)
        state, done = tr.state, done | tr.done
        if bool(((state.q[:, 2] < -1.5) | done).all()):
            break
    assert bool(((state.q[:, 2] < -1.5) | done).all())
    assert bool((state.task.attached == 0).all())
