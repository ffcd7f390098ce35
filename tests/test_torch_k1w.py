"""K1a redesigned for Hopper (``csrc/engine_k1w.cu``, one warp per env) on the
CPU: its per-env code built by g++ under ``-DK1W_HOST_CHECK`` (lane width
1, the collectives identities) and run as a loop over envs.

- the walker's key picks it, and only ``thread_per_env=True`` reaches the
  thread-per-env instance of ``csrc/engine_k1.cu``; its global workspace is
  empty;
- at B = 64 on near-contact walker states made from a numpy seed it agrees
  with the port's plain path at K1a's gates (q 2e-4, qd 5e-3, depth 2e-4,
  impulse 5e-3 on the per-env medians, the largest env within ten times)
  and with the JAX package's llc frame (``mocca_envs_tpu/ops/step.py``, λ
  and the frame-start Minv threaded as the kernel threads them) at the same
  gates;
- it agrees with the thread-per-env instance's host build at ``TOL_TWIN``
  (q 2e-5, qd 5e-4, depth 2e-5, impulse 5e-4; the JAX package's gate
  between two orders of the same iteration) on that batch, on a batch with
  no contact (every contact row skipped), on that batch with no row active
  and on a batch with every row active (nothing skipped, a lane's second
  row solved): skipping the inactive rows changes nothing; off near
  contact also with the plain path at K1a's gates.
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
from mocca_envs_tpu.ops.step import make_substep as jsubstep
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu.utils.config import EngineConfig as JConfig
from mocca_envs_tpu_torch.models import walker3d
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.utils.config import EngineConfig

from tests import torch_workers  # noqa: F401
from tests.torch_k1_host import build_host, run_on_host

TOL = chip_smoke.TOL
TOL_TWIN = chip_smoke.TOL_TWIN
B = 64
# every row active: margins no state reaches (the table carries them, the
# key and so the instances are the walker's)
ALL_ROWS = {"contact_margin": 1e3, "limit_margin": 1e3}
# no row active on a lifted batch: a limit margin no joint reaches
NO_ROWS = {"limit_margin": -1e3}


def _gate(got, want, tol):
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        per_env = np.abs(np.asarray(g) - np.asarray(w)).max(axis=1)
        assert np.median(per_env) <= tol[name], (name, float(np.median(per_env)))
        assert per_env.max() <= 10 * tol[name], (name, float(per_env.max()))


def _states(case):
    """Numpy ``(q, qd, tau, ground_z, friction)`` of chip_smoke.py's
    near-contact walker states; ``no_contact`` lifts every base 3 m."""
    arrays = [np.ascontiguousarray(x) for x in chip_smoke.near_contact_states(
        walker3d.make_model(), np.random.default_rng(5), B)]
    if case == "no_contact":
        arrays[0][:, 2] += 3.0
    return arrays


def _pair(**config):
    """(warp-per-env K1a, thread-per-env K1a) for one EngineConfig."""
    model = walker3d.make_model()
    return (engine.K1a(model, EngineConfig(**config)),
            engine.K1a(model, EngineConfig(**config), thread_per_env=True))


@pytest.fixture(scope="module")
def libs():
    """The two K1a instances built by g++, side by side."""
    return build_host(_pair())


def _run(libs, kernel, inputs):
    return run_on_host(libs[kernel.name], kernel, inputs)


def test_walker_key_picks_the_warp_per_env_instance(libs):
    new, old = _pair()
    assert new.name == "k1w_nl22_ns14_nlim21_sub4_it4" and new.instance.source == engine.SOURCE_W
    assert old.name == "k1a_nl22_ns14_nlim21_sub4_it4" and old.instance.index == 0
    assert new.key == old.key and new.variant == old.variant == "k1a"
    assert engine.compile_flags(new.instance) == ["-DK1W_ONLY=0"]
    assert engine.WARP_INSTANCES[new.key] is new.instance
    # the entry points' choice: make_kernel takes the warp-per-env instance
    picked = engine.make_kernel(new.model, EngineConfig())
    assert picked.name == new.name and picked.instance.source == engine.SOURCE_W
    # the child shares the key; its split key is K1h-si's warp-per-env
    # instance, its A-form key and its cold start have one too, and so has
    # PD at two llc frames (the generic one); keys the warp-per-env source
    # cannot hold (torque mode at two llc frames) keep their engine_k1.cu
    # instance
    assert engine.instance_for(dataclasses.replace(new.key, split=True)).source == engine.SOURCE_W
    assert engine.instance_for(dataclasses.replace(new.key, matfree=False)).source \
        == engine.SOURCE_W
    assert engine.instance_for(dataclasses.replace(new.key, warm=False)).index == 23
    two = dataclasses.replace(new.key, pd=True, llc=2)
    assert engine.instance_for(two) == engine.warp_instance(two)
    assert engine.instance_for(dataclasses.replace(new.key, llc=2)).source == engine.SOURCE
    # the same table; no global workspace
    assert engine.layout(libs[new.name], new.name) == (new.table_host.size, 0)
    assert engine.layout(libs[old.name], old.name)[1] > 0


def test_k1w_matches_plain_on_host(libs):
    new, _ = _pair()
    inputs = _states("near_contact")
    outs = _run(libs, new, inputs)
    want = [t.numpy() for t in new.plain(*map(torch.as_tensor, inputs))]
    assert all(np.isfinite(o).all() for o in outs)
    _gate(outs, want, TOL)
    assert (want[3] > 0).mean() > 0.1   # contacts carry load


@pytest.mark.parametrize("case", ["near_contact", "no_contact", "all_rows_active", "no_rows"])
def test_k1w_matches_thread_per_env_on_host(libs, case):
    """The same iteration as the thread-per-env instance, whether rows are
    skipped (no contact: all 42 contact rows; no rows: every row) or not
    (every row active: 63, so that a lane takes a second row); off near
    contact also the plain path's."""
    new, old = _pair(**{"all_rows_active": ALL_ROWS, "no_rows": NO_ROWS}.get(case, {}))
    inputs = _states("no_contact" if case in ("no_contact", "no_rows") else "near_contact")
    outs = _run(libs, new, inputs)
    _gate(outs, _run(libs, old, inputs), TOL_TWIN)
    lim_act, con_act, _ = engine.k1_activity(new, *map(torch.as_tensor, inputs))
    if case in ("no_contact", "no_rows"):
        assert not con_act.any() and (outs[3] == 0).all()
        assert lim_act.any() == (case == "no_contact")
    elif case == "all_rows_active":
        assert lim_act.all() and con_act.all()
    else:
        assert 0.05 < float(con_act.float().mean()) < 0.95   # some rows skipped, some not
    if case != "near_contact":   # near contact: test_k1w_matches_plain_on_host
        want = [t.numpy() for t in new.plain(*map(torch.as_tensor, inputs))]
        _gate(outs, want, TOL)


def test_k1w_matches_jax_llc_frame(libs):
    """The JAX package's llc frame at the shipped EngineConfig (four
    substeps, λ warm-started from zero, Minv of the frame's start) on the
    same inputs."""
    jm = jwalker.make_model()
    cfg = JConfig()
    sub = jsubstep(jm, cfg)
    inputs = _states("near_contact")

    # one substep compiled once and called four times (a frame unrolled
    # compiles several times slower on a CPU)
    minv = jax.jit(jax.vmap(lambda q, qd: sub.minv_of(jkin.forward_kinematics(jm, q, qd))))
    step = jax.jit(jax.vmap(lambda q, qd, tau, m, lam: sub(q, qd, tau, jscene.flat(),
                                                           Minv_in=m, lam_in=lam)))
    q, qd, tau = inputs[:3]
    Minv0 = minv(q, qd)
    lam = jnp.zeros((B, len(jlimited(jm)) + 3 * jm.ns))
    for _ in range(cfg.sim_substeps):
        q, qd, info, lam = step(q, qd, tau, Minv0, lam)
    want = [np.asarray(w) for w in (q, qd, info.contacts.depth, info.normal_impulse)]
    new, _ = _pair()
    _gate(_run(libs, new, inputs), want, TOL)
