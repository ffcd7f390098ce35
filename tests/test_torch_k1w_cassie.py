"""K1e redesigned for Hopper (``csrc/engine_k1w.cu``, one warp per env) on
Cassie's and Cassie2D's keys, on the CPU: the warp-per-env source's per-env
code built by g++ under ``-DK1W_HOST_CHECK`` (lane width 1, the collectives
identities) and run as a loop over envs, for ``planar`` off and on.

- Cassie's key (and with the planar lock Cassie2D's) picks the warp-per-env
  instance through ``make_kernel`` and ``K1e``; only ``thread_per_env=True``
  reaches the thread-per-env instance of ``csrc/engine_k1.cu``; its global
  workspace is empty;
- at B = 64 on chip_smoke.py's Cassie states (near the stand pose, feet in
  or near contact, rods a few millimetres open) it agrees with the port's
  plain unit at K1e's chip gate: ``TOL_EQ`` medians (q 5e-4, qd 2e-2, depth
  5e-4, impulse 5e-3), the 99th percentile within ten times;
- against the thread-per-env instance's host build on those states, with
  every foot lifted 1 m (every contact and limit row skipped) and with every
  row active (margins no state reaches): ``TOL_EQ`` medians, the 99th
  percentile within ten times; the lifted and the every-row batches also
  against the plain unit at the same gate. Not ``TOL_TWIN``: over the 20 stiff substeps of a call
  two orders of the same sums part by more (measured medians, Cassie /
  Cassie2D: q 1.3e-6 / 3.8e-6, qd 2.6e-4 / 7.1e-4 near stand; q 7.0e-7 /
  8.4e-6, qd 2.2e-4 / 1.3e-3 lifted; p99 of qd up to 3.4e-2), as far as the
  thread-per-env instance parts from itself when q̇ is nudged by 1e-7
  relative (qd medians 3.3e-4 / 6.5e-4 near stand, 2.3e-4 / 7.1e-4 lifted;
  ``test_the_twin_gap_is_the_rounding_floor`` holds the two within 3×);
- at B = 8 it agrees with the JAX package's control step
  (``mocca_envs_tpu/ops/step.py::make_control_step`` with ``CASSIE_CONFIG``
  and ``cassie.constraints()``, one env per call on threads, as
  tests/test_torch_cassie_step.py runs it): medians within the walker's
  tolerances (q 2e-4, qd 5e-3, depth 2e-4, impulse 5e-3), the largest env
  within twenty times.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from mocca_envs_tpu.models import cassie as jcassie
from mocca_envs_tpu.ops.step import ConstraintSpec as JSpec
from mocca_envs_tpu.ops.step import make_control_step as jcontrol
from mocca_envs_tpu.tasks.cassie_task import CASSIE_CONFIG as JCASSIE_CONFIG
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu_torch.models import cassie
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.tasks.cassie_task import CASSIE_CONFIG

from tests import torch_workers  # noqa: F401
from tests.test_torch_cassie_step import run_per_env
from tests.torch_k1_host import build_host, run_on_host

TOL = {"q": 2e-4, "qd": 5e-3, "depth": 2e-4, "nimp": 5e-3}
TOL_EQ = chip_smoke.TOL_EQ
B = 64
PLANAR = pytest.mark.parametrize("planar", [False, True], ids=["cassie", "cassie2d"])
SYMBOL = "nl17_ns5_nlim16_sub2_it4_llc10_p2p2"


def _pair(planar, **config):
    """(warp-per-env K1e, thread-per-env K1e) of Cassie's whole PD control
    step, with the planar lock for Cassie2D."""
    model = cassie.make_model()
    spec = dataclasses.replace(cassie.constraints(), planar=planar)
    cfg = dataclasses.replace(CASSIE_CONFIG, **config)
    return tuple(engine.K1e(model, cfg, spec, pd_mode=True,
                            extra_damping=model.actuated * model.kd, thread_per_env=tpe)
                 for tpe in (False, True))


@pytest.fixture(scope="module")
def libs():
    """The four instances built by g++, side by side."""
    return build_host([k for planar in (False, True) for k in _pair(planar)])


def _states(planar, batch=B, lifted=False):
    """Numpy ``(q, qd, targets, ground_z, friction)`` of chip_smoke.py's
    Cassie states; ``lifted`` raises every pelvis 1 m."""
    model = cassie.make_model()
    arrays = [np.ascontiguousarray(x) for x in chip_smoke.cassie_states(
        model, cassie.stand_q(model), cassie.initial_z(), np.random.default_rng(31 + planar),
        planar, batch)]
    if lifted:
        arrays[0][:, 2] += 1.0
    return arrays


def _gate(got, want, tol, tail="p99", factor=10):
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        per_env = np.abs(np.asarray(g) - np.asarray(w)).max(axis=1)
        assert np.median(per_env) <= tol[name], (name, float(np.median(per_env)))
        worst = np.quantile(per_env, 0.99) if tail == "p99" else per_env.max()
        assert worst <= factor * tol[name], (name, tail, float(worst))


@PLANAR
def test_cassie_keys_pick_the_warp_per_env_instance(libs, planar):
    new, old = _pair(planar)
    tag = "_planar" if planar else ""
    assert new.name == f"k1w_{SYMBOL}{tag}" and new.instance.source == engine.SOURCE_W
    assert old.name == f"k1e_{SYMBOL}{tag}" and old.instance.source == engine.SOURCE
    assert new.key == old.key and new.variant == old.variant == "k1e"
    assert engine.WARP_INSTANCES[new.key] is new.instance
    assert engine.compile_flags(new.instance) == [f"-DK1W_ONLY={1 + planar}"]
    # the entry points' choice (the four Cassie families build this unit)
    model = new.model
    picked = engine.make_kernel(model, CASSIE_CONFIG, pd_mode=True, constraints=new.constraints,
                                extra_damping=model.actuated * model.kd)
    assert isinstance(picked, engine.K1e) and picked.name == new.name
    # the split key has its own warp-per-env instance
    # (tests/test_torch_k1w_split_cassie.py)
    split = engine.K1e(model, dataclasses.replace(CASSIE_CONFIG, split_impulse=True),
                       new.constraints, pd_mode=True, extra_damping=model.actuated * model.kd)
    assert split.instance.source == engine.SOURCE_W and split.name == f"{new.name}_si"
    assert split.variant == "k1h_e" and split.key != new.key
    # the same table; no global workspace
    assert engine.layout(libs[new.name], new.name) == (new.table_host.size, 0)
    assert engine.layout(libs[old.name], old.name)[1] > 0


@PLANAR
def test_k1w_cassie_matches_plain_on_host(libs, planar):
    new, _ = _pair(planar)
    inputs = _states(planar)
    outs = run_on_host(libs[new.name], new, inputs)
    want = [t.numpy() for t in new.plain(*map(torch.as_tensor, inputs))]
    assert all(np.isfinite(o).all() for o in outs)
    _gate(outs, want, TOL_EQ)
    assert (want[3] > 0).mean() > 0.1   # the feet carry load
    # the servo and the springs moved the joints; the lock pulled the drift in
    assert np.abs(outs[0][:, 7:] - inputs[0][:, 7:]).max() > 0.01
    if planar:
        assert np.abs(outs[0][:, 1]).mean() < np.abs(inputs[0][:, 1]).mean()


@PLANAR
@pytest.mark.parametrize("case", ["near_stand", "lifted", "all_rows_active"])
def test_k1w_cassie_matches_thread_per_env_on_host(libs, planar, case):
    """The same iteration as the thread-per-env instance, whether rows are
    skipped (lifted: all 15 contact rows and every limit row, the equality
    rows alone) or not (every row active: 37 or 40, so that a lane takes a
    second row); off the stand also the plain unit's."""
    config = {"contact_margin": 1e3, "limit_margin": 1e3} if case == "all_rows_active" else {}
    new, old = _pair(planar, **config)
    inputs = _states(planar, lifted=case == "lifted")
    outs = run_on_host(libs[new.name], new, inputs)
    _gate(outs, run_on_host(libs[old.name], old, inputs), TOL_EQ)
    lim_act, con_act, _ = engine.k1_activity(new, *map(torch.as_tensor, inputs))
    if case == "lifted":   # the equality rows alone
        assert not con_act.any() and not lim_act.any() and (outs[3] == 0).all()
    elif case == "all_rows_active":
        assert lim_act.all() and con_act.all()
    else:
        assert 0.05 < float(con_act.float().mean()) < 0.95   # some rows skipped, some not
    if case != "near_stand":   # near the stand: test_k1w_cassie_matches_plain_on_host
        want = [t.numpy() for t in new.plain(*map(torch.as_tensor, inputs))]
        _gate(outs, want, TOL_EQ)


@PLANAR
@pytest.mark.parametrize("lifted", [False, True], ids=["near_stand", "lifted"])
def test_the_twin_gap_is_the_rounding_floor(libs, planar, lifted):
    """Why the twins are held at ``TOL_EQ``, not ``TOL_TWIN``: the per-env
    median of |Δq̇| between the two designs is within three times the median
    by which the thread-per-env instance parts from itself when q̇ is nudged
    by 1e-7 (relative, numpy seed 0): rounding, amplified over 20 stiff
    substeps, not a difference of iteration."""
    new, old = _pair(planar)
    inputs = _states(planar, lifted=lifted)
    nudged = list(inputs)
    noise = np.random.default_rng(0).standard_normal(inputs[1].shape)
    nudged[1] = (inputs[1] * (1 + 1e-7 * noise)).astype(np.float32)
    base = run_on_host(libs[old.name], old, inputs)
    med = lambda a, b: float(np.median(np.abs(a[1] - b[1]).max(axis=1)))  # noqa: E731
    twin = med(run_on_host(libs[new.name], new, inputs), base)
    floor = med(run_on_host(libs[old.name], old, nudged), base)
    assert 0 < twin <= 3 * floor and floor > chip_smoke.TOL_TWIN["qd"] / 10, (twin, floor)


@PLANAR
def test_k1w_cassie_matches_jax_control_step(libs, planar):
    """The JAX package's control step on the same inputs, one env per call."""
    n = 8
    jm = jcassie.make_model()
    jspec = jcassie.constraints()
    if planar:
        jspec = JSpec(**{**dataclasses.asdict(jspec), "planar": True})
    q, qd, targets, gz, fric = _states(planar, n)
    jstep = jcontrol(jm, JCASSIE_CONFIG, constraints=jspec, pd_targets=lambda a: a,
                     extra_damping=jm.actuated * jm.kd)
    jit_step = jax.jit(lambda a, b, c: jstep(a, b, c, jscene.flat()))
    want = run_per_env(jit_step.lower(q[0], qd[0], targets[0]).compile(), q, qd, targets)
    want = [np.stack([np.asarray(f(w)) for w in want]) for f in (
        lambda w: w[0], lambda w: w[1], lambda w: w[2].contacts.depth,
        lambda w: w[2].normal_impulse)]
    new, _ = _pair(planar)
    outs = run_on_host(libs[new.name], new, [q, qd, targets, gz, fric])
    _gate(outs, want, TOL, tail="max", factor=20)
    assert (want[3] > 0).mean() > 0.1


def test_build_raises_naming_the_warp_instance_it_cannot_compile(tmp_path, monkeypatch):
    """No fallback: where the warp-per-env source does not compile (here a
    stand-in for nvcc that refuses it and writes every other library),
    ``build`` raises naming each of its instances, with the compiler's
    output, and loads nothing; the thread-per-env instances of the same keys
    are not taken in their place."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    "for a in \"$@\"; do prev=$cur; cur=$a; [ \"$prev\" = -o ] && out=$a; done\n"
                    f"case \"$cur\" in *{engine.SOURCE_W.name}) echo 'error: no such kernel'; "
                    "exit 2;; esac\n: > \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(engine, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(engine, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(engine._Library, "handles", {})
    monkeypatch.setattr(engine._Library, "logs", {})
    with pytest.raises(RuntimeError) as err:
        engine.build()
    for inst in engine.WARP_INSTANCES.values():
        assert f"{inst.symbol}: nvcc failed (2):\nerror: no such kernel" in str(err.value)
    assert engine._Library.handles == {}
    assert not any(p.name.startswith("libk1w") for p in (tmp_path / "build").iterdir())
