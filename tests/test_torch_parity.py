"""PyTorch port vs the JAX package: the parity interchange format, the raw
record / replay across packages, and the pybullet recorder, on the CPU.

- ``Recording`` files cross between the packages both ways, field for
  field, and ``model_hash`` agrees;
- cross-package raw replay: the JAX ``record_raw`` of the MJCF hopper of
  tests/test_model_compilers.py for 30 steps, replayed by the port's
  ``replay_check_raw``, is ``ok``, and the reverse; each ``max_q_err``
  stated against the envelope (1e-3 · 1.02^t);
- the port's ``record`` → ``replay_check`` is deterministic on the CPU
  walker for 20 steps (every error 0.0), and a changed action fails it;
- the envelope algebra of tests/test_drift_horizon.py;
- both modes of the port's ``parity_record_pybullet`` CLI run against
  tests/fake_pybullet.py, pointed at the port's ``data/walker3d.urdf``.
"""

import sys

import numpy as np
import pytest

from mocca_envs_tpu.harness import parity as jparity
from mocca_envs_tpu.models.mjcf import parse_mjcf as jparse_mjcf
from mocca_envs_tpu.utils.config import EngineConfig as JConfig
from mocca_envs_tpu_torch import make
from mocca_envs_tpu_torch.harness import parity
from mocca_envs_tpu_torch.models import assets, walker3d
from mocca_envs_tpu_torch.models.mjcf import parse_mjcf
from mocca_envs_tpu_torch.utils.config import EngineConfig

from tests import fake_pybullet, torch_workers  # noqa: F401
from tests.test_model_compilers import MJCF_HOPPER

FIELDS = ("q", "qd", "action", "obs", "reward", "done")


def _hopper_q0():
    q0 = np.zeros(9, np.float32)
    q0[2], q0[3] = 0.72, 1.0
    q0[7:] = (0.2, -0.3)
    return q0


def _assert_recordings_equal(a, b):
    assert a.meta == b.meta
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.fixture(scope="module")
def jax_hopper_rec():
    return jparity.record_raw(jparse_mjcf(MJCF_HOPPER), JConfig(), seed=3, horizon=30,
                              q0=_hopper_q0(), name="hopper")


@pytest.fixture(scope="module")
def port_hopper_rec():
    return parity.record_raw(parse_mjcf(MJCF_HOPPER), EngineConfig(), seed=3, horizon=30,
                             q0=_hopper_q0(), name="hopper")


def test_recording_files_cross_both_ways(jax_hopper_rec, port_hopper_rec, tmp_path):
    for rec, loaders in ((port_hopper_rec, (jparity.Recording, parity.Recording)),
                         (jax_hopper_rec, (parity.Recording, jparity.Recording))):
        path = str(tmp_path / f"{rec.meta['engine']}.npz")
        rec.save(path)
        other, same = (L.load(path) for L in loaders)
        _assert_recordings_equal(other, rec)
        _assert_recordings_equal(same, rec)
    # one file layout: the same meta keys and array shapes / dtypes
    assert set(port_hopper_rec.meta) == set(jax_hopper_rec.meta)
    assert port_hopper_rec.meta["model_hash"] == jax_hopper_rec.meta["model_hash"]
    for f in FIELDS:
        a, b = getattr(port_hopper_rec, f), getattr(jax_hopper_rec, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
    np.testing.assert_array_equal(port_hopper_rec.action, jax_hopper_rec.action)
    # xyzw in the file: the recording's first row is q0 with its quat rolled
    q0 = _hopper_q0()
    np.testing.assert_array_equal(port_hopper_rec.q[0],
                                  np.concatenate([q0[:3], q0[4:7], q0[3:4], q0[7:]]))


def test_raw_replay_crosses_packages(jax_hopper_rec, port_hopper_rec):
    """The JAX recording replayed by the port and the port's by the JAX
    package, each from the recording's own q[0] / qd[0] and torques."""
    gate = parity.ToleranceGate()
    mine = parity.replay_check_raw(parse_mjcf(MJCF_HOPPER), EngineConfig(), jax_hopper_rec)
    theirs = jparity.replay_check_raw(jparse_mjcf(MJCF_HOPPER), JConfig(), port_hopper_rec)
    for rep in (mine, theirs):
        assert rep["ok"], rep
        assert rep["steps"] == 30 and rep["first_failure"] == ""
        # inside the envelope's starting width (1e-3) at every step: the two
        # packages' float32 roundings part by ~2e-4 over 30 contact steps
        assert rep["max_q_err"] < gate.envelope(0, gate.q_atol), rep
    # the hopper touched the ground: the replay crossed contacts
    assert float(jax_hopper_rec.q[:, 2].min()) < 0.7
    # the port replaying its own recording: bit for bit on one device
    own = parity.replay_check_raw(parse_mjcf(MJCF_HOPPER), EngineConfig(), port_hopper_rec)
    assert own["ok"] and own["max_q_err"] == 0.0


def test_raw_replay_catches_a_changed_torque(port_hopper_rec):
    bad = parity.Recording(**{**port_hopper_rec.__dict__,
                              "action": port_hopper_rec.action * 0.0})
    rep = parity.replay_check_raw(parse_mjcf(MJCF_HOPPER), EngineConfig(), bad)
    assert not rep["ok"] and rep["first_failure"].startswith("q@")


@pytest.fixture(scope="module")
def walker_env():
    return make("Walker3DCustomEnv-v0", device="cpu")


def test_record_replay_deterministic(walker_env, tmp_path):
    rng = np.random.default_rng(0)
    acts = rng.uniform(-0.5, 0.5, (20, walker_env.act_dim)).astype(np.float32)
    rec = parity.record(walker_env, walker_env.model, seed=3, horizon=20,
                        policy=lambda obs, t: acts[t])
    assert rec.meta["engine"] == "torch" and rec.meta["seed"] == 3
    assert rec.q.shape == (rec.action.shape[0] + 1, walker_env.model.nq)
    assert rec.obs.shape == (rec.action.shape[0], walker_env.obs_dim)
    path = str(tmp_path / "walker.npz")
    rec.save(path)
    out = parity.replay_check(walker_env, walker_env.model, parity.Recording.load(path))
    assert out["ok"], out
    assert out["max_q_err"] == out["max_reward_err"] == out["max_obs_err"] == 0.0
    # the recording loads in the JAX package field for field
    _assert_recordings_equal(jparity.Recording.load(path), rec)
    bad = parity.Recording(**{**rec.__dict__, "action": rec.action + 0.5})
    assert not parity.replay_check(walker_env, walker_env.model, bad)["ok"]


def test_envelope_crossing_algebra():
    """tests/test_drift_horizon.py's algebra on the port's gate."""
    horizon = 200
    gate = parity.ToleranceGate()
    ref = jparity.ToleranceGate()
    assert (gate.q_atol, gate.growth, gate.reward_atol, gate.obs_atol) == (
        ref.q_atol, ref.growth, ref.reward_atol, ref.obs_atol)
    assert gate.q_atol == 1e-3 and gate.growth == 1.02
    base = 3.65e-3
    crossings = [t for t in range(horizon) if base > gate.envelope(t, gate.q_atol)]
    assert crossings and crossings[0] == 0
    assert max(crossings) == 65
    assert base <= gate.envelope(66, gate.q_atol)
    err = base * 1.01 ** np.arange(horizon)
    env = gate.q_atol * gate.growth ** np.arange(horizon)
    inside = err <= env
    assert inside[horizon - 1]
    assert inside[int(np.argmax(inside)):].all()
    for t in (0, 10, 65, 199):
        assert gate.envelope(t, 1e-3) == ref.envelope(t, 1e-3)


def test_stub_names_the_port_cli():
    assert "mocca_envs_tpu_torch.harness.parity_record_pybullet" in \
        parity.reference_recorder_stub()


# -------------------------------------------------- the pybullet recorder CLI
@pytest.fixture()
def fake_stack(monkeypatch):
    fake_pybullet.reset_fake()
    urdf = assets.asset_path("walker3d")
    gym_mod, pb_mod, mocca_mod = fake_pybullet.make_fake_modules(urdf)
    monkeypatch.setitem(sys.modules, "gym", gym_mod)
    monkeypatch.setitem(sys.modules, "pybullet", pb_mod)
    monkeypatch.setitem(sys.modules, "mocca_envs", mocca_mod)
    return urdf


def _called(name):
    return any(c[0] == name for c in fake_pybullet.CALLS)


def test_record_pybullet_cli(fake_stack, walker_env, tmp_path):
    from mocca_envs_tpu_torch.harness import parity_record_pybullet as rec_mod

    assert fake_stack.endswith("mocca_envs_tpu_torch/data/walker3d.urdf")
    out = str(tmp_path / "ref.npz")
    rec_mod.main(["--env", "Walker3DCustomEnv-v0", "--seed", "3", "--horizon", "4",
                  "--out", out])
    rec = parity.Recording.load(out)
    nj = walker3d.make_model().nj
    assert rec.meta["engine"] == "pybullet" and rec.meta["seed"] == 3
    assert rec.q.shape[1] == 7 + nj and rec.qd.shape[1] == 6 + nj
    assert rec.action.shape == (4, nj) and rec.reward.shape == (4,)
    assert np.all(np.isfinite(rec.q))
    for call in ("env.seed", "env.reset", "env.step", "getBasePositionAndOrientation",
                 "getBaseVelocity", "getJointStates", "env.close"):
        assert _called(call), call
    # the fake's dynamics are not physics: the port's gate catches it
    report = parity.replay_check(walker_env, walker_env.model, rec)
    assert report["ok"] is False


def test_record_raw_pybullet_cli(fake_stack, tmp_path):
    from mocca_envs_tpu_torch.harness import parity_record_pybullet as rec_mod

    model = walker3d.make_model()
    config = EngineConfig()
    q0 = np.zeros(model.nq, dtype=np.float32)
    q0[2], q0[3] = 1.0, 1.0
    ours = parity.record_raw(model, config, seed=5, horizon=3, q0=q0)
    match = str(tmp_path / "ours.npz")
    ours.save(match)
    out = str(tmp_path / "pb_raw.npz")
    rec_mod.main(["--raw-urdf", fake_stack, "--match", match, "--out", out])
    rec = parity.Recording.load(out)
    assert rec.meta["engine"] == "pybullet_raw"
    assert rec.q.shape == (4, 7 + model.nj) and rec.qd.shape == (4, 6 + model.nj)
    np.testing.assert_array_equal(rec.action, ours.action)
    np.testing.assert_allclose(rec.q[0], ours.q[0], atol=1e-6)
    for call in ("connect", "setGravity", "setTimeStep", "loadURDF", "resetJointState",
                 "setJointMotorControlArray", "stepSimulation", "disconnect"):
        assert _called(call), call
    nsim = sum(1 for c in fake_pybullet.CALLS if c[0] == "stepSimulation")
    assert nsim == 3 * config.sim_substeps * config.llc_frames
    assert not parity.replay_check_raw(model, config, rec)["ok"]


def test_recorder_cli_refusals(tmp_path):
    from mocca_envs_tpu_torch.harness import parity_record_pybullet as rec_mod

    for name in ("gym", "pybullet", "mocca_envs"):
        assert name not in sys.modules or hasattr(sys.modules[name], "make")
    with pytest.raises(SystemExit, match="reference stack"):
        rec_mod.record_pybullet("X-v0", 0, 1)
    with pytest.raises(SystemExit):
        rec_mod.main(["--raw-urdf", "x.urdf", "--out", str(tmp_path / "o.npz")])
    with pytest.raises(SystemExit):
        rec_mod.main(["--out", str(tmp_path / "o.npz")])
