"""The port's ``parallel/`` package in one process on the CPU: a gloo group
of one, and one check against the JAX package.

- ``sharded_init`` and ``sharded_env`` on a mesh of one equal
  ``BatchedEnv`` at the same seed bit for bit, over steps with auto-reset;
- a ``PPOLearner`` on a mesh of one equals the one without a mesh bit for
  bit (the walker with every reduction the mesh averages switched on, and
  the mixed trio);
- the divisibility errors read as the JAX package's;
- ``fingerprint`` of the JAX package's ``ActorCritic`` parameters equals
  the port's of the same parameters carried over by ``convert.py``, to
  1e-12 relative;
- the mesh's slot ranges, the replica check, ``multihost.initialize``'s
  single-process run and refusals, checkpoints under a mesh and at another
  world size, ``graft_entry.entry()``, and that ``parallel/`` and
  ``graft_entry.py`` import no JAX.
"""

import ast
import dataclasses
import logging
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import mocca_envs_tpu
import mocca_envs_tpu_torch
from mocca_envs_tpu.harness import mixed as jmixed
from mocca_envs_tpu.harness import ppo as jppo
from mocca_envs_tpu.parallel import multihost as jmultihost
from mocca_envs_tpu.parallel.sharded import sharded_init as jsharded_init
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.harness import ppo
from mocca_envs_tpu_torch.harness.checkpoint import CheckpointManager, CheckpointMismatch
from mocca_envs_tpu_torch.harness.mixed import MixedSuite
from mocca_envs_tpu_torch.parallel import multihost
from mocca_envs_tpu_torch.parallel.mesh import Sharding, env_mesh, env_sharding, replicated
from mocca_envs_tpu_torch.parallel.sharded import shard_mapped_env, sharded_env, sharded_init

from tests import torch_workers  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
WALKER = "Walker3DCustomEnv-v0"


@pytest.fixture
def mesh():
    """A mesh of one over a gloo group of one, left as it was found."""
    started = not dist.is_initialized()
    yield env_mesh(device="cpu")
    if started:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def walker():
    return mocca_envs_tpu_torch.make(WALKER, device="cpu")


def _fake_mesh(size):
    """A mesh's size and rank, for the checks made before any collective."""
    return types.SimpleNamespace(size=size, rank=0, device=torch.device("cpu"))


def _equal(a, b, what="state"):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _equal(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


def test_sharded_init_and_step_equal_batched_env(mesh, walker):
    B = 8
    state, gen = sharded_init(walker, mesh, B, seed=3)
    batch = mocca_envs_tpu_torch.BatchedEnv(walker, B, seed=3, device="cpu")
    want = batch.init()
    _equal(state, want)
    step = sharded_env(walker, mesh)
    assert shard_mapped_env is sharded_env
    rng = np.random.default_rng(0)
    dones = 0
    for t in range(30):
        a = torch.as_tensor(rng.uniform(-1, 1, (B, walker.act_dim)), dtype=torch.float32)
        tr, tw = step(state, a, gen), batch.step(want, a)
        _equal(tr.state, tw.state, f"step {t}")
        for name in ("obs", "reward", "done"):
            assert torch.equal(getattr(tr, name), getattr(tw, name)), (t, name)
        state, want = tr.state, tw.state
        dones += int(tr.done.sum())
    assert dones > 0, "auto-reset should fire within the run"
    with pytest.raises(ValueError, match="this rank's rows"):
        step(state, torch.zeros(B + 1, walker.act_dim), gen)


def _metrics_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]) or (a[k].isnan() and b[k].isnan()), k


@pytest.mark.parametrize("which", ["walker", "mixed"])
def test_mesh_of_one_equals_no_mesh(mesh, walker, which):
    if which == "walker":
        env, num_envs, updates = walker, 8, 2
        cfg = ppo.PPOConfig(horizon=4, num_epochs=2, num_minibatches=2, hidden=(16, 16),
                            normalize_reward=True, mirror_coef=0.1)
    else:
        env, num_envs, updates = MixedSuite(MixedSuite.DEFAULT, (2, 2, 2), device="cpu"), 6, 1
        cfg = ppo.PPOConfig(horizon=2, num_epochs=1, num_minibatches=2, hidden=(16, 16),
                            mirror_coef=0.1, shuffle_mode="time")
    runs = []
    for m in (None, mesh):
        learner = ppo.PPOLearner(env, cfg, mesh=m, num_envs=num_envs)
        state = learner.init(seed=5)
        for _ in range(updates):
            state, metrics = learner.train_step(state)
        runs.append((state, metrics))
    (a, ma), (b, mb) = runs
    for k, v in a.params.state_dict().items():
        assert torch.equal(v, b.params.state_dict()[k]), k
    assert multihost.fingerprint(a.opt_state).tolist() == multihost.fingerprint(
        b.opt_state).tolist()
    for name in ("env_state", "obs", "obs_norm", "ret_accum", "ret_norm"):
        _equal(getattr(a, name), getattr(b, name), name)
    for g, h in zip(*(s.env_key if isinstance(s.env_key, tuple) else (s.env_key,)
                      for s in (a, b))):
        assert torch.equal(g.get_state(), h.get_state())
    assert torch.equal(a.key.get_state(), b.key.get_state())
    _metrics_equal(ma, mb)


def test_divisibility_errors_read_as_the_jax_packages(walker):
    jenv = mocca_envs_tpu.make(WALKER)
    three = Mesh(np.array(jax.devices()[:3]), ("env",))
    with pytest.raises(ValueError) as jerr:
        jsharded_init(jenv, three, 4)
    with pytest.raises(ValueError) as terr:
        sharded_init(walker, _fake_mesh(3), 4)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        jppo.PPOLearner(jenv, jppo.PPOConfig(num_minibatches=2), mesh=three, num_envs=8)
    with pytest.raises(ValueError) as terr:
        ppo.PPOLearner(walker, ppo.PPOConfig(num_minibatches=2), mesh=_fake_mesh(3), num_envs=8)
    assert str(terr.value) == str(jerr.value)
    # family counts of 2, 4 and 2 over 4 devices: the batch of 8 divides,
    # the first family does not
    four = Mesh(np.array(jax.devices()[:4]), ("env",))
    cfg = dict(num_minibatches=1, hidden=(16, 16))
    with pytest.raises(ValueError) as jerr:
        jppo.PPOLearner(jmixed.MixedSuite(jmixed.MixedSuite.DEFAULT, (2, 4, 2)),
                        jppo.PPOConfig(**cfg), mesh=four)
    suite = MixedSuite(MixedSuite.DEFAULT, (2, 4, 2), device="cpu")
    with pytest.raises(ValueError) as terr:
        ppo.PPOLearner(suite, ppo.PPOConfig(**cfg), mesh=_fake_mesh(4))
    assert str(terr.value) == str(jerr.value) == "family count 2 must divide over 4 devices"
    with pytest.raises(ValueError, match="family count 2 must divide over 4 devices"):
        suite.init_states(0, _fake_mesh(4))


def test_fingerprint_matches_jax_on_carried_weights():
    obs_dim, act_dim, hidden = 52, 21, (32, 32)
    params = jppo.ActorCritic(act_dim, hidden).init(jax.random.key(0), np.zeros((1, obs_dim),
                                                                              np.float32))
    want = jmultihost.fingerprint(jax.device_get(params))
    net = ppo.ActorCritic(obs_dim, act_dim, hidden)
    net.load_state_dict(convert.actor_critic_from_flax(jax.device_get(params)))
    got = multihost.fingerprint(net)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert abs(want[0]) < want[1]   # the signed sum is not the absolute one


def test_replica_check_and_fingerprint_trees(mesh, walker):
    learner = ppo.PPOLearner(walker, ppo.PPOConfig(horizon=2, hidden=(16, 16)), mesh=mesh,
                             num_envs=4)
    state = learner.init(seed=0)
    assert multihost.check_replica_divergence(state.params, mesh)
    assert multihost.check_replica_divergence(state.params)
    fp = multihost.fingerprint(state.params)
    # the same values as a tuple of tensors and as a dict with a number beside
    tensors = [v for v in state.params.state_dict().values()]
    np.testing.assert_allclose(multihost.fingerprint(tuple(tensors)), fp, rtol=1e-15)
    np.testing.assert_allclose(multihost.fingerprint({"p": tensors, "n": -2}),
                               fp + [-2.0, 2.0], rtol=1e-15)
    np.testing.assert_array_equal(multihost.fingerprint(None), [0.0, 0.0])


def test_sharding_slots_and_local_parts(walker):
    assert Sharding(rank=1, size=4).slots(16) == slice(4, 8)
    assert Sharding(rank=3, size=4).slots(16) == slice(12, 16)
    assert Sharding(rank=1, size=4, split=False).slots(16) == slice(0, 16)
    with pytest.raises(ValueError, match="num_envs=10 must divide evenly over 4 devices"):
        Sharding(rank=0, size=4).slots(10)
    state = walker.init(torch.Generator().manual_seed(0), 8)
    part = Sharding(rank=1, size=2).local(state)
    assert torch.equal(part.q, state.q[4:]) and torch.equal(part.task.target,
                                                            state.task.target[4:])
    assert torch.equal(part.scene.friction, state.scene.friction[4:])
    with pytest.raises(ValueError, match="0-d"):
        Sharding(rank=0, size=2).local((torch.zeros(4), torch.zeros(())))
    fake = _fake_mesh(2)
    assert env_sharding(fake) == Sharding(0, 2, True)
    assert replicated(fake) == Sharding(0, 2, False)


def test_env_mesh_of_one(mesh):
    assert (mesh.size, mesh.rank, mesh.device) == (1, 0, torch.device("cpu"))
    assert dist.get_world_size(mesh.group) == 1
    with pytest.raises(ValueError, match="one process per device"):
        env_mesh(2, device="cpu")


def test_initialize_single_process_and_refusals(monkeypatch, caplog):
    for k in multihost.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    multihost.initialize(num_processes=1)
    with caplog.at_level(logging.INFO, logger=multihost.__name__):
        multihost.initialize(device="cpu")
    assert "single-process run" in caplog.text
    if dist.is_initialized():
        pytest.skip("a process group of this process was left by another test")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="coordinator address or a launcher"):
        multihost.initialize(num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="num_processes and process_id"):
        multihost.initialize("127.0.0.1:1", device="cpu")
    assert not dist.is_initialized()


def test_checkpoint_under_a_mesh_and_another_world_size(tmp_path, mesh, walker):
    learner = ppo.PPOLearner(walker, ppo.PPOConfig(horizon=2, hidden=(8,)), mesh=mesh,
                             num_envs=4)
    state = learner.init(seed=0)
    CheckpointManager(str(tmp_path / "m"), mesh=mesh).save(1, state)
    saved = torch.load(tmp_path / "m" / "ckpt_1.pt", weights_only=True)
    assert saved["world"] == 1 and len(saved["ranks"]) == 1
    fresh = learner.init(seed=1)
    back = CheckpointManager(str(tmp_path / "m"), mesh=mesh).restore(fresh)
    _equal(back.env_state, state.env_state, "env_state")
    assert torch.equal(back.env_key.get_state(), state.env_key.get_state())
    # a checkpoint of a mesh of one restores without a mesh, and the plain
    # one under a mesh of one
    CheckpointManager(str(tmp_path / "m")).restore(learner.init(seed=1))
    CheckpointManager(str(tmp_path / "p")).save(1, state)
    CheckpointManager(str(tmp_path / "p"), mesh=mesh).restore(learner.init(seed=1))
    saved["world"], saved["ranks"] = 2, saved["ranks"] * 2
    torch.save(saved, tmp_path / "m" / "ckpt_2.pt")
    with pytest.raises(CheckpointMismatch, match="world size 2, this run has world size 1"):
        CheckpointManager(str(tmp_path / "m"), mesh=mesh).restore(fresh)


def test_entry_steps_the_walker_on_the_cpu():
    from mocca_envs_tpu_torch.graft_entry import entry

    fn, (state, actions) = entry(device="cpu")
    tr = fn(state, actions)
    assert tr.obs.shape == (256, tr.obs.shape[1]) and bool(torch.isfinite(tr.state.q).all())


def test_parallel_and_graft_entry_import_no_jax():
    files = sorted((REPO / "mocca_envs_tpu_torch" / "parallel").glob("*.py")) + [
        REPO / "mocca_envs_tpu_torch" / "graft_entry.py"]
    assert {p.name for p in files} == {"__init__.py", "mesh.py", "sharded.py", "multihost.py",
                                      "graft_entry.py"}
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "optax",
                                                  "mocca_envs_tpu"), f"{path}: imports {name}"
