"""The port's multi-device path in two processes on the CPU (gloo over
localhost), mirroring tests/test_multihost_spawn.py's two cases.

Two OS processes join one process group (``parallel/multihost.py``), build
the ``env`` mesh and (tests/torch_parallel_workers.py):

- step their halves of the same walker states: with ``step_no_reset`` the
  gathered halves equal the one-process step on all the states bit for bit,
  and with ``step`` on the slots that did not reset (a fresh episode draws
  from the rank's own generator). The plain path's per-env arithmetic does
  not depend on the batch size, with one exception on the CPU: PyTorch's
  vectorized ``atan2`` over a contiguous run takes it two SIMD vectors at a
  time (32 floats on AVX-512, 16 on AVX2) and the rest one element at a
  time, and the two part by an ulp; 8 states, halves of 4, stay on the
  one-element path on either (on the card every element takes one path);
- update the learner on their halves of one fixed trajectory: the network,
  the running norms and the metrics equal the one-process update on the
  whole trajectory within float32 summation order (one minibatch, so the
  ranks' own shuffles reorder only a mean), and the two ranks' networks are
  equal bit for bit;
- train the mixed trio (BASELINE config 5) 2 updates into one learner: the
  replica fingerprints are equal and ``check_replica_divergence`` holds;
- against the JAX package: its ``sharded_env`` over a 2-device mesh of the
  test process's CPU devices, and the port's two ranks on the same walker
  states converted through numpy, per-env medians at the gates of
  tests/test_torch_walker_env.py.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import mocca_envs_tpu
import mocca_envs_tpu_torch
from mocca_envs_tpu.parallel.sharded import sharded_env as jsharded_env
from mocca_envs_tpu.parallel.sharded import sharded_init as jsharded_init
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.core import rng as trng
from mocca_envs_tpu_torch.harness.checkpoint import CheckpointManager, CheckpointMismatch
from mocca_envs_tpu_torch.harness.ppo import PPOConfig, PPOLearner, gaussian_log_prob
from mocca_envs_tpu_torch.harness.rollout import Trajectory

from tests import torch_workers  # noqa: F401
from tests.torch_parallel_workers import (fail_rank_1, run_ranks, sleep_60, step_shard,
                                          train_cli, update_and_mixed)

WALKER = "Walker3DCustomEnv-v0"
B = 16        # the update's batch
STEP_B = 8    # the sharded step's (module docstring)
# float32 summation order: the gradient and the batch moments are sums over
# 64 samples taken in two halves; two Adam steps of lr 3e-4 follow
PARAM_ATOL = 1e-6
REL = 1e-5


def _eq(a, b, what):
    """Bit-for-bit equality of two trees of tensors."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _eq(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _eq(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


def _cat(trees):
    """The rank halves of a batched tree joined along the batch axis."""
    a = trees[0]
    if isinstance(a, torch.Tensor):
        return torch.cat(trees)
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{f.name: _cat([getattr(t, f.name) for t in trees])
                                         for f in dataclasses.fields(a)})
    if isinstance(a, dict):
        return {k: _cat([t[k] for t in trees]) for k in a}
    assert all(t is None for t in trees)
    return None


def test_sharded_step_equals_the_one_process_step(tmp_path):
    env = mocca_envs_tpu_torch.make(WALKER, device="cpu")
    gen = trng.generator(0, "cpu")
    rng = np.random.default_rng(0)
    n = STEP_B
    state = env.init(gen, n)
    for _ in range(10):   # into contact
        state = env.step(state, torch.as_tensor(rng.uniform(-1, 1, (n, env.act_dim)),
                                                dtype=torch.float32), gen).state
    actions = torch.as_tensor(rng.uniform(-1, 1, (n, env.act_dim)), dtype=torch.float32)
    torch.save({"env_id": WALKER, "state": state, "actions": actions}, tmp_path / "inputs.pt")
    ranks = run_ranks(step_shard, tmp_path)

    raw = env.step_no_reset(state, actions, trng.generator(7, "cpu"))
    _eq(_cat([r["raw"] for r in ranks]), raw, "step_no_reset")
    tr = env.step(state, actions, trng.generator(7, "cpu"))
    got = _cat([r["step"] for r in ranks])
    _eq(got.done, tr.done, "done")
    live = ~tr.done
    assert live.sum() >= n // 2
    for name in ("q", "qd", "steps", "reset_count"):
        assert torch.equal(getattr(got.state, name)[live], getattr(tr.state, name)[live]), name
    for name in ("obs", "reward"):
        assert torch.equal(getattr(got, name)[live], getattr(tr, name)[live]), name


def _trajectory(learner, T, rng):
    """A fixed trajectory whose actions come from the initial policy, with
    episode ends and a metric channel that is NaN in some entries."""
    net = learner.init(seed=0).params
    obs = torch.as_tensor(rng.standard_normal((T, B, learner.env.obs_dim)), dtype=torch.float32)
    with torch.no_grad():
        mean, log_std, value = net(obs / math.sqrt(1 + 1e-8))
        action = mean + torch.exp(log_std) * torch.as_tensor(
            rng.standard_normal(mean.shape), dtype=torch.float32)
        log_prob = gaussian_log_prob(mean, log_std, action)
    metric = rng.standard_normal((T, B)).astype(np.float32)
    metric[rng.random((T, B)) < 0.3] = np.nan
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    return Trajectory(obs=obs, action=action, log_prob=log_prob, value=value,
                      reward=f32(rng.standard_normal((T, B))),
                      done=torch.as_tensor(rng.random((T, B)) < 0.2),
                      last_obs=f32(rng.standard_normal((B, learner.env.obs_dim))),
                      env_metrics={"x": f32(metric)})


def test_two_rank_update_and_the_mixed_trio(tmp_path):
    env = mocca_envs_tpu_torch.make(WALKER, device="cpu")
    config = PPOConfig(horizon=4, num_epochs=2, num_minibatches=1, hidden=(16, 16),
                       normalize_reward=True, mirror_coef=0.1)
    learner = PPOLearner(env, config, num_envs=B)
    traj = _trajectory(learner, config.horizon, np.random.default_rng(1))
    mixed_config = PPOConfig(horizon=2, num_epochs=1, num_minibatches=1, hidden=(16, 16),
                             mirror_coef=0.1)
    torch.save({"env_id": WALKER, "config": config, "num_envs": B, "traj": traj,
                "family_counts": (4, 4, 4), "mixed_config": mixed_config},
               tmp_path / "inputs.pt")
    ranks = run_ranks(update_and_mixed, tmp_path)

    state, metrics = learner.update(learner.init(seed=0), traj)
    want = state.params.state_dict()
    for r in ranks:
        got = r["update"]
        for k, v in want.items():
            torch.testing.assert_close(got["params"][k], v, rtol=0, atol=PARAM_ATOL, msg=k)
        for norm, mine in ((got["obs_norm"], state.obs_norm), (got["ret_norm"], state.ret_norm)):
            torch.testing.assert_close(norm.mean, mine.mean, rtol=REL, atol=1e-7)
            torch.testing.assert_close(norm.var, mine.var, rtol=REL, atol=0)
            assert float(norm.count) == float(mine.count)
        assert got["metrics"].keys() == metrics.keys()
        for k, v in metrics.items():
            torch.testing.assert_close(got["metrics"][k], v, rtol=REL, atol=1e-6,
                                       equal_nan=True, msg=k)
    _eq(ranks[0]["update"]["params"], ranks[1]["update"]["params"], "replicas")

    mixed = [r["mixed"] for r in ranks]
    assert all(m["same"] for m in mixed)
    assert mixed[0]["fingerprint"].tolist() == mixed[1]["fingerprint"].tolist()
    assert all(m["update_count"] == 2 and m["local_envs"] == [2, 2, 2] for m in mixed)
    for ch in ("env/Walker3DCustomEnv/progress", "env/CassieEnv/speed",
               "env/Monkey3DStepperEnv/bars_reached"):
        assert all(np.isfinite(m["metrics"][ch]) for m in mixed), ch
    np.testing.assert_array_equal(*(np.array(list(m["metrics"].values())) for m in mixed))

    # the mesh's checkpoint: each rank restores its own env shard and env
    # generators bit for bit over a learner seeded otherwise; another world
    # size is refused
    for r in ranks:
        ck = r["ckpt"]
        _eq(ck["restored"], ck["saved"], "restored")
        assert not torch.equal(ck["fresh"]["env_state"][0].q, ck["saved"]["env_state"][0].q)
        assert ck["fingerprint"].tolist() == mixed[0]["fingerprint"].tolist()
    for f in range(3):
        assert not torch.equal(ranks[0]["ckpt"]["saved"]["env_state"][f].q,
                               ranks[1]["ckpt"]["saved"]["env_state"][f].q)
        assert not torch.equal(ranks[0]["ckpt"]["saved"]["env_key"][f],
                               ranks[1]["ckpt"]["saved"]["env_key"][f])
    with pytest.raises(CheckpointMismatch, match="world size 2, this run has world size 1"):
        CheckpointManager(str(tmp_path / "ckpt")).restore(learner.init(seed=0))


def _to_port(js):
    n = np.asarray
    return convert.env_state_from_numpy(
        q=n(js.q), qd=n(js.qd), steps=n(js.steps), reset_count=n(js.reset_count),
        done=n(js.done), blowup_count=n(js.blowup_count), target=n(js.task.target),
        potential=n(js.task.potential), ground_z=n(js.scene.ground_z),
        friction=n(js.scene.friction))


def test_two_ranks_match_the_jax_sharded_env(tmp_path):
    jenv = mocca_envs_tpu.make(WALKER)
    mesh = Mesh(np.array(jax.devices()[:2]), ("env",))
    n = 4
    js = jsharded_init(jenv, mesh, n, seed=0)
    state = _to_port(jax.device_get(js))
    actions = np.random.default_rng(2).uniform(-1, 1, (n, jenv.act_dim)).astype(np.float32)
    jtr = jax.device_get(jsharded_env(jenv, mesh)(js, jnp.asarray(actions)))
    torch.save({"env_id": WALKER, "state": state, "actions": torch.as_tensor(actions)},
               tmp_path / "inputs.pt")
    ptr = _cat([r["step"] for r in run_ranks(step_shard, tmp_path)])

    jdone = np.asarray(jtr.done)
    np.testing.assert_array_equal(ptr.done.numpy(), jdone)
    live = ~jdone
    assert live.all()
    np.testing.assert_allclose(ptr.reward.numpy(), np.asarray(jtr.reward), atol=1e-4)
    per_env = np.abs(ptr.obs.numpy() - np.asarray(jtr.obs)).max(axis=1)
    assert np.median(per_env) <= 1e-4 and per_env.max() <= 1e-3, per_env
    per_env_q = np.abs(ptr.state.q.numpy() - np.asarray(jtr.state.q)).max(axis=1)
    assert np.median(per_env_q) <= 2e-4, per_env_q


@pytest.mark.parametrize("mesh", [True, False], ids=["mesh", "no_mesh"])
def test_cli_on_two_processes(tmp_path, mesh):
    """``--multihost`` in two processes: only the group's rank 0 writes
    metrics, with the curriculum stage; under the mesh each rank holds half
    the batch and the checkpoint holds both ranks' shards, under
    ``--no-mesh`` each rank trains the whole batch and rank 0 alone writes
    a checkpoint of one."""
    argv = ["--env", "Walker3DStepperEnv", "--num-envs", "4", "--horizon", "2", "--updates",
            "2", "--minibatches", "1", "--epochs", "1", "--log-every", "1", "--ckpt-every", "1",
            "--ckpt-dir", str(tmp_path / "ckpt"), "--metrics", str(tmp_path / "m.jsonl")]
    torch.save({"argv": argv + ([] if mesh else ["--no-mesh"])}, tmp_path / "inputs.pt")
    ranks = run_ranks(train_cli, tmp_path)

    lines = [json.loads(line) for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [line["step"] for line in lines] == [1, 2]
    assert all(np.isfinite(line["curriculum_stage"]) for line in lines)
    assert [r["local_envs"] for r in ranks] == ([2, 2] if mesh else [4, 4])
    saved = torch.load(tmp_path / "ckpt" / "ckpt_2.pt", weights_only=True)
    if mesh:
        assert saved["world"] == 2 and len(saved["ranks"]) == 2
        assert ranks[0]["fingerprint"].tolist() == ranks[1]["fingerprint"].tolist()
    else:
        assert "world" not in saved and saved["state"]["fields"]["env_state"]["fields"][
            "q"].shape[0] == 4


def test_dryrun_multichip_on_two_cpu_processes():
    """The multi-device dry run (``graft_entry.py``): a sharded step, a training
    step and the mixed trio into one learner over two processes."""
    from mocca_envs_tpu_torch.graft_entry import dryrun_multichip

    dryrun_multichip(2, device="cpu")


@pytest.mark.parametrize("bad", ["rank", "timeout"])
def test_a_failing_rank_raises(tmp_path, bad):
    """A rank that raises, or ranks that outlast the limit, raise in the
    caller; no rank is left running."""
    import torch.multiprocessing as mp

    from mocca_envs_tpu_torch.graft_entry import join

    ctx = mp.start_processes(fail_rank_1 if bad == "rank" else sleep_60, args=(), nprocs=2, join=False,
                             start_method="spawn")
    with pytest.raises(Exception, match="ValueError" if bad == "rank" else "did not finish"):
        join(ctx, 60 if bad == "rank" else 2)
    assert not any(p.is_alive() for p in ctx.processes)

