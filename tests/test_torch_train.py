"""The port's training harness on the CPU: the CLI, checkpoints, transfer
seams, and a toy task with a known optimum.

- ``main(argv, device="cpu")`` trains 2 updates of a small batch; its
  metric lines carry the JAX learner's names: the learner's own (from the
  JAX ``PPOLearner`` run on a one-dimensional toy env, whose names the
  port's learner matches exactly) and ``env/`` / ``ep_end/`` for each of the
  JAX walker's metric channels (read from its traced step), plus the CLI's
  ``env_steps_per_s`` and the rollout and update seconds;
- a save → resume → continue run of ``--env Walker3DStepperEnv
  --split-impulse`` ends with parameters, optimizer state, env state and
  observations bit-identical to an uninterrupted run;
- ``restore_compat`` resumes across a ``--normalize-reward`` flip both ways;
- ``--multihost`` and a mesh raise, naming ROADMAP item 13 (the mixed
  suite, a comma-separated ``--env``, is tested in test_torch_mixed.py); no
  device means the card, which a CPU-only box does not have;
- PPO on a one-step toy task (reward −(a − 0.6)²) moves the policy mean
  from 0 to within 0.15 of 0.6 in 15 seeded updates;
- the checkpoint keeps the newest three and refuses a template of another
  structure; the metrics logger writes the JAX package's JSONL lines and
  skips a TensorBoard it cannot import; ``--profile-dir`` writes a trace.
"""

import dataclasses
import json
import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mocca_envs_tpu
from mocca_envs_tpu.envs import env as jenv_mod
from mocca_envs_tpu.harness import ppo as jppo
from mocca_envs_tpu.tasks.cassie_task import CASSIE_CONFIG as JCASSIE_CONFIG
from mocca_envs_tpu_torch.envs import env as tenv_mod
from mocca_envs_tpu_torch.harness import ppo, train
from mocca_envs_tpu_torch.harness.checkpoint import CheckpointManager, CheckpointMismatch
from mocca_envs_tpu_torch.harness.metrics import MetricsLogger, aggregate, merge_means
from mocca_envs_tpu_torch.harness.profile import TRACE_FILE
from mocca_envs_tpu_torch.harness.rollout import random_rollout
from mocca_envs_tpu_torch.tasks.cassie_task import CASSIE_CONFIG as TCASSIE_CONFIG

from tests import torch_workers  # noqa: F401

SMALL = ["--num-envs", "8", "--horizon", "4", "--minibatches", "2", "--epochs", "2",
         "--log-every", "1"]
CLI_KEYS = {"step", "wall_s", "env_steps_per_s", "rollout_s", "update_s"}
OPTIMUM = 0.6


def _cli(tmp_path, *argv, name="run", **kw):
    metrics = tmp_path / f"{name}.jsonl"
    state = train.main([*SMALL, "--metrics", str(metrics), *argv], device="cpu", **kw)
    return state, [json.loads(line) for line in metrics.read_text().splitlines()]


# ------------------------------------------------------------ the toy task
def _jax_toy():
    """One-step bandit in the JAX package: obs a constant 1, reward
    −(a − 0.6)², a ``hit`` channel."""
    def reset(key, reset_count, prev=None):
        z = jnp.zeros(1)
        return jenv_mod.EnvState(q=z, qd=z, key=key, reset_count=reset_count,
                                 steps=jnp.zeros((), jnp.int32), task=None, scene=None,
                                 done=jnp.zeros((), bool), blowup_count=jnp.zeros((), jnp.int32))

    def raw_step(state, action):
        err = action[0] - OPTIMUM
        return jenv_mod.Transition(state=state, obs=jnp.ones(1), reward=-err * err,
                                   done=jnp.ones((), bool),
                                   metrics={"hit": (jnp.abs(err) < 0.1).astype(jnp.float32)})

    return jenv_mod.make_fn_env(name="Toy", obs_dim=1, act_dim=1, reset=reset,
                                raw_step=raw_step, obs_fn=lambda s: jnp.ones(1), control_dt=0.1)


def _port_toy():
    """The same bandit, batch-first, in the port."""
    def reset(gen, reset_count, prev=None):
        B = reset_count.shape[0]
        return tenv_mod.EnvState(q=torch.zeros(B, 1), qd=torch.zeros(B, 1),
                                 reset_count=reset_count, steps=torch.zeros(B, dtype=torch.int32),
                                 task=None, scene=None, done=torch.zeros(B, dtype=torch.bool),
                                 blowup_count=torch.zeros(B, dtype=torch.int32))

    def obs_fn(state):
        return torch.ones(state.q.shape[0], 1)

    def raw_step(state, action, gen):
        err = action[:, 0] - OPTIMUM
        return tenv_mod.Transition(state=state, obs=obs_fn(state), reward=-err * err,
                                   done=torch.ones_like(err, dtype=torch.bool),
                                   metrics={"hit": (err.abs() < 0.1).to(torch.float32)})

    return tenv_mod.make_fn_env(name="Toy", obs_dim=1, act_dim=1, reset=reset,
                                raw_step=raw_step, obs_fn=obs_fn, control_dt=0.1,
                                device=torch.device("cpu"))


@pytest.fixture(scope="module")
def jax_learner_keys():
    """The metric names of one JAX learner update on the toy env."""
    cfg = jppo.PPOConfig(horizon=4, hidden=(16, 16), num_minibatches=2, num_epochs=1)
    learner = jppo.PPOLearner(_jax_toy(), cfg, num_envs=8)
    _, metrics = learner.train_step(learner.init(seed=0))
    return set(metrics)


def test_learner_metric_names_match_jax(jax_learner_keys):
    cfg = ppo.PPOConfig(horizon=4, hidden=(16, 16), num_minibatches=2, num_epochs=1)
    learner = ppo.PPOLearner(_port_toy(), cfg, num_envs=8)
    state, metrics = learner.train_step(learner.init(seed=0))
    assert set(metrics) == jax_learner_keys
    assert {"env/hit", "ep_end/hit", "env/blowup"} <= jax_learner_keys
    assert state.update_count == 1 and all(bool(torch.isfinite(v)) for v in metrics.values())


def test_cli_metric_lines_carry_the_jax_learners_names(tmp_path, jax_learner_keys):
    """Two updates of the walker through the CLI; the JAX walker's metric
    channels come from its traced (not compiled) step."""
    jenv = mocca_envs_tpu.make("Walker3DCustomEnv")
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(jnp.arange(2))
    states = jax.eval_shape(jax.vmap(jenv.init), keys)
    tr = jax.eval_shape(jax.vmap(jenv.step), states, jnp.zeros((2, jenv.act_dim)))
    own = {k for k in jax_learner_keys if "/" not in k}
    want = own | {f"{p}/{k}" for k in tr.metrics for p in ("env", "ep_end")}
    state, lines = _cli(tmp_path, "--env", "Walker3DCustomEnv", "--updates", "2")
    assert [line["step"] for line in lines] == [1, 2] and state.update_count == 2
    for line in lines:
        assert set(line) - CLI_KEYS == want
        assert line["env_steps_per_s"] > 0 and line["rollout_s"] > 0 and line["update_s"] > 0
        # NaN only where the JAX learner allows it: env channels of batches
        # in which no episode ended (or a channel is nowhere finite)
        assert all(np.isfinite(v) for k, v in line.items() if "/" not in k)


def test_ppo_moves_the_policy_mean_to_the_optimum():
    """Deterministic: a seeded run of 15 updates, the policy mean read
    before and after."""
    cfg = ppo.PPOConfig(horizon=8, hidden=(16, 16), lr=3e-3, num_minibatches=2)
    learner = ppo.PPOLearner(_port_toy(), cfg, num_envs=32)
    state = learner.init(seed=3)

    def policy_mean(state):
        with torch.no_grad():
            return float(state.params(state.obs_norm.normalize(torch.ones(1, 1)))[0][0, 0])

    before = policy_mean(state)
    for _ in range(15):
        state, metrics = learner.train_step(state)
    after = policy_mean(state)
    assert abs(before) < 0.05
    assert abs(after - OPTIMUM) < 0.15, (before, after)
    assert float(metrics["env/hit"]) > 0.1


# ----------------------------------------------------------- checkpoints
def _assert_states_equal(a, b):
    for (ka, va), (kb, vb) in zip(a.params.state_dict().items(), b.params.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    for pa, pb in zip(a.params.parameters(), b.params.parameters()):
        sa, sb = a.opt_state.state[pa], b.opt_state.state[pb]
        assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    assert torch.equal(a.obs, b.obs) and torch.equal(a.env_state.q, b.env_state.q)
    assert torch.equal(a.env_state.task.stage, b.env_state.task.stage)
    for f in ("mean", "var", "count"):
        assert torch.equal(getattr(a.obs_norm, f), getattr(b.obs_norm, f))
    assert torch.equal(a.key.get_state(), b.key.get_state())
    assert torch.equal(a.env_key.get_state(), b.env_key.get_state())
    assert a.update_count == b.update_count


def test_resume_is_bit_identical(tmp_path, caplog):
    """The training path of this slice: the stepper with split impulse,
    2 updates, saved, then resumed to 3; against 3 in one run."""
    args = ["--env", "Walker3DStepperEnv", "--split-impulse"]
    _cli(tmp_path, *args, "--updates", "2", "--ckpt-dir", str(tmp_path / "a"), name="a1")
    with caplog.at_level(logging.INFO):
        resumed, lines = _cli(tmp_path, *args, "--updates", "3", "--ckpt-dir",
                              str(tmp_path / "a"), name="a2")
    assert "resumed from update 2" in caplog.text and [x["step"] for x in lines] == [3]
    straight, _ = _cli(tmp_path, *args, "--updates", "3", "--ckpt-dir", str(tmp_path / "b"),
                       name="b")
    _assert_states_equal(resumed, straight)
    assert CheckpointManager(str(tmp_path / "a")).steps() == [2, 3]


@pytest.mark.parametrize("first", [True, False], ids=["saved_with", "saved_without"])
def test_restore_compat_across_the_normalize_reward_flip(tmp_path, first):
    flag = ["--normalize-reward"]
    base = ["--env", "Walker3DCustomEnv", "--horizon", "2", "--ckpt-dir", str(tmp_path / "c")]
    _cli(tmp_path, *base, "--updates", "1", *(flag if first else []), name="one")
    state, lines = _cli(tmp_path, *base, "--updates", "2", *([] if first else flag), name="two")
    assert state.update_count == 2 and [x["step"] for x in lines] == [2]
    assert (state.ret_accum is None) == first and (state.ret_norm is None) == first
    assert ("reward_norm_std" in lines[0]) != first
    if not first:
        # this run's fresh accumulator, carried through its one update
        assert state.ret_accum.shape == (8,) and float(state.ret_norm.count) > 1.0


def test_checkpoint_keeps_three_and_refuses_another_structure(tmp_path):
    learner = ppo.PPOLearner(_port_toy(), ppo.PPOConfig(horizon=2, hidden=(8,)), num_envs=8)
    state = learner.init(seed=0)
    ckpt = CheckpointManager(str(tmp_path))
    for step in range(1, 6):
        ckpt.save(step, dataclasses.replace(state, update_count=step))
    assert ckpt.steps() == [3, 4, 5] and ckpt.latest_step() == 5
    assert ckpt.restore(learner.init(seed=1)).update_count == 5
    assert ckpt.restore(learner.init(seed=1), step=4).update_count == 4
    other = ppo.PPOLearner(_port_toy(), ppo.PPOConfig(horizon=2, hidden=(4,)), num_envs=8)
    with pytest.raises(CheckpointMismatch):
        ckpt.restore(other.init(seed=0))
    with pytest.raises(CheckpointMismatch, match="ret_accum"):
        ckpt.restore(dataclasses.replace(state, ret_accum=torch.zeros(8),
                                         ret_norm=ppo.RunningNorm.init(1)))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)


# -------------------------------------------------------------- the CLI
def test_cli_refuses_what_it_has_not_ported():
    with pytest.raises(NotImplementedError, match="item 13"):
        train.main(["--multihost"], device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        ppo.PPOLearner(_port_toy(), mesh=object(), num_envs=8)


def test_no_device_means_the_card():
    """Without a device argument the trainer runs on the CUDA card and does
    not go on on the CPU where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card refusal cannot show here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--env", "Walker3DCustomEnv", "--updates", "1"])


def test_split_config_keeps_each_familys_timing():
    for env_id, base in (("CassieEnv", TCASSIE_CONFIG), ("CassiePhase2DEnv", TCASSIE_CONFIG),
                         ("Walker3DStepperEnv", None), ("Monkey3DStepperEnv", None)):
        cfg = train.split_config(env_id)
        assert cfg.split_impulse
        want = dataclasses.replace(base, split_impulse=True) if base else None
        if want is not None:
            assert cfg == want
            assert (cfg.llc_frames, cfg.sim_substeps, cfg.dt) == (
                JCASSIE_CONFIG.llc_frames, JCASSIE_CONFIG.sim_substeps, JCASSIE_CONFIG.dt)
        else:
            assert (cfg.llc_frames, cfg.sim_substeps) == (1, 4)


def test_metrics_logger_lines_and_a_missing_tensorboard(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    path = tmp_path / "m.jsonl"
    with caplog.at_level(logging.WARNING):
        log = MetricsLogger(jsonl_path=str(path), tensorboard_dir=str(tmp_path / "tb"))
    assert "tensorboard writer unavailable" in caplog.text
    log.log(3, {"a": torch.tensor(1.5), "b": float("nan")})
    log.close()
    line = json.loads(path.read_text())
    assert line["step"] == 3 and line["a"] == 1.5 and np.isnan(line["b"]) and "wall_s" in line


def test_profile_dir_writes_a_trace(tmp_path):
    _cli(tmp_path, "--env", "Walker3DCustomEnv", "--updates", "1", "--horizon", "2",
         "--profile-dir", str(tmp_path / "prof"))
    trace = json.loads((tmp_path / "prof" / TRACE_FILE).read_text())
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])


def test_aggregate_merge_means_and_random_rollout():
    """The metric helpers reduce as the JAX package's do; the random
    rollout is seeded (the same seed, the same rewards)."""
    agg = aggregate({"a": torch.tensor([[1.0, 2.0], [3.0, 6.0]]), "b": torch.tensor([1, 0])})
    assert float(agg["a"]) == 3.0 and float(agg["b"]) == 0.5
    assert merge_means([{"a": 1.0, "b": 2.0}, {"a": 3.0, "b": torch.tensor(4.0)}]) == {
        "a": 2.0, "b": 3.0}
    state, rewards = random_rollout(_port_toy(), 8, 5, seed=2)
    assert rewards.shape == (5, 8) and bool((rewards <= 0).all())
    assert torch.equal(rewards, random_rollout(_port_toy(), 8, 5, seed=2)[1])
    assert not torch.equal(rewards, random_rollout(_port_toy(), 8, 5, seed=3)[1])
    assert int(state.reset_count.min()) == 5        # every step ends the toy's episode
