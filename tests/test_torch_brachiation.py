"""PyTorch port vs the JAX package: the brachiation pipeline (CPU).

Held against the JAX package's ``harness/brachiation.py``:

- ``BrachiationConfig``'s defaults (the 2500 + 800 updates) and the JAX
  tests' ``TINY`` field by field, ``ppo()`` against the JAX ``PPOConfig``
  for the main phase and the fine-tune, and ``monkey_params()`` pinned and
  not, every field of ``MonkeyParams`` equal in its JAX dtype;
- ``eval_bars`` on one scripted env (episodes of known lengths) in both
  packages, pinned (only episodes begun under the pin count) and adaptive
  (every episode end counts, the carried stages averaged): the same rows.

On the port alone (the JAX package's end-to-end test is ``slow``: it
compiles the monkey's step), at the JAX tests' ``TINY`` on the CPU:
``run_brachiation`` finishes both phases with their ``PHASE_DONE`` markers
and a pinned and an adaptive eval row of the JAX keys; ``main`` on the same
root then short-circuits both phases and prints the evals.
"""

import dataclasses
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from mocca_envs_tpu.harness import allsteps as jall
from mocca_envs_tpu.harness import brachiation as jbr
from mocca_envs_tpu.harness import ppo as jppo
from mocca_envs_tpu_torch.harness import allsteps, brachiation, ppo

from tests import torch_workers  # noqa: F401
from tests.test_torch_allsteps import assert_params_equal

TINY_FIELDS = dict(num_envs=8, seed=5, horizon=4, num_epochs=1, num_minibatches=2,
                   hidden=(16, 16), main_updates=2, ft_updates=2, floor_anneal_updates=2,
                   eval_steps=10, eval_stages=(0.0,), checkpoint_every=2, log_every=1)
TINY = brachiation.BrachiationConfig(**TINY_FIELDS)
EVAL_KEYS = {"stage", "deterministic", "truncated", "episodes", "ep_end_bars_mean",
             "ep_end_bars_p50", "ep_end_bars_p90", "frac_ge_4", "stage_mean"}


@pytest.mark.parametrize("fields", [{}, TINY_FIELDS], ids=["defaults", "tiny"])
def test_config_matches_jax(fields):
    port, ref = brachiation.BrachiationConfig(**fields), jbr.BrachiationConfig(**fields)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    for kw in ({}, dict(log_std_min=port.floor_explore, log_std_min_final=port.floor_final,
                        log_std_anneal_updates=port.floor_anneal_updates)):
        assert dataclasses.asdict(port.ppo(**kw)) == dataclasses.asdict(ref.ppo(**kw))
    assert (port.main_updates, port.ft_updates) == ((2500, 800) if not fields else (2, 2))


@pytest.mark.parametrize("pinned", [False, True])
def test_monkey_params_match_jax(pinned):
    mp = TINY.monkey_params(pinned=pinned)
    assert_params_equal(mp, jbr.BrachiationConfig(**TINY_FIELDS).monkey_params(pinned=pinned))
    assert mp.adv_threshold == (99.0 if pinned else 4.0)
    assert (mp.alive_bonus, mp.hold_grace, mp.w_swing, mp.progress_timeout) == (0.3, 60, 0.5, 120)


# --------------------------------------------------- a scripted env
class _JTask(struct.PyTreeNode):
    next_bar: jnp.ndarray
    stage: jnp.ndarray
    length: jnp.ndarray


class _JState(struct.PyTreeNode):
    reset_count: jnp.ndarray
    task: _JTask


class _JTr(struct.PyTreeNode):
    state: _JState
    obs: jnp.ndarray
    done: jnp.ndarray


@dataclasses.dataclass
class _TTask:
    next_bar: torch.Tensor
    stage: torch.Tensor
    length: torch.Tensor


@dataclasses.dataclass
class _TState:
    reset_count: torch.Tensor
    task: _TTask


INIT = dict(reset_count=np.array([1, 0, 2, 0, 0, 4], np.int32),
            next_bar=np.array([0, 2, 1, 0, 3, 1], np.int32),
            stage=np.array([0.0, 1.0, 3.0, 2.0, 0.0, 5.0], np.float32),
            length=np.array([3, 4, 6, 2, 5, 7], np.float32))


def _jax_parts():
    """An env whose episodes end after ``length + stage`` steps, reaching a
    bar a step."""
    def step(s, a):
        n = s.task.next_bar + 1
        done = n.astype(jnp.float32) >= s.task.length + s.task.stage
        st = s.replace(reset_count=s.reset_count + done.astype(jnp.int32),
                       task=s.task.replace(next_bar=jnp.where(done, 0, n)))
        return _JTr(state=st, obs=jnp.zeros(2), done=done)

    e = {k: jnp.asarray(v) for k, v in INIT.items()}
    state = SimpleNamespace(params=None, obs_norm=jppo.RunningNorm.init(2), env_state=_JState(
        reset_count=e["reset_count"], task=_JTask(next_bar=e["next_bar"], stage=e["stage"],
                                                  length=e["length"])))
    net = SimpleNamespace(apply=lambda p, o: (jnp.zeros((o.shape[0], 1)), jnp.zeros(1),
                                              jnp.zeros(o.shape[0])))
    return SimpleNamespace(step=step, obs_fn=lambda s: jnp.zeros(2)), net, state


def _port_parts():
    def step(s, a, gen):
        n = s.task.next_bar + 1
        done = n.to(torch.float32) >= s.task.length + s.task.stage
        st = dataclasses.replace(s, reset_count=s.reset_count + done.to(torch.int32),
                                 task=dataclasses.replace(s.task, next_bar=torch.where(
                                     done, torch.zeros_like(n), n)))
        return SimpleNamespace(state=st, obs=torch.zeros(6, 2), done=done)

    e = {k: torch.as_tensor(v) for k, v in INIT.items()}
    state = SimpleNamespace(obs_norm=ppo.RunningNorm.init(2), env_key=torch.Generator(),
                            env_state=_TState(reset_count=e["reset_count"], task=_TTask(
                                next_bar=e["next_bar"], stage=e["stage"], length=e["length"])))
    net = lambda o: (torch.zeros(o.shape[0], 1), torch.zeros(1), torch.zeros(o.shape[0]))  # noqa
    return (SimpleNamespace(step=step, obs_fn=lambda s: torch.zeros(6, 2),
                            device=torch.device("cpu")), net, state)


@pytest.mark.parametrize("stage,deterministic", [(None, True), (2.0, True), (0.0, False)],
                         ids=["adaptive", "pinned", "pinned_noise"])
def test_eval_bars_matches_jax_on_a_scripted_env(stage, deterministic):
    rows = []
    for mod, parts in ((jbr, _jax_parts), (brachiation, _port_parts)):
        env, net, state = parts()
        cfg = mod.BrachiationConfig(eval_steps=25)
        hooks = (jall if mod is jbr else allsteps).RunHooks(emit=lambda **kw: None)
        rows.append(mod.eval_bars(env, net, state, cfg, stage, hooks, deterministic))
    assert rows[0] == rows[1]
    row = rows[1]
    assert set(row) == EVAL_KEYS and row["stage"] == stage
    # the scripted env in numpy: pinned, each env's first end is discarded
    stages = INIT["stage"] if stage is None else np.full(6, stage, np.float32)
    bars, at = [], []
    for i in range(6):
        count, rc = int(INIT["next_bar"][i]), int(INIT["reset_count"][i])
        for _ in range(25):
            pre, count = count, count + 1
            if count >= INIT["length"][i] + stages[i]:
                rc, count = rc + 1, 0
                if stage is None or rc > INIT["reset_count"][i] + 1:
                    bars.append(pre)
                    at.append(stages[i])
    assert row["episodes"] == len(bars) > 0
    assert row["ep_end_bars_mean"] == round(float(np.mean(bars)), 2)
    assert row["stage_mean"] == round(float(np.mean(at)), 3)


BRACHIATION_CLI = ["--num-envs", "8", "--seed", "5", "--horizon", "4", "--num-epochs", "1",
                   "--num-minibatches", "2", "--hidden", "16", "16", "--main-updates", "2",
                   "--ft-updates", "2", "--eval-steps", "4", "--eval-stages", "0"]


def test_run_brachiation_end_to_end_and_resume(tmp_path, capsys):
    emits = []
    cfg = dataclasses.replace(TINY, ckpt_root=str(tmp_path))
    out = brachiation.run_brachiation(
        cfg, allsteps.RunHooks(emit=lambda **kw: emits.append(kw)), device="cpu")
    assert out["main_finished"] and out["ft_finished"]
    # the pinned stage-0 row and the adaptive (stage=None) row
    assert [row["stage"] for row in out["evals"]] == [0.0, None]
    for row in out["evals"]:
        assert set(row) == EVAL_KEYS
        if row["episodes"] == 0:
            assert row["ep_end_bars_mean"] is None
        else:
            assert row["ep_end_bars_mean"] >= 0.0
    for phase in ("main", "ft"):
        assert json.loads((tmp_path / "s5" / phase / "PHASE_DONE").read_text()) == {"at": 2}
    rows = [e for e in emits if "update" in e]
    assert [(e["phase"], e["update"]) for e in rows] == [
        (p, u) for p in ("monkey_main", "monkey_ft") for u in (1, 2)]
    assert [e["log_std_floor"] for e in rows] == [-1.0, -1.0, -1.0, -1.5]
    assert sum(1 for e in emits if e.get("seeded")) == 1

    capsys.readouterr()
    brachiation.main([*BRACHIATION_CLI, "--ckpt-root", str(tmp_path)], device="cpu")
    text = capsys.readouterr().out
    lines = [json.loads(x) for x in text.splitlines() if x.startswith('{"phase"')]
    assert [e["already_done_at"] for e in lines if "already_done_at" in e] == [2, 2]
    assert not any("update" in e for e in lines), "retrained a done phase"
    evals = json.loads(text[text.index('{\n  "evals"'):])["evals"]
    assert [row["stage"] for row in evals] == [0.0, None]
