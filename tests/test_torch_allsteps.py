"""PyTorch port vs the JAX package: the ALLSTEPS pipeline (CPU).

Held against the JAX package's ``harness/allsteps.py``:

- ``AllstepsConfig``'s defaults (and the JAX tests' ``TINY``) field by
  field, ``ppo()`` against the JAX ``PPOConfig`` field by field (as each
  phase builds it), and ``stepper_params()`` pinned and not, every field
  of ``StepperParams``, ``WalkerParams`` and ``StoneParams`` equal in
  float32;
- ``train_phase`` with one scripted learner (deterministic metrics, a tiny
  state) in both packages: the same ``emit`` rows (less the timing), the
  same ``finished`` flags, ``PHASE_DONE`` markers and checkpoint steps,
  fresh, resumed, already done, stopped early, truncated by the deadline,
  seeded with the update count zeroed and the stages pinned, and wiped on a
  checkpoint of another structure; ``restore_latest`` likewise;
- ``eval_fixed_stage`` on one scripted env (episodes of known lengths) in
  both packages: the same rows, which count only the episodes begun under
  the pinned stage, ``None`` statistics where none ended, and the same
  truncation at the deadline.

On the port alone (the JAX package's own tests of these are ``slow``: each
compiles its env step), at the JAX tests' ``TINY`` sizes on the CPU:

- ``eval_fixed_stage`` on the stepper, deterministic and not: rows well
  formed, the train state left as it was;
- ``run_allsteps`` end to end: every phase finished, ``PHASE_DONE`` in each,
  two seeded phases, one ladder row; then ``main`` on the same root
  short-circuits every phase (``already_done_at``, no update row) and
  prints the ladder;
- the deadline truncates a phase without its marker, and a relaunch
  resumes and finishes it;
- a phase seeded by a transfer writes nothing into the source state.
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from mocca_envs_tpu.harness import allsteps as jall
from mocca_envs_tpu.harness import ppo as jppo
from mocca_envs_tpu_torch import make
from mocca_envs_tpu_torch.harness import allsteps, ppo
from mocca_envs_tpu_torch.harness.transfer import transfer_train_state
from mocca_envs_tpu_torch.tasks import walker_stepper as tws

from tests import torch_workers  # noqa: F401

TINY_FIELDS = dict(
    num_envs=8, seed=3, horizon=4, num_epochs=1, num_minibatches=2, hidden=(16, 16),
    mirror_coef=1.0, pretrain_updates=2, pretrain_min_updates=99, stepper_updates=2,
    stepper_min_updates=99, highstage_updates=2, floor_anneal_updates=2,
    eval_stages=(0.0,), eval_steps=12, checkpoint_every=2, log_every=1,
)
TINY = allsteps.AllstepsConfig(**TINY_FIELDS)
LADDER_KEYS = {"stage", "deterministic", "truncated", "episodes", "ep_end_steps_mean",
               "ep_end_steps_p50", "ep_end_steps_p90", "frac_ge_4", "frac_ge_8",
               "frac_complete"}


def assert_params_equal(port, ref, path="params"):
    """Every field of a port params dataclass equals the JAX one's in the
    JAX field's dtype (float32 / int32), recursing into nested params."""
    if dataclasses.is_dataclass(port):
        names = [f.name for f in dataclasses.fields(port)]
        assert names == [f.name for f in dataclasses.fields(ref)], path
        for n in names:
            assert_params_equal(getattr(port, n), getattr(ref, n), f"{path}.{n}")
        return
    want = np.asarray(ref)
    np.testing.assert_array_equal(np.asarray(port, dtype=want.dtype), want, err_msg=path)


@pytest.mark.parametrize("fields", [{}, TINY_FIELDS], ids=["defaults", "tiny"])
def test_config_matches_jax(fields):
    port, ref = allsteps.AllstepsConfig(**fields), jall.AllstepsConfig(**fields)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]


@pytest.mark.parametrize("over", [{}, {"mirror_coef": 0.0}, "highstage"],
                         ids=["pretrain", "no_mirror", "highstage"])
def test_ppo_config_matches_jax(over):
    for fields in ({}, TINY_FIELDS):
        port, ref = allsteps.AllstepsConfig(**fields), jall.AllstepsConfig(**fields)
        kw = over if over != "highstage" else dict(
            log_std_min=port.floor_explore, log_std_min_final=port.floor_final,
            log_std_anneal_updates=port.floor_anneal_updates)
        assert dataclasses.asdict(port.ppo(**kw)) == dataclasses.asdict(ref.ppo(**kw))


@pytest.mark.parametrize("pinned", [False, True])
def test_stepper_params_match_jax(pinned):
    for fields in ({}, TINY_FIELDS, {"w_nearmiss": 0.25, "step_bonus": 12.0}):
        port = allsteps.AllstepsConfig(**fields).stepper_params(pinned=pinned)
        assert_params_equal(port, jall.AllstepsConfig(**fields).stepper_params(pinned=pinned))
        assert port.adv_threshold == (99.0 if pinned else 8.0)


# ------------------------------------------------- a scripted learner
class _JTask(struct.PyTreeNode):
    stage: jnp.ndarray


class _JEnv(struct.PyTreeNode):
    qd: jnp.ndarray
    task: _JTask


class _JState(struct.PyTreeNode):
    params: jnp.ndarray
    env_state: _JEnv
    update_count: jnp.ndarray


@dataclasses.dataclass
class _TTask:
    stage: torch.Tensor


@dataclasses.dataclass
class _TEnv:
    qd: torch.Tensor
    task: _TTask


@dataclasses.dataclass
class _TState:
    params: torch.Tensor
    env_state: _TEnv
    update_count: int


QD0 = np.array([[3.0, 4.0, 1.0]] * 4, np.float32) * np.arange(1, 5, dtype=np.float32)[:, None]


class ScriptedJax:
    """A learner whose update is arithmetic on its update count: env i's
    root speed 5·(i + 1)·u, NaN episode-end stones on odd updates."""

    def __init__(self, width=3):
        self.width = width

    def init(self, seed=0):
        return _JState(params=jnp.zeros(self.width),
                       env_state=_JEnv(qd=jnp.asarray(QD0),
                                       task=_JTask(stage=jnp.arange(4.0) / 2)),
                       update_count=jnp.zeros((), jnp.int32))

    def train_step(self, s):
        u = s.update_count + 1
        uf = u.astype(jnp.float32)
        state = s.replace(params=s.params + 1.0, update_count=u,
                          env_state=s.env_state.replace(qd=jnp.asarray(QD0) * uf))
        return state, {"reward_per_step": uf * 0.37, "episode_done_rate": uf * 0.01,
                       "env/progress": uf,
                       "ep_end/steps_reached": jnp.where(u % 2 == 1, jnp.nan, uf * 0.25)}


class ScriptedPort(ScriptedJax):
    def init(self, seed=0):
        return _TState(params=torch.zeros(self.width),
                       env_state=_TEnv(qd=torch.as_tensor(QD0),
                                       task=_TTask(stage=torch.arange(4.0) / 2)),
                       update_count=0)

    def train_step(self, s):
        u = s.update_count + 1
        uf = torch.tensor(float(u))
        state = dataclasses.replace(s, params=s.params + 1.0, update_count=u,
                                    env_state=dataclasses.replace(s.env_state,
                                                                  qd=torch.as_tensor(QD0) * uf))
        return state, {"reward_per_step": uf * 0.37, "episode_done_rate": uf * 0.01,
                       "env/progress": uf,
                       "ep_end/steps_reached": uf * 0.25 if u % 2 == 0 else uf * float("nan")}


PKGS = {"jax": (jall, ScriptedJax, lambda: jnp.asarray([4.0, 5.0, 4.0, 5.0])),
        "port": (allsteps, ScriptedPort, lambda: torch.tensor([4.0, 5.0, 4.0, 5.0]))}


def _scenario(name, pkg, root):
    """Run one scenario through a package's ``train_phase``; return what it
    emitted (less the timing), its outcomes, markers and checkpoint steps."""
    mod, Learner, pins = PKGS[pkg]
    cfg = mod.AllstepsConfig(num_envs=4, horizon=2, checkpoint_every=2, log_every=1)
    emits, outs = [], []
    hooks = mod.RunHooks(emit=lambda **kw: emits.append(
        {k: v for k, v in kw.items() if k != "env_steps_per_s"}))
    d = os.path.join(root, name)

    def phase(n, learner=None, **kw):
        state, finished = mod.train_phase(learner or Learner(), d, n, name, kw.pop("cfg", cfg),
                                          kw.pop("hooks", hooks), **kw)
        outs.append((finished, int(state.update_count), float(state.params[0])))

    if name == "fresh_then_done":
        phase(3)
        phase(3)
    elif name == "deadline_then_resume":
        phase(3, hooks=dataclasses.replace(hooks, time_left=lambda: 0.0))
        assert not os.path.exists(os.path.join(d, "PHASE_DONE"))
        phase(3)
        phase(3)
    elif name == "early_stop":
        phase(5, stop_fn=lambda u, row, state: u >= 2 and row["speed"] > 20.0)
        phase(5)
    elif name == "log_every_2":
        phase(5, cfg=dataclasses.replace(cfg, log_every=2, checkpoint_every=3))
    elif name == "seeded_pinned":
        learner = Learner()
        seed = learner.init()
        for _ in range(2):
            seed, _ = learner.train_step(seed)
        phase(2, learner, seed_state=seed, zero_update_count=True, pin_stages=pins())
    elif name == "wiped_on_mismatch":
        phase(2)
        phase(2, Learner(width=5))
    elif name == "restore_latest":
        outs.append(mod.restore_latest(Learner(), d, seed=0))
        phase(3)
        outs.append(int(mod.restore_latest(Learner(), d, seed=0).update_count))
        outs.append(mod.restore_latest(Learner(width=5), d, seed=0))
    marker = os.path.join(d, "PHASE_DONE")
    done = json.load(open(marker)) if os.path.exists(marker) else None
    steps = sorted(int(x.removeprefix("ckpt_").removesuffix(".pt")) for x in os.listdir(d)
                   if x.removeprefix("ckpt_").removesuffix(".pt").isdigit())
    return emits, outs, done, steps


@pytest.mark.parametrize("name", ["fresh_then_done", "deadline_then_resume", "early_stop",
                                  "log_every_2", "seeded_pinned", "wiped_on_mismatch",
                                  "restore_latest"])
def test_train_phase_matches_jax_on_a_scripted_learner(name, tmp_path):
    got = _scenario(name, "port", str(tmp_path / "port"))
    want = _scenario(name, "jax", str(tmp_path / "jax"))
    assert got == want
    emits = got[0]
    assert emits, name
    if name == "wiped_on_mismatch":
        assert {"phase": name, "resume_failed": "structure mismatch — wiped"} in emits


# --------------------------------------------------- a scripted env
class _JEvalTask(struct.PyTreeNode):
    next_step: jnp.ndarray
    stage: jnp.ndarray
    stone_top: jnp.ndarray
    length: jnp.ndarray


class _JEvalState(struct.PyTreeNode):
    reset_count: jnp.ndarray
    task: _JEvalTask


class _JTr(struct.PyTreeNode):
    state: _JEvalState
    obs: jnp.ndarray
    done: jnp.ndarray


@dataclasses.dataclass
class _TEvalTask:
    next_step: torch.Tensor
    stage: torch.Tensor
    stone_top: torch.Tensor
    length: torch.Tensor


@dataclasses.dataclass
class _TEvalState:
    reset_count: torch.Tensor
    task: _TEvalTask


EVAL_INIT = dict(reset_count=np.array([0, 3, 1, 0, 2, 5, 0, 1], np.int32),
                 next_step=np.array([0, 1, 2, 0, 1, 0, 3, 2], np.int32),
                 stage=np.zeros(8, np.float32), stone_top=np.zeros((8, 10, 3), np.float32),
                 length=np.array([2, 3, 5, 9, 10, 11, 4, 6], np.float32))


def _jax_eval_parts():
    """An env whose episodes end after ``length + stage`` steps, counting
    the stones reached (``next_step``) one a step."""
    def step(s, a):
        n = s.task.next_step + 1
        done = n.astype(jnp.float32) >= s.task.length + s.task.stage
        st = s.replace(reset_count=s.reset_count + done.astype(jnp.int32),
                       task=s.task.replace(next_step=jnp.where(done, 0, n)))
        return _JTr(state=st, obs=jnp.zeros(3), done=done)

    e = {k: jnp.asarray(v) for k, v in EVAL_INIT.items()}
    state = SimpleNamespace(params=None, obs_norm=jppo.RunningNorm.init(3), env_state=_JEvalState(
        reset_count=e["reset_count"], task=_JEvalTask(**{k: e[k] for k in (
            "next_step", "stage", "stone_top", "length")})))
    net = SimpleNamespace(apply=lambda p, o: (jnp.zeros((o.shape[0], 2)), jnp.zeros(2),
                                              jnp.zeros(o.shape[0])))
    return SimpleNamespace(step=step, obs_fn=lambda s: jnp.zeros(3)), net, state


def _port_eval_parts():
    def step(s, a, gen):
        n = s.task.next_step + 1
        done = n.to(torch.float32) >= s.task.length + s.task.stage
        st = dataclasses.replace(s, reset_count=s.reset_count + done.to(torch.int32),
                                 task=dataclasses.replace(s.task, next_step=torch.where(
                                     done, torch.zeros_like(n), n)))
        return SimpleNamespace(state=st, obs=torch.zeros(8, 3), done=done)

    e = {k: torch.as_tensor(v) for k, v in EVAL_INIT.items()}
    state = SimpleNamespace(obs_norm=ppo.RunningNorm.init(3), env_key=torch.Generator(),
                            env_state=_TEvalState(reset_count=e["reset_count"], task=_TEvalTask(
                                **{k: e[k] for k in ("next_step", "stage", "stone_top",
                                                     "length")})))
    net = lambda o: (torch.zeros(o.shape[0], 2), torch.zeros(2), torch.zeros(o.shape[0]))  # noqa
    env = SimpleNamespace(step=step, obs_fn=lambda s: torch.zeros(8, 3),
                          device=torch.device("cpu"))
    return env, net, state


@pytest.mark.parametrize("stage,steps,deterministic,late", [
    (0.0, 30, True, False), (2.0, 30, False, False), (0.0, 3, True, False),
    (4.0, 30, True, True)], ids=["stage0", "stage2_noise", "none_ended", "deadline"])
def test_eval_fixed_stage_matches_jax_on_a_scripted_env(stage, steps, deterministic, late):
    """Env i's episodes last length_i + stage steps and end at stone
    length_i + stage − 1; only episodes begun under the pinned stage count
    (reset_count > its start + 1)."""
    rows = []
    for mod, parts in ((jall, _jax_eval_parts), (allsteps, _port_eval_parts)):
        emits = []
        hooks = mod.RunHooks(emit=lambda **kw: emits.append(kw),
                             time_left=(lambda: 0.0) if late else (lambda: float("inf")))
        env, net, state = parts()
        cfg = mod.AllstepsConfig(eval_steps=steps)
        rows.append((mod.eval_fixed_stage(env, net, state, stage, cfg, hooks, deterministic),
                     emits))
    assert rows[0] == rows[1]
    row = rows[1][0]
    assert set(row) == LADDER_KEYS and row["stage"] == stage
    if late:
        assert row["truncated"] and rows[1][1] == [{"phase": "eval_truncated", "stage": stage,
                                                    "at_step": 0}]
    # the scripted env in numpy: each env's first episode end is discarded
    # (begun before the pin), every later one counted at its last stone
    want = []
    for i in range(8) if not late else ():
        count, rc = int(EVAL_INIT["next_step"][i]), int(EVAL_INIT["reset_count"][i])
        for _ in range(steps):
            pre, count = count, count + 1
            if count >= EVAL_INIT["length"][i] + stage:
                rc, count = rc + 1, 0
                if rc > EVAL_INIT["reset_count"][i] + 1:
                    want.append(pre)
    assert row["episodes"] == len(want)
    if want:
        assert row["ep_end_steps_mean"] == round(float(np.mean(want)), 2)
        assert row["frac_complete"] == round(float(np.mean(np.array(want) >= 9)), 3)
    else:
        assert row["ep_end_steps_mean"] is None and row["frac_complete"] is None
    assert (steps == 3 or late) == (not want)


def test_eval_fixed_stage_on_the_stepper():
    """The JAX test's shape on the port's stepper: a random policy at 12
    steps may or may not end episodes, and both rows are well formed; the
    train state is left as it was."""
    env = tws.make_walker3d_stepper(params=TINY.stepper_params(pinned=True),
                                    name="EvalGateStepper", device="cpu")
    learner = ppo.PPOLearner(env, TINY.ppo(mirror_coef=0.0), num_envs=TINY.num_envs)
    state = learner.init(seed=0)
    q, gen = state.env_state.q.clone(), state.env_key.get_state()
    for deterministic, steps in ((True, TINY.eval_steps), (False, 3)):
        row = allsteps.eval_fixed_stage(env, state.params, state, 0.0,
                                        dataclasses.replace(TINY, eval_steps=steps),
                                        deterministic=deterministic)
        assert set(row) == LADDER_KEYS and row["stage"] == 0.0
        if row["episodes"] == 0:
            assert row["ep_end_steps_mean"] is None
        else:
            assert row["ep_end_steps_mean"] >= 0.0 and 0.0 <= row["frac_complete"] <= 1.0
    assert torch.equal(state.env_state.q, q) and torch.equal(state.env_key.get_state(), gen)
    assert torch.equal(state.env_state.task.stage, torch.zeros(TINY.num_envs))


ALLSTEPS_CLI = ["--num-envs", "8", "--seed", "3", "--horizon", "4", "--num-epochs", "1",
                "--num-minibatches", "2", "--hidden", "16", "16", "--eval-stages", "0",
                "--eval-steps", "12", "--pretrain-updates", "2", "--stepper-updates", "2",
                "--highstage-updates", "2"]


def test_run_allsteps_end_to_end_and_resume(tmp_path, capsys):
    emits = []
    cfg = dataclasses.replace(TINY, ckpt_root=str(tmp_path))
    out = allsteps.run_allsteps(cfg, allsteps.RunHooks(emit=lambda **kw: emits.append(kw)),
                                device="cpu")
    assert out["pretrain_finished"] and out["stepper_finished"] and out["highstage_finished"]
    assert len(out["ladder"]) == 1 and set(out["ladder"][0]) == LADDER_KEYS
    assert out["config"] == dataclasses.asdict(cfg)
    root = tmp_path / "s3"
    for phase in ("pre", "st", "hs"):
        assert (root / phase / "PHASE_DONE").exists(), phase
        assert json.loads((root / phase / "PHASE_DONE").read_text()) == {"at": 2}
    phases = [e.get("phase") for e in emits]
    assert "pretrain" in phases and "ladder" in phases
    assert sum(1 for e in emits if e.get("seeded")) == 2
    rows = [e for e in emits if "update" in e]
    assert [(e["phase"], e["update"]) for e in rows] == [
        (p, u) for p in ("pretrain", "stepper", "highstage") for u in (1, 2)]
    assert all(np.isfinite(e["pg_loss"]) and e["env_steps_per_s"] > 0 for e in rows)
    # the high-stage dwell pins env i to stage 4 + i % 6 and anneals the floor
    hs = [e for e in rows if e["phase"] == "highstage"]
    assert hs[0]["mean_stage"] == round(float(np.mean(4 + np.arange(8) % 6)), 3)
    assert [e["log_std_floor"] for e in hs] == [-1.0, -1.5]

    # re-entry through the CLI: every phase short-circuits on its marker
    capsys.readouterr()
    allsteps.main([*ALLSTEPS_CLI, "--ckpt-root", str(tmp_path)], device="cpu")
    text = capsys.readouterr().out
    lines = [json.loads(x) for x in text.splitlines() if x.startswith('{"phase"')]
    assert sum(1 for e in lines if "already_done_at" in e) == 3
    assert not any("update" in e for e in lines), "retrained a done phase"
    ladder = json.loads(text[text.index('{\n  "ladder"'):])["ladder"]
    assert len(ladder) == 1 and set(ladder[0]) == LADDER_KEYS


def test_deadline_truncates_without_done_marker(tmp_path):
    cfg = dataclasses.replace(TINY, ckpt_root=str(tmp_path))
    env = make("Walker3DCustomEnv-v0", device="cpu")
    learner = ppo.PPOLearner(env, cfg.ppo(mirror_coef=0.0), num_envs=cfg.num_envs)
    hooks = allsteps.RunHooks(emit=lambda **kw: None, time_left=lambda: 0.0)
    state, finished = allsteps.train_phase(learner, str(tmp_path / "pre"), 4, "pretrain", cfg,
                                           hooks)
    assert not finished and state.update_count == 1
    assert not (tmp_path / "pre" / "PHASE_DONE").exists()
    # a relaunch resumes from the truncation checkpoint
    emits = []
    state2, finished2 = allsteps.train_phase(
        learner, str(tmp_path / "pre"), 4, "pretrain", cfg,
        allsteps.RunHooks(emit=lambda **kw: emits.append(kw)))
    assert finished2 and state2.update_count == 4 and emits[0] == {"phase": "pretrain",
                                                                   "resumed_from": 1}
    assert (tmp_path / "pre" / "PHASE_DONE").exists()


def test_a_seeded_phase_leaves_its_source_as_it_was(tmp_path):
    """P2's seeding: a transfer copies the pretrained network, so training
    the seeded phase writes nothing into the source state."""
    env = make("Walker3DCustomEnv-v0", device="cpu")
    learner = ppo.PPOLearner(env, TINY.ppo(), num_envs=TINY.num_envs)
    src, _ = learner.train_step(learner.init(seed=1))
    before = {k: v.clone() for k, v in src.params.state_dict().items()}
    q, norm = src.env_state.q.clone(), src.obs_norm.mean.clone()
    seeded = transfer_train_state(src, learner.init(seed=2), reset_log_std=-0.5)
    state, finished = allsteps.train_phase(learner, str(tmp_path / "st"), 2, "stepper", TINY,
                                           allsteps.RunHooks(emit=lambda **kw: None),
                                           seed_state=seeded)
    assert finished and state.update_count == 2 and state.params is seeded.params
    assert all(torch.equal(v, before[k]) for k, v in src.params.state_dict().items())
    assert torch.equal(src.env_state.q, q) and torch.equal(src.obs_norm.mean, norm)
    assert not torch.equal(state.params.trunk[0].weight, before["trunk.0.weight"])
