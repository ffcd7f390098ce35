"""PyTorch port vs the JAX package: the gym-style wrapper, on the CPU.

- ``get_mirror_indices`` equals the JAX ``GymEnv``'s for every family with
  a mirror spec (no step runs);
- the 4-tuple, ``seed``, the reset count and ``set_curriculum`` against the
  JAX ``GymEnv`` on a scripted env written in each package with a few lines
  of arithmetic (its episodes end after ``3 + stage`` steps; its reset reads
  the reset count and, given ``prev``, the stamped stage), so that no JAX
  env step compiles;
- the port's ``GymEnv.step`` on ``Walker3DCustomEnv`` equals the port's own
  ``env.step_no_reset`` (and, with ``auto_reset``, ``env.step``) at B = 1 on
  the same state and generator, bit for bit (tests/test_torch_walker_env.py holds
  that step to the JAX package);
- ``render("rgb_array")``: the JAX frame of the same state, pixel for
  pixel; ``render("human")`` + ``close()`` write a viewer page embedding
  one frame per call.
"""

import dataclasses
import json
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

import mocca_envs_tpu
import mocca_envs_tpu_torch as port
from mocca_envs_tpu.envs.env import FnEnv as JFnEnv
from mocca_envs_tpu.envs.gym_wrapper import GymEnv as JGymEnv
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu_torch.envs.env import FnEnv
from mocca_envs_tpu_torch.envs.gym_wrapper import GymEnv

from tests import torch_workers  # noqa: F401


# ------------------------------------------------------------ mirror lists
def test_mirror_indices_match_jax():
    checked = 0
    for env_id in port.registered_envs():
        jenv = mocca_envs_tpu.make(env_id)
        if jenv.mirror is None:
            continue
        mine = GymEnv(port.make(env_id, device="cpu")).get_mirror_indices()
        ref = JGymEnv(jenv).get_mirror_indices()
        assert len(mine) == len(ref) == 6
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a, np.asarray(b))
            assert a.dtype == np.int64
        checked += 1
    assert checked >= 5


def test_no_mirror_raises():
    env = _port_env()
    with pytest.raises(ValueError, match="no mirror spec"):
        GymEnv(env).get_mirror_indices()


# ------------------------------------------------------------ a scripted env
class _JTask(struct.PyTreeNode):
    stage: jnp.ndarray


class _JState(struct.PyTreeNode):
    q: jnp.ndarray
    qd: jnp.ndarray
    steps: jnp.ndarray
    task: _JTask


class _JTr(struct.PyTreeNode):
    state: _JState
    obs: jnp.ndarray
    reward: jnp.ndarray
    done: jnp.ndarray
    metrics: dict


def _jax_env():
    def reset(key, n, prev=None):
        del key
        stage = jnp.zeros(()) if prev is None else prev.task.stage
        q = jnp.stack([n.astype(jnp.float32), stage, jnp.ones(())])
        return _JState(q=q, qd=jnp.zeros(3), steps=jnp.zeros((), jnp.int32),
                       task=_JTask(stage=stage))

    def step(s, a):
        q = s.q + a
        steps = s.steps + 1
        st = s.replace(q=q, qd=a, steps=steps)
        return _JTr(state=st, obs=q * 2.0, reward=jnp.sum(a) + steps.astype(jnp.float32),
                    done=steps.astype(jnp.float32) >= 3.0 + s.task.stage,
                    metrics={"progress": q[0], "steps": steps.astype(jnp.float32)})

    return JFnEnv(name="Scripted", obs_dim=3, act_dim=3, reset=reset, step=step,
                  step_no_reset=step, obs_fn=lambda s: s.q * 2.0, control_dt=0.1)


@dataclasses.dataclass
class _TTask:
    stage: torch.Tensor


@dataclasses.dataclass
class _TState:
    q: torch.Tensor
    qd: torch.Tensor
    steps: torch.Tensor
    task: _TTask


def _port_env():
    def reset(gen, n, prev=None):
        stage = torch.zeros(1) if prev is None else prev.task.stage
        q = torch.stack([n.to(torch.float32), stage, torch.ones(1)], dim=1)
        return _TState(q=q, qd=torch.zeros(1, 3), steps=torch.zeros(1, dtype=torch.int32),
                       task=_TTask(stage=stage))

    def step(s, a, gen):
        q = s.q + a
        steps = s.steps + 1
        st = dataclasses.replace(s, q=q, qd=a, steps=steps)
        return SimpleNamespace(
            state=st, obs=q * 2.0, reward=a.sum(1) + steps.to(torch.float32),
            done=steps.to(torch.float32) >= 3.0 + s.task.stage,
            metrics={"progress": q[:, 0], "steps": steps.to(torch.float32)})

    return FnEnv(name="Scripted", obs_dim=3, act_dim=3, reset=reset, step=step,
                 step_no_reset=step, obs_fn=lambda s: s.q * 2.0, control_dt=0.1,
                 device=torch.device("cpu"))


def test_four_tuple_seed_and_curriculum_match_jax():
    rng = np.random.default_rng(0)
    actions = rng.uniform(-1, 1, (24, 3)).astype(np.float32)
    logs = []
    for G, make in ((JGymEnv, _jax_env), (GymEnv, _port_env)):
        g = G(make(), seed=7)
        log = [g.reset()]
        for t, a in enumerate(actions):
            if t == 6:
                g.set_curriculum(2.0)
            if t == 15:
                log.append(g.seed(11))
            obs, r, done, info = g.step(a)
            log.append((obs, r, done, info, g.render("state")["q"]))
            if done:
                log.append(g.reset())
        log.append(g._reset_count)
        logs.append(log)
    assert len(logs[0]) == len(logs[1])
    for ref, mine in zip(*logs):
        if isinstance(ref, tuple) and len(ref) == 5:
            obs, r, done, info, q = mine
            np.testing.assert_array_equal(obs, np.asarray(ref[0]))
            assert isinstance(obs, np.ndarray) and obs.dtype == np.float32
            assert type(r) is float and type(done) is bool and r == ref[1] and done == ref[2]
            assert info == ref[3] and all(type(v) is float for v in info.values())
            np.testing.assert_array_equal(q, np.asarray(ref[4]))
        elif isinstance(ref, np.ndarray) or hasattr(ref, "shape"):
            np.testing.assert_array_equal(mine, np.asarray(ref))
        else:
            assert mine == ref
    # a stage was stamped (episodes of 5 steps) and the count restarted
    assert logs[1][-1] >= 2


def test_curriculum_needs_a_stage():
    env = _port_env()
    no_stage = dataclasses.replace(env, reset=lambda gen, n, prev=None: SimpleNamespace(
        q=torch.zeros(1, 3), task=None))
    g = GymEnv(no_stage)
    g.set_curriculum(1.0)
    with pytest.raises(ValueError, match="no curriculum stage"):
        g.reset()


# ------------------------------------------------------------ the walker
@pytest.fixture(scope="module")
def walker():
    return port.make("Walker3DCustomEnv-v0", device="cpu")


@pytest.mark.parametrize("auto_reset", [False, True], ids=["no_reset", "auto_reset"])
def test_step_equals_the_env_step_bit_for_bit(walker, auto_reset):
    g = GymEnv(walker, seed=4, auto_reset=auto_reset)
    g.reset()
    state = g.state
    gen = torch.Generator()
    gen.set_state(g._gen.get_state())
    step = walker.step if auto_reset else walker.step_no_reset
    rng = np.random.default_rng(1)
    for _ in range(3):
        a = rng.uniform(-1, 1, walker.act_dim).astype(np.float32)
        obs, r, done, info = g.step(a)
        tr = step(state, torch.as_tensor(a)[None], gen)
        state = tr.state
        np.testing.assert_array_equal(obs, tr.obs[0].numpy())
        assert r == float(tr.reward[0]) and done == bool(tr.done[0])
        assert info == {k: float(v[0]) for k, v in tr.metrics.items()}
        torch.testing.assert_close(g.state.q, state.q, rtol=0, atol=0)
        torch.testing.assert_close(g.state.qd, state.qd, rtol=0, atol=0)


def test_reset_depends_on_seed_and_count(walker):
    a, b = GymEnv(walker, seed=2), GymEnv(walker, seed=2)
    first = a.reset()
    np.testing.assert_array_equal(first, b.reset())
    second = a.reset()
    assert not np.array_equal(first, second)
    a.seed(2)
    np.testing.assert_array_equal(a.reset(), first)
    assert not np.array_equal(GymEnv(walker, seed=3).reset(), first)


def test_render_rgb_array_matches_jax(walker):
    pytest.importorskip("matplotlib", reason="render('rgb_array') draws with matplotlib")
    g = GymEnv(walker, seed=1)
    g.reset()
    g.step(np.zeros(walker.act_dim, np.float32))
    mine = g.render("rgb_array", model=walker.model)
    jenv = mocca_envs_tpu.make("Walker3DCustomEnv")
    jg = JGymEnv(jenv)
    jg._state = SimpleNamespace(q=jnp.asarray(g.state.q[0].numpy()),
                                qd=jnp.asarray(g.state.qd[0].numpy()), scene=jscene.flat())
    ref = jg.render("rgb_array", model=jenv.model)
    assert mine.shape == ref.shape and mine.dtype == ref.dtype == np.uint8
    diff = np.abs(mine.astype(np.int16) - ref.astype(np.int16))
    assert int(diff.max()) == 0, f"largest pixel difference {int(diff.max())}"
    base_only = g.render("rgb_array")
    assert base_only.shape == mine.shape and not np.array_equal(base_only, mine)
    with pytest.raises(ValueError, match="unknown render mode"):
        g.render("video")


def test_render_human_writes_one_frame_per_call(walker, tmp_path):
    g = GymEnv(walker, seed=0)
    g._human_path = str(tmp_path / "human.html")
    g.reset()
    for _ in range(4):
        g.step(np.zeros(walker.act_dim, np.float32))
        assert g.render("human") == g._human_path
    g.close()
    assert g.state is None
    html = open(g._human_path).read()
    doc = json.loads(re.search(r"const DOC = (\{.*?\});\n", html, re.S).group(1))
    assert len(doc["frames"]) == 4 and len(doc["sphere_frames"]) == 4
    assert doc["link_names"] == list(walker.model.link_names)
    assert doc["scene"] == {"ground_z": 0.0}
