"""The plain reference against the port's plain path, on the CPU at B = 16:
the same robot, the same raw step, the same fresh episodes."""

import dataclasses

import pytest
import torch

from benchmark import cells
from benchmark.window import fields

CELLS = {"walker3d-custom": "walker3d-custom.b131072", "cassie": "cassie.b32768"}


def _port_env(config):
    from mocca_envs_tpu_torch import BatchedEnv, make

    env = make(config["env_id"], device="cpu", **config.get("make", {}))
    return env, BatchedEnv(env, 16, seed=3, device="cpu")


@pytest.mark.parametrize("name", sorted(CELLS))
def test_reference_model_equals_the_port_model(name):
    config = cells.find_cell(CELLS[name]).config
    env, _ = _port_env(config)
    ref = cells.reference(config, "cpu")
    for f in dataclasses.fields(env.model):
        a, b = getattr(env.model, f.name), getattr(ref.model, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", sorted(CELLS))
def test_reference_step_equals_the_port_plain_step(name):
    config = cells.find_cell(CELLS[name]).config
    env, batch = _port_env(config)
    ref = cells.reference(config, "cpu")
    gen = torch.Generator().manual_seed(5)
    state = batch.init()
    for k in range(3):
        action = torch.rand((16, env.act_dim), generator=gen) * 2 - 1
        tr = env.step_no_reset(state, action, batch.generator)
        pre, post = fields(state), fields(tr.state, tr)
        got = ref.step(pre, action, post)
        for key in ("q", "qd", "obs", "reward", "done", "steps"):
            assert torch.equal(got[key], post[key]), (k, key)
        assert ref.carry_ok(post, got).all()
        state = tr.state
    # a kept target or action that was changed is not carried
    moved = dict(post)
    key = "task.target" if "task.target" in moved else "task.prev_action"
    moved[key] = moved[key] + 0.5
    assert not ref.carry_ok(moved, got).any()


@pytest.mark.parametrize("name", sorted(CELLS))
def test_reset_checks_accept_the_port_fresh_episodes_only(name):
    config = cells.find_cell(CELLS[name]).config
    env, batch = _port_env(config)
    ref = cells.reference(config, "cpu")
    fresh = fields(env.reset(batch.generator, torch.ones(16, dtype=torch.int32)))
    assert ref.reset_ok(fresh).all()
    obs = env.reset_obs_fn(env.reset(torch.Generator().manual_seed(9),
                                     torch.ones(16, dtype=torch.int32)))
    assert obs.shape == (16, ref.obs_dim)
    moving = dict(fresh, qd=fresh["qd"] + 1e-3)
    assert not ref.reset_ok(moving).any()
    fallen = dict(fresh, q=fresh["q"].clone())
    fallen["q"][:, 2] -= 0.3
    assert not ref.reset_ok(fallen).any()
