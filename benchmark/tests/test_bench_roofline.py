"""The benchmark's frozen count equals the port's ``engine.k1_flops`` and
``engine.k1_bytes_per_env`` on the same inputs today, for the walker's K1a
and Cassie's K1e, on small batches on the CPU."""

import pytest
import torch

from benchmark import cells, roofline
from benchmark.window import fields

CELLS = ("walker3d-custom.b131072", "cassie.b32768")


def _inputs(config, ref, n_steps=4):
    """A batch of 16 states some steps into their episodes, and the inputs of
    the next step's launch unit."""
    from mocca_envs_tpu_torch import BatchedEnv, make

    env = make(config["env_id"], device="cpu")
    batch = BatchedEnv(env, 16, seed=4, device="cpu")
    state = batch.init()
    gen = torch.Generator().manual_seed(8)
    for _ in range(n_steps):
        action = torch.rand((16, env.act_dim), generator=gen) * 2 - 1
        state = batch.step(state, action).state
    action = torch.rand((16, env.act_dim), generator=gen) * 2 - 1
    return env, ref.unit_inputs(fields(state), action)


@pytest.mark.parametrize("name", CELLS)
def test_frozen_count_equals_the_port_count(name):
    from mocca_envs_tpu_torch.ops.cuda import engine

    config = cells.find_cell(name).config
    ref = cells.reference(config, "cpu")
    env, (q, qd, tau) = _inputs(config, ref)
    constraints, pd_mode, damping = ref.unit_spec()
    gz, fr = ref.scene(16)
    lim, con = roofline.k1_activity(ref.model, ref.engine, constraints, pd_mode, q, qd, tau,
                                    gz, fr, extra_damping=damping)
    kernel = engine.make_kernel(
        env.model, _port_config(config), pd_mode=pd_mode,
        extra_damping=None if damping is None else env.model.actuated * env.model.kd,
        constraints=_port_constraints(constraints))
    assert kernel.name == config["k1_instance"]
    p_lim, p_con, _ = engine.k1_activity(kernel, q, qd, tau, gz, fr)
    assert torch.equal(lim, p_lim) and torch.equal(con, p_con)
    assert 0 < int(con.sum()) < con.numel()
    ours = roofline.k1_flops(ref.model, ref.engine, constraints, pd_mode, lim, con)
    assert ours == engine.k1_flops(kernel, p_lim, p_con)
    assert roofline.k1_bytes_per_env(ref.model) == engine.k1_bytes_per_env(kernel)
    # all rows active counts more, none fewer, on both sides alike
    for fill in (torch.zeros_like, torch.ones_like):
        assert (roofline.k1_flops(ref.model, ref.engine, constraints, pd_mode, fill(lim),
                                  fill(con))
                == engine.k1_flops(kernel, fill(lim), fill(con)))


def _port_config(config):
    from mocca_envs_tpu_torch.utils.config import EngineConfig

    return EngineConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in config["engine"].items()})


def _port_constraints(spec):
    from mocca_envs_tpu_torch.ops.step import ConstraintSpec

    return ConstraintSpec(p2p_link_a=spec.p2p_link_a, p2p_link_b=spec.p2p_link_b,
                          p2p_anchor_a=spec.p2p_anchor_a, p2p_anchor_b=spec.p2p_anchor_b)


def test_bound_takes_the_larger_time():
    ms, by = roofline.bound_ms(67e9, 1.0)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = roofline.bound_ms(1.0, 3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0)
