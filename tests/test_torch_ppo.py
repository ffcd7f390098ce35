"""PyTorch port vs the JAX package: the PPO learner's pieces (CPU).

The same numpy inputs, made from a seed, go through the JAX package's
``harness/ppo.py`` / ``harness/transfer.py`` and the port's
``mocca_envs_tpu_torch/harness``:

- ``gae`` and ``discounted_return_scan`` on fixed (T = 16, B = 8) arrays
  with episode ends, within 1e-6 (float32 over 16 steps of a few
  multiply-adds);
- ``RunningNorm`` (two updates, then ``normalize`` with its ±10 clip),
  within 1e-6 relative;
- ``ActorCritic``'s forward on weights carried over by ``convert.py``
  against flax's ``apply``, within 1e-5 (two 32-wide float32 products in
  another order), and the carry-over both ways exactly;
- the Gaussian log-probability, within 1e-6 relative;
- one optimizer step on a fixed minibatch after a first one (so that Adam's
  moments and count are carried over from optax), at an annealed learning
  rate, against the JAX package's own ``ActorCritic``,
  ``_gaussian_log_prob`` and the ``optax.chain(clip_by_global_norm, adam)``
  a ``PPOLearner`` builds: losses within 1e-5 relative, parameters and Adam
  moments within 1e-6 absolute;
- the learning-rate and log-std floor schedules, exactly;
- the mirror loss on the walker's mirror spec, within 1e-5 relative;
- ``transfer_train_state``, exactly (a copy into the leading block).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mocca_envs_tpu
import mocca_envs_tpu_torch
from mocca_envs_tpu.harness import ppo as jppo
from mocca_envs_tpu.harness import rollout as jrollout
from mocca_envs_tpu.harness.transfer import transfer_train_state as jtransfer
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.harness import ppo
from mocca_envs_tpu_torch.harness.rollout import Trajectory
from mocca_envs_tpu_torch.harness.transfer import embed_pytree, transfer_train_state

from tests import torch_workers  # noqa: F401

T = torch.as_tensor
HIDDEN = (32, 32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_gae_and_discounted_returns_match_jax():
    rng = np.random.default_rng(0)
    Tn, B = 16, 8
    reward = rng.standard_normal((Tn, B)).astype(np.float32)
    done = rng.random((Tn, B)) < 0.15
    value = rng.standard_normal((Tn, B)).astype(np.float32)
    last = rng.standard_normal(B).astype(np.float32)
    accum = rng.standard_normal(B).astype(np.float32)
    assert done.any(axis=0).sum() >= 4
    jtraj = jrollout.Trajectory(
        obs=jnp.zeros((Tn, B, 1)), action=jnp.zeros((Tn, B, 1)), log_prob=jnp.zeros((Tn, B)),
        value=jnp.asarray(value), reward=jnp.asarray(reward), done=jnp.asarray(done),
        last_obs=jnp.zeros((B, 1)))
    ptraj = Trajectory(obs=torch.zeros(Tn, B, 1), action=torch.zeros(Tn, B, 1),
                       log_prob=torch.zeros(Tn, B), value=T(value), reward=T(reward),
                       done=T(done), last_obs=torch.zeros(B, 1))
    for got, want in zip(ppo.gae(ptraj, T(last), 0.99, 0.95),
                         jppo.gae(jtraj, jnp.asarray(last), 0.99, 0.95)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    for got, want in zip(ppo.discounted_return_scan(T(reward), T(done), T(accum), 0.99),
                         jppo.discounted_return_scan(jnp.asarray(reward), jnp.asarray(done),
                                                     jnp.asarray(accum), 0.99)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_running_norm_matches_jax():
    rng = np.random.default_rng(1)
    dim = 7
    jn, tn = jppo.RunningNorm.init(dim), ppo.RunningNorm.init(dim)
    for scale in (1.0, 30.0):
        x = (scale * rng.standard_normal((64, dim)) + 3.0).astype(np.float32)
        bmean, bvar = x.mean(0), x.var(0)
        jn = jn.update(jnp.asarray(bmean), jnp.asarray(bvar), jnp.asarray(64.0, jnp.float32))
        tn = tn.update(T(bmean), T(bvar), 64.0)
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(tn, f).numpy(), np.asarray(getattr(jn, f)),
                                   rtol=1e-6, atol=0)
    x = (80.0 * rng.standard_normal((32, dim))).astype(np.float32)
    got, want = tn.normalize(T(x)).numpy(), np.asarray(jn.normalize(jnp.asarray(x)))
    assert (np.abs(want) == 10.0).any()          # the clip is exercised
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    back = convert.running_norm_from_numpy(**convert.running_norm_to_numpy(tn))
    assert all(torch.equal(getattr(back, f), getattr(tn, f)) for f in ("mean", "var", "count"))


def _flax_params(obs_dim, act_dim, seed, hidden=HIDDEN):
    net = jppo.ActorCritic(act_dim, hidden)
    params = _np(net.init(jax.random.key(seed), jnp.zeros((1, obs_dim))))
    rng = np.random.default_rng(seed)
    params["params"]["log_std"] = rng.uniform(-1.5, 0.0, act_dim).astype(np.float32)
    return net, params


def _port_net(params, obs_dim, act_dim, hidden=HIDDEN):
    net = ppo.ActorCritic(obs_dim, act_dim, hidden)
    net.load_state_dict(convert.actor_critic_from_flax(params))
    return net


def test_actor_critic_forward_on_carried_weights_matches_flax():
    obs_dim, act_dim = 12, 5
    jnet, params = _flax_params(obs_dim, act_dim, 2)
    net = _port_net(params, obs_dim, act_dim)
    obs = np.random.default_rng(3).standard_normal((64, obs_dim)).astype(np.float32)
    want = jnet.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        got = net(T(obs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=0)
    back = convert.actor_critic_to_flax(net.state_dict())
    jax.tree.map(np.testing.assert_array_equal, back, params)
    # the port's own initialisation has the flax module's layout and scales
    fresh = ppo.ActorCritic(obs_dim, act_dim, HIDDEN, torch.Generator().manual_seed(0))
    w = fresh.mean.weight.detach()
    torch.testing.assert_close(w @ w.T, 1e-4 * torch.eye(act_dim), atol=1e-7, rtol=0)
    assert float(fresh.log_std.detach()[0]) == -0.5
    assert float(fresh.trunk[0].bias.detach().abs().max()) == 0.0
    assert 0.5 / obs_dim ** 0.5 < float(fresh.trunk[0].weight.std()) < 1.5 / obs_dim ** 0.5


def test_gaussian_log_prob_matches_jax():
    rng = np.random.default_rng(4)
    mean, action = (rng.standard_normal((2, 32, 6)).astype(np.float32))
    log_std = rng.uniform(-2.0, 0.5, 6).astype(np.float32)
    want = jppo._gaussian_log_prob(jnp.asarray(mean), jnp.asarray(log_std), jnp.asarray(action))
    got = ppo.gaussian_log_prob(T(mean), T(log_std), T(action))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)
    # a sample's own log-probability is the density at the action it drew
    act, lp = ppo.gaussian_sample(T(mean), T(log_std), torch.Generator().manual_seed(0))
    torch.testing.assert_close(lp, ppo.gaussian_log_prob(T(mean), T(log_std), act),
                               atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def walkers():
    """The walker in both packages, for its sizes and mirror spec."""
    return mocca_envs_tpu.make("Walker3DCustomEnv"), mocca_envs_tpu_torch.make(
        "Walker3DCustomEnv", device="cpu")


def _minibatch(obs_dim, act_dim, n, seed):
    """(obs, action, old log-prob, old value, advantage, return), a running
    norm and the advantage statistics, as numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    mb = (f(n, obs_dim), f(n, act_dim), f(n) - 6.0, f(n), f(n), 10.0 * f(n))
    norm = (0.3 * f(obs_dim), rng.uniform(0.5, 2.0, obs_dim).astype(np.float32),
            np.float32(100.0))
    return mb, norm, (np.float32(mb[4].mean()), np.float32(mb[4].std()))


def _jax_loss(jl, params, mb, adv_stats, norm, floor, cfg):
    """The JAX learner's loss (harness/ppo.py ``loss_fn`` in ``_build``),
    written out on its own ActorCritic and ``_gaussian_log_prob``."""
    obs, action, old_lp, old_v, adv, ret = mb
    mean, log_std, value = jl.net.apply(params, norm.normalize(obs))
    log_std = jnp.maximum(log_std, floor)
    adv_n = (adv - adv_stats[0]) / (adv_stats[1] + 1e-8)
    ratio = jnp.exp(jppo._gaussian_log_prob(mean, log_std, action) - old_lp)
    pg = -jnp.mean(jnp.minimum(ratio * adv_n,
                               jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n))
    v_clipped = old_v + jnp.clip(value - old_v, -cfg.clip_eps, cfg.clip_eps)
    v_loss = 0.5 * jnp.mean(jnp.maximum(jnp.square(value - ret), jnp.square(v_clipped - ret)))
    entropy = jnp.sum(log_std + 0.5 * jnp.log(2 * jnp.pi * jnp.e))
    loss = pg + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
    if cfg.mirror_coef > 0.0:
        hp = jax.lax.Precision.HIGHEST
        m_mean, _, _ = jl.net.apply(params, norm.normalize(
            jnp.matmul(obs, jl._mir_mats["obs"], precision=hp)))
        loss = loss + cfg.mirror_coef * jnp.mean(jnp.square(
            m_mean - jnp.matmul(mean, jl._mir_mats["act"], precision=hp)))
    return loss, (pg, v_loss, entropy)


def _learners(walkers, **kw):
    cfg = dict(hidden=HIDDEN, num_epochs=1, num_minibatches=1, horizon=4, **kw)
    jenv, tenv = walkers
    return (jppo.PPOLearner(jenv, jppo.PPOConfig(**cfg), num_envs=8),
            ppo.PPOLearner(tenv, ppo.PPOConfig(**cfg), num_envs=8))


def test_one_optimizer_step_matches_optax(walkers):
    """Step 1 on minibatch A in JAX; its params and Adam state carried over;
    step 2 on minibatch B on both sides, the learning rate annealed (the
    schedule reads the carried count), the gradient's global norm above
    max_grad_norm so that the clip acts."""
    jl, tl = _learners(walkers, lr=1e-3, lr_final=2e-4, lr_anneal_updates=3)
    jenv, _ = walkers
    obs_dim, act_dim = jenv.obs_dim, jenv.act_dim
    _, params = _flax_params(obs_dim, act_dim, 5)
    floor = np.float32(-1.0)
    batches = [_minibatch(obs_dim, act_dim, 64, seed) for seed in (6, 7)]

    def jax_step(params, opt_state, batch):
        mb, norm, stats = batch
        jnorm = jppo.RunningNorm(*map(jnp.asarray, norm))
        (_, aux), grads = jax.value_and_grad(_jax_loss, argnums=1, has_aux=True)(
            jl, params, tuple(map(jnp.asarray, mb)), stats, jnorm, floor, jl.config)
        assert float(optax.global_norm(grads)) > jl.config.max_grad_norm
        updates, opt_state = jl.tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, aux

    params1, opt1, _ = jax_step(params, jl.tx.init(params), batches[0])
    params2, opt2, jaux = jax_step(params1, opt1, batches[1])
    adam1 = opt1[1][0]
    assert int(adam1.count) == 1

    net = _port_net(_np(params1), obs_dim, act_dim)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    convert.adam_state_from_optax(net, opt, _np(adam1.mu), _np(adam1.nu), adam1.count)
    mb, norm, stats = batches[1]
    aux = tl.update_minibatch(net, opt, [T(x) for x in mb], tuple(map(T, stats)),
                              ppo.RunningNorm(*map(T, norm)), torch.tensor(floor))
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), rtol=1e-5, atol=1e-6)
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-3 + (2e-4 - 1e-3) / 3, rel=1e-6)
    got = convert.actor_critic_to_flax(net.state_dict())
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=1e-6, rtol=0),
                 got, _np(params2))
    mu, nu, count = convert.adam_state_to_optax(net, opt)
    adam2 = opt2[1][0]
    assert int(count) == int(adam2.count) == 2
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-4),
                 (mu, nu), (_np(adam2.mu), _np(adam2.nu)))


def test_schedules_match_jax(walkers):
    """The learning rate is optax's linear schedule at the optimizer's step
    count; the log-std floor anneals with the update count as the JAX
    learner's ``_floor_of`` (harness/ppo.py ``_build``) computes it."""
    jl, tl = _learners(walkers, lr=3e-4, lr_final=1e-5, lr_anneal_updates=5,
                       log_std_min=-1.0, log_std_min_final=-2.3, log_std_anneal_updates=7)
    schedule = optax.linear_schedule(3e-4, 1e-5, 5)   # 5 updates × 1 epoch × 1 minibatch
    for k in (0, 1, 3, 5, 9):
        assert tl.lr_at(k) == float(schedule(k))
    cfg = jl.config
    for u in (0, 1, 4, 7, 12):
        frac = jnp.clip(jnp.asarray(u, jnp.int32).astype(jnp.float32)
                        / cfg.log_std_anneal_updates, 0.0, 1.0)
        want = cfg.log_std_min + frac * (cfg.log_std_min_final - cfg.log_std_min)
        assert tl.floor_of(u) == float(want)
    const = _learners(walkers)[1]
    assert const.lr_at(10) == 3e-4 and const.floor_of(10) == float(np.float32(-2.0))
    with pytest.raises(ValueError, match="set together"):
        _learners(walkers, lr_final=1e-5)


def test_mirror_loss_matches_jax(walkers):
    """The loss with mirror_coef on the walker's mirror spec (signed
    permutations of the obs and the actions) and its gradient."""
    jl, tl = _learners(walkers, mirror_coef=0.7)
    jenv, tenv = walkers
    for k in ("obs_perm", "obs_sign", "act_perm", "act_sign"):
        np.testing.assert_array_equal(tenv.mirror[k].numpy(), np.asarray(jenv.mirror[k]))
    _, params = _flax_params(jenv.obs_dim, jenv.act_dim, 8)
    mb, norm, stats = _minibatch(jenv.obs_dim, jenv.act_dim, 48, 9)
    jnorm = jppo.RunningNorm(*map(jnp.asarray, norm))
    (jloss, _), jgrad = jax.value_and_grad(_jax_loss, argnums=1, has_aux=True)(
        jl, params, tuple(map(jnp.asarray, mb)), stats, jnorm, np.float32(-2.0), jl.config)
    net = _port_net(params, jenv.obs_dim, jenv.act_dim)
    loss, _ = tl.loss_fn(net, [T(x) for x in mb], tuple(map(T, stats)),
                         ppo.RunningNorm(*map(T, norm)), torch.tensor(-2.0))
    loss.backward()
    without, _ = _learners(walkers)[1].loss_fn(net, [T(x) for x in mb], tuple(map(T, stats)),
                                               ppo.RunningNorm(*map(T, norm)),
                                               torch.tensor(-2.0))
    assert float(loss) > float(without) + 1e-6     # the mirror term is there
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    grads = convert.actor_critic_to_flax({n: p.grad for n, p in net.named_parameters()})
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4),
                 grads, _np(jgrad))
    with pytest.raises(ValueError, match="no mirror spec"):
        ppo.PPOLearner(dataclasses.replace(tenv, mirror=None),
                       ppo.PPOConfig(mirror_coef=0.5), num_envs=8)


def test_transfer_train_state_matches_jax():
    """The walker's network (obs 10) embedded into a stepper-like one (obs
    14): the first layer's weight gains the new inputs' columns, which keep
    their fresh values; the obs norm the same way; log-std reset."""
    src_net, src = _flax_params(10, 4, 11, (16, 16))
    _, dst = _flax_params(14, 4, 12, (16, 16))
    rng = np.random.default_rng(13)
    norms = [tuple(rng.uniform(0.5, 2.0, d).astype(np.float32) for _ in range(2))
             + (np.float32(rng.uniform(10, 100)),) for d in (10, 14)]

    def jstate(params, norm):
        return jppo.TrainState(params=jax.tree.map(jnp.asarray, params), opt_state=None,
                               env_state=None, obs=None, key=None,
                               update_count=jnp.zeros((), jnp.int32),
                               obs_norm=jppo.RunningNorm(*map(jnp.asarray, norm)))

    def tstate(params, norm, obs_dim):
        return ppo.TrainState(params=_port_net(params, obs_dim, 4, (16, 16)), opt_state=None,
                              env_state=None, obs=None, key=None, env_key=None,
                              update_count=0, obs_norm=ppo.RunningNorm(*map(T, norm)))

    want = jtransfer(jstate(src, norms[0]), jstate(dst, norms[1]), reset_log_std=-0.7)
    t_src = tstate(src, norms[0], 10)
    got = transfer_train_state(t_src, tstate(dst, norms[1], 14), reset_log_std=-0.7)
    jax.tree.map(np.testing.assert_array_equal,
                 convert.actor_critic_to_flax(got.params.state_dict()), _np(want.params))
    for f, w in zip(("mean", "var", "count"), (want.obs_norm.mean, want.obs_norm.var,
                                                want.obs_norm.count)):
        np.testing.assert_array_equal(getattr(got.obs_norm, f).numpy(), np.asarray(w))
    # the source is left as it was, and nothing aliases it
    jax.tree.map(np.testing.assert_array_equal,
                 convert.actor_critic_to_flax(t_src.params.state_dict()), src)
    with pytest.raises(ValueError, match="cannot embed"):
        embed_pytree(torch.zeros(3, 5), torch.zeros(4, 4))
