"""PyTorch port vs the JAX package: the mixed suite on one device (CPU).

- ``MixedSuite`` over the default trio and over the walker and the monkey
  has the JAX suite's ``obs_dim``, ``act_dim``, ``num_envs`` and ``name``,
  and its ``_suite_mirror`` arrays equal the JAX package's exactly;
- the family mirror loss (each row mapped by its family's signed
  permutation, selected by the one-hot tag in its obs tail) on one fixed
  minibatch with weights carried over by ``convert.py`` is within 1e-5
  relative of the JAX learner's, written out from its ``loss_fn``
  (harness/ppo.py, the ``m.get("family")`` branch), and so is its gradient
  (1e-5 absolute, 1e-4 relative);
- ``padded_env`` pads each family's obs with zeros and its one-hot tag, and
  steps on its action prefix alone; the rollout's metric union is NaN
  exactly off each family's slice;
- one ``train_step`` of the walker and the monkey (as the JAX package's
  ``tests/test_harness.py`` config-5 slice) gives finite namespaced
  channels and parameters;
- ``train.main`` with ``--env Walker3DCustomEnv,CassieEnv,Monkey3DStepperEnv``
  checkpoints the tuple state, resumes from it bit for bit against an
  uninterrupted run, and logs each family's rollout seconds; with
  ``--split-impulse`` it exits with the JAX package's message;
- the checkpoint refuses a tuple of another length, and the curriculum
  hook lets a tuple of states pass.

No JAX env step is compiled: the JAX side builds its suite and learner
(construction only) and reads their specs.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocca_envs_tpu.harness import mixed as jmixed
from mocca_envs_tpu.harness import ppo as jppo
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.core import rng as rng_mod
from mocca_envs_tpu_torch.harness import ppo, train
from mocca_envs_tpu_torch.harness.checkpoint import CheckpointMismatch, from_tree, to_tree
from mocca_envs_tpu_torch.harness.mixed import MixedSuite

from tests import torch_workers  # noqa: F401

T = torch.as_tensor
HIDDEN = (32, 32)
SUITES = {"trio": (MixedSuite.DEFAULT, (4, 4, 4)),
          "walker_monkey": (("Walker3DCustomEnv", "Monkey3DStepperEnv"), (8, 8))}


@pytest.fixture(scope="module")
def trio():
    ids, counts = SUITES["trio"]
    return jmixed.MixedSuite(ids, counts), MixedSuite(ids, counts, device="cpu")


@pytest.mark.parametrize("which", SUITES)
def test_suite_matches_jax(which, trio):
    ids, counts = SUITES[which]
    jsuite, tsuite = trio if which == "trio" else (jmixed.MixedSuite(ids, counts),
                                                    MixedSuite(ids, counts, device="cpu"))
    for k in ("obs_dim", "act_dim", "num_envs", "name"):
        assert getattr(tsuite, k) == getattr(jsuite, k), k
    assert [e.name for e in tsuite._base] == [e.name for e in jsuite._base]
    assert tsuite.mirror["family"] and tsuite.mirror["num_families"] == len(ids)
    for k in ("obs_perms", "obs_signs", "act_perms", "act_signs"):
        np.testing.assert_array_equal(tsuite.mirror[k].numpy(), np.asarray(jsuite.mirror[k]))
    # the walker mirrors, the others carry the identity
    assert not np.array_equal(tsuite.mirror["obs_perms"][0].numpy(), np.arange(tsuite.obs_dim))
    np.testing.assert_array_equal(tsuite.mirror["obs_perms"][-1].numpy(),
                                  np.arange(tsuite.obs_dim))
    assert MixedSuite.default(2, device="cpu").counts == (2, 2, 2)


def _jax_family_loss(jl, params, mb, adv_stats, norm, floor, cfg):
    """The JAX learner's loss with the mixed suite's family mirror
    (harness/ppo.py ``loss_fn`` in ``_build``), written out on its own
    ActorCritic, ``_gaussian_log_prob`` and one-hot mirror matrices."""
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
    hp = jax.lax.Precision.HIGHEST
    Kf = int(jl.mirror["num_families"])
    tag = obs[:, -Kf:]
    m_obs = jnp.einsum("bf,fbd->bd", tag, jnp.stack(
        [jnp.matmul(obs, jl._mir_mats["obs"][f], precision=hp) for f in range(Kf)]))
    tgt_mean = jnp.einsum("bf,fbd->bd", tag, jnp.stack(
        [jnp.matmul(mean, jl._mir_mats["act"][f], precision=hp) for f in range(Kf)]))
    m_mean, _, _ = jl.net.apply(params, norm.normalize(m_obs))
    return loss + cfg.mirror_coef * jnp.mean(jnp.square(m_mean - tgt_mean)), (pg, v_loss,
                                                                                  entropy)


def test_family_mirror_loss_matches_jax(trio):
    """One fixed minibatch of 48 rows, each tagged with a family drawn at
    random (all three present), through both learners' loss with
    mirror_coef 0.7 on the same carried weights."""
    jsuite, tsuite = trio
    kw = dict(hidden=HIDDEN, num_epochs=1, num_minibatches=1, horizon=4, mirror_coef=0.7)
    jl = jppo.PPOLearner(jsuite, jppo.PPOConfig(**kw), num_envs=12)
    tl = ppo.PPOLearner(tsuite, ppo.PPOConfig(**kw))
    assert tl.num_envs == 12
    D, A, K, n = tsuite.obs_dim, tsuite.act_dim, 3, 48
    rng = np.random.default_rng(21)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    fam = rng.permutation(np.arange(n) % K)
    obs = f(n, D)
    obs[:, -K:] = np.eye(K, dtype=np.float32)[fam]
    mb = (obs, f(n, A), f(n) - 6.0, f(n), f(n), 10.0 * f(n))
    norm = (0.3 * f(D), rng.uniform(0.5, 2.0, D).astype(np.float32), np.float32(100.0))
    stats = (np.float32(mb[4].mean()), np.float32(mb[4].std()))
    # flax's layout from the port's initialisation (no flax init to trace)
    params = convert.actor_critic_to_flax(
        ppo.ActorCritic(D, A, HIDDEN, torch.Generator().manual_seed(8)).state_dict())
    params["params"]["log_std"] = rng.uniform(-1.5, 0.0, A).astype(np.float32)
    jnorm = jppo.RunningNorm(*map(jnp.asarray, norm))
    (jloss, _), jgrad = jax.jit(jax.value_and_grad(lambda p: _jax_family_loss(
        jl, p, tuple(map(jnp.asarray, mb)), stats, jnorm, np.float32(-2.0), jl.config),
        has_aux=True))(params)
    net = ppo.ActorCritic(D, A, HIDDEN)
    net.load_state_dict(convert.actor_critic_from_flax(params))
    args = ([T(x) for x in mb], tuple(map(T, stats)), ppo.RunningNorm(*map(T, norm)),
            torch.tensor(-2.0))
    loss, _ = tl.loss_fn(net, *args)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = convert.actor_critic_to_flax({k: p.grad for k, p in net.named_parameters()})
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4),
                 grads, jax.tree.map(np.asarray, jgrad))
    # the mirror term is there, and the per-row selection is exact
    without, _ = ppo.PPOLearner(tsuite, ppo.PPOConfig(**{**kw, "mirror_coef": 0.0})).loss_fn(
        net, *args)
    assert loss.item() > without.item() + 1e-6
    x = T(obs)
    got = tl._mirror(x, "obs", x[:, -K:])
    m = tsuite.mirror
    for i in range(n):
        want = x[i, m["obs_perms"][fam[i]]] * m["obs_signs"][fam[i]]
        assert torch.equal(got[i], want)


def test_padded_env_and_the_metric_union():
    """Each family's padded obs and action prefix, and the rollout's
    namespaced union, NaN exactly off its family's slice."""
    suite = MixedSuite(("Walker3DCustomEnv", "Monkey3DStepperEnv"), (3, 2), device="cpu")
    states, obss, gens = suite.init_states(seed=4)
    for f, (base, st, ob) in enumerate(zip(suite._base, states, obss)):
        assert ob.shape == (suite.counts[f], suite.obs_dim)
        assert torch.equal(ob[:, :base.obs_dim], base.obs_fn(st))
        assert not ob[:, base.obs_dim:-2].any()
        assert torch.equal(ob[:, -2:], torch.eye(2)[f].expand(suite.counts[f], 2))
        # the action's tail beyond the family's width changes nothing
        act = torch.linspace(-0.5, 0.5, suite.act_dim).expand(suite.counts[f], -1).clone()
        g1, g2 = (rng_mod.generator(9, "cpu") for _ in range(2))
        tr = suite.envs[f].step(st, act, g1)
        act[:, base.act_dim:] = 7.0
        want = base.step(st, act[:, :base.act_dim], g2)
        assert torch.equal(tr.state.q, want.state.q)
        assert torch.equal(tr.obs[:, :base.obs_dim], want.obs)
    # seeds: fold_in(seed, family), the same seed the same episodes
    again = suite.init_states(seed=4)
    assert all(torch.equal(a.q, b.q) for a, b in zip(states, again[0]))
    assert torch.equal(states[1].q, suite.envs[1].init(
        rng_mod.generator(rng_mod.fold_in(4, 1), "cpu"), 2).q)
    assert not torch.equal(gens[0].get_state(), gens[1].get_state())

    def policy(_, obs, gen):
        a = torch.zeros(obs.shape[0], suite.act_dim)
        return a, torch.zeros(obs.shape[0]), torch.zeros(obs.shape[0])

    _, new_obss, traj = suite.make_rollout(3, policy)(None, states, obss, torch.Generator(),
                                                      gens)
    assert traj.obs.shape == (3, 5, suite.obs_dim) and traj.last_obs.shape == (5, suite.obs_dim)
    assert torch.equal(traj.last_obs, torch.cat(new_obss))
    assert {"Walker3DCustomEnv/progress", "Monkey3DStepperEnv/bars_reached"} <= set(
        traj.env_metrics)
    for k, v in traj.env_metrics.items():
        own = slice(0, 3) if k.startswith("Walker") else slice(3, 5)
        other = slice(3, 5) if k.startswith("Walker") else slice(0, 3)
        assert torch.isfinite(v[:, own]).all() and torch.isnan(v[:, other]).all(), k
    assert set(suite.timer.times) == {"Walker3DCustomEnv", "Monkey3DStepperEnv"}


def test_mixed_train_step_per_family_metrics():
    """The JAX package's config-5 CPU slice: namespaced channels with finite
    batch means, and finite parameters after an update with the family
    mirror on."""
    suite = MixedSuite(("Walker3DCustomEnv", "Monkey3DStepperEnv"), (8, 8), device="cpu")
    cfg = ppo.PPOConfig(horizon=4, num_epochs=1, num_minibatches=1, hidden=(16, 16),
                        mirror_coef=0.1)
    learner = ppo.PPOLearner(suite, cfg, num_envs=16)
    state = learner.init(seed=0)
    assert isinstance(state.env_state, tuple) and len(state.env_key) == 2
    state, metrics = learner.train_step(state)
    for ch in ("env/Walker3DCustomEnv/progress", "env/Walker3DCustomEnv/episode_steps",
               "env/Monkey3DStepperEnv/bars_reached"):
        assert ch in metrics, sorted(metrics)
        assert np.isfinite(float(metrics[ch])), ch
    assert float(metrics["env/Walker3DCustomEnv/episode_steps"]) > 0.0
    assert all(bool(torch.isfinite(p).all()) for p in state.params.parameters())
    assert state.update_count == 1 and state.obs[0].shape == (8, suite.obs_dim)


MIXED = ["--env", "Walker3DCustomEnv,CassieEnv,Monkey3DStepperEnv", "--num-envs", "7",
         "--horizon", "2", "--minibatches", "2", "--epochs", "1", "--log-every", "1",
         "--mirror-coef", "0.5"]


def test_mixed_cli_resumes_bit_for_bit(tmp_path, caplog):
    """1 update saved, then resumed to 2, against 2 in one run: the network,
    Adam, every family's env state, obs and generator equal. --num-envs 7
    gives 2 envs per family (6 in all), as the JAX CLI splits it."""
    def run(name, updates, ckpt):
        state = train.main([*MIXED, "--updates", str(updates), "--ckpt-dir", str(tmp_path / ckpt),
                            "--metrics", str(tmp_path / f"{name}.jsonl")], device="cpu")
        return state, [json.loads(x) for x in (tmp_path / f"{name}.jsonl").read_text()
                       .splitlines()]

    run("a1", 1, "a")
    with caplog.at_level(logging.INFO):
        resumed, lines = run("a2", 2, "a")
    assert "resumed from update 1" in caplog.text and [x["step"] for x in lines] == [2]
    straight, _ = run("b", 2, "b")
    assert resumed.update_count == straight.update_count == 2
    for (ka, va), (kb, vb) in zip(resumed.params.state_dict().items(),
                                  straight.params.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    for pa, pb in zip(resumed.params.parameters(), straight.params.parameters()):
        sa, sb = resumed.opt_state.state[pa], straight.opt_state.state[pb]
        assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    assert len(resumed.env_state) == 3 and [s.q.shape[0] for s in resumed.env_state] == [2] * 3
    for a, b in zip(resumed.env_state, straight.env_state):
        assert torch.equal(a.q, b.q) and torch.equal(a.qd, b.qd)
        assert torch.equal(a.reset_count, b.reset_count)
    for a, b in zip((*resumed.obs, *resumed.env_key, resumed.key),
                    (*straight.obs, *straight.env_key, straight.key)):
        assert torch.equal(*((a, b) if isinstance(a, torch.Tensor)
                             else (a.get_state(), b.get_state())))
    line = lines[0]
    for name in ("Walker3DCustomEnv", "CassieEnv", "Monkey3DStepperEnv"):
        assert line[f"rollout_s/{name}"] > 0 and f"env/{name}/blowup" in line


def test_mixed_cli_refuses_split_impulse():
    with pytest.raises(SystemExit, match="not wired for mixed suites"):
        train.main(["--env", "Walker3DCustomEnv,CassieEnv", "--split-impulse"], device="cpu")


def test_checkpoint_tuples_and_the_curriculum_hook():
    """A tuple survives the tree as a tuple, in place for generators; a
    template of another length or kind is refused; the host curriculum
    hook passes a tuple of states unchanged."""
    gens = (torch.Generator().manual_seed(1), torch.Generator().manual_seed(2))
    tree = to_tree((torch.arange(3.0), gens, [4, 5]))
    fresh = (torch.zeros(3), (torch.Generator(), torch.Generator()), [0, 0])
    back = from_tree(fresh, tree)
    assert isinstance(back, tuple) and isinstance(back[2], list) and back[2] == [4, 5]
    assert back[1][1] is fresh[1][1]
    assert torch.equal(back[1][1].get_state(), gens[1].get_state())
    with pytest.raises(CheckpointMismatch, match="2 entries, the template 3"):
        from_tree((torch.zeros(3), (torch.Generator(),) * 3, [0, 0]), tree)
    with pytest.raises(CheckpointMismatch, match="no list"):
        from_tree((torch.zeros(3), (torch.Generator(),) * 2, [0, 0]), to_tree(
            (torch.zeros(3), {"a": 1}, [4, 5])))
    state = ppo.TrainState(params=None, opt_state=None, env_state=(object(), object()),
                           obs=None, key=None, env_key=None, update_count=0, obs_norm=None)
    assert train.maybe_advance_curriculum(state, {"env/steps_reached": 9.0}, 1.0) == (state,
                                                                                       None)
