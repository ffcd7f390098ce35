"""PPO learner over a batched env, on one device or over a mesh.

Counterpart of ``mocca_envs_tpu/harness/ppo.py`` (the JAX package's one
jitted program per update): ``train_step(state) → (state, metrics)`` runs
the rollout (a loop over the horizon on the batched env, without autograd),
the learner-side reward processing, GAE, and the minibatched clipped-
surrogate epochs, each minibatch a gradient of the loss by autograd,
clipped by its global norm and applied by Adam. The network is a plain
``nn.Module``; the env's draws and the learner's (action noise, shuffles)
come from two ``torch.Generator`` on the env's device, kept in the state,
so a run is a function of its seed and a checkpoint resumes it exactly.
The env may also be a rollout provider (``harness/mixed.py::MixedSuite``):
then the env states, observations and env generators are tuples, one entry
per family, and the learner math is the same.

Over a mesh (``parallel/mesh.py``: one process per device) every rank holds
``num_envs // world`` slots of the batch and its own generators, and a copy
of the network and optimizer. The JAX learner's ``shard_map`` averages
(``pmean``) the reward and return statistics, the obs-norm and advantage
moments, each minibatch's gradients and the metrics over the devices; here
each of those is an all-reduce over the group at the same place, so the
copies stay equal. A mesh of one is bit for bit the run without one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mocca_envs_tpu_torch.core import rng as rng_mod
from mocca_envs_tpu_torch.envs.env import FnEnv
from mocca_envs_tpu_torch.harness.profile import StageTimer
from mocca_envs_tpu_torch.harness.rollout import Trajectory, make_batched_rollout
from mocca_envs_tpu_torch.parallel.multihost import check_replica_divergence

LOG_2PI = math.log(2 * math.pi)
# the learner's generator is seeded apart from the env's (which takes the
# seed itself, as BatchedEnv does), so that the two streams never coincide
LEARNER_SEED_OFFSET = 2 ** 31


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Every field and default of the JAX package's ``PPOConfig``; its
    comments there say what each does."""

    horizon: int = 128
    num_epochs: int = 4
    num_minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    lr: float = 3e-4
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    hidden: tuple = (256, 256)
    normalize_obs: bool = True
    reward_scale: float = 1.0
    mirror_coef: float = 0.0
    log_std_min: float = -2.0
    log_std_min_final: float | None = None
    log_std_anneal_updates: int = 0
    lr_final: float | None = None
    lr_anneal_updates: int = 0
    normalize_reward: bool = False
    # "full": a permutation of all horizon·num_envs samples per epoch;
    # "time": of the horizon axis only (a minibatch is horizon /
    # num_minibatches whole timesteps)
    shuffle_mode: str = "full"


@dataclasses.dataclass
class RunningNorm:
    """Running mean / variance over observation dims (the batch's moments
    merged into the running ones, Chan et al.)."""

    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor   # 0-d

    @classmethod
    def init(cls, dim: int, device="cpu") -> "RunningNorm":
        return cls(mean=torch.zeros(dim, device=device), var=torch.ones(dim, device=device),
                   count=torch.tensor(1e-4, device=device))

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp((x - self.mean) / torch.sqrt(self.var + 1e-8), -10.0, 10.0)

    def update(self, bmean, bvar, bcount) -> "RunningNorm":
        delta = bmean - self.mean
        tot = self.count + bcount
        mean = self.mean + delta * (bcount / tot)
        m_a = self.var * self.count
        m_b = bvar * bcount
        m2 = m_a + m_b + torch.square(delta) * (self.count * bcount / tot)
        return RunningNorm(mean=mean, var=m2 / tot, count=tot)


class ActorCritic(nn.Module):
    """Tanh-MLP Gaussian policy and value head: the trunk ``hidden``, a mean
    head initialised orthogonal(0.01), a state-independent ``log_std``
    (−0.5 at init) and a value head orthogonal(1.0) on the shared trunk.
    Hidden layers start as flax's ``Dense`` does (LeCun normal, truncated at
    two standard deviations; zero biases). ``forward(obs) → (mean, log_std,
    value)``."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: tuple = (256, 256),
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = (obs_dim, *hidden)
        self.trunk = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.mean = nn.Linear(widths[-1], act_dim)
        self.log_std = nn.Parameter(torch.full((act_dim,), -0.5))
        self.value = nn.Linear(widths[-1], 1)
        with torch.no_grad():
            for layer in self.trunk:
                std = (1.0 / layer.in_features) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                layer.bias.zero_()
            for head, gain in ((self.mean, 0.01), (self.value, 1.0)):
                nn.init.orthogonal_(head.weight, gain, generator=generator)
                head.bias.zero_()

    def forward(self, obs: torch.Tensor):
        x = obs
        for layer in self.trunk:
            x = torch.tanh(layer(x))
        return self.mean(x), self.log_std, self.value(x).squeeze(-1)


def gaussian_sample(mean, log_std, gen: torch.Generator):
    """An action from N(mean, exp(log_std)²) with noise from ``gen``, and its
    log-probability."""
    eps = torch.randn(mean.shape, generator=gen, device=mean.device, dtype=mean.dtype)
    action = mean + torch.exp(log_std) * eps
    log_prob = torch.sum(-0.5 * torch.square(eps) - log_std - 0.5 * LOG_2PI, dim=-1)
    return action, log_prob


def gaussian_log_prob(mean, log_std, action):
    z = (action - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * torch.square(z) - log_std - 0.5 * LOG_2PI, dim=-1)


@dataclasses.dataclass
class TrainState:
    """Everything the next update needs. ``params`` and ``opt_state`` are
    the network and its optimizer (their step count is the optimizer's);
    ``key`` draws the learner's noise and shuffles, ``env_key`` the env's.
    A train step updates the network and optimizer in place. Under a
    rollout provider ``env_state``, ``obs`` and ``env_key`` are tuples, one
    entry per family."""

    params: ActorCritic
    opt_state: torch.optim.Adam
    env_state: Any
    obs: Any
    key: torch.Generator
    env_key: Any
    update_count: int
    obs_norm: RunningNorm
    # only with PPOConfig.normalize_reward
    ret_accum: Any = None   # (B,) per-env discounted-return accumulator
    ret_norm: Any = None    # RunningNorm over the scalar return


def discounted_return_scan(reward, done, accum, gamma):
    """R_t = γ·R_{t−1} + r_t over a (T, B) slice, the accumulator reset after
    a step that ends an episode. Returns the (T, B) running returns and the
    (B,) accumulator carried to the next rollout."""
    rets = torch.empty_like(reward)
    for t in range(reward.shape[0]):
        accum = gamma * accum + reward[t]
        rets[t] = accum
        accum = accum * (1.0 - done[t].to(accum.dtype))
    return rets, accum


def gae(traj: Trajectory, last_value, gamma, lam):
    """Generalized advantage estimation, a reverse loop over time. Returns
    (advantages, returns), both (T, B)."""
    advs = torch.empty_like(traj.value)
    next_adv, next_value = torch.zeros_like(last_value), last_value
    for t in range(traj.value.shape[0] - 1, -1, -1):
        nonterm = 1.0 - traj.done[t].to(traj.value.dtype)
        value = traj.value[t]
        delta = traj.reward[t] + gamma * next_value * nonterm - value
        next_adv = delta + gamma * lam * nonterm * next_adv
        advs[t] = next_adv
        next_value = value
    return advs, advs + traj.value


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` in place: every gradient scaled by
    max_norm / ‖g‖ where the global norm ‖g‖ reaches max_norm (no epsilon;
    ``torch.nn.utils.clip_grad_norm_`` adds 1e-6). No host sync."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class PPOLearner:
    """PPO: ``init(seed) → TrainState``, ``train_step(state) → (state,
    metrics)``, and its learner half ``update(state, traj)``. ``metrics``
    are 0-d tensors under the JAX learner's names. ``timer`` sums the wall
    seconds of the rollouts and of the updates apart (each ends with a
    synchronise on a card). With a ``mesh`` (``parallel/mesh.py``)
    ``num_envs`` stays the global batch, and this rank steps and learns on
    its ``num_envs // mesh.size`` slots."""

    def __init__(self, env: FnEnv, config: PPOConfig = PPOConfig(), mesh=None,
                 num_envs: int = 1024):
        # ``env`` may be one FnEnv or a rollout provider (harness/mixed.py's
        # MixedSuite): anything with obs_dim / act_dim / device and
        # init_states(seed) → (env states, obs, env generators), tuples per
        # family, and make_rollout(horizon, policy), whose rollout takes and
        # returns those tuples. The provider sets the batch size.
        self._provider = hasattr(env, "init_states") and hasattr(env, "make_rollout")
        if self._provider:
            num_envs = env.num_envs
        if num_envs % config.num_minibatches != 0:
            raise ValueError("num_envs must divide into minibatches")
        if config.shuffle_mode not in ("full", "time"):
            raise ValueError(f"unknown shuffle_mode {config.shuffle_mode!r}")
        if config.shuffle_mode == "time" and config.horizon % config.num_minibatches != 0:
            raise ValueError(
                "shuffle_mode='time' slices minibatches along the horizon — "
                f"horizon {config.horizon} must divide into {config.num_minibatches} minibatches")
        if mesh is not None and num_envs % (mesh.size * config.num_minibatches) != 0:
            raise ValueError("num_envs must divide over devices × minibatches")
        if self._provider and mesh is not None:
            for c in env.counts:
                if c % mesh.size != 0:
                    raise ValueError(f"family count {c} must divide over {mesh.size} devices")
        self.mesh = mesh
        self.world = 1 if mesh is None else mesh.size
        self.rank = 0 if mesh is None else mesh.rank
        self.local_envs = num_envs // self.world
        self.env = env
        self.config = config
        self.num_envs = num_envs
        self.device = env.device
        self.mirror = getattr(env, "mirror", None)
        if config.mirror_coef > 0.0 and self.mirror is None:
            raise ValueError(f"{env.name} has no mirror spec for mirror_coef")
        if (config.lr_final is not None) != (config.lr_anneal_updates > 0):
            raise ValueError(
                "lr_final and lr_anneal_updates must be set together "
                f"(got lr_final={config.lr_final}, "
                f"lr_anneal_updates={config.lr_anneal_updates}); passing "
                "only one would silently run a constant LR")
        # the LR schedule runs over optimizer steps: num_epochs·num_minibatches
        # of them per PPO update
        self._lr_steps = config.lr_anneal_updates * config.num_epochs * config.num_minibatches
        self.timer = StageTimer(self.device)
        self._rollout = (env.make_rollout(config.horizon, self._policy) if self._provider else
                         make_batched_rollout(env, config.horizon, self._policy))

    # ------------------------------------------------------------- pieces
    def lr_at(self, opt_step: int) -> float:
        """optax's ``linear_schedule(lr, lr_final, steps)`` at the count of
        optimizer steps taken so far, in its float32 arithmetic (constant
        without an anneal)."""
        cfg = self.config
        if not self._lr_steps:
            return cfg.lr
        f32 = np.float32
        frac = f32(1.0) - f32(min(max(opt_step, 0), self._lr_steps)) / f32(self._lr_steps)
        return float(f32(cfg.lr - cfg.lr_final) * frac + f32(cfg.lr_final))

    def floor_of(self, update_count: int) -> float:
        """The log-std floor at this update: ``log_std_min`` annealed
        linearly to ``log_std_min_final`` over ``log_std_anneal_updates``,
        then held (float32 arithmetic, as the JAX learner computes it)."""
        cfg = self.config
        if cfg.log_std_anneal_updates <= 0 or cfg.log_std_min_final is None:
            return float(np.float32(cfg.log_std_min))
        frac = np.clip(np.float32(update_count) / np.float32(cfg.log_std_anneal_updates),
                       np.float32(0.0), np.float32(1.0))
        return float(np.float32(cfg.log_std_min)
                     + frac * np.float32(cfg.log_std_min_final - cfg.log_std_min))

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the mesh's ranks (``x`` itself without a
        mesh): an all-reduce of the sum, divided by the world size, since
        gloo has no average. Every rank gets the same bits."""
        if self.mesh is None:
            return x
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.mesh.group)
        return x / self.world

    def _maybe_norm(self, norm: RunningNorm, obs):
        return norm.normalize(obs) if self.config.normalize_obs else obs

    def _policy(self, params_and_norm, obs, gen):
        net, norm, floor = params_and_norm
        mean, log_std, value = net(self._maybe_norm(norm, obs))
        action, log_prob = gaussian_sample(mean, torch.maximum(log_std, floor), gen)
        return action, log_prob, value

    def _mirror(self, x, which: str, tag=None):
        """``x`` under the mirror map ``which`` ("obs" or "act"): a signed
        permutation, exact as an index. The mixed suite's family spec maps
        each row by its family's permutation, selected by the one-hot
        ``tag`` (B, K) of the row's obs tail: a sum of elementwise products
        with 1 and 0 (no matmul, which TF32 could round), exact as the JAX
        learner's one-hot contraction."""
        if tag is None:
            return x[..., self.mirror[f"{which}_perm"]] * self.mirror[f"{which}_sign"]
        m = self.mirror
        per_family = torch.stack([x[:, perm] * sign for perm, sign in
                                  zip(m[f"{which}_perms"], m[f"{which}_signs"])])
        return (tag.t()[:, :, None] * per_family).sum(dim=0)

    def loss_fn(self, net, mb, adv_stats, norm, floor):
        """The clipped surrogate, the clipped value loss and (with
        ``mirror_coef``) the mirror loss of one minibatch ``(obs, action,
        old log-prob, old value, advantage, return)``. Returns ``(loss,
        (pg_loss, v_loss, entropy))``."""
        cfg = self.config
        obs, action, old_lp, old_v, adv, ret = mb
        mean, log_std, value = net(self._maybe_norm(norm, obs))
        log_std = torch.maximum(log_std, floor)
        adv_mean, adv_std = adv_stats
        adv_n = (adv - adv_mean) / (adv_std + 1e-8)
        ratio = torch.exp(gaussian_log_prob(mean, log_std, action) - old_lp)
        s1 = ratio * adv_n
        s2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
        pg_loss = -torch.mean(torch.minimum(s1, s2))
        v_clipped = old_v + torch.clamp(value - old_v, -cfg.clip_eps, cfg.clip_eps)
        v_loss = 0.5 * torch.mean(torch.maximum(torch.square(value - ret),
                                                torch.square(v_clipped - ret)))
        entropy = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))
        loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
        if cfg.mirror_coef > 0.0:
            # π(M_obs(s)) against M_act(π(s)); the mirrored obs take the
            # unmirrored running stats, as in the JAX learner. A signed
            # permutation is exact as an index (the JAX learner's one-hot
            # matrices at HIGHEST precision compute the same values); the
            # mixed suite's families without a spec carry the identity
            tag = (obs[:, -int(self.mirror["num_families"]):] if self.mirror.get("family")
                   else None)
            m_mean, _, _ = net(self._maybe_norm(norm, self._mirror(obs, "obs", tag)))
            loss = loss + cfg.mirror_coef * torch.mean(
                torch.square(m_mean - self._mirror(mean, "act", tag)))
        return loss, (pg_loss, v_loss, entropy)

    # --------------------------------------------------------------- init
    def init(self, seed: int = 0) -> TrainState:
        cfg = self.config
        init_gen = torch.Generator().manual_seed(seed)
        net = ActorCritic(self.env.obs_dim, self.env.act_dim, cfg.hidden,
                          generator=init_gen).to(self.device)
        # optax.adam's defaults
        opt = torch.optim.Adam(net.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
        # the same seed on every rank draws the same network: checked
        if self.mesh is not None and not check_replica_divergence(net, self.mesh):
            raise RuntimeError("the initial parameters differ across the mesh's ranks")
        # rank 0 keeps the single-device streams, rank r ≥ 1 folds r in
        # (core/rng.py)
        if self._provider:
            env_state, obs, env_key = self.env.init_states(seed, self.mesh)
        else:
            env_key = rng_mod.generator(rng_mod.rank_seed(seed, self.rank), self.device)
            env_state = self.env.init(env_key, self.local_envs)
            obs = self.env.obs_fn(env_state)
        key = rng_mod.generator(rng_mod.rank_seed(seed + LEARNER_SEED_OFFSET, self.rank),
                                self.device)
        return TrainState(
            params=net, opt_state=opt, env_state=env_state, obs=obs, key=key, env_key=env_key,
            update_count=0, obs_norm=RunningNorm.init(self.env.obs_dim, self.device),
            ret_accum=(torch.zeros(self.local_envs, device=self.device)
                       if cfg.normalize_reward else None),
            ret_norm=RunningNorm.init(1, self.device) if cfg.normalize_reward else None,
        )

    # --------------------------------------------------------- train step
    def _opt_step_count(self, opt: torch.optim.Optimizer) -> int:
        first = opt.param_groups[0]["params"][0]
        state = opt.state.get(first)
        return int(state["step"]) if state else 0

    def update_minibatch(self, net, opt, mb, adv_stats, norm, floor) -> torch.Tensor:
        """One optimizer step on one minibatch: the loss's gradient,
        averaged over the mesh, clipped by its global norm, then Adam at the
        scheduled learning rate. Returns the detached ``(pg_loss, v_loss,
        entropy)`` as one tensor."""
        opt.zero_grad(set_to_none=False)
        loss, aux = self.loss_fn(net, mb, adv_stats, norm, floor)
        loss.backward()
        grads = [p.grad for p in net.parameters()]
        if self.mesh is not None:
            # one all-reduce over the gradients laid end to end
            flat = self.pmean(torch.cat([g.reshape(-1) for g in grads]))
            for g, part in zip(grads, torch.split(flat, [g.numel() for g in grads])):
                g.copy_(part.view_as(g))
        clip_by_global_norm_(grads, self.config.max_grad_norm)
        for group in opt.param_groups:
            group["lr"] = self.lr_at(self._opt_step_count(opt))
        opt.step()
        return torch.stack([a.detach() for a in aux])

    def _floor(self, update_count: int) -> torch.Tensor:
        # a fill, not a host-to-device copy
        return torch.full((), self.floor_of(update_count), device=self.device)

    def train_step(self, state: TrainState):
        """One PPO update: a rollout from the state's envs, then
        :meth:`update` on its trajectory."""
        with self.timer.stage("rollout"):
            env_state, obs, traj = self._rollout(
                (state.params, state.obs_norm, self._floor(state.update_count)),
                state.env_state, state.obs, state.key, state.env_key)
        with self.timer.stage("update"):
            return self.update(dataclasses.replace(state, env_state=env_state, obs=obs), traj)

    def update(self, state: TrainState, traj: Trajectory):
        """The learner's half of a train step on a given trajectory (this
        rank's (T, B/W) slice under a mesh): the reward processing, GAE, the
        running norms and the minibatched clipped-surrogate epochs, which
        train the state's network and optimizer in place. Returns the state
        with its norms updated and ``update_count`` one up, and the
        metrics."""
        cfg = self.config
        net, opt, norm = state.params, state.opt_state, state.obs_norm
        floor = self._floor(state.update_count)
        pmean = self.pmean
        ret_accum, ret_norm = state.ret_accum, state.ret_norm
        # samples on this rank, and over the mesh (the running norms' count)
        n = cfg.horizon * self.local_envs
        n_all = float(np.float32(cfg.horizon * self.num_envs))
        with torch.no_grad():
            last_value = net(self._maybe_norm(norm, traj.last_obs))[2]
            raw_reward_mean = pmean(torch.mean(traj.reward))
            reward = traj.reward
            if cfg.reward_scale != 1.0:
                reward = reward * cfg.reward_scale
            if cfg.normalize_reward:
                rets, ret_accum = discounted_return_scan(reward, traj.done, ret_accum, cfg.gamma)
                rmean = pmean(torch.mean(rets))
                rvar = pmean(torch.mean(torch.square(rets - rmean)))
                ret_norm = ret_norm.update(rmean[None], rvar[None], n_all)
                # scale only, no mean shift: the reward's sign survives
                rstd = torch.sqrt(ret_norm.var[0] + 1e-8)
                reward = torch.clamp(reward / rstd, -10.0, 10.0)
            traj = dataclasses.replace(traj, reward=reward)
            adv, ret = gae(traj, last_value, cfg.gamma, cfg.gae_lambda)
            new_norm = norm
            if cfg.normalize_obs:
                flat_obs = traj.obs.reshape(-1, traj.obs.shape[-1])
                # the deviations about the mean over the whole mesh
                bmean = pmean(torch.mean(flat_obs, dim=0))
                bvar = pmean(torch.mean(torch.square(flat_obs - bmean), dim=0))
                new_norm = norm.update(bmean, bvar, n_all)
            adv_mean, adv_sq = pmean(torch.stack([torch.mean(adv),
                                                  torch.mean(torch.square(adv))]))
            adv_std = torch.sqrt(torch.clamp(adv_sq - torch.square(adv_mean), min=1e-12))
        flat = [x.reshape((n,) + tuple(x.shape[2:])) for x in
                (traj.obs, traj.action, traj.log_prob, traj.value, adv, ret)]
        mb_size = n // cfg.num_minibatches
        auxs = []
        for _ in range(cfg.num_epochs):
            if cfg.shuffle_mode == "time":
                # whole timesteps: a minibatch is horizon/num_minibatches
                # timesteps × all of this rank's envs
                perm_t = torch.randperm(cfg.horizon, generator=state.key, device=self.device)
                shuffled = [x.reshape((cfg.horizon, self.local_envs) + tuple(x.shape[1:]))[
                    perm_t].reshape(x.shape) for x in flat]
            else:
                perm = torch.randperm(n, generator=state.key, device=self.device)
                shuffled = [x[perm] for x in flat]
            for i in range(cfg.num_minibatches):
                mb = [x[i * mb_size:(i + 1) * mb_size] for x in shuffled]
                auxs.append(self.update_minibatch(net, opt, mb, (adv_mean, adv_std), norm,
                                                  floor))
        pg_loss, v_loss, entropy = torch.stack(auxs).mean(dim=0)
        with torch.no_grad():
            done_rate, pg_loss, v_loss = pmean(torch.stack(
                [torch.mean(traj.done.to(torch.float32)), pg_loss, v_loss]))
            metrics = {
                # the raw env reward, before reward_scale / normalization
                "reward_per_step": raw_reward_mean,
                "episode_done_rate": done_rate,
                "pg_loss": pg_loss,
                "v_loss": v_loss,
                "entropy": entropy,
                "adv_std": adv_std,
                "log_std_floor": floor,
            }
            if cfg.normalize_reward:
                metrics["reward_norm_std"] = torch.sqrt(ret_norm.var[0] + 1e-8)
            if traj.env_metrics is not None:
                metrics.update(env_metric_channels(traj.env_metrics, traj.done, pmean))
        return dataclasses.replace(
            state, update_count=state.update_count + 1, obs_norm=new_norm, ret_accum=ret_accum,
            ret_norm=ret_norm), metrics


def env_metric_channels(env_metrics: dict, done: torch.Tensor, pmean=None) -> dict:
    """Per env metric channel, its mean over the finite entries
    (``env/<name>``) and over the finite entries of the steps that ended an
    episode (``ep_end/<name>``): NaN where there are none (no episode ended,
    or the channel is NaN everywhere), never a fabricated 0. Under a mesh
    ``pmean`` averages each rank's sums and rates before the ratio is
    taken (a ratio of means, never a mean of ratios), all channels in one
    reduction."""
    dmask = done.to(torch.float32)
    local = []
    for v in env_metrics.values():
        v = v.to(torch.float32)
        valid = torch.isfinite(v).to(torch.float32)
        vz = torch.where(valid > 0.0, v, torch.zeros_like(v))
        local += [torch.mean(valid), torch.mean(vz), torch.mean(dmask * valid),
                  torch.mean(vz * dmask)]
    if not local:
        return {}
    means = torch.stack(local)
    if pmean is not None:
        means = pmean(means)
    out = {}
    for k, (vrate, vsum, dv_rate, dvsum) in zip(env_metrics, means.view(-1, 4)):
        nan = torch.full_like(vrate, float("nan"))
        out["env/" + k] = torch.where(vrate > 0.0, vsum / torch.clamp(vrate, min=1e-9), nan)
        out["ep_end/" + k] = torch.where(dv_rate > 0.0, dvsum / torch.clamp(dv_rate, min=1e-9),
                                         nan)
    return out


def dryrun_train_step(env: FnEnv, mesh, num_envs: int) -> None:
    """A full training step over the mesh at tiny shapes: part of the
    multi-device dry run (``mocca_envs_tpu_torch/graft_entry.py``)."""
    cfg = PPOConfig(horizon=4, num_epochs=1, num_minibatches=1, hidden=(32, 32))
    learner = PPOLearner(env, cfg, mesh=mesh, num_envs=num_envs)
    state, _ = learner.train_step(learner.init(seed=0))
    if learner.device.type == "cuda":
        torch.cuda.synchronize(learner.device)
