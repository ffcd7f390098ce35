"""Mixed multi-family suite: BASELINE.json config 5's env side.

Counterpart of ``mocca_envs_tpu/harness/mixed.py``. Each family steps as its
own sub-batch (through its own kernel: the walker's K1a, Cassie's K1e, the
monkey's K1d), and the families present one padded interface to a single
shared learner:

- obs: zero-padded to the widest family, plus a one-hot family tag so the
  shared policy can condition on the task;
- act: zero-padded to the widest family; each env consumes its own prefix.

``MixedSuite`` is a rollout provider for ``harness/ppo.py::PPOLearner``
(``obs_dim`` / ``act_dim`` / ``device`` / ``init_states`` /
``make_rollout``), so the update (GAE, the minibatched clipped-surrogate
epochs) is the single-family one: the per-family trajectories are
concatenated along the batch axis before learning. Over a mesh
(``parallel/mesh.py``) each family's count is global and every rank steps
its ``count // world`` slots of each family into the one learner.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mocca_envs_tpu_torch.core import rng as rng_mod
from mocca_envs_tpu_torch.envs.env import FnEnv, Transition
from mocca_envs_tpu_torch.harness.profile import StageTimer
from mocca_envs_tpu_torch.harness.rollout import Trajectory, make_batched_rollout
from mocca_envs_tpu_torch.utils.device import resolve_device


def padded_env(env: FnEnv, family: int, num_families: int, obs_dim: int,
               act_dim: int) -> FnEnv:
    """Wrap a family env to the suite-wide (obs_dim, act_dim) interface."""
    pad_w = obs_dim - num_families - env.obs_dim
    tag = torch.zeros(num_families, device=env.device)
    tag[family] = 1.0

    def _pad(obs):
        return torch.cat([torch.nn.functional.pad(obs, (0, pad_w)),
                          tag.expand(obs.shape[0], num_families)], dim=1)

    def obs_fn(state):
        return _pad(env.obs_fn(state))

    def step(state, action, gen) -> Transition:
        tr = env.step(state, action[:, :env.act_dim], gen)
        return dataclasses.replace(tr, obs=_pad(tr.obs))

    def step_no_reset(state, action, gen) -> Transition:
        tr = env.step_no_reset(state, action[:, :env.act_dim], gen)
        return dataclasses.replace(tr, obs=_pad(tr.obs))

    return FnEnv(
        name=f"{env.name}[padded {family}/{num_families}]",
        obs_dim=obs_dim,
        act_dim=act_dim,
        reset=env.reset,
        step=step,
        step_no_reset=step_no_reset,
        obs_fn=obs_fn,
        control_dt=env.control_dt,
        device=env.device,
        mirror=None,  # families mirror differently; the suite's spec is per family
        model=env.model,
    )


@dataclasses.dataclass(frozen=True)
class MixedSuite:
    """K families and their env counts, as a PPOLearner provider, on
    ``device`` (None = the CUDA card). ``timer`` sums each family's rollout
    seconds under the family's name (each ends with a synchronise on a
    card)."""

    env_ids: tuple
    counts: tuple
    device: object = None

    DEFAULT = ("Walker3DCustomEnv-v0", "CassieEnv-v0", "Monkey3DStepperEnv-v0")

    def __post_init__(self):
        assert len(self.env_ids) == len(self.counts) >= 2
        import mocca_envs_tpu_torch

        device = resolve_device(self.device)
        base = [mocca_envs_tpu_torch.make(e, device=device) for e in self.env_ids]
        K = len(base)
        max_obs = max(e.obs_dim for e in base)
        max_act = max(e.act_dim for e in base)
        object.__setattr__(self, "device", device)
        object.__setattr__(self, "_base", base)
        object.__setattr__(self, "obs_dim", max_obs + K)
        object.__setattr__(self, "act_dim", max_act)
        object.__setattr__(
            self, "envs", [padded_env(e, f, K, max_obs + K, max_act) for f, e in enumerate(base)])
        object.__setattr__(self, "num_envs", sum(self.counts))
        object.__setattr__(self, "name", "Mixed(" + "+".join(self.env_ids) + ")")
        object.__setattr__(self, "mirror", self._suite_mirror(base))
        object.__setattr__(self, "timer", StageTimer(device))

    def _suite_mirror(self, base):
        """Family-stacked mirror spec lifted to the padded layout.

        Each family's obs / act permutation and sign extend with the identity
        over its pad block and the one-hot tag; families without a mirror
        spec get the identity (their rows add no mirror residual). The
        learner selects per row by the tag (``harness/ppo.py::_mirror``).
        None when no family has a spec.
        """
        if not any(getattr(e, "mirror", None) for e in base):
            return None
        obs_perms, obs_signs, act_perms, act_signs = [], [], [], []
        for e in base:
            op = np.arange(self.obs_dim, dtype=np.int64)
            osn = np.ones(self.obs_dim, dtype=np.float32)
            ap = np.arange(self.act_dim, dtype=np.int64)
            asn = np.ones(self.act_dim, dtype=np.float32)
            spec = getattr(e, "mirror", None)
            if spec is not None:
                op[: e.obs_dim] = spec["obs_perm"].cpu().numpy()
                osn[: e.obs_dim] = spec["obs_sign"].cpu().numpy()
                ap[: e.act_dim] = spec["act_perm"].cpu().numpy()
                asn[: e.act_dim] = spec["act_sign"].cpu().numpy()
            obs_perms.append(op)
            obs_signs.append(osn)
            act_perms.append(ap)
            act_signs.append(asn)
        t = lambda a: torch.as_tensor(np.stack(a), device=self.device)  # noqa: E731
        return {
            "family": True,
            "num_families": len(base),
            "obs_perms": t(obs_perms),
            "obs_signs": t(obs_signs),
            "act_perms": t(act_perms),
            "act_signs": t(act_signs),
        }

    @classmethod
    def default(cls, envs_per_family: int = 1024, device=None) -> "MixedSuite":
        return cls(cls.DEFAULT, (envs_per_family,) * len(cls.DEFAULT), device)

    def init_states(self, seed: int, mesh=None):
        """Per-family env states, padded obs and env generators, as tuples:
        this rank's ``count // world`` slots of each family under a
        ``mesh``. Family f draws from the generator seeded
        ``rng.rank_seed(rng.fold_in(seed, f), rank)``: ``fold_in(seed, f)``
        on one device and on rank 0."""
        world, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
        states, obss, gens = [], [], []
        for f, env in enumerate(self.envs):
            if self.counts[f] % world != 0:
                raise ValueError(f"family count {self.counts[f]} must divide over {world} devices")
            gen = rng_mod.generator(rng_mod.rank_seed(rng_mod.fold_in(seed, f), rank),
                                    self.device)
            st = env.init(gen, self.counts[f] // world)
            states.append(st)
            obss.append(env.obs_fn(st))
            gens.append(gen)
        return tuple(states), tuple(obss), tuple(gens)

    def make_rollout(self, horizon: int, policy):
        """K per-family rollouts → one batch-concatenated Trajectory. The
        policy's noise comes from the one learner generator, family after
        family; each family's env draws from its own generator."""
        rollouts = [make_batched_rollout(env, horizon, policy) for env in self.envs]
        names = [e.name for e in self._base]

        def rollout(params, env_states, obss, gen, env_gens):
            new_states, new_obss, trajs = [], [], []
            for f, ro in enumerate(rollouts):
                with self.timer.stage(names[f]):
                    st, ob, traj = ro(params, env_states[f], obss[f], gen, env_gens[f])
                new_states.append(st)
                new_obss.append(ob)
                trajs.append(traj)
            cat = lambda attr, dim: torch.cat([getattr(t, attr) for t in trajs],  # noqa: E731
                                              dim=dim)
            # env metrics merge to a union namespaced per family
            # ("Walker3DCustomEnv/progress" …): each channel spans the whole
            # batch, NaN outside its family's slice; the learner's
            # env_metric_channels means over the finite slots only
            bounds = np.cumsum([0] + [t.reward.shape[1] for t in trajs])
            union = {}
            for f, t in enumerate(trajs):
                for k, v in (t.env_metrics or {}).items():
                    full = torch.full((v.shape[0], int(bounds[-1])), float("nan"),
                                      device=v.device)
                    full[:, bounds[f]:bounds[f + 1]] = v
                    union[f"{names[f]}/{k}"] = full
            traj = Trajectory(
                obs=cat("obs", 1), action=cat("action", 1), log_prob=cat("log_prob", 1),
                value=cat("value", 1), reward=cat("reward", 1), done=cat("done", 1),
                last_obs=cat("last_obs", 0), env_metrics=union or None,
            )
            return tuple(new_states), tuple(new_obss), traj

        return rollout
