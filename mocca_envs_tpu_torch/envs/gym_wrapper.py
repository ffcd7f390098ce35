"""Gym-style host wrapper for single-env debugging.

Counterpart of ``mocca_envs_tpu/envs/gym_wrapper.py``: the reference's
user-facing API (``env = gym.make("Walker3DCustomEnv-v0"); obs =
env.reset(); obs, r, done, info = env.step(a)``) over one slot (B = 1) of a
functional env, on the env's device. A debugging and parity convenience —
production stepping is the batched path (envs/env.BatchedEnv).

Seeding: episode ``n`` (the n-th ``reset`` since the last ``seed``) draws
from a generator seeded ``core/rng.fold_in(seed, n)``, so a reset depends on
the seed and the reset count alone, as the JAX wrapper's ``(key, n)``; the
steps of the episode continue that generator. Each ``step`` reads its
results back to the host once.

Rendering: ``render("state")`` returns q / qd for external visualizers,
``render("human")`` gathers frames that ``close()`` writes as an interactive
HTML viewer (harness/viewer.py), ``render("rgb_array")`` draws an x–z side
view with matplotlib (imported only there).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mocca_envs_tpu_torch.core import rng as rng_mod
from mocca_envs_tpu_torch.envs.env import FnEnv


class GymEnv:
    """Single-env, host-facing, stateful wrapper (old-gym 4-tuple API)."""

    def __init__(self, env: FnEnv, seed: int = 0, auto_reset: bool = False):
        self._env = env
        self._seed = seed
        self._step = env.step if auto_reset else env.step_no_reset
        self._gen = None
        self._state = None
        self._reset_count = 0
        self.observation_space_shape = (env.obs_dim,)
        self.action_space_shape = (env.act_dim,)
        # render("human") accumulator → interactive HTML on close()
        self._human_qs = None
        self._human_path = f"{env.name.lower()}_view.html"
        self._curriculum = None

    # -- reference API surface -------------------------------------------
    def seed(self, seed: int):
        """Reseed the env stream; the reset count starts again at 0."""
        self._seed = seed
        self._reset_count = 0
        return [seed]

    def set_curriculum(self, stage: float):
        """Takes effect at the next ``reset()``: the scene is resampled with
        the stage's ranges; physics is unchanged."""
        self._curriculum = float(stage)

    def get_mirror_indices(self):
        """Reference-style mirror index lists ``(neg_obs, right_obs,
        left_obs, neg_act, right_act, left_act)``; mirroring applies as::

            m = obs.copy()
            m[right], m[left] = obs[left], obs[right]
            m[neg] *= -1

        Equivalent to the engine's perm+sign maps (``obs[perm] * sign``):
        negation lists are ``sign < 0`` at the destination index, swap lists
        are the permutation's 2-cycles."""
        m = self._env.mirror
        if m is None:
            raise ValueError(f"{self._env.name} has no mirror spec")

        def split(perm, sign):
            perm = perm.cpu().numpy()
            sign = sign.cpu().numpy()
            neg = np.nonzero(sign < 0)[0]
            right = np.asarray(
                [i for i in range(len(perm)) if perm[i] > i], dtype=np.int64
            )
            left = perm[right] if right.size else right
            return neg, right, left

        no, ro, lo = split(m["obs_perm"], m["obs_sign"])
        na, ra, la = split(m["act_perm"], m["act_sign"])
        return no, ro, lo, na, ra, la

    def _episode_generator(self) -> torch.Generator:
        return rng_mod.generator(rng_mod.fold_in(self._seed, self._reset_count),
                                 self._env.device)

    def reset(self) -> np.ndarray:
        n = torch.full((1,), self._reset_count, dtype=torch.int32, device=self._env.device)
        self._gen = self._episode_generator()
        self._state = self._env.reset(self._gen, n)
        if self._curriculum is not None:
            task = getattr(self._state, "task", None)
            if task is None or not hasattr(task, "stage"):
                raise ValueError(f"{self._env.name} has no curriculum stage to set")
            # stamp the stage, then reset again with prev= and the same draws,
            # so that the scene is resampled under the stage's ranges
            staged = dataclasses.replace(self._state, task=dataclasses.replace(
                task, stage=torch.full_like(task.stage, self._curriculum)))
            self._gen = self._episode_generator()
            self._state = self._env.reset(self._gen, n, staged)
        self._reset_count += 1
        return self._env.obs_fn(self._state)[0].cpu().numpy()

    def step(self, action):
        a = torch.as_tensor(np.asarray(action, dtype=np.float32), device=self._env.device)
        tr = self._step(self._state, a.reshape(1, -1), self._gen)
        self._state = tr.state
        # one read back: obs, reward, done and the metrics side by side
        names = list(tr.metrics)
        row = torch.cat([tr.obs[0], tr.reward.to(torch.float32), tr.done.to(torch.float32),
                         *(tr.metrics[k].reshape(-1).to(torch.float32) for k in names)])
        host = row.cpu()
        d = self._env.obs_dim
        info = {k: float(host[d + 2 + i]) for i, k in enumerate(names)}
        return host[:d].numpy(), float(host[d]), bool(host[d + 1]), info

    def render(self, mode: str = "state", model=None):
        """Render the current state.

        - ``state`` → dict of q/qd (external-viewer feed; the default);
        - ``human`` → the frame is appended; ``close()`` writes the
          interactive HTML viewer, whose path this returns;
        - ``rgb_array`` → (H, W, 3) uint8 frame: a matplotlib orthographic
          x–z view of the collision spheres. Pass ``model`` (RobotModel) for
          sphere placement; without it only the base trace renders.
        """
        s = self._state
        if mode == "state":
            return {"q": s.q[0].cpu().numpy(), "qd": s.qd[0].cpu().numpy()}
        if mode == "human":
            if self._human_qs is None:
                self._human_qs = []
            self._human_qs.append(s.q[0].clone())
            return self._human_path
        if mode != "rgb_array":
            raise ValueError(f"unknown render mode {mode!r}")
        try:
            import matplotlib
        except ImportError as e:
            raise ImportError("render('rgb_array') needs matplotlib, which is not "
                              "installed") from e
        return _rgb_frame(matplotlib, s, model)

    def close(self):
        if self._human_qs:
            self._flush_human_render()
        self._state = None

    def _flush_human_render(self) -> str:
        """Write the accumulated render("human") frames as an interactive
        HTML viewer; returns the path. Needs the env's RobotModel."""
        model = self._env.model
        if model is None:
            raise ValueError(
                f"{self._env.name} carries no RobotModel — human render needs FK replay"
            )
        from mocca_envs_tpu_torch.harness.viewer import export_html
        from mocca_envs_tpu_torch.harness.viz import scene_to_desc, trajectory_doc

        doc = trajectory_doc(model, torch.stack(self._human_qs),
                             scene_desc=scene_to_desc(self._state.scene))
        out = export_html(doc, self._human_path)
        self._human_qs = None
        return out

    @property
    def state(self):
        return self._state


def _rgb_frame(matplotlib, s, model) -> np.ndarray:
    """The x–z side view of slot 0 of state ``s`` as an (H, W, 3) uint8
    frame: the kinematic skeleton and the collision spheres of ``model``,
    the base, the plane, stones as rectangles, mesh faces as segments and
    bars as circles."""
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(4, 3), dpi=96)
    base = s.q[0, 0:3].cpu().numpy()
    if model is not None:
        from mocca_envs_tpu_torch.ops.collide import sphere_centers
        from mocca_envs_tpu_torch.ops.kinematics import forward_kinematics

        fd = forward_kinematics(model, s.q[:1], s.qd[:1])
        # kinematic skeleton: parent→child link segments (through the joint
        # origins) make small-sphere models (monkey) legible
        pos = fd.pos[0].cpu().numpy()
        for l in range(1, model.nl):
            p = int(model.parent[l])
            if p >= 0:
                ax.plot([pos[p, 0], pos[l, 0]], [pos[p, 2], pos[l, 2]],
                        color="tab:blue", lw=2.0, alpha=0.8, solid_capstyle="round")
        centers = sphere_centers(model, fd)[0].cpu().numpy()
        radii = model.sph_radius.cpu().numpy()
        for c, r in zip(centers, radii):
            ax.add_patch(plt.Circle((c[0], c[2]), max(r, 0.01), alpha=0.7))
    ax.plot([base[0]], [base[2]], "r+")
    sc = s.scene
    from mocca_envs_tpu_torch.terrain.scene import NO_GROUND_Z

    gz = float(sc.ground_z[0])
    if gz > NO_GROUND_Z / 2:
        ax.axhline(gz, color="k", lw=1)
    if sc.has_stones:
        # x–z side view: stones as (axis-aligned) rectangles at their
        # centers — orientation is dropped, enough to see the chain
        for p, h in zip(sc.stone_pos[0].cpu().numpy(), sc.stone_half[0].cpu().numpy()):
            ax.add_patch(plt.Rectangle((p[0] - h[0], p[2] - h[2]), 2 * h[0], 2 * h[2],
                                       color="tab:gray", alpha=0.8))
    if sc.has_tris:
        a, b, c = (t[0].cpu().numpy() for t in (sc.tri_a, sc.tri_b, sc.tri_c))
        for k in range(a.shape[0]):
            for p0, p1 in ((a[k], b[k]), (b[k], c[k]), (c[k], a[k])):
                ax.plot([p0[0], p1[0]], [p0[2], p1[2]], color="tab:purple", lw=0.8, alpha=0.6)
    if sc.has_bars:
        mid = 0.5 * (sc.bar_a[0] + sc.bar_b[0]).cpu().numpy()
        for m, r in zip(mid, sc.bar_r[0].cpu().numpy()):
            ax.add_patch(plt.Circle((m[0], m[2]), max(float(r), 0.02), color="tab:brown"))
    ax.set_xlim(base[0] - 1.5, base[0] + 1.5)
    ax.set_ylim(base[2] - 1.5, base[2] + 1.5)
    ax.set_aspect("equal")
    ax.set_axis_off()
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf
