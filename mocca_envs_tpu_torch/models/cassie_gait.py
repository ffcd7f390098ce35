"""Cassie reference-motion tables (the CassiePhase* variants).

Counterpart of ``mocca_envs_tpu/models/cassie_gait.py``: a phase variable
indexes a gait table of motor positions and per-foot stance indicators, and
the reward tracks the interpolated row. The default table is a synthesized
parametric walk:

- hip pitch: sinusoid, the legs π out of phase;
- knee: a flexion bump during each leg's swing half-cycle, slight
  extension in stance;
- foot: counter-rotates the knee to stay level;
- hip roll / yaw: zero (a straight-line walk).

:func:`from_npz` loads a recorded table in its place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class GaitTable:
    """Clock-indexed reference motion, shared by the whole batch."""

    q_motors: torch.Tensor    # (T, n_motors) motor positions (deviations from stand)
    stance: torch.Tensor      # (T, 2) right / left expected ground contact
    period_steps: float       # control steps per gait cycle

    @property
    def length(self) -> int:
        return self.q_motors.shape[0]

    def to(self, device) -> "GaitTable":
        return GaitTable(self.q_motors.to(device), self.stance.to(device), self.period_steps)

    def at_phase(self, phase: torch.Tensor):
        """Linear interpolation at ``phase`` (B,) in [0, period_steps) →
        ``(q_ref (B, n_motors), stance (B, 2))``: a gather of the two
        neighbouring rows (the last wraps to the first) and a lerp."""
        T = self.length
        u = torch.remainder(phase, self.period_steps) / self.period_steps * T
        i0 = torch.floor(u)
        f = (u - i0)[:, None]
        a = i0.to(torch.long)
        b = torch.remainder(a + 1, T)
        return ((1.0 - f) * self.q_motors[a] + f * self.q_motors[b],
                (1.0 - f) * self.stance[a] + f * self.stance[b])


def synthesized_walk(
    n_motors: int = 10,
    period_steps: float = 40.0,
    rows: int = 64,
    hip_amp: float = 0.30,
    knee_amp: float = 0.45,
    knee_stance: float = 0.08,
    foot_level: float = 0.7,
) -> GaitTable:
    """Parametric alternating walking gait. Motor layout per leg:
    [hip roll, hip yaw, hip pitch, knee, foot]; right leg first."""
    t = np.linspace(0.0, 2 * np.pi, rows, endpoint=False)
    q = np.zeros((rows, n_motors), dtype=np.float32)
    stance = np.zeros((rows, 2), dtype=np.float32)
    for leg, phase_off in ((0, 0.0), (1, np.pi)):           # right, left
        ph = t + phase_off
        hip = hip_amp * np.sin(ph)
        # swing = the half-cycle with sin(ph) > 0 (leg moving forward)
        swing = (np.sin(ph) > 0).astype(np.float32)
        bump = np.maximum(np.sin(ph), 0.0) ** 2
        knee = knee_stance + knee_amp * bump
        foot = -foot_level * knee
        base = leg * 5
        q[:, base + 2] = hip
        q[:, base + 3] = knee
        q[:, base + 4] = foot
        stance[:, leg] = 1.0 - swing
    return GaitTable(torch.as_tensor(q), torch.as_tensor(stance), float(period_steps))


def from_npz(path: str, period_steps: float) -> GaitTable:
    """Load a recorded table: ``q_motors (T, n_motors)`` and optionally
    ``stance (T, 2)`` (else a leg whose knee is below its median flexion
    counts as in stance)."""
    data = np.load(path)
    q = np.asarray(data["q_motors"], dtype=np.float32)
    if "stance" in data:
        st = np.asarray(data["stance"], dtype=np.float32)
    else:
        st = np.zeros((q.shape[0], 2), dtype=np.float32)
        for leg in range(2):
            knee = q[:, leg * 5 + 3]
            st[:, leg] = (knee < np.median(knee)).astype(np.float32)
    return GaitTable(torch.as_tensor(q), torch.as_tensor(st), float(period_steps))
