"""Engine configuration: the counterpart of ``mocca_envs_tpu/utils/config.py``.

Same fields and defaults as the JAX package's :class:`EngineConfig`, so one
configuration means the same physics in both packages. The rationale for each
default (measured on the JAX package's hardware) is documented there; here
only the meaning of each field is kept.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static physics-step configuration.

    The policy acts once per control step; actuation recomputes every llc
    frame; physics integrates ``sim_substeps`` times per llc frame at ``dt``
    seconds. Walker default: 1 llc × 4 substeps at 240 Hz ⇒ 60 Hz control.
    """

    dt: float = 1.0 / 240.0
    sim_substeps: int = 4
    llc_frames: int = 1
    solver_iters: int = 4
    baumgarte: float = 0.2          # ERP-style position correction factor
    slop: float = 2e-3              # penetration allowed before correction [m]
    max_push_vel: float = 1.0       # cap on correction velocity [m/s]
    cfm: float = 1e-6               # constraint force mixing (A-diag reg.)
    contact_margin: float = 0.02    # rows activate within this distance [m]
    # Solve each contact's two friction rows as one coupled 2×2 system per
    # sweep (same fixed point as row PGS, faster convergence).
    block_pgs: bool = True
    # Hold the frame-start mass-matrix factor across a frame's substeps.
    reuse_factor: bool = True
    # Matrix-free PGS in the fused kernel: carry z = W·λ instead of forming
    # the Delassus matrix. Algebraically the same iteration; the plain path
    # keeps the explicit A.
    matfree_pgs: bool = True
    # Seed each substep's impulses with the previous substep's λ (zeros at a
    # control step's first substep).
    warm_start: bool = True
    # Split-impulse position correction: the push-out bias solved in a
    # position pass that advances the positions only (ops/step.py).
    split_impulse: bool = False
    limit_margin: float = 0.15      # joint-limit rows activate within [rad|m]
    # Stone / triangle windows of the culled narrowphase, re-selected once
    # per control step around the root.
    stone_window: int = 6
    tri_window: int = 16
    gravity: tuple = (0.0, 0.0, -9.8)
    # Field kept so a configuration reads the same in both packages. The
    # port does not read it: it dispatches by the tensors' device.
    use_pallas: bool = True

    @property
    def control_dt(self) -> float:
        return self.dt * self.sim_substeps * self.llc_frames
