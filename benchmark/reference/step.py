"""The plain physics step over a flat plane, batch-first.

Frozen copy of the plain path of the port's ``ops/step.py``: floating-base
models with revolute joints over the plane, torque or PD actuation and the
point-to-point rods of a :class:`ConstraintSpec`. No kernel, no culling.

    control step
      └─ llc frame × llc_frames:   actuation (torques held over the frame,
           │                       or PD torque kp·(target − q) refreshed)
           └─ substep × sim_substeps:
                FK → collide → bias / mass matrix
                → impulse PGS over [equality | limits | contacts]
                → semi-implicit integrate

A launch unit is one llc frame in torque mode (λ starts at zero each frame)
and the whole control step in PD mode (λ carried across its llc frames).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from benchmark.reference import collide as collide_mod
from benchmark.reference import linalg
from benchmark.reference.dynamics import bias_forces, forward_dynamics, mass_matrix
from benchmark.reference.integrate import LIMIT_SLOP, integrate
from benchmark.reference.kinematics import forward_kinematics, joint_q, joint_qd, point_jacobian
from benchmark.reference.schema import RobotModel
from benchmark.reference.solver import delassus, pgs_solve, tangent_basis


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The solver settings a configuration file states (its ``engine``
    block), under the port's field names."""

    dt: float = 1.0 / 240.0
    sim_substeps: int = 4
    llc_frames: int = 1
    solver_iters: int = 4
    baumgarte: float = 0.2
    slop: float = 2e-3
    max_push_vel: float = 1.0
    cfm: float = 1e-6
    contact_margin: float = 0.02
    block_pgs: bool = True
    reuse_factor: bool = True
    matfree_pgs: bool = True
    warm_start: bool = True
    split_impulse: bool = False
    limit_margin: float = 0.15
    gravity: tuple = (0.0, 0.0, -9.8)

    @property
    def control_dt(self) -> float:
        return self.dt * self.sim_substeps * self.llc_frames


@dataclasses.dataclass(frozen=True)
class ConstraintSpec:
    """Permanent point-to-point rods between two robot links (Cassie's
    achilles rods closing the leg four-bars)."""

    p2p_link_a: tuple = ()
    p2p_link_b: tuple = ()
    p2p_anchor_a: tuple = ()   # local points on link_a, tuple of 3-tuples
    p2p_anchor_b: tuple = ()

    @property
    def num_p2p(self) -> int:
        return len(self.p2p_link_a)

    @property
    def ne(self) -> int:
        return 3 * self.num_p2p


LIMIT_RANGE_CAP = 12.0  # joints with a wider range get no limit row [rad]


def limited_joints(model: RobotModel) -> tuple:
    """Static indices of the joints that get a solver limit row."""
    lo = model.limit_lo.cpu().numpy()
    hi = model.limit_hi.cpu().numpy()
    return tuple(int(j) for j in range(model.nj) if hi[j] - lo[j] < LIMIT_RANGE_CAP)


@dataclasses.dataclass
class StepInfo:
    """Per-step diagnostics for the tasks (from the LAST substep)."""

    contacts: collide_mod.Contacts
    normal_impulse: torch.Tensor   # (B, ns) per-sphere normal impulse
    foot_contact: torch.Tensor     # (B, nfeet) binary flags
    link_contact: torch.Tensor     # (B, nl) binary flags


def make_substep(model: RobotModel, config: EngineConfig,
                 constraints: ConstraintSpec = ConstraintSpec(),
                 extra_damping: torch.Tensor | None = None):
    """``substep(q, qd, tau_joint, ground_z, friction, Minv_in=None,
    lam_in=None) → (q', qd', StepInfo, λ)`` over a batch (B, ·).
    ``extra_damping`` (nj,) adds per-joint viscous damping handled
    implicitly every substep (a PD servo's −k_d·q̇ term)."""
    if config.split_impulse:
        raise NotImplementedError("the reference holds no split-impulse pass")
    dt = config.dt
    ns = model.ns
    ne = constraints.ne
    num_p2p = constraints.num_p2p
    lim_idx = limited_joints(model)
    nlim = len(lim_idx)
    li = torch.as_tensor(lim_idx, dtype=torch.long, device=model.device)
    lim_cols = 6 + li
    beta = config.baumgarte / dt
    if num_p2p:
        dev = model.device
        p2p_la = torch.as_tensor(constraints.p2p_link_a, dtype=torch.long, device=dev)
        p2p_lb = torch.as_tensor(constraints.p2p_link_b, dtype=torch.long, device=dev)
        p2p_aa = torch.as_tensor(constraints.p2p_anchor_a, dtype=torch.float32, device=dev)
        p2p_ab = torch.as_tensor(constraints.p2p_anchor_b, dtype=torch.float32, device=dev)
    damping = model.damping if extra_damping is None else model.damping + extra_damping
    # implicit damper/spring diagonal dt·c + dt²·k on the joint block
    joint_diag = dt * (damping + dt * model.stiffness)

    def eq_target(err):
        # Baumgarte drift correction, velocity-capped like contact push-out
        return torch.clamp(-beta * err, -config.max_push_vel, config.max_push_vel)

    def minv_of(fd):
        """Explicit inverse inertia: the factor ``reuse_factor`` holds fixed
        across a frame's substeps."""
        M = mass_matrix(model, fd)
        jd = torch.cat([joint_diag.new_zeros(6), joint_diag])
        return linalg.chol_inverse(linalg.chol_factor(M + torch.diag(jd)))

    def substep(q, qd, tau_joint, ground_z, friction, Minv_in=None, lam_in=None):
        B = q.shape[0]
        fd = forward_kinematics(model, q, qd)
        contacts = collide_mod.collide(model, fd, ground_z, config.contact_margin)

        qj = joint_q(model, q)
        qdj = joint_qd(model, qd)
        tau_j = tau_joint - damping * qdj - model.stiffness * (qj - model.spring_ref)
        tau = torch.cat([q.new_zeros(B, 6), tau_j], dim=1)

        if Minv_in is None:
            qdd_free, Minv = forward_dynamics(
                model, fd, qd, tau, config.gravity, joint_diag=joint_diag
            )
        else:
            Minv = Minv_in
            qdd_free = torch.einsum(
                "bij,bj->bi", Minv, tau - bias_forces(model, fd, qd, config.gravity)
            )
        v_free = qd + dt * qdd_free

        rows_J, rows_tgt, rows_act = [], [], []
        # rod rows: the two anchor points move together
        if num_p2p:
            xa = fd.pos[:, p2p_la] + torch.einsum("bkij,kj->bki", fd.rot[:, p2p_la], p2p_aa)
            xb = fd.pos[:, p2p_lb] + torch.einsum("bkij,kj->bki", fd.rot[:, p2p_lb], p2p_ab)
            Jk = point_jacobian(model, fd, p2p_la, xa) - point_jacobian(model, fd, p2p_lb, xb)
            rows_J.append(Jk.reshape(B, 3 * num_p2p, -1))
            rows_tgt.append(eq_target(xa - xb).reshape(B, -1))
            rows_act.append(q.new_ones(B, 3 * num_p2p))
        # joint-limit rows: unilateral, signed toward the nearer bound
        if nlim:
            d_lo = qj[:, li] - model.limit_lo[li]
            d_hi = model.limit_hi[li] - qj[:, li]
            sgn = torch.where(d_lo <= d_hi, 1.0, -1.0).to(q.dtype)
            gap = torch.minimum(d_lo, d_hi)
            Jl = q.new_zeros(B, nlim, model.nv)
            Jl[:, torch.arange(nlim, device=q.device), lim_cols] = sgn
            viol = -gap
            bias_l = torch.clamp(beta * torch.clamp(viol - LIMIT_SLOP, min=0.0),
                                 max=config.max_push_vel)
            push_l = bias_l - torch.clamp(-viol, min=0.0) / dt
            rows_J.append(Jl)
            rows_tgt.append(push_l)
            rows_act.append((gap < config.limit_margin).to(q.dtype))

        # contact rows, one [normal, t1, t2] block per collision sphere
        Jc = point_jacobian(model, fd, contacts.link, contacts.pos)   # (B,ns,3,nv)
        t1, t2 = tangent_basis(contacts.normal)
        Jn = torch.einsum("bsi,bsik->bsk", contacts.normal, Jc)
        Jt1 = torch.einsum("bsi,bsik->bsk", t1, Jc)
        Jt2 = torch.einsum("bsi,bsik->bsk", t2, Jc)
        bias_n = torch.clamp(
            beta * torch.clamp(contacts.depth - config.slop, min=0.0), max=config.max_push_vel
        )
        push = bias_n - torch.clamp(-contacts.depth, min=0.0) / dt
        zeros = torch.zeros_like(push)
        rows_J.append(torch.stack([Jn, Jt1, Jt2], dim=2).reshape(B, 3 * ns, -1))
        rows_tgt.append(torch.stack([push, zeros, zeros], dim=2).reshape(B, -1))
        rows_act.append(contacts.active.repeat_interleave(3, dim=1))

        J = torch.cat(rows_J, dim=1)
        target = torch.cat(rows_tgt, dim=1)
        active = torch.cat(rows_act, dim=1)

        A, MinvJT = delassus(Minv, J, config.cfm)
        c = torch.einsum("brk,bk->br", J, v_free) - target
        mu = friction[:, None].expand(B, ns)
        lam = pgs_solve(
            A, c, active, mu, ne, ns, config.solver_iters, nlim=nlim,
            block=config.block_pgs, lam0=lam_in if config.warm_start else None,
        )
        qd_new = v_free + torch.einsum("bkr,br->bk", MinvJT, lam)
        q_new, qd_new = integrate(model, q, qd_new, dt)

        info = StepInfo(
            contacts=contacts,
            normal_impulse=lam[:, ne + nlim:].reshape(B, ns, 3)[..., 0],
            foot_contact=collide_mod.foot_contact_flags(model, contacts),
            link_contact=collide_mod.link_contact_mask(model, contacts),
        )
        return q_new, qd_new, info, lam

    substep.minv_of = minv_of
    substep.num_rows = ne + nlim + 3 * ns
    return substep


def make_plain_llc(model: RobotModel, config: EngineConfig, substep, pd_mode: bool = False):
    """One launch unit, ``(q, qd, tau_or_targets, ground_z, friction) →
    (q', qd', StepInfo)``: in torque mode one llc frame of ``sim_substeps``
    substeps at fixed torques; in PD mode the whole control step,
    ``llc_frames`` frames whose torque ``actuated·kp·(target − q)`` is taken
    from the state at each frame's start. λ is carried across the unit's
    substeps (zeros at its start) and each frame's starting factor is held
    when ``reuse_factor`` is on."""
    frames = config.llc_frames if pd_mode else 1
    pd_gain = model.actuated * model.kp

    def plain_unit(q, qd, tau_or_targets, ground_z, friction):
        reuse = config.reuse_factor and config.sim_substeps > 1
        lam = q.new_zeros(q.shape[0], substep.num_rows) if config.warm_start else None
        info = None
        for _ in range(frames):
            tau_j = pd_gain * (tau_or_targets - joint_q(model, q)) if pd_mode else tau_or_targets
            Minv0 = substep.minv_of(forward_kinematics(model, q, qd)) if reuse else None
            for _ in range(config.sim_substeps):
                q, qd, info, lam_out = substep(q, qd, tau_j, ground_z, friction,
                                               Minv_in=Minv0, lam_in=lam)
                lam = lam_out if config.warm_start else None
        return q, qd, info

    return plain_unit


def make_control_step(model: RobotModel, config: EngineConfig,
                      constraints: ConstraintSpec = ConstraintSpec(),
                      actuation: Callable | None = None,
                      extra_damping: torch.Tensor | None = None,
                      pd_targets: Callable | None = None):
    """Control-rate step ``(q, qd, action, ground_z, friction) → (q', qd',
    StepInfo)``. Torque families give ``actuation(q, qd, action) →
    tau_joint``, run once per llc frame; PD families give ``pd_targets(action)
    → joint targets`` and the whole control step is one unit."""
    substep = make_substep(model, config, constraints, extra_damping=extra_damping)
    if pd_targets is not None:
        unit = make_plain_llc(model, config, substep, pd_mode=True)

        def pd_control_step(q, qd, action, ground_z, friction):
            return unit(q, qd, pd_targets(action), ground_z, friction)

        return pd_control_step

    unit = make_plain_llc(model, config, substep)

    def control_step(q, qd, action, ground_z, friction):
        info = None
        for _ in range(config.llc_frames):
            q, qd, info = unit(q, qd, actuation(q, qd, action), ground_z, friction)
        return q, qd, info

    return control_step
