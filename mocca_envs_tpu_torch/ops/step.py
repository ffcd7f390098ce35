"""The assembled physics step, batch-first.

Counterpart of ``mocca_envs_tpu/ops/step.py`` for floating-base and
fixed-base models, with revolute and prismatic joints, over the plane, the stone boxes, the bar capsules, heightfields and triangle
meshes, with torque or PD actuation, the optional split-impulse position
pass, and the equality rows of a :class:`ConstraintSpec` (point-to-point
rods, the planar base lock, and the maskable grab rows whose activity and
anchor are per-env data: ``grab_active (B, ng)``, ``grab_target (B, ng,
3)``).

    control step
      └─ llc frame × llc_frames:   actuation (torques held over the frame,
           │                       or PD torque kp·(target − q) refreshed)
           └─ substep × sim_substeps:
                FK → collide → bias / mass matrix
                → impulse PGS over [equality | limits | contacts]
                → semi-implicit integrate

A launch unit is one llc frame in torque mode (λ starts at zero each frame)
and the whole control step in PD mode (λ carried across its llc frames). On
CPU tensors a unit runs this plain PyTorch path. On CUDA tensors it runs as
ONE launch of the hand-written engine kernel (ops/cuda/engine.py: K1a on the
plane, K1c over stones, K1b in PD mode, K1e with equality rows, K1d over bars
with grab rows, K1f over a heightfield, K1g over mesh triangles, each also
with split impulse, under any EngineConfig's solver options), which computes
the same unit; there is no fallback between the two. A model the kernel
does not cover (``ops/cuda/engine.py::supports``: a fixed base, or a
prismatic joint) takes the plain path on every device, as the JAX package
sends it to its XLA path; its structure decides that once, when the unit is
built. Stones are culled to ``config.stone_window``, mesh faces to
``config.tri_window``, and a heightfield grid is cut to its ``HF_PATCH ×
HF_PATCH`` window around the root once per unit, before either path; bars
are never culled.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from mocca_envs_tpu_torch.models.schema import RobotModel
from mocca_envs_tpu_torch.ops import collide as collide_mod
from mocca_envs_tpu_torch.ops import linalg
from mocca_envs_tpu_torch.ops.dynamics import bias_forces, forward_dynamics, mass_matrix
from mocca_envs_tpu_torch.ops.integrate import LIMIT_SLOP, integrate
from mocca_envs_tpu_torch.ops.kinematics import (
    forward_kinematics,
    joint_q,
    joint_qd,
    point_jacobian,
)
from mocca_envs_tpu_torch.ops.solver import delassus, pgs_solve, tangent_basis
from mocca_envs_tpu_torch.terrain.scene import (
    HF_PATCH, Scene, cull_stones, cull_tris, extract_patch)
from mocca_envs_tpu_torch.utils.config import EngineConfig


@dataclasses.dataclass(frozen=True)
class ConstraintSpec:
    """Static equality-constraint structure of an env family.

    - ``p2p_*``: permanent point-to-point rods between two robot links
      (Cassie's achilles rods closing the leg four-bars);
    - ``planar``: locks base y-translation, roll and yaw (the 2D variants);
    - ``num_grabs``: world-anchor constraints whose activation and anchor
      are runtime data (monkey-bar grabs): the point ``grab_anchors[g]`` of
      link ``grab_links[g]`` is pulled onto its target while active.
    """

    p2p_link_a: tuple = ()
    p2p_link_b: tuple = ()
    p2p_anchor_a: tuple = ()   # local points on link_a, tuple of 3-tuples
    p2p_anchor_b: tuple = ()
    planar: bool = False
    num_grabs: int = 0
    grab_links: tuple = ()
    grab_anchors: tuple = ()   # local palm point per grab

    @property
    def num_p2p(self) -> int:
        return len(self.p2p_link_a)

    @property
    def ne(self) -> int:
        return 3 * self.num_p2p + (3 if self.planar else 0) + 3 * self.num_grabs


LIMIT_RANGE_CAP = 12.0  # joints with a wider range get no limit row [rad|m]


def limited_joints(model: RobotModel) -> tuple:
    """Static indices of joints that get a solver limit row; shared by the
    plain path and the kernel so both build ``[equality | limits |
    contacts]``."""
    lo = model.limit_lo.cpu().numpy()
    hi = model.limit_hi.cpu().numpy()
    return tuple(int(j) for j in range(model.nj) if hi[j] - lo[j] < LIMIT_RANGE_CAP)


@dataclasses.dataclass
class StepInfo:
    """Per-step diagnostics for tasks and metrics (from the LAST substep)."""

    contacts: collide_mod.Contacts
    normal_impulse: torch.Tensor   # (B, ns) per-sphere normal impulse
    foot_contact: torch.Tensor     # (B, nfeet) binary flags
    link_contact: torch.Tensor     # (B, nl) binary flags


def make_substep(model: RobotModel, config: EngineConfig,
                 constraints: ConstraintSpec = ConstraintSpec(),
                 extra_damping: torch.Tensor | None = None):
    """Build ``substep(q, qd, tau_joint, scene, grab_active=None,
    grab_target=None, Minv_in=None, lam_in=None) → (q', qd', StepInfo, λ)``
    over a batch (B, ·). A spec with grabs needs ``grab_active (B, ng)`` and
    ``grab_target (B, ng, 3)``.

    ``extra_damping`` (nj,) adds per-joint viscous damping handled
    implicitly every substep: the home of a PD servo's −k_d·q̇ term. An
    explicit k_d·q̇ held over a substep is unstable whenever ``dt >
    2·I_joint / k_d``, which Cassie's toe (k_d = 5, I ≈ 5·10⁻⁴ kg·m²)
    violates at any practical rate; in the system matrix it is stable.

    ``config.split_impulse`` keeps the push-out bias of the limit and
    contact-normal rows out of the velocity solve; a second PGS over those
    rows alone (μ = 0, no block, from λ = 0, the same Delassus operator)
    turns the bias into a pseudo-velocity that advances the positions only
    (:func:`~mocca_envs_tpu_torch.ops.integrate.integrate`)."""
    dt = config.dt
    ns = model.ns
    ne = constraints.ne
    num_p2p = constraints.num_p2p
    num_grabs = constraints.num_grabs
    lim_idx = limited_joints(model)
    nlim = len(lim_idx)
    base_off = 6 if model.floating else 0
    li = torch.as_tensor(lim_idx, dtype=torch.long, device=model.device)
    lim_cols = base_off + li
    beta = config.baumgarte / dt
    if num_p2p:
        dev = model.device
        p2p_la = torch.as_tensor(constraints.p2p_link_a, dtype=torch.long, device=dev)
        p2p_lb = torch.as_tensor(constraints.p2p_link_b, dtype=torch.long, device=dev)
        p2p_aa = torch.as_tensor(constraints.p2p_anchor_a, dtype=torch.float32, device=dev)
        p2p_ab = torch.as_tensor(constraints.p2p_anchor_b, dtype=torch.float32, device=dev)
    if num_grabs:
        dev = model.device
        grab_l = torch.as_tensor(constraints.grab_links, dtype=torch.long, device=dev)
        grab_anc = torch.as_tensor(constraints.grab_anchors, dtype=torch.float32, device=dev)
    if constraints.planar:
        # base linear y, angular x (roll rate), angular z (yaw rate)
        planar_J = torch.zeros(3, model.nv, device=model.device)
        planar_J[[0, 1, 2], [1, 3, 5]] = 1.0
    damping = model.damping if extra_damping is None else model.damping + extra_damping
    # implicit damper/spring diagonal dt·c + dt²·k on the joint block
    joint_diag = dt * (damping + dt * model.stiffness)

    def eq_target(err):
        # Baumgarte drift correction, velocity-capped like contact push-out:
        # an uncapped β/dt (120 s⁻¹ at Cassie's 600 Hz) turns any residual
        # closure error into solver-breaking impulse targets
        return torch.clamp(-beta * err, -config.max_push_vel, config.max_push_vel)

    def minv_of(fd):
        """Explicit inverse inertia for a configuration — the factor that
        ``config.reuse_factor`` holds fixed across a frame's substeps."""
        M = mass_matrix(model, fd)
        jd = torch.cat([joint_diag.new_zeros(6), joint_diag]) if model.floating else joint_diag
        return linalg.chol_inverse(linalg.chol_factor(M + torch.diag(jd)))

    def substep(q, qd, tau_joint, scene: Scene, grab_active=None, grab_target=None,
                Minv_in=None, lam_in=None):
        B = q.shape[0]
        fd = forward_kinematics(model, q, qd)
        contacts = collide_mod.collide(model, fd, scene, config.contact_margin)

        qj = joint_q(model, q)
        qdj = joint_qd(model, qd)
        tau_j = tau_joint - damping * qdj - model.stiffness * (qj - model.spring_ref)
        tau = torch.cat([q.new_zeros(B, 6), tau_j], dim=1) if model.floating else tau_j

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
        # planar lock: roll / yaw drift through the sine surrogates 2(wx+yz),
        # 2(wz+xy), first-order exact on the locked manifold, as the JAX
        # package's oracle and kernel take them (not atan2)
        if constraints.planar:
            w_, x_, y_, z_ = q[:, 3], q[:, 4], q[:, 5], q[:, 6]
            err = torch.stack([q[:, 1], 2.0 * (w_ * x_ + y_ * z_), 2.0 * (w_ * z_ + x_ * y_)],
                              dim=1)
            rows_J.append(planar_J.expand(B, 3, -1))
            rows_tgt.append(eq_target(err))
            rows_act.append(q.new_ones(B, 3))
        # grab rows: a world-anchor point Jacobian per hand, the palm pulled
        # onto its target, all three rows masked by the hand's activity
        if num_grabs:
            xg = fd.pos[:, grab_l] + torch.einsum("bkij,kj->bki", fd.rot[:, grab_l], grab_anc)
            rows_J.append(point_jacobian(model, fd, grab_l, xg).reshape(B, 3 * num_grabs, -1))
            rows_tgt.append(eq_target(xg - grab_target).reshape(B, -1))
            rows_act.append(grab_active.repeat_interleave(3, dim=1))
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
            if config.split_impulse:
                # the push-out moves to the position pass: the velocity
                # solve only forbids further approach
                push_l = push_l - bias_l
            rows_J.append(Jl)
            rows_tgt.append(push_l)
            rows_act.append((gap < config.limit_margin).to(q.dtype))

        # contact rows, one [normal, t1, t2] block per collision sphere
        Jc = point_jacobian(model, fd, contacts.link, contacts.pos)   # (B,ns,3,nv)
        t1, t2 = tangent_basis(contacts.normal)
        Jn = torch.einsum("bsi,bsik->bsk", contacts.normal, Jc)
        Jt1 = torch.einsum("bsi,bsik->bsk", t1, Jc)
        Jt2 = torch.einsum("bsi,bsik->bsk", t2, Jc)
        # penetrating: capped Baumgarte push-out; within the margin: allow
        # approach up to closing the gap this substep
        bias_n = torch.clamp(
            beta * torch.clamp(contacts.depth - config.slop, min=0.0), max=config.max_push_vel
        )
        push = bias_n - torch.clamp(-contacts.depth, min=0.0) / dt
        if config.split_impulse:
            push = push - bias_n
        zeros = torch.zeros_like(push)
        rows_J.append(torch.stack([Jn, Jt1, Jt2], dim=2).reshape(B, 3 * ns, -1))
        rows_tgt.append(torch.stack([push, zeros, zeros], dim=2).reshape(B, -1))
        rows_act.append(contacts.active.repeat_interleave(3, dim=1))

        J = torch.cat(rows_J, dim=1)
        target = torch.cat(rows_tgt, dim=1)
        active = torch.cat(rows_act, dim=1)

        A, MinvJT = delassus(Minv, J, config.cfm)
        c = torch.einsum("brk,bk->br", J, v_free) - target
        mu = scene.friction[:, None].expand(B, ns)
        lam = pgs_solve(
            A, c, active, mu, ne, ns, config.solver_iters, nlim=nlim,
            block=config.block_pgs, lam0=lam_in if config.warm_start else None,
        )
        qd_new = v_free + torch.einsum("bkr,br->bk", MinvJT, lam)

        qd_pos = None
        if config.split_impulse:
            # the position pass: pseudo-impulses against the bias alone, over
            # the limit and contact-normal rows (the equality rows masked,
            # the friction rows bounded to [0, 0] by μ = 0); the residual at
            # λ = 0 is −bias
            bias = torch.zeros_like(c)
            if nlim:
                bias[:, ne:ne + nlim] = bias_l
            bias[:, ne + nlim::3] = bias_n
            act_pos = active.clone()
            act_pos[:, :ne] = 0.0
            lam_pos = pgs_solve(A, -bias, act_pos, torch.zeros_like(mu), ne, ns,
                                config.solver_iters, nlim=nlim, block=False)
            qd_pos = torch.einsum("bkr,br->bk", MinvJT, lam_pos)
        q_new, qd_new = integrate(model, q, qd_new, dt, qd_pos=qd_pos)

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


def make_plain_llc(model: RobotModel, config: EngineConfig, substep=None,
                   pd_mode: bool = False):
    """One launch unit on the plain path, ``(q, qd, tau_or_targets, scene) →
    (q', qd', StepInfo)``.

    Torque mode: one llc frame of ``sim_substeps`` substeps at fixed torques.
    PD mode: the whole control step, ``llc_frames`` frames whose torque
    ``actuated·kp·(target − q)`` is taken from the state at each frame's
    start. λ is carried across the unit's substeps (zeros at its start) and
    each frame's starting factor is held when ``reuse_factor`` is on. The
    scene is taken as given: the caller culls."""
    substep = substep or make_substep(model, config)
    frames = config.llc_frames if pd_mode else 1
    pd_gain = model.actuated * model.kp

    def plain_unit(q, qd, tau_or_targets, scene: Scene, grab_active=None, grab_target=None):
        reuse = config.reuse_factor and config.sim_substeps > 1
        lam = q.new_zeros(q.shape[0], substep.num_rows) if config.warm_start else None
        for _ in range(frames):
            tau_j = pd_gain * (tau_or_targets - joint_q(model, q)) if pd_mode else tau_or_targets
            Minv0 = substep.minv_of(forward_kinematics(model, q, qd)) if reuse else None
            for _ in range(config.sim_substeps):
                q, qd, info, lam_out = substep(q, qd, tau_j, scene, grab_active, grab_target,
                                               Minv_in=Minv0, lam_in=lam)
                lam = lam_out if config.warm_start else None
        return q, qd, info

    return plain_unit


def info_from_kernel(model: RobotModel, config: EngineConfig,
                     depth: torch.Tensor, nimp: torch.Tensor) -> StepInfo:
    """StepInfo from the kernel's last-substep depth and normal impulse;
    ``active`` is recomputed here as the kernel does not return it."""
    B, ns = depth.shape
    normal = depth.new_zeros(B, ns, 3)
    normal[..., 2] = 1.0
    contacts = collide_mod.Contacts(
        pos=depth.new_zeros(B, ns, 3), normal=normal, depth=depth,
        link=model.sph_link, active=(depth > -config.contact_margin).to(depth.dtype),
    )
    return StepInfo(
        contacts=contacts,
        normal_impulse=nimp,
        foot_contact=collide_mod.foot_contact_flags(model, contacts),
        link_contact=collide_mod.link_contact_mask(model, contacts),
    )


def unit_route(device: torch.device, kernel_covers: bool, hf_shape=None) -> str:
    """Where a launch unit runs: ``"plain"`` on CPU tensors, for a model
    the kernel does not cover (``engine.supports``) and for a heightfield
    grid (``hf_shape``, its static (H, W)) smaller than the ``HF_PATCH``
    window, as the JAX package decides at trace time; else ``"kernel"``,
    the engine kernel of the scene's variant (K1f over a grid)."""
    if device.type == "cpu" or not kernel_covers:
        return "plain"
    if hf_shape is not None and min(hf_shape) < HF_PATCH:
        return "plain"
    return "kernel"


def _make_llc_unit(model: RobotModel, config: EngineConfig, substep,
                   constraints: ConstraintSpec = ConstraintSpec(),
                   extra_damping=None, pd_mode: bool = False):
    """One launch unit (see :func:`make_plain_llc`). Stones and mesh faces
    are culled to their windows first, and a heightfield grid larger than
    ``HF_PATCH`` is cut to the window around the root (a grid that is one
    already passes through), on both paths. :func:`unit_route` then picks
    the path: the plain one on CPU tensors, for a model the kernel does
    not cover and for a grid smaller than the window, on any device; else
    the engine kernel of the scene's, the actuation's and the constraints'
    variant (any combination the TPU kernel composes: several geometries,
    PD mode, equality rows, extra damping). The kernel's scene inputs
    (stones; bars and grabs; the heightfield window; the faces) are packed
    per unit."""
    from mocca_envs_tpu_torch.ops.cuda import engine as cuda_engine

    plain_unit = make_plain_llc(model, config, substep, pd_mode)
    kernel_covers = cuda_engine.supports(model)
    kernels: dict = {}

    def llc_unit(q, qd, tau_or_targets, scene: Scene, grab_active=None, grab_target=None):
        scene = cull_stones(scene, q[:, 0:2], config.stone_window)
        scene = cull_tris(scene, q[:, 0:2], config.tri_window)
        hf_shape = tuple(scene.hf_height.shape[1:]) if scene.has_hf else None
        if hf_shape is not None and min(hf_shape) >= HF_PATCH:
            scene = extract_patch(scene, q[:, 0:2], HF_PATCH)
        if unit_route(q.device, kernel_covers, hf_shape) == "plain":
            return plain_unit(q, qd, tau_or_targets, scene, grab_active, grab_target)
        hf_patch = HF_PATCH if hf_shape is not None else 0
        key = (scene.stone_pos.shape[1] if scene.has_stones else 0,
               scene.bar_a.shape[1] if scene.has_bars else 0, hf_patch,
               scene.tri_a.shape[1] if scene.has_tris else 0)
        if key not in kernels:
            kernels[key] = cuda_engine.make_kernel(
                model, config, num_stones=key[0], num_bars=key[1], hf_patch=hf_patch,
                num_tris=key[3], pd_mode=pd_mode, extra_damping=extra_damping,
                plain_unit=plain_unit, constraints=constraints)
        kernel = kernels[key]
        qq, dd, depth, nimp = kernel.launch(
            q, qd, tau_or_targets, scene.ground_z, scene.friction,
            *kernel.pack(scene, grab_active, grab_target))
        return qq, dd, info_from_kernel(model, config, depth, nimp)

    return llc_unit


def make_control_step(model: RobotModel, config: EngineConfig,
                      constraints: ConstraintSpec = ConstraintSpec(),
                      actuation: Callable | None = None,
                      extra_damping: torch.Tensor | None = None,
                      pd_targets: Callable | None = None):
    """Control-rate step ``(q, qd, action, scene, grab_active=None,
    grab_target=None) → (q', qd', StepInfo)``; the grab arguments are needed
    when ``constraints`` has grabs and are held over the control step.

    Torque families: ``actuation(q, qd, action) → tau_joint`` runs once per
    llc frame. PD families give ``pd_targets(action) → joint targets``; the
    whole control step is then one unit, with the derivative gain riding
    ``extra_damping``."""
    substep = make_substep(model, config, constraints, extra_damping=extra_damping)
    if pd_targets is not None:
        pd_unit = _make_llc_unit(model, config, substep, constraints, extra_damping,
                                 pd_mode=True)

        def pd_control_step(q, qd, action, scene: Scene, grab_active=None, grab_target=None):
            return pd_unit(q, qd, pd_targets(action), scene, grab_active, grab_target)

        return pd_control_step

    if actuation is None:
        actuation = lambda q, qd, a: a  # noqa: E731 - raw joint torques
    llc_unit = _make_llc_unit(model, config, substep, constraints, extra_damping)

    def control_step(q, qd, action, scene: Scene, grab_active=None, grab_target=None):
        info = None
        for _ in range(config.llc_frames):
            q, qd, info = llc_unit(q, qd, actuation(q, qd, action), scene, grab_active,
                                   grab_target)
        return q, qd, info

    return control_step
