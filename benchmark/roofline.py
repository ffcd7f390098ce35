"""The benchmark's frozen count of K1's work, and the card's published peaks.

A frozen copy of the port's ``ops/cuda/engine.py`` count (``k1_activity``,
``k1_flops``, ``_row_table``, ``_solver_ops``, ``k1_bytes_per_env``), cut to
what the benchmark's configurations run: the plane, torque or PD mode, the
point-to-point rods, the four PGS options, no split impulse. It runs over
the reference's plain physics, so a change to the program cannot move its
own yardstick. The count is of the work the step's inputs need: a row is
counted only where it is active, as the warp-per-env kernel skips the
others. ``benchmark/tests/test_roofline.py`` holds it equal to the port's
count on the same masks.
"""

from __future__ import annotations

import torch

from benchmark.reference.kinematics import forward_kinematics, joint_q
from benchmark.reference.step import limited_joints, make_substep

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_FP32 = 67e12      # operations / s outside the tensor cores
PEAK_BYTES = 3.35e12   # HBM3 bytes / s


def k1_activity(model, config, constraints, pd_mode: bool, q, qd, tau, ground_z, friction,
                extra_damping=None):
    """Which rows each substep of one launch unit needs, on these inputs:
    limit rows within the limit margin and spheres within the contact
    margin, at each substep's start state, from the reference's plain run
    of the unit (rods are always active). Returns bool masks ``(limits
    (S,B,nlim), contacts (S,B,ns))`` over the S = llc frames × substeps of
    the unit (PD mode: the whole control step; torque mode: one frame)."""
    substep = make_substep(model, config, constraints, extra_damping=extra_damping)
    lim = torch.as_tensor(limited_joints(model), dtype=torch.long, device=q.device)
    gain = model.actuated * model.kp
    lam = q.new_zeros(q.shape[0], substep.num_rows) if config.warm_start else None
    lim_act, con_act = [], []
    for _ in range(config.llc_frames if pd_mode else 1):
        tau_j = gain * (tau - joint_q(model, q)) if pd_mode else tau
        Minv0 = substep.minv_of(forward_kinematics(model, q, qd)) if config.reuse_factor else None
        for _ in range(config.sim_substeps):
            qj = joint_q(model, q)[:, lim]
            gap = torch.minimum(qj - model.limit_lo[lim], model.limit_hi[lim] - qj)
            lim_act.append(gap < config.limit_margin)
            q, qd, info, lam_out = substep(q, qd, tau_j, ground_z, friction,
                                           Minv_in=Minv0, lam_in=lam)
            lam = lam_out if config.warm_start else None
            con_act.append(info.contacts.active > 0.5)
    return torch.stack(lim_act), torch.stack(con_act)


def k1_flops(model, config, constraints, pd_mode: bool, lim_act, con_act) -> int:
    """fp32 operations one launch unit needs, summed over the batch, given
    the activity masks of :func:`k1_activity`; a multiply-add counts 2.

    Every substep needs FK, the narrowphase, RNEA, the free velocity and the
    integration; each llc frame needs CRBA and the Cholesky factor once
    (every substep without ``reuse_factor``). Only an active row needs its W
    = L⁻¹Jᵀ row and its share of the solve (:func:`_solver_ops`); the
    impulse map runs only where some row is active. A contact's Jacobian
    takes a cross product per ancestor joint of its sphere's link. PD mode
    adds the torque per llc frame. A rod is needed every substep: its two
    anchors to the world frame, two point Jacobians over the anchors'
    ancestor joints, their difference, three dense W rows with their
    targets."""
    nl, nj, nv, ns = model.nl, model.nj, model.nv, model.ns
    lim = limited_joints(model)
    anc = model.anc.cpu().numpy() > 0.5
    S, B = con_act.shape[:2]
    frames = S // config.sim_substeps
    # FK: 2 qmul (28 each) + 2 qrot (30 each) + sincos (~20) + 9 per joint;
    # per link qmat (24) + COM (18) + R I Rᵀ (90)
    fk = (nl - 1) * (2 * 28 + 2 * 30 + 20 + 9) + nl * (24 + 18 + 90)
    collide = ns * (15 + 3)
    # RNEA: forward (3 crosses + 6 adds), per-link wrench (4 crosses, 2
    # matvecs, 12 mul/adds), backward (1 cross + 9 adds), joint dots
    rnea = (nl - 1) * (4 * 9 + 9) + nl * (4 * 9 + 2 * 15 + 12) + (nl - 1) * (9 + 6) + nj * 5
    free_vel = 2 * nv * nv + nj * 6 + nv * 2
    # every row's gap / sign / depth test and target, the velocity clamp and
    # the integration
    rows = len(lim) * 12 + ns * 10
    integ = 2 * nv + 40 + nj * 6
    per_sub = fk + collide + rnea + free_vel + rows + integ
    # CRBA: per-link composite (~40), up-sweep (13), momentum per base axis
    # and joint (~39) plus one pair (11) per stored nonzero of M
    pairs = 21 + nj * 7 + int(sum(anc[j + 1, :j].sum() for j in range(nj)))
    crba = nl * 40 + (nl - 1) * 13 + (6 + nj) * 39 + pairs * 11
    chol = sum((nv - j) * 2 * j for j in range(nv)) + nv * 4
    factors = frames if config.reuse_factor else S
    # per active limit row: its W row, a forward solve from its column
    span = torch.tensor([nv - (6 + j) for j in lim], dtype=torch.float64)
    # per active contact: Jacobian over the ancestor joints, three W rows
    # (dense forward solve and c)
    n_anc = torch.tensor(anc[model.sph_link.cpu().numpy()].sum(axis=1), dtype=torch.float64)
    con_row = n_anc * 12 + 9 + 3 * (nv * nv + 2 * nv)
    la, ca = lim_act.cpu().double(), con_act.cpu().double()
    total = S * B * per_sub + factors * B * (crba + chol)
    total += float((la * span * span).sum() + (ca * con_row).sum())
    any_act = lim_act.cpu().any(dim=2) | con_act.cpu().any(dim=2)
    total += float(any_act.sum()) * (nv * nv)
    if pd_mode:
        total += frames * B * nj * 3
    eq_sub = 0.0
    for la_, lb_ in zip(constraints.p2p_link_a, constraints.p2p_link_b):
        eq_sub += 2 * 18 + (anc[la_].sum() + anc[lb_].sum()) * 12 + 2 * 9 + 3 * nv
        eq_sub += 3 * (nv * nv + 2 * nv + 6)
    total += B * S * eq_sub
    total += _solver_ops(model, config, constraints, la, ca)
    return int(round(total))


def _row_table(model, constraints, la, ca):
    """Every row of one unit in the kernel's order [rods | limits | contacts
    × (n, t1, t2)]: its activity per substep and env ``(S, B, NR)`` and its
    span, the columns from its first nonzero to nv ``(NR,)``; and the slices
    of the limit rows and the contacts' normal rows."""
    nv = model.nv
    S, B = ca.shape[:2]
    acts = [torch.ones((S, B, 3 * constraints.num_p2p), dtype=torch.float64)]
    spans = [nv] * (3 * constraints.num_p2p)
    acts += [la, ca.repeat_interleave(3, dim=2)]
    spans += [nv - (6 + j) for j in limited_joints(model)] + [nv] * (3 * model.ns)
    ne, nlim = constraints.ne, la.shape[2]
    normals = torch.arange(ne + nlim, ne + nlim + 3 * model.ns, 3)
    return (torch.cat(acts, dim=2), torch.tensor(spans, dtype=torch.float64),
            torch.arange(ne, ne + nlim), normals)


def _solver_ops(model, config, constraints, la, ca) -> float:
    """fp32 operations of the PGS of one unit over the active rows: the
    diagonals (and the contacts' 2×2 friction blocks), ``solver_iters``
    sweeps and the warm start from the substep before. Matrix-free: a row's
    diagonal is a dot over its span; a sweep visits it with a residual and an
    update of z = Wλ over its span (4·span + 6; a block friction pair 8·nv +
    16 with its 2×2 step); a warm start adds Wλ over its span. A-form: A =
    WWᵀ + cfm·I over the active rows, a visit updates the residual of the n
    active rows (2·n + 6; a block pair 4·n + 16), a warm start adds A's
    column over the active rows, z = Wλ is made once after the sweeps."""
    nv, iters = model.nv, config.solver_iters
    act, span, _, normals = _row_table(model, constraints, la, ca)
    tangents = torch.cat([normals + 1, normals + 2])
    unit = torch.ones(act.shape[2], dtype=torch.bool)     # rows swept alone
    unit[tangents] = not config.block_pgs
    unit[normals] = True
    carried = act[1:] * act[:-1]                          # warm-started rows
    n_con = float(ca.sum())
    total = 0.0
    if config.matfree_pgs:
        total += float((act * 2 * span).sum())
        if config.block_pgs:
            total += n_con * (2 * nv + 8)
        total += iters * float((act[..., unit] * (4 * span[unit] + 6)).sum())
        if config.block_pgs:
            total += iters * n_con * (8 * nv + 16)
        if config.warm_start:
            total += float((carried * 2 * span).sum())
        return total
    n = act.sum(dim=2)                                    # active rows (S, B)
    shorter = torch.minimum(span[:, None], span[None, :])
    pairs = torch.triu(2 * shorter) + torch.eye(len(span), dtype=torch.float64)
    total += float(torch.einsum("sbi,ij,sbj->", act, pairs, act))
    if config.block_pgs:
        total += n_con * 8
    total += iters * float((act[..., unit] * (2 * n[..., None] + 6)).sum())
    if config.block_pgs:
        total += iters * float((ca * (4 * n[..., None] + 16)).sum())
    if config.warm_start:
        total += float((carried.sum(dim=2) * 2 * n[1:]).sum())
    total += float((act * 2 * span).sum())
    return total


def k1_bytes_per_env(model) -> int:
    """Bytes one env of one unit must move over the plane: each input read
    once (q, qd, tau, ground_z, friction), each output written once (q',
    qd', depth, normal impulse)."""
    inputs = model.nq + model.nv + model.nj + 2
    outputs = model.nq + model.nv + 2 * model.ns
    return 4 * (inputs + outputs)


def bound_ms(flops: float, nbytes: float) -> tuple:
    """The least time the card could take for this work (ms), and what
    bounds it: ``operations`` or ``bytes``."""
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
