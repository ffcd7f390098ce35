// The fused rigid-body engine kernel redesigned for Hopper (sm_90a), one warp
// per env, for the keys the busiest families launch:
//
//   K1a  Walker3D / Child3D on the plane in torque mode at the shipped solver
//        options, one llc frame per call;
//   K1b  Walker3D / Child3D on the plane in PD mode (the PD walker and the PD
//        child): the whole control step per call, one llc frame, the torque
//        gain·(target − q) formed at the frame's start, the derivative gain
//        folded into the table's damping and implicit diagonal;
//   K1f  Walker3D over a PHF × PHF heightfield window per env, torque mode
//        (the terrain walker and the LIDAR walker): the scene has no plane
//        (its height sunk to -1e9), each contact has its own normal;
//   K1c  Walker3D over K oriented stone boxes per env, torque mode (the
//        stepping-stone env, ALLSTEPS), each contact with its own normal;
//   K1g  Walker3D over KT triangle-mesh faces per env, torque mode (the
//        stairs), each contact with its own normal;
//   K1e  Cassie and Cassie2D: PD mode, the whole control step per call (10
//        llc frames × 2 substeps, the torque gain·(target − q) refreshed at
//        each frame's start), the two achilles rods as point-to-point
//        equality rows and, for Cassie2D, the planar lock of base y, roll and
//        yaw in front of the others; and Walker2D / Crab2D: torque mode, one
//        llc frame per call, the planar lock alone;
//   K1h-e, K1h-e2d  the same two keys with split impulse (the training CLI's
//        --split-impulse): the push-out bias out of the velocity rows and
//        the position pass after the velocity sweeps;
//   K1h-g, K1h-f  K1g's and K1f's keys with split impulse: the same pass
//        over the contacts' own normals (mesh faces, heightfield window);
//   K1h-c, K1h-b  K1c's and K1b's keys with split impulse: the pass over the
//        stones' own normals, and in PD mode;
//   K1h-si  K1a's key with split impulse: the pass over the plane's
//        constant-folded contact rows;
//   K1d  Monkey3D: torque mode over KB bar capsules per env, each contact
//        with its own normal, and NGRAB maskable grab rows (a palm point
//        pulled onto its target while the grab is attached);
//   K1h-d  K1d's key with split impulse: the position pass behind the
//        attached grabs' rows;
//   the planar K1h-e  the planar walkers' K1e key with split impulse: the
//        position pass behind the lock's 3 rows;
//   the K1h A-form  K1h-si's key in the A-form (matfree_pgs off, Cfg::
//        MATFREE false): A = WWᵀ + cfm·I over the active rows, the residual
//        carried instead of z = Wλ;
//   the K1 A-form  K1a's key in the A-form, and the all-off key: the A-form
//        with scalar friction rows, λ from zero in every substep and a
//        factor in every substep (block_pgs, warm_start, reuse_factor off:
//        Cfg::BLOCK, WARM, REUSE false);
//   K1 scalar, K1 refactor  K1a's key in the matrix-free form with scalar
//        friction rows (block_pgs off: a contact's t1 then t2 row, each
//        clamped alone, a butterfly each), and with a CRBA and factor in
//        every substep (reuse_factor off), each K1a's shape;
//   K1 cold  K1a's key with a cold start (warm_start off: Cfg::WARM false);
//   and any other key this source holds (PD mode or one llc frame per
//        call, and one env beside the model table in an SM's shared memory:
//        other substeps and sweeps, model sizes past 32 velocity DOFs too,
//        windows, option mixes, PD keys of several llc frames, and any mix
//        of a heightfield, stones, a mesh and bars beside PD mode, equality
//        rows and extra damping, as the TPU kernel composes them), as one
//        instance built from -DK1W_* flags (K1W_NAME and the Cfg arguments;
//        ops/cuda/engine.py::warp_instance picks its launch shape: as many
//        envs per block as an SM's shared memory holds, one block per SM).
//        A key whose env fits no SM runs its engine_k1.cu instance
//        (ops/cuda/engine.py::instance_for).
//
// Replaces the TPU kernel mocca_envs_tpu/ops/pallas/engine.py::
// make_pallas_substep (pallas_call at :1441) for those configurations (with
// pd_mode, hf_patch, num_stones, num_tris, num_bars, constraints= and
// split_impulse there: :1276-1352, :371-377, :458-509, :363-375, :511-549,
// :378-382, :551-616, :618-651, :280-290, :341, :858-894; split impulse
// :898-932, :1077-1111, :1236-1262; the A-form :1112-1235; block_pgs :301,
// :996, :1035, :1138, :1174; warm_start :303, :976-981, :1295; reuse_factor
// :711, :1288). It computes what
// engine_k1.cu's thread-per-env
// instances of the same keys compute, the same iteration with some sums in
// another order; those instances stay built for comparison
// (ops/cuda/engine.py, thread_per_env=True), and every other key keeps its
// engine_k1.cu instance.
//
// Each llc frame runs NSUB substeps of: FK along the quaternion chain →
// every sphere vs the plane [and vs the heightfield window, the stones, the
// mesh faces or the bars] → the rods' and the grabs' anchors → Newton–Euler
// bias → [substep 0 (every substep without REUSE): CRBA about the base +
// Cholesky] → free velocity → rows [rods × 3 | planar × 3 | grabs × 3 |
// joint limits | contacts × (n, t1, t2)] → W = L⁻¹Jᵀ per active row →
// matrix-free (or A-form) block (or scalar) PGS, λ warm-started across the
// call's substeps (or from zero in each), the equality rows unclamped →
// [split impulse: the position pass] → qd' = v_free + L⁻ᵀ(Wλ) →
// semi-implicit integrate + limit backstop.
//
// What bounds it. Near contact a K1a call needs ~1.6e5 fp32 operations per
// env against 0.65 KB of inputs and outputs (K1b the same and the torque;
// K1f ~2.8e3 more for the window's narrowphase and the contacts' own normals
// against 1.7 KB, the window 1 KB of it; K1c ~1.5e4 more for the six
// stones' box tests against 0.9 KB; K1g ~7e4 more for the 896 sphere-face
// walks against 1.3 KB; K1h-si ~1.5e4 more for the position pass), a K1e
// call on Cassie ~6.3e5 (its 20 substeps and 10 factors) against 0.47 KB, a
// K1d call on the hanging monkey ~5.9e4 against 0.9 KB (the 16 bars 0.5 KB
// of it) (ops/cuda/engine.py::k1_flops), so the floor is the fp32 rate:
// ~0.01 ms (K1a, K1b, K1f, K1c, K1g, K1h-si), ~0.04 ms (K1e), ~0.004 ms
// (K1d) at B = 4096. The thread-per-env design ran 300–900× above it:
// one warp of 32 envs per block left the SMs under one warp each at B =
// 4096, its 255 registers spilled a 6–8 KB frame, the factor, W (NR × NV),
// λ and z = Wλ round-tripped through a global (C, B) workspace on every row
// visit, and every row was solved and visited whether or not it was active.
// On an H100 at B = 4096 this design runs K1a ~49× above the bound, K1b ~50×
// and K1f ~58×, each ~16× faster than that one, and K1e ~43× above it, ~7×
// faster; with split impulse (the position pass, ~6% more operations) K1h-e
// and K1h-e2d run ~48× above theirs, ~6.7× faster, K1h-g ~48× and K1h-f
// ~67×, ~12.5× and ~13× faster, K1h-c ~57× and K1h-b ~54×, ~13× and ~14×
// faster, K1h-si ~54× and K1d ~59×, ~14× and ~6.5× faster, K1h-d ~68× and
// the planar K1e ~70×, ~5.9× and ~3.5× faster, the planar K1h-e ~83×, ~3.2×
// faster, the split A-form ~78× (against K1h-si's count), ~58× faster
// than its thread-per-env twin and 1.46× K1h-si's time, the A-form ~73×
// (against K1a's count), ~48× faster and 1.49× K1a's time, the all-off
// key ~82× (against its matrix-free form's count), ~41× faster, scalar
// friction ~52×, ~16× faster and 1.04× K1a's time, and a factor every
// substep ~49×, ~13× faster and 1.21× K1a's time (PERF.md §6). The
// monkey's NV = 16 leaves half the lanes idle in the DOF loops, the planar
// walkers' NV = 12 twenty of 32. Past 32 DOFs each DOF loop takes two
// slots a lane: a 35-DOF humanoid runs ~66× its bound at 12 envs per SM,
// ~16× faster than its thread-per-env twin, a 64-DOF rig ~95× at 3 envs
// per SM (59 KB an env), ~30× faster (PERF.md §6, "K1 wide").
//
// Design.
//   - One warp per env, C::ENVS warps per block, registers for C::BLOCKS
//     blocks per SM (the __launch_bounds__ minimum; shared memory may hold
//     fewer). Every branch on an env's data (a row's kind and activity, a
//     contact) is warp-uniform.
//   - Nothing per env in global memory: the state, the link kinematics, the
//     factor L (packed lower), W (NR rows of stride WS, NV rounded up to an
//     odd count, so that the 32 rows the lanes solve side by side fall in 32
//     banks, and a DOF vector's two lane slots read rows of consecutive
//     words), λ, c, the diagonals and the activity sit in one EnvW of dynamic
//     shared memory; the Newton–Euler and CRBA scratch share W's space, which
//     is written after them. The global workspace is empty (ws_per_env 0);
//     the model table is staged once per block.
//   - Occupancy. A Cassie env holds 6,232 bytes (Cassie2D 6,568): its link
//     kinematics (quaternions, ω, COMs, the bias) share W's space too, since
//     they are dead once W is written, so that 32 envs fit in one block of
//     1,024 threads and 214 KB, at 64 registers a thread: B = 4096 runs in
//     one wave on 132 SMs. (On an H100 at B = 4096 the same 32 envs per SM
//     as 4 blocks of 8 ran 10–15% slower, 24 per SM as 3 blocks of 8 at
//     68–72 registers ~40%: k1w_launch_shapes.py.)
//     The walker's EnvW keeps its 12,000 bytes, 4 envs per block, 4 blocks
//     (16 envs) per SM; K1b's adds the 84 bytes of its targets, K1f's the
//     per-sphere normals (168) and where its window lies (24), K1c's the
//     normals and its six stones (264), K1g's the normals and its 16 faces
//     (640, 56,240 bytes a block): 4 blocks of 4 still fit in the SM's
//     233,472 bytes with each block's 1 KB reserve. K1f's registers are
//     sized for 8 blocks: 63, no spill, where sized for 4 it took 95 and ran
//     no faster; blocks of 8 or 16 envs, at the same 16 per SM, ran within 2%
//     of these (k1w_launch_shapes.py). K1c and K1g take the same shape, and
//     K1h-f (EnvW 12,472: split impulse's 280 bytes; 61 registers). K1h-g's
//     13,088 bytes would take four blocks of 4 to 4 × (57,360 + 1,024) =
//     233,536, 64 over the SM: at 3 blocks (12 envs per SM) it ran 23%
//     slower at B = 4096; as one block of 16 envs (214,416 bytes, registers
//     for one block: 92, no spill) it ran fastest, two blocks of 8 3% slower.
//     K1h-c (EnvW 12,712) and K1h-b (12,364) would fit four blocks of 4
//     (4 × (55,856 + 1,024) = 227,520 bytes for K1h-c), but as one block of
//     16 envs (208,400 / 202,832 bytes, registers for one block: 92 / 56, no
//     spill) they ran 3.0% / 3.7% faster at B = 4096 than at K1c's 4 × 8
//     and K1b's 4 × 4, 4.7% / 4.0% at 16,384; two blocks of 8 fell between.
//     K1h-si (EnvW 12,280) likewise: one block of 16 (201,488 bytes, 64
//     registers) 3.2% / 4.2% faster than K1a's 4 × 4. The monkey's EnvW
//     (4,928 bytes, its bars and grab state in empty bases) takes 32 envs
//     in one block of 1,024 threads, 159,712 bytes, 64 registers: B = 4096
//     in one wave on 132 SMs; two blocks of 16 or four of 8 ran 7% / 11%
//     slower. Its link kinematics stay out of W's space: it fits without.
//     K1h-d (5,032 bytes: bpos and λ_pos of 13 rows; 163,040 a block, 63
//     registers) and the planar walkers' K1e (2,564 bytes, its kinematics
//     in W's space; 83,216 a block, 58 registers: registers, not shared
//     memory, hold it to one block per SM) and its split twin, the planar
//     K1h-e (2,652 bytes; 86,032 a block, 58 registers), take the same one
//     block of 32; two of 16 or four of 8 ran 2–10% slower
//     (k1w_launch_shapes.py). The split A-form's EnvW holds A as its
//     packed lower triangle (2,016 floats): 20,344 bytes, 11 envs in one
//     block of 352 threads (228,792 bytes, 108 registers); in full rows of
//     stride 63 (28,156 bytes) the SM held 8, which ran 17% slower on an
//     H100 at B = 4096 (PERF.md §6). The A-form and the all-off key take
//     the same A without the split state: 20,064 bytes, 11 envs in one
//     block (225,712 bytes, 107 / 108 registers); one block of 8 or two of
//     5 ran 21–29% slower at B = 4096 (k1w_launch_shapes.py). Scalar
//     friction and a factor every substep keep K1a's EnvW and run as one
//     block of 16 (197,008 bytes; 64 / 96 registers): four blocks of 4 ran
//     1% / 7.5% slower at B = 4096.
//   - Lanes: link i for the FK, the Newton–Euler passes and the CRBA
//     composites, one tree level at a time (depth 6 for the walker, 7 for
//     Cassie; a parent sums its children in the order the serial code does);
//     sphere s for the narrowphase and the contact activity; anchor k for the
//     rods; row r of the factor's trailing update (right-looking, the same
//     subtractions in the same order as the left-looking code; REGCHOL:
//     row r in the lane's registers, the pivot column by shuffles, no
//     barrier per pivot, 12% off the refactor key); DOF j for the
//     free velocity, the PD torque, z = Wλ and q̇, the triangular solves
//     column by column with the pivot broadcast by a shuffle; one active row
//     per lane for J_r, W_r = L⁻¹J_rᵀ (a forward solve, L read as a
//     broadcast), c_r and the diagonal. Where the launch shape leaves a
//     thread 128 registers (K1a, K1b, the instances of one block of 16 envs,
//     the A-forms; not REGCHOL's) the row is built and solved in the lane's
//     registers and stored into W once: K1a 124 registers, no spill, 11–12%
//     faster than the row built and solved in place in its row of W, which
//     the other instances keep (in registers they spilled at 64 and 96 a
//     thread).
//   - Past 32 of anything, lane ℓ takes items ℓ, ℓ + 32, ... in turn: links
//     (one tree level spans both slots; a link's parent sits a level above,
//     so the order within a level does not matter), spheres, limit rows,
//     active rows (the ballot lists them 32 at a time) and DOFs. A DOF
//     vector is NVL = ⌈NV / 32⌉ floats per lane (DOF j in slot j / 32 of
//     lane j % 32): a pivot is read from its slot by a select, not an
//     index, so that the slots stay in registers, and a row's dot with z
//     sums the lane's slots in slot order before the butterfly. All of it
//     stays in one warp (no named barrier), and an instance with NV <= 32
//     (NVL = 1) compiles as before. REGCHOL holds NVL rows of NV floats per
//     lane: 128 registers at NV = 64, so a generic key sets it only up to
//     NV = 32. One warp per env against two: two would halve the DOF loops'
//     serial depth but put a barrier in every triangular solve and PGS visit
//     (PERF.md §6, "K1 wide").
//   - Inactive rows are skipped: the active rows are listed once per substep
//     (a ballot per 32 rows; the equality rows always, first) and only they
//     get a W solve, a diagonal, a 2×2 friction inverse and a visit. Under
//     warm start an inactive row's λ is masked to 0 and its update would be 0
//     (a contact's friction bound is μ·λ_n = 0), so the iteration is the same.
//   - A PGS row visit is one warp reduction: lane j forms W[r][j]·z_j, a
//     __shfl_xor_sync butterfly sums them (every lane ends with the same
//     bits), the λ update is warp-uniform (unclamped for an equality row,
//     clamped at 0 for a limit or a contact normal) and lane j then adds
//     W[r][j]·Δλ to z_j. A contact's friction pair sums its two residuals in
//     one butterfly.
//   - The A-form (Cfg::MATFREE false), as engine_k1.cu's and the JAX
//     A-form: once the active rows' W is solved, A(t1, t2) = W_r1·W_r2 (+
//     cfm on the diagonal) over the list positions t of the active rows,
//     each dot over j in engine_k1.cu's order; lane ℓ keeps the W rows of
//     positions ℓ and ℓ + 32 in registers and forms their columns of A
//     against each row broadcast in turn. A sits in the env's shared memory
//     as its packed lower triangle. The residual c + Aλ is lane-owned
//     (positions ℓ, ℓ + 32), started under warm start from the masked λ in
//     the serial order; a visit takes its row's residual from its lane by
//     one shuffle, updates λ as the matrix-free visit does, and each lane
//     moves its own residuals by A's row t (the triangle's row t up to the
//     diagonal, contiguous, then its column t). z = Wλ is formed once after
//     the sweeps. The position pass starts its residual at −bpos on the
//     limit and contact-normal rows (0 elsewhere), visits them as the
//     sweeps do and forms z_pos = Wλ_pos once at its end. Without BLOCK a
//     contact's t1 and t2 rows are visited one after the other, each
//     clamped to ±μ·λ_n and moving the residuals by its own row of A (the
//     A-form) or z by its own W row (the matrix-free form: t2's butterfly
//     reads z after t1's move, as engine_k1.cu's loop); no 2×2 inverse is
//     formed; without WARM every λ starts each substep at
//     0, so the residual starts at c; without REUSE the CRBA and the factor
//     run in every substep.
//
// Heightfield narrowphase (K1f), as engine_k1.cu's and the plain version's
// (terrain/scene.py::hf_corners, hf_sample, hf_normal): one sphere per lane;
// the cell of the center's xy clamped to [0, PHF − 1.001], the four corner
// heights read by index from the env's row of the (B, PHF·PHF + 3) input in
// global memory through the read-only path, the bilinear height, its
// gradient, the normal (−∂h/∂x, −∂h/∂y, 1) divided by its norm, the depth
// r − (c_z − h)·n_z; it replaces the plane only where strictly deeper. The
// window is not staged in shared memory: 1,036 bytes per env would take the
// SM to 3 blocks of 4 (12 envs), and the four reads per sphere and substep
// come from L1 / L2 (the windows of B = 4096 envs take 4.2 MB).
//
// Stone narrowphase (K1c), as engine_k1.cu's: one sphere per lane over the
// env's stones in index order; the center in the box frame, outside where its
// distance to the box is above 1e-9 (the closest point), else out through
// the nearest face (the first of equally near faces); the deepest active
// stone wins (the first of equals) and replaces the plane only where strictly
// deeper, its normal and point turned back to the world frame. Mesh
// narrowphase (K1g), as engine_k1.cu's: one sphere per lane over the env's
// faces in index order, the closest point by Ericson's region walk
// (k1_common.cuh::closest_on_triangle), the deepest active face (the first
// of equals), its normal the offset over the distance or, for a center on
// the face (distance ≤ 1e-9), the face normal turned to the center's side;
// it replaces the plane only where strictly deeper. Both scenes are staged
// in the env's shared memory once per call (66 and 160 floats), read by the
// lanes as broadcasts: the caller packs them once per control step and they
// are constant over the call's substeps.
//
// Bar narrowphase (K1d), as engine_k1.cu's and the plain version's
// (terrain/scene.py::sphere_capsule_depth): the closest point on each bar's
// axis (the segment parameter clamped to [0, 1], its denominator guarded at
// 1e-12), the plain norm of the offset, the depth r_s + r_b − distance; of
// equally deep active bars the first wins; spheres the table marks no_bar
// (the grabbing palms, which wrap the bar they hold) skip the bars; the
// deepest bar replaces the plane only where strictly deeper, its normal the
// offset over the distance (+z for a center on the axis, distance ≤ 1e-9),
// its point on the bar's surface. The 80 sphere-bar pairs of the monkey are
// spread over the lanes: each sphere's center is written to a scratch in the
// Newton–Euler pass's space, each lane takes its pairs'
// depths, and each sphere's lane then picks its deepest active bar in index
// order (the first of equals, as the serial loop) and takes its point and
// normal again from the same function, so the bits are the serial loop's.
// One sphere per lane over the 16 bars, as K1c over its stones, left 27
// lanes idle and ran 7% slower (k1w_launch_shapes.py monkey). The bars are
// staged in the env's shared memory once per call (128 floats).
//
// Several geometries in one instance (any mix of a window, stones, faces and
// bars beside PD mode, equality rows and extra damping: ops/cuda/engine.py's
// K1x), as the TPU kernel composes them: each sphere's contact is merged in
// ops/collide.py's order, the plane, the heightfield, the stones, the faces,
// the bars, each geometry taking it only where strictly deeper than the one
// so far; the normal is set to the plane's +z once, by the instance's first
// geometry (Cfg::FIRST_K, FIRST_KT, FIRST_KB), so that a later geometry with
// a shallower candidate leaves an earlier winner's normal alone. Each
// geometry's state sits in its own base of EnvW (HfState, StoneState,
// TriState, BarState), and the bars' center scratch in the Newton–Euler
// pass's space: the walker over a window, 6 stones and 16 faces holds
// 13,096 bytes, 17 envs in one block per SM.
//
// Contact rows. On the plane (+z) a contact's rows n, t1, t2 are rows z, x,
// y of its point Jacobian, constant-folded. Where a narrowphase sets a
// sphere's own normal (Cfg::GENERAL: the heightfield, stones, a mesh) they are n·Jc, t1·Jc,
// t2·Jc with the branchless tangent basis of ops/solver.py::tangent_basis,
// each entry the projection of the entry's three point-Jacobian components.
//
// Equality rows, as engine_k1.cu's. A rod's three rows are the difference of
// the point Jacobians of its two anchors (each over its link's ancestor
// joints), with the target −β·(xa − xb) clipped to ±max_push_vel; a planar row
// is the unit row on base column 1, 3 or 5 with the drift y, 2(wx+yz) or
// 2(wz+xy) (sine surrogates of roll and yaw) under the same clipped target.
// They are always active and swept first. The rods come in the packed table
// behind the ancestry: link a, link b, anchor a, anchor b per rod. A grab's
// three rows (behind the rods and the lock; link and palm anchor per grab
// in the table behind the rods, then the no_bar flag per sphere) are the
// point Jacobian of its palm's world anchor, the drift palm − target under
// the same clipped target. They are masked by the grab's activity, an input
// constant over the call: a grab's rows are listed where its activity is
// not 0 (the monkey's is 0 or 1), its λ is multiplied by it in the warm
// start and after each visit, and an unlisted row's λ stays 0, as the plain
// solver's mask makes it. The grabs' activity and targets are staged once
// per call, the palm anchors formed per substep, one grab per lane.
//
// Split impulse (Cfg::SPLIT), as engine_k1.cu's and the plain version's
// (ops/step.py): a limit row and a contact's normal row take the velocity
// target −max(−gap, 0)/dt (no approach past the surface) and keep their
// push-out b = min(β·max(viol − slop, 0), maxpush) aside in bpos (a
// contact's from its sphere's deepest feature). After the velocity sweeps,
// a scalar PGS from λ_pos = 0 in every substep of every llc frame, ITERS
// sweeps over the active limit rows and contact normal rows in the serial
// order (the JAX reference's static visit list: no rod, planar, grab or
// friction row), against −bpos with the same W, diagonals and activity.
// Each visit is one butterfly: res = cfm·λ_pos − b + W_r·z_pos, λ_pos' =
// max(0, λ_pos − res/diag_r), z_pos += W_r·Δλ_pos, z_pos lane-owned as z
// is. An inactive row is skipped: its λ_pos starts at 0 and its update is
// max(0, ·)·act = 0, so the iteration is the same. L⁻ᵀz_pos is the
// pseudo-velocity, added to the clamped velocity for the position advance
// alone (the base translation, the base rotation's ω and the joints); the
// limit backstop clamps the advanced joint and zeroes only the real
// outward velocity, and qd' is the real velocity. bpos and λ_pos sit in an
// empty base (SplitState), 168 bytes for Cassie, 280 for the walker. Where
// contacts have their own normals (Cfg::GENERAL) a contact's normal row is
// its n·Jc row and its bias comes from the sphere's deepest feature, so the
// pass pushes out along that normal (sideways off a riser; off a stone's
// side face). In PD mode the derivative gain's implicit damping sits on the
// factor's joint diagonal (the table's JDIAG), so the pass's W, diagonals
// and L⁻ᵀz_pos carry it as the velocity rows do.
//
// Host check. The per-env code is written against a lane width: loops run
// `for (j = lane; j < n; j += WIDTH)`, collectives go through wsum / wbcast /
// wballot / wsync, and a lane's share of a DOF-indexed vector is an array of
// (n + WIDTH − 1) / WIDTH floats. Compiled with the host compiler under
// K1W_HOST_CHECK, WIDTH is 1, lane 0 owns everything, the collectives are
// identities and the envs run as a plain loop: tests check this file's
// arithmetic there, and the card checks the split across lanes. With
// K1W_ONLY=<n> defined only the n-th instance is compiled, so that one
// compiler process per instance can build them side by side; with K1W_NAME
// defined, only the generic instance of the -DK1W_* flags. Each instance
// exports <sym>_env_bytes, sizeof(EnvW), which the host's pick of a generic
// launch shape is checked against.
//
// Interface (all f32, contiguous, row-major), as engine_k1.cu's:
//   q (B,NQ), qd (B,NV), tau (B,NJ) (PD: the joint targets), ground_z (B,),
//   friction (B,), hf (B, PHF·PHF + 3) for PHF > 0 (env b's heights
//   row-major, then the world x0, y0 of its corner cell and the cell size),
//   stones (K·11, B) for K > 0 and tris (KT·10, B) for KT > 0 (component-
//   major, as engine_k1.cu takes them), bars (KB·8, B) for KB > 0 and
//   grabs (NGRAB·4, B) for NGRAB > 0 (component-major: end a, end b, radius,
//   active per bar; active, target per grab; a null window, stones, tris,
//   bars or grabs where the instance reads it is refused)
//   → q' (B,NQ), qd' (B,NV), depth (B,NS), normal_impulse (B,NS) of the last
//   substep. <sym>_occupancy reports the blocks (and so the envs) resident
//   per SM.

#include "k1_common.cuh"

namespace k1w {

using namespace k1;

#ifdef K1W_HOST_CHECK
constexpr int WIDTH = 1;
inline float wsum(float x) { return x; }
inline void wsum2(float&, float&) {}
inline float wbcast(float x, int) { return x; }
inline unsigned wballot(bool p) { return p ? 1u : 0u; }
inline void wsync() {}
inline int popc(unsigned x) { return __builtin_popcount(x); }
#else
constexpr int WIDTH = 32;
constexpr unsigned kFull = 0xffffffffu;
__device__ __forceinline__ float wsum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}
__device__ __forceinline__ void wsum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
}
__device__ __forceinline__ float wbcast(float x, int src) { return __shfl_sync(kFull, x, src); }
__device__ __forceinline__ unsigned wballot(bool p) { return __ballot_sync(kFull, p); }
__device__ __forceinline__ void wsync() { __syncwarp(); }
__device__ __forceinline__ int popc(unsigned x) { return __popc(x); }
#endif

// The phases of the clocked kernel (k1w_kernel<C, true>, <sym>_launch_phases;
// <sym>_host_phases on the host), in ops/cuda/engine.py::PHASES's order:
//   io           the table into shared memory, the env's state and scene in,
//                and the results out
//   fk           FK along the chain, and the rods' and grabs' anchors
//   narrowphase  every sphere against the plane, window, stones, faces or bars
//   bias         the Newton–Euler bias; in PD mode also the frame's torque
//   factor       CRBA and Cholesky
//   rows         free velocity, the rows, and W = L⁻¹Jᵀ (the A-form: and A)
//   pgs          the sweeps, and the split position pass
//   integrate    qd' and the semi-implicit integration with its limit backstop
enum Phase : int { PH_IO, PH_FK, PH_NARROW, PH_BIAS, PH_FACTOR, PH_ROWS, PH_PGS, PH_INTEGRATE,
                   NPHASE };

// An env's phase clock in the clocked kernel. A stamp, made where the warp
// has converged, adds the cycles since the previous stamp to one phase and,
// where it closes a visit, one visit, so that consecutive stamps cover the
// warp's time from kernel entry to its last store. The call's counts stay in
// registers (a stamp's phase is a constant where it is inlined), 32 bits
// each; at the call's end lane 0 adds them into the env's NPHASE (cycles,
// visits) pairs of a global 64-bit buffer. (On an H100 a global atomic at
// each stamp cost the walker's K1a 3.0% and these registers 1.7%; another
// arrangement of the same counts, 2.4–3.0%: the clocked kernel's code is
// scheduled anew around its stamps.) On the card a stamp reads clock64();
// under K1W_HOST_CHECK a per-env counter that each stamp advances by one,
// so that a phase's cycles count the stamps that closed in it. The shipped
// kernel passes no clock: each stamp is a fold over an empty pack, and its
// code is what it was.
struct PhaseClock {
  unsigned long long* acc;    // the env's NPHASE (cycles, visits) pairs
  long long t0;               // the previous stamp
  int lane;
  unsigned cyc[NPHASE] = {};  // the call's cycles per phase
  unsigned vis[NPHASE] = {};  // and visits
  HD void stamp(int p, bool visit = true) {
    wsync();
#ifdef K1W_HOST_CHECK
    const long long t = t0 + 1;
#else
    const long long t = clock64();
#endif
    cyc[p] += (unsigned)(t - t0);
    if (visit) vis[p] += 1u;
    t0 = t;
  }
  // the call's counts into the env's pairs
  HD void flush() {
    if (lane == 0)
#pragma unroll
      for (int p = 0; p < NPHASE; ++p) {
#ifdef K1W_HOST_CHECK
        acc[2 * p] += cyc[p];
        acc[2 * p + 1] += vis[p];
#else
        atomicAdd(acc + 2 * p, (unsigned long long)cyc[p]);
        atomicAdd(acc + 2 * p + 1, (unsigned long long)vis[p]);
#endif
      }
  }
};

// One instance: the model's sizes, the substeps and sweeps, the actuation
// (PD: NLLC llc frames per call), the equality rows, the launch's envs
// (warps) per block and the blocks per SM its registers are sized for (at
// most 65,536 / (32 · ENVS · BLOCKS) a thread), the heightfield window's
// side, the stones and the mesh faces per env (0: none), split impulse, the
// bar capsules and the grabs per env (0: none), the PGS form (matrix-free,
// else the A-form) and the other PGS options, each false as engine_k1.cu's
// flag of the same name: BLOCK (else a contact's friction rows one at a time),
// WARM (else λ from zero every substep), REUSE (else a factor every substep);
// and REGCHOL, the Cholesky factor with each lane's rows in registers (the
// same arithmetic, no barrier per pivot).
template <int NL_, int NS_, int NLIM_, int NSUB_, int ITERS_, bool PD_, int NLLC_, int NP2P_,
          bool PLANAR_, int ENVS_, int BLOCKS_, int PHF_ = 0, int K_ = 0, int KT_ = 0,
          bool SPLIT_ = false, int KB_ = 0, int NGRAB_ = 0, bool MATFREE_ = true,
          bool BLOCK_ = true, bool WARM_ = true, bool REUSE_ = true, bool REGCHOL_ = false>
struct Cfg {
  static constexpr int NL = NL_, NS = NS_, NLIM = NLIM_, NSUB = NSUB_, ITERS = ITERS_;
  static constexpr bool PD = PD_, PLANAR = PLANAR_, SPLIT = SPLIT_, MATFREE = MATFREE_;
  static constexpr bool BLOCK = BLOCK_, WARM = WARM_, REUSE = REUSE_, REGCHOL = REGCHOL_;
  static constexpr int NLLC = NLLC_, NP2P = NP2P_, ENVS = ENVS_, BLOCKS = BLOCKS_, PHF = PHF_;
  static constexpr int K = K_, KT = KT_, KB = KB_, NGRAB = NGRAB_;
  using L = Layout<NL, NS, NLIM, NP2P, PLANAR, KB, NGRAB>;
  static constexpr int WS = L::NV | 1;   // W's row stride: odd
  // the A-form's A over the active-row list: its lower triangle packed row
  // after row
  static constexpr int ASIZE = MATFREE ? 0 : L::NR * (L::NR + 1) / 2;
  // the rod and planar instances hold the link kinematics in W's space
  // (Cassie's 32 envs per block need it); the monkey's EnvW fits 32 envs in
  // one block without it
  static constexpr bool KIN_IN_W = L::NE0 > 0;
  // each contact has its own normal (else the plane's +z)
  static constexpr bool GENERAL = PHF > 0 || K > 0 || KT > 0 || KB > 0;
  static_assert(PD || NLLC == 1, "torque mode is launched once per llc frame");
  // the first of the instance's geometries in the merge order (heightfield,
  // stones, mesh, bars), which resets each sphere's normal to the plane's
  static constexpr bool FIRST_K = PHF == 0, FIRST_KT = FIRST_K && K == 0;
  static constexpr bool FIRST_KB = FIRST_KT && KT == 0;
};

// component c of a × b
HD inline float cross_comp(const float* a, const float* b, int c) {
  return c == 0 ? a[1] * b[2] - a[2] * b[1]
                : c == 1 ? a[2] * b[0] - a[0] * b[2] : a[0] * b[1] - a[1] * b[0];
}

// R I Rᵀ of a link from its quaternion and its link-frame inertia
HD inline void world_inertia(const float* quat, const float* I, float* Iw) {
  float R[9], IRt[9];
  qmat(quat, R);
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      IRt[3 * a + b] = I[3 * a] * R[3 * b] + I[3 * a + 1] * R[3 * b + 1] + I[3 * a + 2] * R[3 * b + 2];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      Iw[3 * a + b] = R[3 * a] * IRt[b] + R[3 * a + 1] * IRt[3 + b] + R[3 * a + 2] * IRt[6 + b];
}

// Sphere (center c, radius rad) against bar br: its depth rad + r − |c −
// cl|, the closest point cl on the bar's axis and the offset dl = c − cl
// and its length, as engine_k1.cu's bar narrowphase computes them
HD inline float bar_depth(const float* br, const float* c, float rad, float* cl, float* dl,
                          float* dist) {
  const float ab[3] = {br[3] - br[0], br[4] - br[1], br[5] - br[2]};
  const float rel[3] = {c[0] - br[0], c[1] - br[1], c[2] - br[2]};
  const float tp = clampf(dot3(rel, ab) / fmaxf(dot3(ab, ab), 1e-12f), 0.0f, 1.0f);
  for (int a = 0; a < 3; ++a) cl[a] = br[a] + tp * ab[a];
  for (int a = 0; a < 3; ++a) dl[a] = c[a] - cl[a];
  *dist = sqrtf(dot3(dl, dl));
  return rad + br[6] - *dist;
}

// ... and sphere s's deepest bar bk (its depth best, closest axis point bc,
// offset bd of length bdist) replaces the plane where strictly deeper: the
// normal the offset over the distance (+z for a center on the axis), the
// point on the bar's surface
template <class E>
HD inline void take_bar(E& e, int s, int bk, float best, const float* bc, const float* bd,
                        float bdist) {
  if (!(bk >= 0 && best > e.depth[s])) return;
  const float rb = e.bar[bk][6];
  const float inv = 1.0f / fmaxf(bdist, 1e-9f);
  for (int a = 0; a < 3; ++a) {
    e.nrm[s][a] = bdist > 1e-9f ? bd[a] * inv : (a == 2 ? 1.0f : 0.0f);
    e.cpt[s][a] = bc[a] + e.nrm[s][a] * rb;
  }
  e.depth[s] = best;
}

// The link kinematics of a substep and the Newton–Euler bias: written by
// the FK and the Newton–Euler passes, read until the free velocity.
template <int NL, int NV>
struct Kin { float quat[NL][4], omega[NL][3], comw[NL][3], bias[NV]; };
template <bool ON, int NL, int NV>
struct KinIn : Kin<NL, NV> {};
template <int NL, int NV>
struct KinIn<false, NL, NV> {};
template <int NL>
struct NeScratch { float alpha[NL][3], acc[NL][3], f[NL][3], n[NL][3]; };
template <int NL>
struct CrbaScratch { float cm[NL], chv[NL][3], cI[NL][9]; };
// Empty bases where there are none, so that the walker's EnvW keeps its size:
// the PD targets, and the world anchors a, b of each rod.
template <bool PD, int NJ>
struct PdState { float target[NJ]; };
template <int NJ>
struct PdState<false, NJ> {};
template <int NP2P>
struct RodState { float anchor[NP2P][2][3]; };
template <>
struct RodState<0> {};
// ... each sphere's contact normal, which the narrowphase sets where
// contacts have their own normals
template <bool GENERAL, int NS>
struct NrmState { float nrm[NS][3]; };
template <int NS>
struct NrmState<false, NS> {};
// ... and where the env's heightfield window lies in global memory, the
// world x0, y0 of its corner cell and the cell size
template <int PHF>
struct HfState { const float* hp; float hx0, hy0, hcell; };
template <>
struct HfState<0> {};
// ... the env's stones and its mesh faces, staged from the packed inputs
// once per call (center, quaternion, half extents, active; vertices a, b,
// c, active)
template <int K>
struct StoneState { float stone[K][STONE_C]; };
template <>
struct StoneState<0> {};
template <int KT>
struct TriState { float tri[KT][TRI_C]; };
template <>
struct TriState<0> {};
// ... and split impulse's push-out bias and pseudo-impulse of the NP limit
// and contact-normal rows
template <bool SPLIT, int NP>
struct SplitState { float bpos[NP], lpos[NP]; };
template <int NP>
struct SplitState<false, NP> {};
// ... the env's bars (end a, end b, radius, active), staged once per call,
// and each grab's activity and target (constant over the call) and its palm
// anchor in the world frame (per substep)
template <int KB>
struct BarState { float bar[KB][BAR_C]; };
template <>
struct BarState<0> {};
template <int NGRAB>
struct GrabState { float gact[NGRAB], gtgt[NGRAB][3], gx[NGRAB][3]; };
template <>
struct GrabState<0> {};
// The bar narrowphase's pairs: each sphere's center, then the depth of each
// sphere-bar pair; written and read before the Newton–Euler pass, so they
// share its space
template <int NS, int KB>
struct BarScratch { float ctr[NS][3], dk[NS][KB]; };
template <int NS>
struct BarScratch<NS, 0> {};
// ... and the A-form's A = WWᵀ + cfm·I over the active rows, by list position
template <int ASIZE>
struct AformState { float A[ASIZE]; };
template <>
struct AformState<0> {};

// One env's state in shared memory.
template <class C>
struct EnvW : PdState<C::PD, C::L::NJ>, RodState<C::NP2P>, NrmState<C::GENERAL, C::NS>,
              HfState<C::PHF>, StoneState<C::K>, TriState<C::KT>,
              SplitState<C::SPLIT, C::NLIM + C::NS>, BarState<C::KB>, GrabState<C::NGRAB>,
              AformState<C::ASIZE>, KinIn<!C::KIN_IN_W, C::NL, C::L::NV> {
  using L = typename C::L;
  float q[L::NQ], qd[L::NV], tau[L::NJ];
  float ground, fric;
  float pos[C::NL][3], ja[L::NJ][3];
  float depth[C::NS], cpt[C::NS][3];
  float vfree[L::NV];
  float Lf[L::NLOW], dinv[L::NV];
  float lam[L::NR], c[L::NR], diag[L::NR], act[L::NR], finv[C::NS][3];
  int rows[L::NR];
  // what a substep writes before W and is done with by then: the link
  // kinematics (KIN_IN_W), the bar pairs, the Newton–Euler or the CRBA
  // scratch
  struct Pre : KinIn<C::KIN_IN_W, C::NL, L::NV> {
    union {
      BarScratch<C::NS, C::KB> bs;
      NeScratch<C::NL> ne;
      CrbaScratch<C::NL> cr;
    };
  };
  union {
    float W[L::NR * C::WS];
    Pre pre;
  } u;
  HD Kin<C::NL, L::NV>& kin() {
    if constexpr (C::KIN_IN_W) return u.pre;
    else return *this;
  }
};

// Where entry (t1, t2) of the A-form's A lies: in the packed lower
// triangle's row of the larger of the two (A is symmetric)
HD inline int aidx(int t1, int t2) {
  return t1 >= t2 ? t1 * (t1 + 1) / 2 + t2 : t2 * (t2 + 1) / 2 + t1;
}

// ... and its value (0 where the instance is matrix-free and keeps no A)
template <class C>
HD inline float aget(const EnvW<C>& e, int t1, int t2) {
  if constexpr (C::MATFREE) return 0.0f;
  else return e.A[aidx(t1, t2)];
}

// v[i] of a lane-owned array, selected without indexing registers
template <int N>
HD inline float owned(const float (&v)[N], int i) {
  float x = v[0];
  for (int k = 1; k < N; ++k) x = k == i ? v[k] : x;
  return x;
}

// entry i of a lane-owned vector (slot i / WIDTH of lane i % WIDTH), to
// every lane
template <int N>
HD inline float bcast_owned(const float (&v)[N], int i) {
  return wbcast(owned(v, i / WIDTH), i % WIDTH);
}

// f(0), f(1), …, f(N − 1) in order: the loop unrolled where UNROLL, so that f
// may index a register array by i
template <int N, bool UNROLL, class F>
HD inline void each(F&& f) {
  if constexpr (UNROLL) {
#pragma unroll
    for (int i = 0; i < N; ++i) f(i);
  } else {
    for (int i = 0; i < N; ++i) f(i);
  }
}

// The depth of each link in the tree (root 0) and the largest.
template <int NL>
HD inline int tree_depths(const float* parent, int* depth) {
  int most = 0;
  for (int l = 0; l < NL; ++l) {
    int d = 0;
    for (int p = l; p > 0; p = (int)parent[p]) ++d;
    depth[l] = d;
    most = d > most ? d : most;
  }
  return most;
}

template <class C, class... Ck>
HD void substep(EnvW<C>& e, const float* tab, const int* level, int maxd, int lane,
                bool factorize, Ck&... ck) {
  using L = typename C::L;
  constexpr int NL = C::NL, NS = C::NS, NLIM = C::NLIM, WS = C::WS;
  constexpr int NJ = L::NJ, NV = L::NV, NR = L::NR, NE = L::NE, NE0 = L::NE0;
  constexpr int NVL = (NV + WIDTH - 1) / WIDTH;   // a lane's share of a DOF vector
  // An active row of W is built and solved in the lane's registers where
  // one lane of the card holds a DOF vector (NV <= 32, NVL = 1 there; the
  // host check's one lane runs the same code) and the launch shape leaves a
  // thread 128 registers or more, 65,536 / (32 · ENVS · BLOCKS), with no
  // factor row held in registers beside it (REGCHOL); else in place in its
  // row of W. (On an H100 the row in registers took K1a to 124 registers
  // without a spill and 11–12% off its time; at 64 and 96 registers a thread,
  // and beside REGCHOL's row, it spilled in most instances: PERF.md §6.)
  constexpr int REG_BUDGET = 65536 / (32 * C::ENVS * C::BLOCKS);
  constexpr bool ROW_REGS = NV <= 32 && REG_BUDGET >= 128 && !C::REGCHOL;
  const float dt = tab[L::DT];
  auto& K = e.kin();
  auto Lx = [&](int i, int j) -> float& { return e.Lf[i * (i + 1) / 2 + j]; };  // i >= j

  // ---------------- FK, one tree level at a time, and each link's COM
  auto link_com = [&](int l) {
    float R[9], cw[3];
    qmat(K.quat[l], R);
    matvec3(R, tab + L::COM + 3 * l, cw);
    for (int k = 0; k < 3; ++k) K.comw[l][k] = e.pos[l][k] + cw[k];
  };
  if (lane == 0) {
    for (int k = 0; k < 3; ++k) { e.pos[0][k] = e.q[k]; K.omega[0][k] = e.qd[3 + k]; }
    for (int k = 0; k < 4; ++k) K.quat[0][k] = e.q[3 + k];
    link_com(0);
  }
  wsync();
  for (int d = 1; d <= maxd; ++d) {
    for (int i = lane; i < NL; i += WIDTH) {
      if (level[i] != d) continue;
      const int j = i - 1;
      const int p = (int)tab[L::PARENT + i];
      const float* axis = tab + L::JAXIS + 3 * j;
      float qpre[4], aw[3], off[3];
      qmul(K.quat[p], tab + L::JQUAT + 4 * j, qpre);
      qrot(qpre, axis, aw);
      qrot(K.quat[p], tab + L::JPOS + 3 * j, off);
      float sh, ch;
      sincosf_(e.q[7 + j] * 0.5f, &sh, &ch);
      const float dq[4] = {ch, axis[0] * sh, axis[1] * sh, axis[2] * sh};
      qmul(qpre, dq, K.quat[i]);
      for (int k = 0; k < 3; ++k) {
        e.pos[i][k] = e.pos[p][k] + off[k];
        K.omega[i][k] = K.omega[p][k] + aw[k] * e.qd[6 + j];
        e.ja[j][k] = aw[k];
      }
      link_com(i);
    }
    wsync();
  }
  (ck.stamp(PH_FK), ...);

  // ---------------- spheres vs the plane, then vs the heightfield window,
  // the stones, the mesh faces and the bars, in that order (ops/collide.py's):
  // the plane's normal +z is set once, by the instance's first geometry
  // before its test, and each geometry takes a sphere's contact (depth,
  // point, normal) only where it is strictly deeper than the one so far, so
  // that a later, shallower candidate leaves an earlier winner's normal alone
  for (int s = lane; s < NS; s += WIDTH) {
    const int l = (int)tab[L::SPHLINK + s];
    const float rad = tab[L::SPHR + s];
    float R[9], cw[3];
    qmat(K.quat[l], R);
    matvec3(R, tab + L::SPHPOS + 3 * s, cw);
    const float cx = e.pos[l][0] + cw[0], cy = e.pos[l][1] + cw[1], cz = e.pos[l][2] + cw[2];
    e.depth[s] = rad - (cz - e.ground);
    e.cpt[s][0] = cx; e.cpt[s][1] = cy; e.cpt[s][2] = e.ground;
    if constexpr (C::PHF > 0) {
      constexpr int P = C::PHF;
      const float umax = (float)(P - 1.001);
      const float u = clampf((cx - e.hx0) / e.hcell, 0.0f, umax);
      const float v = clampf((cy - e.hy0) / e.hcell, 0.0f, umax);
      const float fi = floorf(u), fj = floorf(v);
      const float fu = u - fi, fv = v - fj, gu = 1.0f - fu, gv = 1.0f - fv;
      const float* h0 = e.hp + (int)fi * P + (int)fj;
      const float h00 = ldg_(h0), h01 = ldg_(h0 + 1), h10 = ldg_(h0 + P), h11 = ldg_(h0 + P + 1);
      const float hgt = h00 * gu * gv + h10 * fu * gv + h01 * gu * fv + h11 * fu * fv;
      const float gx = -(((h10 - h00) * gv + (h11 - h01) * fv) / e.hcell);
      const float gy = -(((h01 - h00) * gu + (h11 - h10) * fu) / e.hcell);
      const float nn = sqrtf(gx * gx + gy * gy + 1.0f);
      const float nz = 1.0f / nn;
      const float dh = rad - (cz - hgt) * nz;
      e.nrm[s][0] = 0.0f; e.nrm[s][1] = 0.0f; e.nrm[s][2] = 1.0f;   // the plane's, once
      if (dh > e.depth[s]) {                    // strictly deeper than the plane
        e.depth[s] = dh;
        e.nrm[s][0] = gx / nn; e.nrm[s][1] = gy / nn; e.nrm[s][2] = nz;
        e.cpt[s][2] = hgt;
      }
    }
    if constexpr (C::K > 0) {
      // the deepest active stone (the first of equals), kept in its box frame
      float best = -1e9f, bn[3] = {0.0f, 0.0f, 1.0f}, bp[3] = {0.0f, 0.0f, 0.0f};
      int bk = -1;
#pragma unroll 1
      for (int k = 0; k < C::K; ++k) {
        const float* st = e.stone[k];
        if (!(st[10] > 0.5f)) continue;
        const float rel[3] = {cx - st[0], cy - st[1], cz - st[2]};
        const float qc[4] = {st[3], -st[4], -st[5], -st[6]};
        float d[3], closest[3], delta[3];
        qrot(qc, rel, d);                       // center in the box frame
        for (int a = 0; a < 3; ++a) {
          closest[a] = clampf(d[a], -st[7 + a], st[7 + a]);
          delta[a] = d[a] - closest[a];
        }
        const float dist = sqrtf(dot3(delta, delta));
        float dk, nl[3], sl[3];
        if (dist > 1e-9f) {                     // outside: closest point
          const float inv = 1.0f / fmaxf(dist, 1e-9f);
          dk = rad - dist;
          for (int a = 0; a < 3; ++a) { nl[a] = delta[a] * inv; sl[a] = closest[a]; }
        } else {                                // inside: out through the nearest face
          int kk = 0;
          float fmin = st[7] - fabsf(d[0]);
          for (int a = 1; a < 3; ++a) {
            const float fa = st[7 + a] - fabsf(d[a]);
            if (fa < fmin) { fmin = fa; kk = a; }
          }
          dk = rad + fmin;
          for (int a = 0; a < 3; ++a) {
            nl[a] = a == kk ? sgn0(d[a]) : 0.0f;
            sl[a] = d[a] + nl[a] * fmin;
          }
        }
        if (dk > best) {
          best = dk; bk = k;
          for (int a = 0; a < 3; ++a) { bn[a] = nl[a]; bp[a] = sl[a]; }
        }
      }
      if constexpr (C::FIRST_K) { e.nrm[s][0] = 0.0f; e.nrm[s][1] = 0.0f; e.nrm[s][2] = 1.0f; }
      if (bk >= 0 && best > e.depth[s]) {       // strictly deeper than what came before
        const float* st = e.stone[bk];
        float pw[3];
        qrot(st + 3, bn, e.nrm[s]);
        qrot(st + 3, bp, pw);
        e.depth[s] = best;
        for (int a = 0; a < 3; ++a) e.cpt[s][a] = st[a] + pw[a];
      }
    }
    if constexpr (C::KT > 0) {
      // the deepest active face (the first of equals): its closest point and
      // the offset from it to the center
      const float cc[3] = {cx, cy, cz};
      float best = -1e9f, bp[3] = {0.0f, 0.0f, 0.0f}, bd[3] = {0.0f, 0.0f, 0.0f}, bdist = 0.0f;
      int bk = -1;
#pragma unroll 1
      for (int k = 0; k < C::KT; ++k) {
        const float* f = e.tri[k];
        if (!(f[9] > 0.5f)) continue;
        float p[3], dl[3];
        closest_on_triangle(cc, f, f + 3, f + 6, p);
        for (int i = 0; i < 3; ++i) dl[i] = cc[i] - p[i];
        const float dist = sqrtf(dot3(dl, dl));
        const float dk = rad - dist;
        if (dk > best) {
          best = dk; bk = k; bdist = dist;
          for (int i = 0; i < 3; ++i) { bp[i] = p[i]; bd[i] = dl[i]; }
        }
      }
      if constexpr (C::FIRST_KT) { e.nrm[s][0] = 0.0f; e.nrm[s][1] = 0.0f; e.nrm[s][2] = 1.0f; }
      if (bk >= 0 && best > e.depth[s]) {       // strictly deeper than what came before
        if (bdist > 1e-9f) {
          const float inv = 1.0f / fmaxf(bdist, 1e-9f);
          for (int i = 0; i < 3; ++i) e.nrm[s][i] = bd[i] * inv;
        } else {                                // center on the face: its normal,
          const float* f = e.tri[bk];           // turned toward the center's side
          float ab[3], ac[3], ap[3], fn[3];
          for (int i = 0; i < 3; ++i) {
            ab[i] = f[3 + i] - f[i];
            ac[i] = f[6 + i] - f[i];
            ap[i] = cc[i] - f[i];
          }
          cross3(ab, ac, fn);
          const float fm = fmaxf(sqrtf(dot3(fn, fn)), 1e-12f);
          for (int i = 0; i < 3; ++i) fn[i] /= fm;
          const float side = dot3(ap, fn) >= 0.0f ? 1.0f : -1.0f;
          for (int i = 0; i < 3; ++i) e.nrm[s][i] = side * fn[i];
        }
        e.depth[s] = best;
        for (int i = 0; i < 3; ++i) e.cpt[s][i] = bp[i];
      }
    }
    if constexpr (C::KB > 0) {
      if constexpr (C::FIRST_KB) { e.nrm[s][0] = 0.0f; e.nrm[s][1] = 0.0f; e.nrm[s][2] = 1.0f; }
      e.u.pre.bs.ctr[s][0] = cx; e.u.pre.bs.ctr[s][1] = cy; e.u.pre.bs.ctr[s][2] = cz;
    }
  }
  if constexpr (C::KB > 0) {
    // the NS × KB sphere-bar pairs over the lanes, then each sphere's
    // deepest active bar (the first of equals) by its lane, in index order
    auto& bs = e.u.pre.bs;
    wsync();
    for (int p = lane; p < NS * C::KB; p += WIDTH) {
      const int s = p / C::KB, k = p % C::KB;
      float cl[3], dl[3], dist;
      bs.dk[s][k] = bar_depth(e.bar[k], bs.ctr[s], tab[L::SPHR + s], cl, dl, &dist);
    }
    wsync();
    for (int s = lane; s < NS; s += WIDTH) {
      if (tab[L::NOBAR + s] > 0.5f) continue;
      float best = -1e9f;
      int bk = -1;
      for (int k = 0; k < C::KB; ++k)
        if (e.bar[k][7] > 0.5f && bs.dk[s][k] > best) { best = bs.dk[s][k]; bk = k; }
      if (bk < 0) continue;
      float bc[3], bd[3], bdist;
      bar_depth(e.bar[bk], bs.ctr[s], tab[L::SPHR + s], bc, bd, &bdist);
      take_bar(e, s, bk, best, bc, bd, bdist);
    }
    wsync();   // the pairs' space is the Newton–Euler pass's next
  }
  (ck.stamp(PH_NARROW), ...);
  // ---------------- the rods' anchors in the world frame, one per lane
  if constexpr (C::NP2P > 0)
    for (int k = lane; k < 2 * C::NP2P; k += WIDTH) {
      const float* rod = tab + L::P2P + 8 * (k / 2);
      const int l = (int)rod[k % 2];
      float R[9];
      float* x = e.anchor[k / 2][k % 2];
      qmat(K.quat[l], R);
      matvec3(R, rod + 2 + 3 * (k % 2), x);
      for (int d = 0; d < 3; ++d) x[d] += e.pos[l][d];
    }
  // ---------------- each grab's palm anchor in the world frame, one per lane
  if constexpr (C::NGRAB > 0)
    for (int g = lane; g < C::NGRAB; g += WIDTH) {
      const float* gr = tab + L::GRAB + 4 * g;
      const int l = (int)gr[0];
      float R[9];
      qmat(K.quat[l], R);
      matvec3(R, gr + 1, e.gx[g]);
      for (int d = 0; d < 3; ++d) e.gx[g][d] += e.pos[l][d];
    }
  (ck.stamp(PH_FK, false), ...);

  // ---------------- Newton–Euler bias (q̈ = 0, base acceleration −g)
  {
    auto& ne = e.u.pre.ne;
    if (lane == 0)
      for (int k = 0; k < 3; ++k) { ne.alpha[0][k] = 0.0f; ne.acc[0][k] = -tab[L::GX + k]; }
    wsync();
    for (int d = 1; d <= maxd; ++d) {
      for (int i = lane; i < NL; i += WIDTH) {
        if (level[i] != d) continue;
        const int j = i - 1, p = (int)tab[L::PARENT + i];
        float r[3], t1[3], t2[3], t3[3], wq[3];
        for (int k = 0; k < 3; ++k) r[k] = e.pos[i][k] - e.pos[p][k];
        cross3(ne.alpha[p], r, t1);
        cross3(K.omega[p], r, t2);
        cross3(K.omega[p], t2, t3);
        for (int k = 0; k < 3; ++k) {
          ne.acc[i][k] = ne.acc[p][k] + (t1[k] + t3[k]);
          wq[k] = e.ja[j][k] * e.qd[6 + j];
        }
        cross3(K.omega[p], wq, t1);
        for (int k = 0; k < 3; ++k) ne.alpha[i][k] = ne.alpha[p][k] + t1[k];
      }
      wsync();
    }
    for (int l = lane; l < NL; l += WIDTH) {
      const float m = tab[L::MASS + l];
      float rc[3], t1[3], t2[3], t3[3], Ia[3], Iwv[3], Iw[9];
      world_inertia(K.quat[l], tab + L::INERTIA + 9 * l, Iw);
      for (int k = 0; k < 3; ++k) rc[k] = K.comw[l][k] - e.pos[l][k];
      cross3(ne.alpha[l], rc, t1);
      cross3(K.omega[l], rc, t2);
      cross3(K.omega[l], t2, t3);
      for (int k = 0; k < 3; ++k) ne.f[l][k] = m * (ne.acc[l][k] + (t1[k] + t3[k]));
      matvec3(Iw, ne.alpha[l], Ia);
      matvec3(Iw, K.omega[l], Iwv);
      cross3(K.omega[l], Iwv, t1);
      cross3(rc, ne.f[l], t2);
      for (int k = 0; k < 3; ++k) ne.n[l][k] = (Ia[k] + t1[k]) + t2[k];
    }
    wsync();
    // children into their parents, deepest level first; a parent takes its
    // children from the highest index down, as the serial sweep does
    for (int d = maxd; d > 0; --d) {
      for (int p = lane; p < NL; p += WIDTH) {
        if (level[p] != d - 1) continue;
        for (int i = NL - 1; i > p; --i) {
          if ((int)tab[L::PARENT + i] != p) continue;
          float r[3], t1[3];
          for (int k = 0; k < 3; ++k) r[k] = e.pos[i][k] - e.pos[p][k];
          cross3(r, ne.f[i], t1);
          for (int k = 0; k < 3; ++k) {
            ne.f[p][k] += ne.f[i][k];
            ne.n[p][k] += ne.n[i][k] + t1[k];
          }
        }
      }
      wsync();
    }
    for (int i = lane; i < NV; i += WIDTH)
      K.bias[i] = i < 3 ? ne.f[0][i] : i < 6 ? ne.n[0][i - 3] : dot3(e.ja[i - 6], ne.n[i - 5]);
    wsync();
  }
  (ck.stamp(PH_BIAS), ...);

  // ---------------- frame start: CRBA (composites about the base origin)
  // and the Cholesky factor, held for the frame's other substeps
  if (factorize) {
    auto& cr = e.u.pre.cr;
    const float* O = e.pos[0];
    for (int l = lane; l < NL; l += WIDTH) {
      const float m = tab[L::MASS + l];
      float d[3], Iw[9];
      world_inertia(K.quat[l], tab + L::INERTIA + 9 * l, Iw);
      for (int k = 0; k < 3; ++k) d[k] = K.comw[l][k] - O[k];
      const float dd = dot3(d, d);
      cr.cm[l] = m;
      for (int a = 0; a < 3; ++a) {
        cr.chv[l][a] = m * d[a];
        for (int b = 0; b < 3; ++b)
          cr.cI[l][3 * a + b] = Iw[3 * a + b] + m * ((a == b ? dd : 0.0f) - d[a] * d[b]);
      }
    }
    wsync();
    for (int d = maxd; d > 0; --d) {
      for (int p = lane; p < NL; p += WIDTH) {
        if (level[p] != d - 1) continue;
        for (int i = NL - 1; i > p; --i) {
          if ((int)tab[L::PARENT + i] != p) continue;
          cr.cm[p] += cr.cm[i];
          for (int k = 0; k < 3; ++k) cr.chv[p][k] += cr.chv[i][k];
          for (int k = 0; k < 9; ++k) cr.cI[p][k] += cr.cI[i][k];
        }
      }
      wsync();
    }
    // spatial momentum (Lm about O, P) of composite l moving with (w, v@O)
    auto momentum = [&](int l, const float* w, const float* v, float* Lm, float* P) {
      float t1[3], t2[3];
      matvec3(cr.cI[l], w, Lm);
      cross3(cr.chv[l], v, t1);
      cross3(w, cr.chv[l], t2);
      for (int k = 0; k < 3; ++k) {
        Lm[k] += t1[k];
        P[k] = cr.cm[l] * v[k] + t2[k];
      }
    };
    // row `row` of M's lower triangle: a base axis, or a joint's axis
    for (int row = lane; row < NV; row += WIDTH) {
      float Lm[3], P[3];
      if (row < 6) {
        // constant indices only, so that nothing lands in local memory
        const float zero3[3] = {0.0f, 0.0f, 0.0f};
        const float ea[3] = {row % 3 == 0 ? 1.0f : 0.0f, row % 3 == 1 ? 1.0f : 0.0f,
                             row % 3 == 2 ? 1.0f : 0.0f};
        if (row < 3) momentum(0, zero3, ea, Lm, P);
        else momentum(0, ea, zero3, Lm, P);
        for (int b = 0; b < 6; ++b)
          if (b <= row) Lx(row, b) = b < 3 ? P[b] : Lm[b - 3];
        continue;
      }
      const int j = row - 6;
      float sv[3], r[3];
      for (int k = 0; k < 3; ++k) r[k] = O[k] - e.pos[j + 1][k];
      cross3(e.ja[j], r, sv);
      momentum(j + 1, e.ja[j], sv, Lm, P);
      for (int b = 0; b < 6; ++b) Lx(row, b) = b < 3 ? P[b] : Lm[b - 3];
      for (int k = 0; k < j; ++k) {
        float mk = 0.0f;
        if (tab[L::ANC + (j + 1) * NJ + k] > 0.5f) {
          float sk[3], rk[3];
          for (int dd = 0; dd < 3; ++dd) rk[dd] = O[dd] - e.pos[k + 1][dd];
          cross3(e.ja[k], rk, sk);
          mk = dot3(e.ja[k], Lm) + dot3(sk, P);
        }
        Lx(row, 6 + k) = mk;
      }
      Lx(row, row) = dot3(e.ja[j], Lm) + dot3(sv, P) + tab[L::JDIAG + j];
    }
    wsync();
    // right-looking Cholesky in place, lanes over the rows below the pivot;
    // the diagonal is clamped at 1e-9. REGCHOL: lane i holds row i in
    // registers and takes column j of the rows above it by shuffles, each
    // entry's subtractions in the same order, so the bits are the same
    if constexpr (C::REGCHOL) {
      float rw[NVL][NV];
#pragma unroll
      for (int jj = 0; jj < NVL; ++jj) {
        const int i = lane + jj * WIDTH;
#pragma unroll
        for (int k = 0; k < NV; ++k) rw[jj][k] = i < NV && k <= i ? Lx(i, k) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float djj = wbcast(rw[j / WIDTH][j], j % WIDTH);
        const float dinv = rsqrtf(fmaxf(djj, 1e-9f));
        if (lane == 0) e.dinv[j] = dinv;
#pragma unroll
        for (int jj = 0; jj < NVL; ++jj) {
          const int i = lane + jj * WIDTH;
          if (i == j) rw[jj][j] = djj * dinv;
          else if (i > j) rw[jj][j] *= dinv;
        }
#pragma unroll
        for (int k = j + 1; k < NV; ++k) {
          const float lkj = wbcast(rw[k / WIDTH][j], k % WIDTH);
#pragma unroll
          for (int jj = 0; jj < NVL; ++jj) {
            const int i = lane + jj * WIDTH;
            if (i >= k && i < NV) rw[jj][k] -= rw[jj][j] * lkj;
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < NVL; ++jj) {
        const int i = lane + jj * WIDTH;
#pragma unroll
        for (int k = 0; k < NV; ++k)
          if (i < NV && k <= i) Lx(i, k) = rw[jj][k];
      }
      wsync();
    } else {
      for (int j = 0; j < NV; ++j) {
        const float djj = Lx(j, j);
        const float dinv = rsqrtf(fmaxf(djj, 1e-9f));
        wsync();
        if (lane == 0) {
          e.dinv[j] = dinv;
          Lx(j, j) = djj * dinv;
        }
        for (int i = j + 1 + lane; i < NV; i += WIDTH) Lx(i, j) *= dinv;
        wsync();
        for (int i = j + 1 + lane; i < NV; i += WIDTH) {
          const float lij = Lx(i, j);
          for (int k = j + 1; k <= i; ++k) Lx(i, k) -= lij * Lx(k, j);
        }
        wsync();
      }
    }
    (ck.stamp(PH_FACTOR), ...);
  }

  // L y = b and Lᵀ x = y on a lane-owned vector (DOF j in slot j / WIDTH
  // of lane j % WIDTH), column by column, each pivot broadcast from its lane
  auto fwd_lanes = [&](float (&y)[NVL]) {
    for (int i = 0; i < NV; ++i) {
      for (int jj = 0; jj < NVL; ++jj)
        if (lane + jj * WIDTH == i) y[jj] *= e.dinv[i];
      const float yi = bcast_owned(y, i);
      for (int jj = 0; jj < NVL; ++jj) {
        const int k = lane + jj * WIDTH;
        if (k > i && k < NV) y[jj] -= Lx(k, i) * yi;
      }
    }
  };
  auto bwd_lanes = [&](float (&x)[NVL]) {
    for (int i = NV - 1; i >= 0; --i) {
      for (int jj = 0; jj < NVL; ++jj)
        if (lane + jj * WIDTH == i) x[jj] *= e.dinv[i];
      const float xi = bcast_owned(x, i);
      for (int jj = 0; jj < NVL; ++jj) {
        const int k = lane + jj * WIDTH;
        if (k < i) x[jj] -= Lx(i, k) * xi;
      }
    }
  };

  // ---------------- free velocity
  {
    float y[NVL];
    for (int jj = 0; jj < NVL; ++jj) {
      const int i = lane + jj * WIDTH;
      y[jj] = 0.0f;
      if (i < 6) {
        y[jj] = -K.bias[i];
      } else if (i < NV) {
        const int j = i - 6;
        const float qj = e.q[7 + j];
        const float tj = e.tau[j] + (-tab[L::DAMP + j] * e.qd[6 + j] -
                                     tab[L::STIFF + j] * (qj - tab[L::SPRREF + j]));
        y[jj] = tj - K.bias[i];
      }
    }
    fwd_lanes(y);
    bwd_lanes(y);
    for (int jj = 0; jj < NVL; ++jj) {
      const int i = lane + jj * WIDTH;
      if (i < NV) e.vfree[i] = e.qd[i] + dt * y[jj];
    }
    wsync();
  }

  // ---------------- which rows are active, and their list: the rods and
  // the planar lock always, a grab's rows where it is attached, first
  const float beta = tab[L::BETA], maxpush = tab[L::MAXPUSH];
  if constexpr (NE0 > 0)
    for (int r = lane; r < NE0; r += WIDTH) e.act[r] = 1.0f;
  if constexpr (NE > NE0)
    for (int r = NE0 + lane; r < NE; r += WIDTH) e.act[r] = e.gact[(r - NE0) / 3];
  for (int lr = lane; lr < NLIM; lr += WIDTH) {
    const int j = (int)tab[L::LIMIDX + lr];
    const float qj = e.q[7 + j];
    const float gap = fminf(qj - tab[L::LIMLO + j], tab[L::LIMHI + j] - qj);
    e.act[NE + lr] = gap < tab[L::LIMMARGIN] ? 1.0f : 0.0f;
  }
  for (int s = lane; s < NS; s += WIDTH) {
    const float a = e.depth[s] > -tab[L::MARGIN] ? 1.0f : 0.0f;
    for (int m = 0; m < 3; ++m) e.act[NE + NLIM + 3 * s + m] = a;
  }
  wsync();
  // neq: the equality rows listed, NE0 and 3 per attached grab (the split
  // pass starts behind them), counted by the predicate that lists them
  int nrows = 0;
  [[maybe_unused]] int neq = NE0;
  for (int base = 0; base < NR; base += WIDTH) {
    const int r = base + lane;
    bool a = r < NR && e.act[r] > 0.5f;
    if constexpr (NE > NE0)   // a grab's rows wherever its activity is not 0
      if (r >= NE0 && r < NE) a = e.act[r] != 0.0f;
    const unsigned mask = wballot(a);
    if (a) e.rows[nrows + popc(mask & ((1u << lane) - 1u))] = r;
    nrows += popc(mask);
    if constexpr (C::SPLIT && NE > NE0) neq += popc(wballot(a && r >= NE0 && r < NE));
  }
  wsync();

  // entry (comp, i) of the point Jacobian (3 × NV) of world point x fixed to
  // link l, rel = x − the base origin
  auto jac = [&](int l, const float* x, const float* rel, int comp, int i) -> float {
    if (i < 3) return i == comp ? 1.0f : 0.0f;
    if (i < 6) {   // e_k × rel, k = i − 3
      return i == 3 ? (comp == 0 ? 0.0f : comp == 1 ? -rel[2] : rel[1])
           : i == 4 ? (comp == 0 ? rel[2] : comp == 1 ? 0.0f : -rel[0])
                    : (comp == 0 ? -rel[1] : comp == 1 ? rel[0] : 0.0f);
    }
    const int j = i - 6;
    if (!(tab[L::ANC + l * NJ + j] > 0.5f)) return 0.0f;
    float dx[3];
    for (int k = 0; k < 3; ++k) dx[k] = x[k] - e.pos[j + 1][k];
    return cross_comp(e.ja[j], dx, comp);
  };
  // an equality row's target: the drift pulled back at a clipped rate
  auto eq_target = [&](float err) { return clampf(-beta * err, -maxpush, maxpush); };

  // ---------------- each active row: J_r, c_r, W_r = L⁻¹J_rᵀ and its
  // diagonal, one row per lane. build_row(r, put) hands entry i of J_r to
  // put(i, J_r[i]) in the order i = 0, 1, …, NV − 1 and sets c_r; each of its
  // loops over i is unrolled where ROW_REGS, so that put may keep the entry
  // in a register of a constant index
  const float cfm = tab[L::CFM];
  auto build_row = [&](int r, auto&& put) {
    if (r < NE0) {
      if constexpr (C::NP2P > 0) {
        if (r < 3 * C::NP2P) {   // a rod: component d of J_a − J_b
          const int k = r / 3, d = r % 3;
          const float* rod = tab + L::P2P + 8 * k;
          const int la = (int)rod[0], lb = (int)rod[1];
          const float* xa = e.anchor[k][0];
          const float* xb = e.anchor[k][1];
          float ra[3], rb[3];
          for (int m = 0; m < 3; ++m) { ra[m] = xa[m] - e.pos[0][m]; rb[m] = xb[m] - e.pos[0][m]; }
          float cv = 0.0f;
          each<NV, ROW_REGS>([&](int i) {
            const float v = jac(la, xa, ra, d, i) - jac(lb, xb, rb, d, i);
            put(i, v);
            cv += v * e.vfree[i];
          });
          e.c[r] = cv - eq_target(xa[d] - xb[d]);
        }
      }
      if constexpr (C::PLANAR) {
        if (r >= 3 * C::NP2P) {  // the lock: base y, roll, yaw
          const int m = r - 3 * C::NP2P, col = 2 * m + 1;
          const float w = e.q[3], x = e.q[4], yq = e.q[5], z = e.q[6];
          const float err = m == 0 ? e.q[1]
                            : m == 1 ? 2.0f * (w * x + yq * z) : 2.0f * (w * z + x * yq);
          each<NV, ROW_REGS>([&](int i) { put(i, i == col ? 1.0f : 0.0f); });
          e.c[r] = e.vfree[col] - eq_target(err);
        }
      }
    } else if (r < NE) {   // a grab: component d of its palm's point Jacobian
      if constexpr (C::NGRAB > 0) {
        const int g = (r - NE0) / 3, d = (r - NE0) % 3;
        const int lg = (int)tab[L::GRAB + 4 * g];
        const float* xg = e.gx[g];
        float rel[3];
        for (int m = 0; m < 3; ++m) rel[m] = xg[m] - e.pos[0][m];
        float cv = 0.0f;
        each<NV, ROW_REGS>([&](int i) {
          const float v = jac(lg, xg, rel, d, i);
          put(i, v);
          cv += v * e.vfree[i];
        });
        e.c[r] = cv - eq_target(xg[d] - e.gtgt[g][d]);
      }
    } else if (r < NE + NLIM) {   // a joint limit: ±1 on its column
      const int lr = r - NE;
      const int j = (int)tab[L::LIMIDX + lr];
      const float qj = e.q[7 + j];
      const float d_lo = qj - tab[L::LIMLO + j], d_hi = tab[L::LIMHI + j] - qj;
      const float sgn = d_lo <= d_hi ? 1.0f : -1.0f;
      const float gap = fminf(d_lo, d_hi), viol = -gap;
      const float b_l = fminf(beta * fmaxf(viol - tab[L::LIMSLOP], 0.0f), maxpush);
      const int col = 6 + j;
      each<NV, ROW_REGS>([&](int i) { put(i, i == col ? sgn : 0.0f); });
      // split impulse: the push-out goes to the position pass
      if constexpr (C::SPLIT) e.bpos[lr] = b_l;
      const float bv = C::SPLIT ? 0.0f : b_l;
      e.c[r] = sgn * e.vfree[col] - (bv - fmaxf(-viol, 0.0f) / dt);
    } else {               // a contact: row n, t1 or t2 of its point Jacobian
      const int s = (r - NE - NLIM) / 3, m = (r - NE - NLIM) % 3;
      const int l = (int)tab[L::SPHLINK + s];
      const float* x = e.cpt[s];
      float rel[3];
      for (int k = 0; k < 3; ++k) rel[k] = x[k] - e.pos[0][k];
      float cv = 0.0f;
      if constexpr (C::GENERAL) {
        // the sphere's normal and its branchless tangent basis, projected
        // onto the three components of each entry
        const float nx = e.nrm[s][0], ny = e.nrm[s][1], nz = e.nrm[s][2];
        const float sg = nz >= 0.0f ? 1.0f : -1.0f;
        const float ka = -1.0f / (sg + nz), kb = nx * ny * ka;
        const float d0 = m == 0 ? nx : m == 1 ? 1.0f + sg * nx * nx * ka : kb;
        const float d1 = m == 0 ? ny : m == 1 ? sg * kb : sg + ny * ny * ka;
        const float d2 = m == 0 ? nz : m == 1 ? -sg * nx : -ny;
        each<NV, ROW_REGS>([&](int i) {
          float jc[3];
          if (i < 6) {
            for (int k = 0; k < 3; ++k) jc[k] = jac(l, x, rel, k, i);
          } else if (tab[L::ANC + l * NJ + (i - 6)] > 0.5f) {
            float dx[3];
            for (int k = 0; k < 3; ++k) dx[k] = x[k] - e.pos[i - 5][k];
            cross3(e.ja[i - 6], dx, jc);
          } else {
            jc[0] = jc[1] = jc[2] = 0.0f;
          }
          const float v = d0 * jc[0] + d1 * jc[1] + d2 * jc[2];
          put(i, v);
          cv += v * e.vfree[i];
        });
      } else {             // the plane: rows z, x, y, constant-folded
        const int comp = m == 0 ? 2 : m - 1;
        each<NV, ROW_REGS>([&](int i) {
          const float v = jac(l, x, rel, comp, i);
          put(i, v);
          cv += v * e.vfree[i];
        });
      }
      if (m == 0) {
        const float dep = e.depth[s];
        const float b_n = fminf(beta * fmaxf(dep - tab[L::SLOP], 0.0f), maxpush);
        if constexpr (C::SPLIT) e.bpos[NLIM + s] = b_n;
        const float bv = C::SPLIT ? 0.0f : b_n;
        cv -= bv - fmaxf(-dep, 0.0f) / dt;
      }
      e.c[r] = cv;
    }
  };
  if constexpr (ROW_REGS) {
    // the row in the lane's registers: J_r built there, the forward solve
    // L y = J_rᵀ there (L and 1 / L_ii broadcast from shared memory), then
    // one store of the row into W
    for (int t = lane; t < nrows; t += WIDTH) {
      const int r = e.rows[t];
      float y[NV];
      build_row(r, [&](int i, float v) { y[i] = v; });
      float dd = 0.0f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float* Li = e.Lf + i * (i + 1) / 2;
        float s = y[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s -= Li[k] * y[k];
        s *= e.dinv[i];
        y[i] = s;
        dd += s * s;
      }
      if constexpr (C::MATFREE) e.diag[r] = fmaxf(dd + cfm, 1e-9f);
      float* w = e.u.W + r * WS;
#pragma unroll
      for (int i = 0; i < NV; ++i) w[i] = y[i];
    }
  } else {
    // J_r written into its row of W and solved there in place
    for (int t = lane; t < nrows; t += WIDTH) {
      const int r = e.rows[t];
      float* y = e.u.W + r * WS;
      build_row(r, [&](int i, float v) { y[i] = v; });
      float dd = 0.0f;
#pragma unroll 1
      for (int i = 0; i < NV; ++i) {
        const float* Li = e.Lf + i * (i + 1) / 2;
        float s = y[i];
        for (int k = 0; k < i; ++k) s -= Li[k] * y[k];
        s *= e.dinv[i];
        y[i] = s;
        dd += s * s;
      }
      if constexpr (C::MATFREE) e.diag[r] = fmaxf(dd + cfm, 1e-9f);
    }
  }
  wsync();
  // the A-form: A(t1, t2) = W_r1·W_r2 (+ cfm where t1 = t2) over the list
  // positions of the active rows, each dot in engine_k1.cu's order. Lane ℓ
  // holds the W rows of positions ℓ and ℓ + 32 and forms A's entries in
  // their columns against each row broadcast in turn; a row's diagonal and
  // each contact's 2×2 friction block come from A
  constexpr int NRL = (NR + WIDTH - 1) / WIDTH;   // a lane's share of a row vector
  if constexpr (!C::MATFREE) {
    float wc[NRL][NV];   // in registers: the loops over jj and j unrolled
#pragma unroll
    for (int jj = 0; jj < NRL; ++jj) {
      const int p = lane + jj * WIDTH;
#pragma unroll
      for (int j = 0; j < NV; ++j) wc[jj][j] = p < nrows ? e.u.W[e.rows[p] * WS + j] : 0.0f;
    }
    for (int t1 = 0; t1 < nrows; ++t1) {
      const float* w1 = e.u.W + e.rows[t1] * WS;
      float acc[NRL];
#pragma unroll
      for (int jj = 0; jj < NRL; ++jj) acc[jj] = 0.0f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float x = w1[j];
#pragma unroll
        for (int jj = 0; jj < NRL; ++jj) acc[jj] += x * wc[jj][j];
      }
      for (int jj = 0; jj < NRL; ++jj) {
        const int p = lane + jj * WIDTH;
        if (p <= t1) e.A[aidx(t1, p)] = t1 == p ? acc[jj] + cfm : acc[jj];
      }
    }
    wsync();
    for (int t = lane; t < nrows; t += WIDTH) e.diag[e.rows[t]] = fmaxf(aget(e, t, t), 1e-9f);
  }
  // each active contact's 2×2 friction block, inverted (scalar friction
  // rows use none)
  if constexpr (C::MATFREE && C::BLOCK) {
    for (int s = lane; s < NS; s += WIDTH) {
      const int t1 = NE + NLIM + 3 * s + 1, t2 = t1 + 1;
      if (!(e.act[t1] > 0.5f)) continue;
      float a12 = 0.0f;
      for (int i = 0; i < NV; ++i) a12 += e.u.W[t1 * WS + i] * e.u.W[t2 * WS + i];
      const float a11 = e.diag[t1], a22 = e.diag[t2];
      const float det = fmaxf(a11 * a22 - a12 * a12, 1e-12f);
      e.finv[s][0] = a22 / det; e.finv[s][1] = a11 / det; e.finv[s][2] = -a12 / det;
    }
  } else if constexpr (!C::MATFREE && C::BLOCK) {
    // a contact's normal row at position t, its friction pair at t + 1, t + 2
    for (int t = lane; t < nrows; t += WIDTH) {
      const int r = e.rows[t];
      if (r < NE + NLIM || (r - NE - NLIM) % 3 != 0) continue;
      const int s = (r - NE - NLIM) / 3;
      const float a11 = fmaxf(aget(e, t + 1, t + 1), 1e-9f);
      const float a22 = fmaxf(aget(e, t + 2, t + 2), 1e-9f);
      const float a12 = aget(e, t + 1, t + 2);
      const float det = fmaxf(a11 * a22 - a12 * a12, 1e-12f);
      e.finv[s][0] = a22 / det; e.finv[s][1] = a11 / det; e.finv[s][2] = -a12 / det;
    }
  }
  // warm start: the previous substep's λ, masked by this substep's activity;
  // else λ from zero
  for (int r = lane; r < NR; r += WIDTH) e.lam[r] = C::WARM ? e.lam[r] * e.act[r] : 0.0f;
  wsync();
  // v_j = Σ_t W_{r_t}[j]·coef(t) over the list positions t from t0 in order
  // (a contact's normal row alone where `normals`, its friction pair
  // skipped), lanes over DOF j
  auto w_times = [&](float* v, int t0, bool normals, auto coef) {
    for (int jj = 0; jj < NVL; ++jj) {
      const int j = lane + jj * WIDTH;
      v[jj] = 0.0f;
      if (j < NV)
        for (int t = t0; t < nrows;) {
          const int r = e.rows[t];
          v[jj] += e.u.W[r * WS + j] * coef(t, r);
          t += normals && r >= NE + NLIM ? 3 : 1;
        }
    }
  };
  auto lam_of = [&](int, int r) { return e.lam[r]; };
  float z[NVL];   // z = Wλ, lane-owned
  // the A-form's residual c + Aλ, lane-owned: lane ℓ holds list positions ℓ
  // and ℓ + 32
  float res[C::MATFREE ? 1 : NRL];
  if constexpr (C::MATFREE) {
    w_times(z, 0, false, lam_of);
  } else {
    for (int jj = 0; jj < NRL; ++jj) {
      const int p = lane + jj * WIDTH;
      res[jj] = 0.0f;
      if (p < nrows) {
        float sum = e.c[e.rows[p]];
        if constexpr (C::WARM)
          for (int k = 0; k < nrows; ++k) sum += aget(e, k, p) * e.lam[e.rows[k]];
        res[jj] = sum;
      }
    }
  }
  // the A-form's residual of position t, broadcast from its lane, and the
  // lane's residuals moved by A's row t times d
  auto res_at = [&](int t) { return bcast_owned(res, t); };
  auto res_move = [&](int t, float d) {
    for (int jj = 0; jj < NRL; ++jj) {
      const int p = lane + jj * WIDTH;
      if (p < nrows) res[jj] += aget(e, t, p) * d;
    }
  };
  // W_r · v, this lane's part, and v += W_r·d, for a lane-owned v (z, z_pos)
  auto part = [&](int r, const float* v) {
    float p = 0.0f;
    for (int jj = 0; jj < NVL; ++jj) {
      const int j = lane + jj * WIDTH;
      if (j < NV) p += e.u.W[r * WS + j] * v[jj];
    }
    return p;
  };
  auto move = [&](int r, float d, float* v) {
    for (int jj = 0; jj < NVL; ++jj) {
      const int j = lane + jj * WIDTH;
      if (j < NV) v[jj] += e.u.W[r * WS + j] * d;
    }
  };
  (ck.stamp(PH_ROWS), ...);

  // ---------------- PGS over the active rows, in the serial order: the
  // equality rows unbounded (a grab's masked by its activity), a limit or a
  // contact normal clamped at 0
  const float fric = e.fric;
  for (int it = 0; it < C::ITERS; ++it) {
    for (int t = 0; t < nrows;) {
      const int r = e.rows[t];
      const float l0 = e.lam[r];
      float rr;
      if constexpr (C::MATFREE) rr = e.c[r] + cfm * l0 + wsum(part(r, z));
      else rr = res_at(t);
      float nw = l0 - rr / e.diag[r];
      if (!(r < NE)) nw = fmaxf(0.0f, nw);
      else if constexpr (NE > NE0) {
        if (r >= NE0) nw *= e.act[r];
      }
      e.lam[r] = nw;
      if constexpr (C::MATFREE) move(r, nw - l0, z);
      else res_move(t, nw - l0);
      if (r < NE + NLIM) { ++t; continue; }
      // a contact's normal row, then its friction pair as one 2×2 step or
      // (scalar friction) t1 then t2, each box-clamped alone: t2's residual
      // read after t1's move, a butterfly each in the matrix-free form
      const int s = (r - NE - NLIM) / 3, b1 = r + 1, b2 = r + 2;
      const float bound = fric * nw;
      if constexpr (!C::BLOCK) {
        for (int m = 1; m <= 2; ++m) {
          const int b = r + m;
          const float lb = e.lam[b];
          float rb;
          if constexpr (C::MATFREE) rb = e.c[b] + cfm * lb + wsum(part(b, z));
          else rb = res_at(t + m);
          const float nb = clampf(lb - rb / e.diag[b], -bound, bound);
          e.lam[b] = nb;
          if constexpr (C::MATFREE) move(b, nb - lb, z);
          else res_move(t + m, nb - lb);
        }
        t += 3;
        continue;
      }
      const float l1 = e.lam[b1], l2 = e.lam[b2];
      float r1, r2;
      if constexpr (C::MATFREE) {
        float p1 = part(b1, z), p2 = part(b2, z);
        wsum2(p1, p2);
        r1 = e.c[b1] + cfm * l1 + p1;
        r2 = e.c[b2] + cfm * l2 + p2;
      } else {
        r1 = res_at(t + 1);
        r2 = res_at(t + 2);
      }
      const float d1 = -(e.finv[s][0] * r1 + e.finv[s][2] * r2);
      const float d2 = -(e.finv[s][2] * r1 + e.finv[s][1] * r2);
      const float n1 = clampf(l1 + d1, -bound, bound), n2 = clampf(l2 + d2, -bound, bound);
      const float e1 = n1 - l1, e2 = n2 - l2;
      e.lam[b1] = n1;
      e.lam[b2] = n2;
      if constexpr (C::MATFREE) {
        for (int jj = 0; jj < NVL; ++jj) {
          const int j = lane + jj * WIDTH;
          if (j < NV) z[jj] += e.u.W[b1 * WS + j] * e1 + e.u.W[b2 * WS + j] * e2;
        }
      } else {
        for (int jj = 0; jj < NRL; ++jj) {
          const int p = lane + jj * WIDTH;
          if (p < nrows) res[jj] += aget(e, t + 1, p) * e1 + aget(e, t + 2, p) * e2;
        }
      }
      t += 3;
    }
  }
  // the A-form: z = Wλ once, after the sweeps
  if constexpr (!C::MATFREE) w_times(z, 0, false, lam_of);

  // ---------------- split impulse: the position pass. Scalar PGS from
  // λ_pos = 0 over the active limit rows and contact normal rows (behind
  // the neq listed equality rows: the rods, the lock and the attached
  // grabs; a contact's normal row is followed by its friction pair),
  // against −bpos; z_pos = Wλ_pos, lane-owned
  // (A-form: the residual from −bpos on those rows and 0 elsewhere, moved by
  // A's rows; z_pos made once after the sweeps)
  float zp[C::SPLIT ? NVL : 1];
  if constexpr (C::SPLIT) {
    // a pass row's index into bpos and λ_pos
    auto kpos = [&](int r) { return r < NE + NLIM ? r - NE : NLIM + (r - NE - NLIM) / 3; };
    for (int jj = 0; jj < NVL; ++jj) zp[jj] = 0.0f;
    for (int k = lane; k < NLIM + NS; k += WIDTH) e.lpos[k] = 0.0f;
    if constexpr (!C::MATFREE)
      for (int jj = 0; jj < NRL; ++jj) {
        const int p = lane + jj * WIDTH;
        res[jj] = 0.0f;
        if (p >= neq && p < nrows) {
          const int r = e.rows[p];
          if (r < NE + NLIM || (r - NE - NLIM) % 3 == 0) res[jj] = -e.bpos[kpos(r)];
        }
      }
    wsync();
    for (int it = 0; it < C::ITERS; ++it) {
      for (int t = neq; t < nrows;) {
        const int r = e.rows[t];
        const int k = kpos(r);
        const float l0 = e.lpos[k];
        float rr;
        if constexpr (C::MATFREE) rr = cfm * l0 - e.bpos[k] + wsum(part(r, zp));
        else rr = res_at(t);
        const float nw = fmaxf(0.0f, l0 - rr / e.diag[r]) * e.act[r];
        e.lpos[k] = nw;
        if constexpr (C::MATFREE) move(r, nw - l0, zp);
        else res_move(t, nw - l0);
        t += r < NE + NLIM ? 1 : 3;
      }
    }
    if constexpr (!C::MATFREE)
      w_times(zp, neq, true, [&](int, int r) { return e.lpos[kpos(r)]; });
  }
  (ck.stamp(PH_PGS), ...);

  // ---------------- impulse map and integration
  bwd_lanes(z);
  const float maxvel = tab[L::MAXVEL], limslop = tab[L::LIMSLOP];
  float qdn[NVL];
  for (int jj = 0; jj < NVL; ++jj) {
    const int i = lane + jj * WIDTH;
    qdn[jj] = i < NV ? clampf(e.vfree[i] + z[jj], -maxvel, maxvel) : 0.0f;
  }
  // the velocity that advances the positions: with split impulse the
  // pseudo-velocity L⁻ᵀz_pos joins the real one here and nowhere else
  if constexpr (C::SPLIT) bwd_lanes(zp);
  auto adv = [&](int jj) -> float {
    if constexpr (C::SPLIT) return qdn[jj] + zp[jj];
    else return qdn[jj];
  };
  // the base rotation: every lane computes it from the broadcast ω
  const float hx = wbcast(adv(3 / WIDTH), 3 % WIDTH) * (0.5f * dt);
  const float hy = wbcast(adv(4 / WIDTH), 4 % WIDTH) * (0.5f * dt);
  const float hz = wbcast(adv(5 / WIDTH), 5 % WIDTH) * (0.5f * dt);
  float bq[4];
  {
    const float theta = sqrtf(hx * hx + hy * hy + hz * hz + 1e-24f);
    float sn, cs;
    sincosf_(theta, &sn, &cs);
    const float sc = sn / theta;
    const float dq[4] = {cs, hx * sc, hy * sc, hz * sc};
    qmul(dq, e.q + 3, bq);
    const float inv = rsqrtf(bq[0] * bq[0] + bq[1] * bq[1] + bq[2] * bq[2] + bq[3] * bq[3]);
    for (int k = 0; k < 4; ++k) bq[k] *= inv;
  }
  wsync();
  if (lane == 0)
    for (int k = 0; k < 4; ++k) e.q[3 + k] = bq[k];
  for (int jj = 0; jj < NVL; ++jj) {
    const int i = lane + jj * WIDTH;
    if (i < 3) {
      e.q[i] += dt * adv(jj);
    } else if (i >= 6 && i < NV) {
      const int j = i - 6;
      const float raw = e.q[7 + j] + dt * adv(jj);
      const float lo = tab[L::LIMLO + j] - limslop, hi = tab[L::LIMHI + j] + limslop;
      float v = qdn[jj];
      if (raw > hi && v > 0.0f) v = 0.0f;
      if (raw < lo && v < 0.0f) v = 0.0f;
      e.q[7 + j] = clampf(raw, lo, hi);
      qdn[jj] = v;
    }
    if (i < NV) e.qd[i] = qdn[jj];
  }
  wsync();
  (ck.stamp(PH_INTEGRATE), ...);
}

// One call for env t: NLLC llc frames of NSUB substeps, λ zeroed once at the
// start and carried across them (WARM; else zeroed in every substep). PD:
// ``tau`` holds joint targets and each frame's torque is gain·(target − q) at
// the frame's start; else the torques are held. PHF > 0: ``hf`` row t is the env's heightfield window. K > 0 /
// KT > 0 / KB > 0 / NGRAB > 0: column t of the component-major ``stones``
// (K·11, B) / ``tris`` (KT·10, B) / ``bars`` (KB·8, B) / ``grabs`` (NGRAB·4,
// B) holds the env's stones / faces / bars / grab state, staged here once
// for the call. ``ck``: the clocked kernel's phase clock (none in the
// shipped kernel).
template <class C, class... Ck>
KERNEL_DEV void frame(const float* q, const float* qd, const float* tau, const float* gz,
                      const float* fric, const float* stones, const float* bars,
                      const float* grabs, const float* hf,
                      const float* tris, float* q_out, float* qd_out, float* depth_out,
                      float* nimp_out, const float* tab, const int* level, int maxd, EnvW<C>& e,
                      int B, int t, int lane, Ck&... ck) {
  using L = typename C::L;
  for (int i = lane; i < L::NQ; i += WIDTH) e.q[i] = q[(long long)t * L::NQ + i];
  for (int i = lane; i < L::NV; i += WIDTH) e.qd[i] = qd[(long long)t * L::NV + i];
  for (int i = lane; i < L::NJ; i += WIDTH) {
    if constexpr (C::PD) e.target[i] = tau[(long long)t * L::NJ + i];
    else e.tau[i] = tau[(long long)t * L::NJ + i];
  }
  for (int r = lane; r < L::NR; r += WIDTH) e.lam[r] = 0.0f;
  if constexpr (C::K > 0)
    for (int i = lane; i < C::K * STONE_C; i += WIDTH)
      e.stone[i / STONE_C][i % STONE_C] = ldg_(stones + (long long)i * B + t);
  if constexpr (C::KT > 0)
    for (int i = lane; i < C::KT * TRI_C; i += WIDTH)
      e.tri[i / TRI_C][i % TRI_C] = ldg_(tris + (long long)i * B + t);
  if constexpr (C::KB > 0)
    for (int i = lane; i < C::KB * BAR_C; i += WIDTH)
      e.bar[i / BAR_C][i % BAR_C] = ldg_(bars + (long long)i * B + t);
  if constexpr (C::NGRAB > 0)
    for (int i = lane; i < C::NGRAB * GRAB_C; i += WIDTH) {
      const float v = ldg_(grabs + (long long)i * B + t);
      if (i % GRAB_C == 0) e.gact[i / GRAB_C] = v;
      else e.gtgt[i / GRAB_C][i % GRAB_C - 1] = v;
    }
  if (lane == 0) {
    e.ground = gz[t];
    e.fric = fric[t];
    if constexpr (C::PHF > 0) {
      constexpr int P2 = C::PHF * C::PHF;
      e.hp = hf + (long long)t * (P2 + 3);
      e.hx0 = ldg_(e.hp + P2);
      e.hy0 = ldg_(e.hp + P2 + 1);
      e.hcell = ldg_(e.hp + P2 + 2);
    }
  }
  wsync();
  (ck.stamp(PH_IO, false), ...);
  for (int llc = 0; llc < C::NLLC; ++llc) {
    if constexpr (C::PD) {
      for (int j = lane; j < L::NJ; j += WIDTH)
        e.tau[j] = tab[L::PDGAIN + j] * (e.target[j] - e.q[7 + j]);
      wsync();
      (ck.stamp(PH_BIAS, false), ...);
    }
    for (int sub = 0; sub < C::NSUB; ++sub)   // REUSE: the factor of each frame's first substep
      substep<C>(e, tab, level, maxd, lane, sub == 0 || !C::REUSE, ck...);
  }
  for (int i = lane; i < L::NQ; i += WIDTH) q_out[(long long)t * L::NQ + i] = e.q[i];
  for (int i = lane; i < L::NV; i += WIDTH) qd_out[(long long)t * L::NV + i] = e.qd[i];
  for (int s = lane; s < C::NS; s += WIDTH) {
    depth_out[(long long)t * C::NS + s] = e.depth[s];
    nimp_out[(long long)t * C::NS + s] = e.lam[L::NE + C::NLIM + 3 * s];
  }
  (ck.stamp(PH_IO), ...);
  (ck.flush(), ...);
}

// Whether the scene inputs the instance reads are given: the stones, the
// bars, the grabs, the heightfield window, the mesh faces.
template <class C>
inline bool scene_given(const float* stones, const float* bars, const float* grabs,
                        const float* hf, const float* tris) {
  return !(C::K > 0 && stones == nullptr) && !(C::KB > 0 && bars == nullptr) &&
         !(C::NGRAB > 0 && grabs == nullptr) && !(C::PHF > 0 && hf == nullptr) &&
         !(C::KT > 0 && tris == nullptr);
}

#ifndef K1W_HOST_CHECK
// Dynamic shared memory of a block: the table, the link depths, C::ENVS EnvW.
template <class C>
struct Smem {
  static constexpr int ENV_OFF = ((C::L::SIZE + C::NL) * 4 + 15) / 16 * 16;
  static constexpr int BYTES = ENV_OFF + C::ENVS * (int)sizeof(EnvW<C>);
};

// The shipped kernel (CLOCKED false) and the clocked one, which adds each
// env's phase cycles and visits into ``clocks`` (B, NPHASE, 2).
template <class C, bool CLOCKED>
__global__ void __launch_bounds__(32 * C::ENVS, C::BLOCKS)
k1w_kernel(const float* __restrict__ q, const float* __restrict__ qd,
           const float* __restrict__ tau, const float* __restrict__ gz,
           const float* __restrict__ fric, const float* __restrict__ stones,
           const float* __restrict__ bars, const float* __restrict__ grabs,
           const float* __restrict__ hf, const float* __restrict__ tris,
           float* __restrict__ q_out, float* __restrict__ qd_out, float* __restrict__ depth_out,
           float* __restrict__ nimp_out, const float* __restrict__ table, int B,
           unsigned long long* __restrict__ clocks) {
  long long t0 = 0;
  if constexpr (CLOCKED) t0 = clock64();
  using L = typename C::L;
  extern __shared__ float4 smem[];
  float* tab = reinterpret_cast<float*>(smem);
  int* level = reinterpret_cast<int*>(tab + L::SIZE);
  auto* envs = reinterpret_cast<EnvW<C>*>(reinterpret_cast<char*>(smem) + Smem<C>::ENV_OFF);
  for (int i = threadIdx.x; i < L::SIZE; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  if (threadIdx.x == 0) tree_depths<C::NL>(tab + L::PARENT, level);
  __syncthreads();
  int maxd = 0;
  for (int l = 0; l < C::NL; ++l) maxd = level[l] > maxd ? level[l] : maxd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * C::ENVS + warp;
  if (t >= B) return;   // the whole warp
  if constexpr (CLOCKED) {
    PhaseClock ck{clocks + (long long)t * 2 * NPHASE, t0, lane};
    frame<C>(q, qd, tau, gz, fric, stones, bars, grabs, hf, tris, q_out, qd_out, depth_out,
             nimp_out, tab, level, maxd, envs[warp], B, t, lane, ck);
  } else {
    frame<C>(q, qd, tau, gz, fric, stones, bars, grabs, hf, tris, q_out, qd_out, depth_out,
             nimp_out, tab, level, maxd, envs[warp], B, t, lane);
  }
}

template <class C, bool CLOCKED = false>
int prepare() {
  return (int)cudaFuncSetAttribute(k1w_kernel<C, CLOCKED>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<C>::BYTES);
}

// The shipped kernel, or (CLOCKED) the clocked one, at the same shape;
// the clocked one refuses a null ``clocks``.
template <class C, bool CLOCKED = false>
int launch(const float* q, const float* qd, const float* tau, const float* gz, const float* fric,
           const float* stones, const float* bars, const float* grabs, const float* hf,
           const float* tris, float* q_out, float* qd_out, float* depth, float* nimp,
           const float* table, int table_size, int B, void* stream,
           unsigned long long* clocks = nullptr) {
  if (table_size != C::L::SIZE || B <= 0 || !scene_given<C>(stones, bars, grabs, hf, tris) ||
      (CLOCKED && clocks == nullptr))
    return (int)cudaErrorInvalidValue;
  const int err = prepare<C, CLOCKED>();
  if (err != 0) return err;
  const int blocks = (B + C::ENVS - 1) / C::ENVS;
  k1w_kernel<C, CLOCKED><<<blocks, 32 * C::ENVS, Smem<C>::BYTES, (cudaStream_t)stream>>>(
      q, qd, tau, gz, fric, stones, bars, grabs, hf, tris, q_out, qd_out, depth, nimp, table, B,
      clocks);
  return (int)cudaGetLastError();
}

template <class C>
int occupancy(int* blocks_per_sm, int* envs_per_block, int* smem_bytes) {
  const int err = prepare<C>();
  if (err != 0) return err;
  *envs_per_block = C::ENVS;
  *smem_bytes = Smem<C>::BYTES;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k1w_kernel<C, false>,
                                                            32 * C::ENVS, Smem<C>::BYTES);
}
#else
// host check: the same per-env code at lane width 1, a plain loop over envs;
// with ``clocks`` (B, NPHASE, 2) each env's phase clock too
template <class C>
int host(const float* q, const float* qd, const float* tau, const float* gz, const float* fric,
         const float* stones, const float* bars, const float* grabs, const float* hf,
         const float* tris, float* q_out, float* qd_out, float* depth, float* nimp,
         const float* table, int table_size, int B, long long* clocks) {
  if (table_size != C::L::SIZE || B <= 0 || !scene_given<C>(stones, bars, grabs, hf, tris))
    return 1;
  int dep[C::NL];
  const int maxd = tree_depths<C::NL>(table + C::L::PARENT, dep);
  auto* e = new EnvW<C>;
  for (int t = 0; t < B; ++t) {
    if (clocks != nullptr) {
      PhaseClock ck{reinterpret_cast<unsigned long long*>(clocks) + (long long)t * 2 * NPHASE,
                    0, 0};
      frame<C>(q, qd, tau, gz, fric, stones, bars, grabs, hf, tris, q_out, qd_out, depth, nimp,
               table, dep, maxd, *e, B, t, 0, ck);
    } else {
      frame<C>(q, qd, tau, gz, fric, stones, bars, grabs, hf, tris, q_out, qd_out, depth, nimp,
               table, dep, maxd, *e, B, t, 0);
    }
  }
  delete e;
  return 0;
}
#endif

}  // namespace k1w

// ------------------------------------------------------------ C interface
// The same entries as engine_k1.cu's instances (the workspace is taken and
// unused; the workspace per env is 0), and <sym>_occupancy. One entry per
// instance: (NL, NS, NLIM, NSUB, ITERS, PD, NLLC, NP2P, PLANAR) at the
// shipped solver options, then envs per block and blocks per SM, then the
// window's side, the stones and the faces where there are any, split
// impulse, the bars and the grabs, and the PGS form and options;
// ops/cuda/engine.py::WARP_INSTANCES lists the same names and numbers. Each
// entry has a clocked twin, <sym>_launch_phases (on the host
// <sym>_host_phases), which takes one more argument: the (B, NPHASE, 2)
// 64-bit buffer the env's phase cycles and visits are added into. Each
// library on the card also exports k1w_smem_limits, the card's shared memory
// per SM, per block and reserved per block.
#define K1W_LAYOUT(NAME, ...)                                                                \
  using NAME##_cfg = k1w::Cfg<__VA_ARGS__>;                                                  \
  extern "C" int NAME##_layout(int* table_size, int* ws_per_env) {                          \
    *table_size = NAME##_cfg::L::SIZE;                                                       \
    *ws_per_env = 0;                                                                         \
    return 0;                                                                                \
  }                                                                                          \
  extern "C" int NAME##_env_bytes() { return (int)sizeof(k1w::EnvW<NAME##_cfg>); }
#ifndef K1W_HOST_CHECK
#define K1W_INSTANCE(NAME, ...)                                                              \
  K1W_LAYOUT(NAME, __VA_ARGS__)                                                              \
  extern "C" int NAME##_launch(const float* q, const float* qd, const float* tau,           \
                               const float* gz, const float* fric, const float* stones,     \
                               const float* bars, const float* grabs, const float* hf,      \
                               const float* tris, float* q_out, float* qd_out,              \
                               float* depth, float* nimp, const float* table,               \
                               int table_size, float*, int B, void* stream) {               \
    return k1w::launch<NAME##_cfg>(q, qd, tau, gz, fric, stones, bars, grabs, hf, tris,      \
                                   q_out, qd_out, depth, nimp, table, table_size, B,        \
                                   stream);                                                 \
  }                                                                                          \
  extern "C" int NAME##_launch_phases(const float* q, const float* qd, const float* tau,    \
                                      const float* gz, const float* fric,                   \
                                      const float* stones, const float* bars,               \
                                      const float* grabs, const float* hf,                  \
                                      const float* tris, float* q_out, float* qd_out,       \
                                      float* depth, float* nimp, const float* table,        \
                                      int table_size, float*, int B, void* stream,          \
                                      long long* clocks) {                                  \
    return k1w::launch<NAME##_cfg, true>(                                                    \
        q, qd, tau, gz, fric, stones, bars, grabs, hf, tris, q_out, qd_out, depth, nimp,     \
        table, table_size, B, stream, reinterpret_cast<unsigned long long*>(clocks));        \
  }                                                                                          \
  extern "C" int NAME##_occupancy(int* blocks_per_sm, int* envs_per_block,                  \
                                  int* smem_bytes) {                                        \
    return k1w::occupancy<NAME##_cfg>(blocks_per_sm, envs_per_block, smem_bytes);           \
  }
// The current card's shared memory: per SM, per block (opt-in) and the
// reserve the runtime keeps per resident block (bytes)
extern "C" int k1w_smem_limits(int* per_sm, int* per_block, int* reserved) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  return err;
}
#else
// host check: k1w::host, without and with the phase clock
#define K1W_INSTANCE(NAME, ...)                                                              \
  K1W_LAYOUT(NAME, __VA_ARGS__)                                                              \
  extern "C" int NAME##_host(const float* q, const float* qd, const float* tau,             \
                             const float* gz, const float* fric, const float* stones,       \
                             const float* bars, const float* grabs, const float* hf,        \
                             const float* tris, float* q_out, float* qd_out, float* depth,  \
                             float* nimp, const float* table, int table_size, float*,       \
                             int B) {                                                        \
    return k1w::host<NAME##_cfg>(q, qd, tau, gz, fric, stones, bars, grabs, hf, tris, q_out, \
                                 qd_out, depth, nimp, table, table_size, B, nullptr);       \
  }                                                                                          \
  extern "C" int NAME##_host_phases(const float* q, const float* qd, const float* tau,      \
                                    const float* gz, const float* fric, const float* stones, \
                                    const float* bars, const float* grabs, const float* hf,  \
                                    const float* tris, float* q_out, float* qd_out,         \
                                    float* depth, float* nimp, const float* table,          \
                                    int table_size, float*, int B, long long* clocks) {     \
    if (clocks == nullptr) return 1;                                                         \
    return k1w::host<NAME##_cfg>(q, qd, tau, gz, fric, stones, bars, grabs, hf, tris, q_out, \
                                 qd_out, depth, nimp, table, table_size, B, clocks);        \
  }
#endif

#ifdef K1W_NAME
// Any other key the source holds (PD mode or one llc frame per call, one
// env in an SM; any model size, any mix of a heightfield, stones, a mesh and
// bars): one instance whose name, Cfg arguments and launch shape come from
// -D macros (ops/cuda/engine.py::compile_flags), built at its first use;
// REGCHOL where a factor is made in every substep of the matrix-free form,
// as the refactor key ships it, up to NV = NL + 5 = 32 (past that its rows
// take NVL × NV registers a lane: 128 at NV = 64). (One more expansion, so that the
// name is substituted before it is pasted.)
#define K1W_GENERIC(...) K1W_INSTANCE(__VA_ARGS__)
K1W_GENERIC(K1W_NAME, K1W_NL, K1W_NS, K1W_NLIM, K1W_NSUB, K1W_ITERS, K1W_PD, K1W_NLLC, K1W_NP2P,
            K1W_PLANAR, K1W_ENVS, K1W_BLOCKS, K1W_PHF, K1W_K, K1W_KT, K1W_SPLIT, K1W_KB,
            K1W_NGRAB, K1W_MATFREE, K1W_BLOCK, K1W_WARM, K1W_REUSE,
            K1W_MATFREE && !K1W_REUSE && K1W_NL + 5 <= 32)
#else
// Walker3D / Child3D at the shipped EngineConfig: 22 links, 14 spheres, 21
// limit rows, 4 substeps, 4 sweeps (K1a); 4 envs per block, 4 blocks per SM
#if !defined(K1W_ONLY) || K1W_ONLY == 0
K1W_INSTANCE(k1w_nl22_ns14_nlim21_sub4_it4, 22, 14, 21, 4, 4, false, 1, 0, false, 4, 4)
static_assert(sizeof(k1w::EnvW<k1w_nl22_ns14_nlim21_sub4_it4_cfg>) == 12000,
              "the walker's per-env state keeps its size");
#endif
// Cassie at its three-rate configuration (K1e): 17 links, 5 spheres, 16 limit
// rows, PD-servoed, 10 llc frames of 2 substeps at 600 Hz per control step,
// the two achilles rods (37 rows); 32 envs per block, 1 block per SM
#if !defined(K1W_ONLY) || K1W_ONLY == 1
K1W_INSTANCE(k1w_nl17_ns5_nlim16_sub2_it4_llc10_p2p2, 17, 5, 16, 2, 4, true, 10, 2, false, 32, 1)
#endif
// ... locked to the sagittal plane (40 rows)
#if !defined(K1W_ONLY) || K1W_ONLY == 2
K1W_INSTANCE(k1w_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_planar, 17, 5, 16, 2, 4, true, 10, 2, true,
             32, 1)
#endif
// The PD walker and the PD child at the shipped EngineConfig (K1b): the
// walker's sizes, PD-servoed, one llc frame per control step; 4 envs per
// block, 4 blocks per SM
#if !defined(K1W_ONLY) || K1W_ONLY == 3
K1W_INSTANCE(k1w_nl22_ns14_nlim21_sub4_it4_llc1, 22, 14, 21, 4, 4, true, 1, 0, false, 4, 4)
#endif
// The walker over a 16 × 16 heightfield window (K1f: the terrain families),
// torque mode; 4 envs per block, registers for 8 blocks per SM (63 a thread,
// no spill; sized for 4 it took 95 and ran no faster), of which shared
// memory holds 4
#if !defined(K1W_ONLY) || K1W_ONLY == 4
K1W_INSTANCE(k1w_nl22_ns14_nlim21_sub4_it4_hf16, 22, 14, 21, 4, 4, false, 1, 0, false, 4, 8, 16)
#endif
// The walker over the 6 culled stones of the stepping-stone env (K1c), torque
// mode; 4 envs per block, registers for 8 blocks per SM, of which shared
// memory holds 4
#if !defined(K1W_ONLY) || K1W_ONLY == 5
K1W_INSTANCE(k1w_nl22_ns14_nlim21_sub4_it4_k6, 22, 14, 21, 4, 4, false, 1, 0, false, 4, 8, 0, 6)
#endif
// The walker over the 16 culled faces of a triangle mesh (K1g: the stairs),
// torque mode; the same launch shape
#if !defined(K1W_ONLY) || K1W_ONLY == 6
K1W_INSTANCE(k1w_nl22_ns14_nlim21_sub4_it4_kt16, 22, 14, 21, 4, 4, false, 1, 0, false, 4, 8, 0, 0,
             16)
#endif
// Cassie and Cassie2D with split impulse (K1h-e, K1h-e2d): the position pass
// in each of the 20 substeps of a control step; the launch shape of their
// unsplit twins, 32 envs in one block per SM
#if !defined(K1W_ONLY) || K1W_ONLY == 7
K1W_INSTANCE(k1w_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_si, 17, 5, 16, 2, 4, true, 10, 2, false, 32,
             1, 0, 0, 0, true)
#endif
#if !defined(K1W_ONLY) || K1W_ONLY == 8
K1W_INSTANCE(k1w_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_planar_si, 17, 5, 16, 2, 4, true, 10, 2, true,
             32, 1, 0, 0, 0, true)
#endif
// The stairs' and the terrain walkers' keys with split impulse (K1h-g,
// K1h-f): the position pass over the contacts' own normals. K1h-g's EnvW
// (13,088 bytes) puts four blocks of 4 envs 64 bytes over the SM's shared
// memory, so its 16 envs per SM run as one block of 16 (registers for one
// block); K1h-f keeps K1f's shape
#if !defined(K1W_ONLY) || K1W_ONLY == 9
K1W_INSTANCE(k1w_nl22_ns14_nlim21_sub4_it4_kt16_si, 22, 14, 21, 4, 4, false, 1, 0, false, 16, 1, 0,
             0, 16, true)
#endif
#if !defined(K1W_ONLY) || K1W_ONLY == 10
K1W_INSTANCE(k1w_nl22_ns14_nlim21_sub4_it4_hf16_si, 22, 14, 21, 4, 4, false, 1, 0, false, 4, 8, 16,
             0, 0, true)
#endif
// The stepper's and the PD walkers' keys with split impulse (K1h-c, K1h-b):
// the position pass over the stones' own normals, and in PD mode (the
// derivative gain's implicit damping in the factor and so in W). Four blocks
// of 4 envs would fit (4 × (55,856 + 1,024) bytes for K1h-c), but one block
// of 16 envs per SM (registers for one block: 92 and 56) ran 3–5% faster
#if !defined(K1W_ONLY) || K1W_ONLY == 11
K1W_INSTANCE(k1w_nl22_ns14_nlim21_sub4_it4_k6_si, 22, 14, 21, 4, 4, false, 1, 0, false, 16, 1, 0, 6,
             0, true)
#endif
#if !defined(K1W_ONLY) || K1W_ONLY == 12
K1W_INSTANCE(k1w_nl22_ns14_nlim21_sub4_it4_llc1_si, 22, 14, 21, 4, 4, true, 1, 0, false, 16, 1, 0,
             0, 0, true)
#endif
// The walker on the plane with split impulse (K1h-si): K1a's key with the
// position pass over the plane's constant-folded contact rows. Four blocks
// of 4 envs fit (4 × (54,128 + 1,024) bytes), but one block of 16 envs per
// SM (201,488 bytes, registers for one block: 64) ran 3–4% faster
#if !defined(K1W_ONLY) || K1W_ONLY == 13
K1W_INSTANCE(k1w_nl22_ns14_nlim21_sub4_it4_si, 22, 14, 21, 4, 4, false, 1, 0, false, 16, 1, 0, 0,
             0, true)
#endif
// Monkey3D at the shipped EngineConfig (K1d): 11 links, 5 spheres, 8 limit
// rows, 4 substeps, 4 sweeps, 16 bars, two grabs (6 + 8 + 15 = 29 rows),
// torque mode; EnvW 4,928 bytes, 32 envs per block of 1,024 threads (159,712
// bytes), one block per SM: B = 4096 in one wave on 132 SMs; the 80
// sphere-bar pairs over the lanes (one sphere per lane ran 7% slower; two
// blocks of 16 or four of 8 envs 3–11% slower)
#if !defined(K1W_ONLY) || K1W_ONLY == 14
K1W_INSTANCE(k1w_nl11_ns5_nlim8_sub4_it4_kb16_ng2, 11, 5, 8, 4, 4, false, 1, 0, false, 32, 1, 0, 0,
             0, false, 16, 2)
#endif
// The monkey's key with split impulse (K1h-d): K1d's with the position pass
// over the limit rows and the bars' contact normal rows, which starts behind
// the listed equality rows (3 per attached grab); bpos and λ_pos of 13 rows
// take EnvW to 5,032 bytes, 32 envs per block of 1,024 threads
#if !defined(K1W_ONLY) || K1W_ONLY == 15
K1W_INSTANCE(k1w_nl11_ns5_nlim8_sub4_it4_kb16_ng2_si, 11, 5, 8, 4, 4, false, 1, 0, false, 32, 1, 0,
             0, 0, true, 16, 2)
#endif
// Walker2D and Crab2D at the shipped EngineConfig (K1e planar): 7 links, 5
// spheres, 6 limit rows, 4 substeps, 4 sweeps, the planar lock's 3 rows in
// front (3 + 6 + 15 = 24 rows), torque mode; the link kinematics in W's space
#if !defined(K1W_ONLY) || K1W_ONLY == 16
K1W_INSTANCE(k1w_nl7_ns5_nlim6_sub4_it4_planar, 7, 5, 6, 4, 4, false, 1, 0, true, 32, 1)
#endif
// Walker2D's and Crab2D's key with split impulse (the planar K1h-e): the
// planar K1e's with the position pass behind the lock's 3 rows; bpos and
// λ_pos of 11 rows take EnvW to 2,652 bytes, 32 envs per block of 1,024
// threads
#if !defined(K1W_ONLY) || K1W_ONLY == 17
K1W_INSTANCE(k1w_nl7_ns5_nlim6_sub4_it4_planar_si, 7, 5, 6, 4, 4, false, 1, 0, true, 32, 1, 0, 0, 0,
             true)
#endif
// The walker on the plane with split impulse in the A-form (matfree_pgs
// off): K1h-si's key with A = WWᵀ + cfm·I over the active rows in the env's
// shared memory as its packed lower triangle (8,064 bytes: EnvW 20,344), 11
// envs in one block per SM (228,792 bytes, 108 registers)
#if !defined(K1W_ONLY) || K1W_ONLY == 18
K1W_INSTANCE(k1w_nl22_ns14_nlim21_sub4_it4_si_aform, 22, 14, 21, 4, 4, false, 1, 0, false, 11, 1,
             0, 0, 0, true, 0, 0, false)
#endif
// The walker on the plane in the A-form (matfree_pgs off): K1a's key with A
// packed lower in the env's shared memory as the split A-form's (8,064
// bytes: EnvW 20,064), 11 envs in one block per SM (225,712 bytes)
#if !defined(K1W_ONLY) || K1W_ONLY == 19
K1W_INSTANCE(k1w_nl22_ns14_nlim21_sub4_it4_aform, 22, 14, 21, 4, 4, false, 1, 0, false, 11, 1, 0,
             0, 0, false, 0, 0, false)
#endif
// ... and with the other three PGS options off too (block_pgs, warm_start,
// reuse_factor): scalar friction rows, λ from zero and a factor in every
// substep; the same shape
#if !defined(K1W_ONLY) || K1W_ONLY == 20
K1W_INSTANCE(k1w_nl22_ns14_nlim21_sub4_it4_aform_scalar_cold_refactor, 22, 14, 21, 4, 4, false, 1,
             0, false, 11, 1, 0, 0, 0, false, 0, 0, false, false, false, false)
#endif
// The walker on the plane with scalar friction rows (block_pgs off, the
// matrix-free form): K1a's key, a contact's t1 then t2 row each clamped
// alone, a butterfly each; no 2×2 inverse formed. Four blocks of 4 envs fit
// (K1a's shape), but one block of 16 envs per SM (197,008 bytes, registers
// for one block: 64) ran 1% faster at B = 4096
#if !defined(K1W_ONLY) || K1W_ONLY == 21
K1W_INSTANCE(k1w_nl22_ns14_nlim21_sub4_it4_scalar, 22, 14, 21, 4, 4, false, 1, 0, false, 16, 1, 0,
             0, 0, false, 0, 0, true, false)
#endif
// ... and with a CRBA and factor in every substep (reuse_factor off, the
// matrix-free form): K1a's key, the factor's rows in registers (REGCHOL:
// 12% faster than the shared-memory factor at B = 4096, 96 registers, no
// spill), one block of 16 envs per SM (8% faster than four of 4 at B =
// 4096, 10% at 16,384)
#if !defined(K1W_ONLY) || K1W_ONLY == 22
K1W_INSTANCE(k1w_nl22_ns14_nlim21_sub4_it4_refactor, 22, 14, 21, 4, 4, false, 1, 0, false, 16, 1,
             0, 0, 0, false, 0, 0, true, true, true, false, true)
#endif
// K1a's key with a cold start (warm_start off): λ from zero in every
// substep, nothing carried across substeps or calls; one block of 16 envs
// per SM
#if !defined(K1W_ONLY) || K1W_ONLY == 23
K1W_INSTANCE(k1w_nl22_ns14_nlim21_sub4_it4_cold, 22, 14, 21, 4, 4, false, 1, 0, false, 16, 1, 0, 0,
             0, false, 0, 0, true, true, false)
#endif
#endif  // K1W_NAME
