// K1: the fused rigid-body engine kernel, one env per thread, for Hopper
// (sm_90a), in the variants this file instantiates.
//
// Replaces the TPU kernel mocca_envs_tpu/ops/pallas/engine.py::
// make_pallas_substep for floating all-revolute models at the shipped
// EngineConfig (block PGS, matrix-free PGS, warm start, frame-start factor
// reuse; split impulse off but in the K1h instances):
//
//   K1a  plane, torque mode: one llc frame per call;
//   K1c  K1a plus K oriented stone boxes per env (num_stones = K there);
//   K1b  PD mode (pd_mode there): the whole control step per call, NLLC llc
//        frames; the tau input holds joint targets and the torque
//        gain·(target − q) is refreshed from the state at each frame's start;
//   K1e  equality rows (constraints there) in front of the others: NP2P
//        point-to-point rods between two links (Cassie's achilles rods) and
//        the PLANAR lock of base y, roll and yaw (the 2D families), in
//        torque or PD mode;
//   K1d  KB bar capsules per env (num_bars there) and NGRAB maskable grab
//        rows (ConstraintSpec.num_grabs there): the monkey's handholds and
//        hands, torque mode;
//   K1f  K1a plus a PHF × PHF heightfield window per env (hf_patch there):
//        the terrain families, whose scene has no plane (its height sunk to
//        -1e9);
//   K1g  K1a plus KT triangle-mesh faces per env (num_tris there): the
//        stairs, culled to the faces nearest the root;
//   K1h  split impulse (split_impulse there, SPLIT here): the push-out
//        bias kept out of the velocity rows and solved in a position pass
//        whose pseudo-velocity advances the positions only; on K1a (K1h-si),
//        K1c (K1h-c), Cassie's K1e with and without the planar lock (K1h-e,
//        K1h-e2d) and K1d (K1h-d).
//
// Each llc frame runs NSUB substeps:
//
//   FK (quaternion chain) → narrowphase: every sphere vs the plane, the
//   heightfield, every active stone, every active face and every active
//   bar, the deepest feature per sphere
//   → passive torques → Newton–Euler bias → [substep 0: CRBA about the base
//   + Cholesky] → free velocity → rows [rods × 3 | planar × 3 | grabs × 3 |
//   joint limits | contacts × (n, t1, t2)]
//   → W = L⁻¹Jᵀ per row → matrix-free block PGS, λ warm-started
//   → [SPLIT: position pass over the limit and normal rows]
//   → qd' = v_free + L⁻ᵀ(Wλ) → semi-implicit integrate + limit backstop.
//
// λ is zeroed once per call, so it is carried across the llc frames of a
// K1b call; the factor is rebuilt at each frame's first substep.
//
// Interface (all f32, contiguous, row-major):
//   q (B,NQ), qd (B,NV), tau (B,NJ), ground_z (B,), friction (B,),
//   stones (K·11, B) for K > 0, bars (KB·8, B) for KB > 0, grabs (NGRAB·4,
//   B) for NGRAB > 0, hf (B, PHF·PHF + 3) for PHF > 0, tris (KT·10, B) for
//   KT > 0 (each unused, and may be null, otherwise)
//   → q' (B,NQ), qd' (B,NV), depth (B,NS), normal_impulse (B,NS)
// depth and normal impulse are those of the LAST substep. Row k·11 + c of
// stones is component c of stone k: center (3), quaternion wxyz (4), half
// extents (3), active (1). Component-major, so that neighbouring threads
// read neighbouring addresses; the caller culls the stones to the K
// nearest the root and packs them once per control step. Row k·8 + c of
// bars is component c of bar k: end a (3), end b (3), radius, active; row
// g·4 + c of grabs is component c of grab g: active, target (3). Bars are
// not culled; both are packed once per control step. Row b of hf is env b's
// window, its PHF × PHF heights row-major, then the world x0, y0 of its
// corner cell and the cell size; the caller cuts it from the env's grid
// around the root once per control step. Unlike the other scene inputs it
// is env-major: a thread reads its own window, four corners per sphere at
// data-dependent cells, and env-major keeps each pair of corners in one
// 32-byte sector, where component-major would spread them B floats apart.
// Row k·10 + c of tris is component c of face k: vertex a (3), b (3), c
// (3), active (1); the caller culls the faces to the KT nearest the root
// and packs them once per control step.
//
// Stone narrowphase. It follows the plain version (ops/collide.py,
// terrain/scene.py::sphere_box_depth), not the TPU kernel, where the two
// differ: the center counts as outside the box when its distance to it is
// above 1e-9 (the TPU kernel: 1e-6, with 1e-18 under the root); inside, the
// first of equally near faces wins; of equally deep stones the first wins
// (the TPU kernel averages over ties); a stone replaces the plane only
// where strictly deeper. A contact's rows are n·Jc, t1·Jc, t2·Jc with the
// branchless tangent basis of ops/solver.py::tangent_basis; the K = 0
// instances keep the constant-folded form for the plane's +z normal
// (rows z, x, y of the point Jacobian).
//
// Bar narrowphase. It follows the plain version (terrain/scene.py::
// sphere_capsule_depth) where the TPU kernel differs: the distance is the
// plain norm (the TPU kernel adds 1e-18 under the root), and of equally deep
// bars the first wins (the TPU kernel averages over ties). A center on the
// axis (distance ≤ 1e-9) takes the normal +z. Spheres the table marks
// no_bar (the grabbing palms, which wrap the bar they hold) skip the bars;
// a bar replaces the plane or a stone only where strictly deeper.
//
// Heightfield narrowphase. It computes what the plain version computes
// (terrain/scene.py::hf_corners, hf_sample, hf_normal and the heightfield
// branch of ops/collide.py): the cell of the center's xy clamped to
// [0, PHF − 1.001], the four corner heights read by index from the env's
// window in global memory through the read-only path, the bilinear height,
// its analytic gradient, the unit normal (−∂h/∂x, −∂h/∂y, 1) divided by its
// norm (a division, as the plain path divides, not rsqrtf), the depth
// r − (c_z − h)·n_z and the contact point (c_x, c_y, h). It comes after the
// plane and replaces it only where strictly deeper. The TPU kernel samples
// the window by one-hot contractions (Mosaic has no vector gather); a
// direct read selects the same four values.
//
// Mesh narrowphase. It follows the plain version (terrain/scene.py::
// sphere_triangle_depth and the mesh branch of ops/collide.py), not the TPU
// kernel, where the two differ: the closest point by Ericson's region walk
// (the first region that holds the center wins; here the walk stops there,
// where the plain version selects among all regions' points), the distance
// the plain norm (the TPU kernel: 1e-18 under the root), the normal the
// offset over the distance or, for a center on the face (distance ≤ 1e-9),
// the face normal turned to the center's side (the TPU kernel: an rsqrt
// with 1e-24 under it), and of equally deep faces the first wins (the TPU
// kernel averages over ties): tread and riser share the nosing edge, a
// quad's two triangles their diagonal. It comes after the plane and
// replaces it only where strictly deeper. The faces are read from the
// component-major input through the read-only path, not staged: 640 bytes
// per env would grow a ~8.3 KB frame by 8%, and neighbouring threads read
// neighbouring addresses, so each read of a face component is one 128-byte
// line per warp, from L1 / L2 (the faces of B = 4096 envs take 2.6 MB).
//
// Split impulse. It follows the plain version (ops/step.py): the limit and
// contact-normal rows take the target −max(−gap, 0)/dt (no approach past
// the surface) and keep their push-out bias aside; after the velocity
// sweeps a scalar PGS from λ_pos = 0 over those NLIM + NS rows alone
// (equality rows masked, friction rows bounded to [0, 0] by μ = 0, so
// neither moves), against −bias, with the same W, diagonals and activity,
// carrying z_pos = Wλ_pos; L⁻ᵀz_pos is the pseudo-velocity, added to the
// clamped velocity for the position advance only. The limit backstop
// clamps the advanced position and zeroes only the real outward velocity.
// λ_pos, z_pos and the biases sit in an empty base (SplitState<false>).
// The pass indexes its rows from NE, behind the rods, the planar lock and
// the grab rows, which it never visits (as the JAX reference's static visit
// list); a contact's bias is taken from its sphere's deepest feature (plane,
// stone or bar), and λ_pos restarts from zero in every substep of every llc
// frame, with no warm start.
//
// Equality rows. A rod's three rows are the difference of the point
// Jacobians of its two anchors, with the target −(baumgarte/dt)·(xa − xb)
// clipped to ±max_push_vel; a planar row is a unit row on base column 1, 3
// or 5 with the drift y, 2(wx+yz) or 2(wz+xy) (sine surrogates of roll and
// yaw) under the same clipped target. They are always active, unbounded in
// the sweep, and swept first. The rods come in the packed table behind the
// ancestry: link a, link b, anchor a, anchor b per rod. A grab's three rows
// are the point Jacobian of the palm anchor (a world anchor: no second
// Jacobian), the drift palm − target under the same clipped target; unlike
// the rods they are masked by the grab's activity, an input constant over
// the call: an inactive grab's λ is zero in the warm start and after every
// sweep, as the plain solver's mask makes it. Behind the rods the table holds
// link and anchor per grab, then (KB > 0) the no_bar flag per sphere.
//
// Design. One thread per env: the per-env work is a long serial chain of
// small dense linear algebra (CRBA, Cholesky, triangular solves, Gauss–
// Seidel sweeps), the counterpart of the TPU kernel's one-env-per-lane
// tile. Any B is allowed; threads past B return. The factor L (packed lower
// triangle), the reciprocal diagonal, W (NR×NV), λ and z = Wλ live in a
// global workspace laid out component-major, (C, B), so neighbouring
// threads touch neighbouring addresses. Small per-link state, the stones
// and the per-sphere normals live in local memory. The model (sizes are
// template constants) comes as one packed f32 table, staged into shared
// memory once per block. The kernel launches on the caller's stream and
// allocates nothing. A heightfield window is not staged: at 1 KB per env it
// would double a frame of ~8 KB of local memory, and its four corner reads
// per sphere and substep go to L1 / L2 (the windows of B = 4096 envs take
// 4.2 MB of the 50 MB L2).
//
// What bounds it on this card. Near contact a K1a call needs ~1.6e5 fp32
// operations per env (~3.3e5 with every row active, counted by
// ops/cuda/engine.py::k1_flops) against 0.65 KB of inputs and outputs
// (0.9 KB with six stones; 1.7 KB with a heightfield window, whose
// narrowphase adds ~2.8e3 operations; 1.3 KB with 16 faces, whose 896
// sphere-face walks add ~7e4; split impulse's position pass adds ~1.5e4), a
// K1e call on Cassie ~6.3e5 (its 20 substeps) against 0.47 KB, and a K1d
// call on the hanging monkey ~5.9e4 against 0.9 KB (the 16 bars are 0.5 KB
// of it), so the floor is the fp32 rate. This simple
// design is far from it: the workspace round-trips through L2 on every row
// of every sweep, one thread per env leaves most of the SMs' warp slots
// empty at B = 4096, and the serial chain has little instruction-level
// parallelism. Left on the table: W and L in shared memory or registers,
// several threads per env (a warp per env splitting the NV-long dot
// products), the structural zeros of the contact Jacobians, and skipping
// inactive rows.
//
// Compiled with the host compiler (K1_HOST_CHECK defined, no CUDA), the
// same per-env code runs as a plain loop: tests use that to check this
// file's arithmetic on machines without a card. With K1_ONLY=<n> defined
// only the n-th instance is compiled, so that one compiler process per
// instance can build them side by side.

#ifdef K1_HOST_CHECK
#include <math.h>
#define HD
#define KERNEL_DEV inline
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
static inline void sincosf_(float x, float* s, float* c) { *s = sinf(x); *c = cosf(x); }
static inline float ldg_(const float* p) { return *p; }
#else
#include <cuda_runtime.h>
#define HD __device__
#define KERNEL_DEV __device__ __forceinline__
static __device__ __forceinline__ void sincosf_(float x, float* s, float* c) { sincosf(x, s, c); }
static __device__ __forceinline__ float ldg_(const float* p) { return __ldg(p); }
#endif

namespace k1 {

// ---------------------------------------------------------------- layout
// The packed model table. ops/cuda/engine.py::pack_tables writes exactly
// this order; the launch checks the size.
template <int NL, int NS, int NLIM, int NP2P, bool PLANAR, int KB, int NGRAB>
struct Layout {
  static constexpr int NJ = NL - 1;
  static constexpr int NV = NJ + 6;
  static constexpr int NQ = NJ + 7;
  static constexpr int NE0 = 3 * NP2P + (PLANAR ? 3 : 0);  // always-active equality rows
  static constexpr int NE = NE0 + 3 * NGRAB;               // ... and the grab rows
  static constexpr int NR = NE + NLIM + 3 * NS;
  // scalars
  static constexpr int DT = 0, GX = 1, GY = 2, GZ = 3, BETA = 4, SLOP = 5,
                       MAXPUSH = 6, CFM = 7, MARGIN = 8, LIMMARGIN = 9,
                       LIMSLOP = 10, MAXVEL = 11;
  static constexpr int NCFG = 12;
  static constexpr int PARENT = NCFG;             // NL
  static constexpr int JQUAT = PARENT + NL;       // NJ × 4
  static constexpr int JAXIS = JQUAT + NJ * 4;    // NJ × 3
  static constexpr int JPOS = JAXIS + NJ * 3;     // NJ × 3
  static constexpr int COM = JPOS + NJ * 3;       // NL × 3
  static constexpr int MASS = COM + NL * 3;       // NL
  static constexpr int INERTIA = MASS + NL;       // NL × 9 (link frame)
  static constexpr int SPHLINK = INERTIA + NL * 9;  // NS
  static constexpr int SPHPOS = SPHLINK + NS;     // NS × 3
  static constexpr int SPHR = SPHPOS + NS * 3;    // NS
  static constexpr int DAMP = SPHR + NS;          // NJ
  static constexpr int STIFF = DAMP + NJ;         // NJ
  static constexpr int SPRREF = STIFF + NJ;       // NJ
  static constexpr int JDIAG = SPRREF + NJ;       // NJ: dt(c + dt k) + armature
  static constexpr int LIMLO = JDIAG + NJ;        // NJ
  static constexpr int LIMHI = LIMLO + NJ;        // NJ
  static constexpr int LIMIDX = LIMHI + NJ;       // NLIM
  static constexpr int PDGAIN = LIMIDX + NLIM;    // NJ: actuated · kp (PD mode)
  static constexpr int ANC = PDGAIN + NJ;         // NL × NJ (0/1)
  static constexpr int P2P = ANC + NL * NJ;        // NP2P × 8: link a, link b, anchors a, b
  static constexpr int GRAB = P2P + NP2P * 8;     // NGRAB × 4: link, anchor
  static constexpr int NOBAR = GRAB + NGRAB * 4;  // NS if KB > 0: 1 = skips bars
  static constexpr int SIZE = NOBAR + (KB > 0 ? NS : 0);
  // workspace components per env
  static constexpr int NLOW = NV * (NV + 1) / 2;
  static constexpr int WS_L = 0;                  // packed lower factor
  static constexpr int WS_DINV = WS_L + NLOW;     // 1 / L_ii
  static constexpr int WS_W = WS_DINV + NV;       // NR × NV
  static constexpr int WS_LAM = WS_W + NR * NV;   // NR
  static constexpr int WS_Z = WS_LAM + NR;        // NV
  static constexpr int WS_SIZE = WS_Z + NV;
};

HD inline void cross3(const float* a, const float* b, float* o) {
  float x = a[1] * b[2] - a[2] * b[1];
  float y = a[2] * b[0] - a[0] * b[2];
  float z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}

HD inline float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

HD inline void qmul(const float* a, const float* b, float* o) {
  float w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  float x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  float y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  float z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

// v + 2 q_v × (q_v × v + q_w v)
HD inline void qrot(const float* q, const float* v, float* o) {
  float t[3], u[3];
  cross3(q + 1, v, t);
  t[0] += q[0] * v[0]; t[1] += q[0] * v[1]; t[2] += q[0] * v[2];
  cross3(q + 1, t, u);
  o[0] = v[0] + 2.0f * u[0];
  o[1] = v[1] + 2.0f * u[1];
  o[2] = v[2] + 2.0f * u[2];
}

HD inline void qmat(const float* q, float* R) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  float xx = x * x, yy = y * y, zz = z * z;
  float xy = x * y, xz = x * z, yz = y * z;
  float wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1.0f - 2.0f * (yy + zz); R[1] = 2.0f * (xy - wz); R[2] = 2.0f * (xz + wy);
  R[3] = 2.0f * (xy + wz); R[4] = 1.0f - 2.0f * (xx + zz); R[5] = 2.0f * (yz - wx);
  R[6] = 2.0f * (xz - wy); R[7] = 2.0f * (yz + wx); R[8] = 1.0f - 2.0f * (xx + yy);
}

HD inline void matvec3(const float* R, const float* v, float* o) {
  for (int i = 0; i < 3; ++i) o[i] = R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2];
}

HD inline float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

HD inline float sgn0(float x) { return (float)(x > 0.0f) - (float)(x < 0.0f); }

// Closest point o of triangle (a, b, c) to p: Ericson's barycentric region
// walk, the first region that holds p winning (vertex a, b, c, edge ab, ac,
// bc, else the interior), with the plain version's 1e-12 guards on every
// denominator.
HD inline void closest_on_triangle(const float* p, const float* a, const float* b,
                                   const float* c, float* o) {
  const float eps = 1e-12f;
  float ab[3], ac[3], ap[3], bp[3], cp[3];
  for (int i = 0; i < 3; ++i) {
    ab[i] = b[i] - a[i]; ac[i] = c[i] - a[i]; ap[i] = p[i] - a[i];
    bp[i] = p[i] - b[i]; cp[i] = p[i] - c[i];
  }
  const float d1 = dot3(ab, ap), d2 = dot3(ac, ap);
  if (d1 <= 0.0f && d2 <= 0.0f) { for (int i = 0; i < 3; ++i) o[i] = a[i]; return; }
  const float d3 = dot3(ab, bp), d4 = dot3(ac, bp);
  if (d3 >= 0.0f && d4 <= d3) { for (int i = 0; i < 3; ++i) o[i] = b[i]; return; }
  const float d5 = dot3(ab, cp), d6 = dot3(ac, cp);
  if (d6 >= 0.0f && d5 <= d6) { for (int i = 0; i < 3; ++i) o[i] = c[i]; return; }
  const float vc = d1 * d4 - d3 * d2;
  if (vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f) {
    const float v = d1 / fmaxf(d1 - d3, eps);
    for (int i = 0; i < 3; ++i) o[i] = a[i] + v * ab[i];
    return;
  }
  const float vb = d5 * d2 - d1 * d6;
  if (vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f) {
    const float w = d2 / fmaxf(d2 - d6, eps);
    for (int i = 0; i < 3; ++i) o[i] = a[i] + w * ac[i];
    return;
  }
  const float va = d3 * d6 - d5 * d4;
  if (va <= 0.0f && d4 - d3 >= 0.0f && d5 - d6 >= 0.0f) {
    const float w = (d4 - d3) / fmaxf((d4 - d3) + (d5 - d6), eps);
    for (int i = 0; i < 3; ++i) o[i] = b[i] + w * (c[i] - b[i]);
    return;
  }
  const float denom = 1.0f / fmaxf(va + vb + vc, eps);
  const float v = vb * denom, w = vc * denom;
  for (int i = 0; i < 3; ++i) o[i] = a[i] + ab[i] * v + ac[i] * w;
}

constexpr int STONE_C = 11;   // floats per stone: center, quaternion, half extents, active
constexpr int BAR_C = 8;      // floats per bar: end a, end b, radius, active
constexpr int GRAB_C = 4;     // floats per grab: active, target
constexpr int TRI_C = 10;     // floats per mesh face: vertices a, b, c, active

// The bars and the grab state of a call. Empty bases where there are none,
// so that the instances without them keep their stack frames.
template <int KB>
struct BarState { float bar[KB][BAR_C]; };
template <>
struct BarState<0> {};
template <int NGRAB>
struct GrabState { float gact[NGRAB], gtgt[NGRAB][3]; };
template <>
struct GrabState<0> {};
// The heightfield window of a call: where the env's heights start in global
// memory, and the world x0, y0 of its corner cell and the cell size.
template <int PHF>
struct HfState { const float* hp; float hx0, hy0, hcell; };
template <>
struct HfState<0> {};
// The mesh faces of a call: where the env's first component starts in the
// component-major input, and the stride between components (B).
template <int KT>
struct TriState { const float* tp; int tstride; };
template <>
struct TriState<0> {};
// Split impulse: the push-out bias of the NP limit and contact-normal rows,
// their pseudo-impulses and z_pos = Wλ_pos (NV), which the impulse map turns
// into the pseudo-velocity in place.
template <bool SPLIT, int NP, int NV>
struct SplitState { float bpos[NP], lpos[NP], zpos[NV]; };
template <int NP, int NV>
struct SplitState<false, NP, NV> {};

// Per-env state of one call, held in local memory.
template <int NL, int NS, int NLIM, int K, int NP2P, bool PLANAR, int KB, int NGRAB, int PHF,
          int KT, bool SPLIT>
struct Env : BarState<KB>, GrabState<NGRAB>, HfState<PHF>, TriState<KT>,
             SplitState<SPLIT, NLIM + NS, NL + 5> {
  using L = Layout<NL, NS, NLIM, NP2P, PLANAR, KB, NGRAB>;
  float q[L::NQ], qd[L::NV], tau[L::NJ];
  float ground, fric;
  // kinematics of the current substep
  float pos[NL][3], quat[NL][4], omega[NL][3], R[NL][9], comw[NL][3], Iw[NL][9];
  float ja[L::NJ][3];
  float depth[NS], cpt[NS][3];
  float nrm[K > 0 || KB > 0 || PHF > 0 || KT > 0 ? NS : 1][3];  // contact normals (plane only: +z)
  float stone[K > 0 ? K : 1][STONE_C];
  float bias[L::NV], vfree[L::NV];
  float c[L::NR], act[L::NR], diag[L::NR], finv[NS][3];
  int start[L::NR];
  float nimp[NS];
};

// Workspace accessor: component c of env t, component-major (C, B).
struct WS {
  float* base;
  int B, t;
  HD float& operator()(int c) const { return base[(long long)c * B + t]; }
};

template <class L>
HD inline float& Lget(const WS& ws, int i, int j) {  // i >= j
  return ws(L::WS_L + i * (i + 1) / 2 + j);
}

// ------------------------------------------------------------- substep
template <int NL, int NS, int NLIM, int ITERS, int K, int NP2P, bool PLANAR, int KB, int NGRAB,
          int PHF, int KT, bool SPLIT>
HD void substep(Env<NL, NS, NLIM, K, NP2P, PLANAR, KB, NGRAB, PHF, KT, SPLIT>& e, const float* tab,
                const WS& ws, bool factorize) {
  using L = Layout<NL, NS, NLIM, NP2P, PLANAR, KB, NGRAB>;
  constexpr int NJ = L::NJ, NV = L::NV, NR = L::NR, NE = L::NE;
  constexpr bool GENERAL_NORMALS = K > 0 || KB > 0 || PHF > 0 || KT > 0;
  // the stone and bar branches set the plane's normal themselves
  static_assert(PHF == 0 || (K == 0 && KB == 0), "no instance combines a heightfield with "
                "stones or bars");
  static_assert(KT == 0 || (K == 0 && KB == 0 && PHF == 0), "no instance combines a mesh with "
                "stones, bars or a heightfield");
  const float dt = tab[L::DT];

  // ---------------- FK along the quaternion chain
  for (int k = 0; k < 3; ++k) { e.pos[0][k] = e.q[k]; e.omega[0][k] = e.qd[3 + k]; }
  for (int k = 0; k < 4; ++k) e.quat[0][k] = e.q[3 + k];
  for (int i = 1; i < NL; ++i) {
    const int j = i - 1;
    const int p = (int)tab[L::PARENT + i];
    const float* axis = tab + L::JAXIS + 3 * j;
    float qpre[4], aw[3], off[3];
    qmul(e.quat[p], tab + L::JQUAT + 4 * j, qpre);
    qrot(qpre, axis, aw);
    qrot(e.quat[p], tab + L::JPOS + 3 * j, off);
    float sh, ch;
    sincosf_(e.q[7 + j] * 0.5f, &sh, &ch);
    const float dq[4] = {ch, axis[0] * sh, axis[1] * sh, axis[2] * sh};
    qmul(qpre, dq, e.quat[i]);
    for (int k = 0; k < 3; ++k) {
      e.pos[i][k] = e.pos[p][k] + off[k];
      e.omega[i][k] = e.omega[p][k] + aw[k] * e.qd[6 + j];
      e.ja[j][k] = aw[k];
    }
  }
  for (int l = 0; l < NL; ++l) {
    qmat(e.quat[l], e.R[l]);
    float cw[3];
    matvec3(e.R[l], tab + L::COM + 3 * l, cw);
    for (int k = 0; k < 3; ++k) e.comw[l][k] = e.pos[l][k] + cw[k];
    // R I Rᵀ
    const float* I = tab + L::INERTIA + 9 * l;
    float IRt[9];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        IRt[3 * a + b] = I[3 * a] * e.R[l][3 * b] + I[3 * a + 1] * e.R[l][3 * b + 1] +
                         I[3 * a + 2] * e.R[l][3 * b + 2];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        e.Iw[l][3 * a + b] = e.R[l][3 * a] * IRt[b] + e.R[l][3 * a + 1] * IRt[3 + b] +
                             e.R[l][3 * a + 2] * IRt[6 + b];
  }

  // ---------------- spheres vs the plane, then vs the heightfield, the
  // stones and the bars
  for (int s = 0; s < NS; ++s) {
    const int l = (int)tab[L::SPHLINK + s];
    const float rad = tab[L::SPHR + s];
    float cw[3];
    matvec3(e.R[l], tab + L::SPHPOS + 3 * s, cw);
    const float cx = e.pos[l][0] + cw[0], cy = e.pos[l][1] + cw[1], cz = e.pos[l][2] + cw[2];
    e.depth[s] = rad - (cz - e.ground);
    e.cpt[s][0] = cx; e.cpt[s][1] = cy; e.cpt[s][2] = e.ground;
    if constexpr (PHF > 0) {
      const float umax = (float)(PHF - 1.001);
      const float u = clampf((cx - e.hx0) / e.hcell, 0.0f, umax);
      const float v = clampf((cy - e.hy0) / e.hcell, 0.0f, umax);
      const float fi = floorf(u), fj = floorf(v);
      const float fu = u - fi, fv = v - fj, gu = 1.0f - fu, gv = 1.0f - fv;
      const float* h0 = e.hp + (int)fi * PHF + (int)fj;
      const float h00 = ldg_(h0), h01 = ldg_(h0 + 1), h10 = ldg_(h0 + PHF),
                  h11 = ldg_(h0 + PHF + 1);
      const float hgt = h00 * gu * gv + h10 * fu * gv + h01 * gu * fv + h11 * fu * fv;
      const float gx = -(((h10 - h00) * gv + (h11 - h01) * fv) / e.hcell);
      const float gy = -(((h01 - h00) * gu + (h11 - h10) * fu) / e.hcell);
      const float nn = sqrtf(gx * gx + gy * gy + 1.0f);
      const float nz = 1.0f / nn;
      const float dh = rad - (cz - hgt) * nz;
      e.nrm[s][0] = 0.0f; e.nrm[s][1] = 0.0f; e.nrm[s][2] = 1.0f;
      if (dh > e.depth[s]) {                    // strictly deeper than the plane
        e.depth[s] = dh;
        e.nrm[s][0] = gx / nn; e.nrm[s][1] = gy / nn; e.nrm[s][2] = nz;
        e.cpt[s][2] = hgt;
      }
    }
    if constexpr (K > 0) {
      // deepest active stone (the first of equals), kept in its box frame
      float best = -1e9f, bn[3] = {0.0f, 0.0f, 1.0f}, bp[3] = {0.0f, 0.0f, 0.0f};
      int bk = -1;
      for (int k = 0; k < K; ++k) {
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
      e.nrm[s][0] = 0.0f; e.nrm[s][1] = 0.0f; e.nrm[s][2] = 1.0f;
      if (bk >= 0 && best > e.depth[s]) {       // strictly deeper than the plane
        const float* st = e.stone[bk];
        float pw[3];
        qrot(st + 3, bn, e.nrm[s]);
        qrot(st + 3, bp, pw);
        e.depth[s] = best;
        for (int a = 0; a < 3; ++a) e.cpt[s][a] = st[a] + pw[a];
      }
    }
    if constexpr (KT > 0) {
      // deepest active face (the first of equals): its closest point and
      // the offset from it to the center, read from the component-major
      // input through the read-only path
      const float cc[3] = {cx, cy, cz};
      auto ld = [&](int k, int comp) {
        return ldg_(e.tp + (long long)(k * TRI_C + comp) * e.tstride);
      };
      float best = -1e9f, bp[3] = {0.0f, 0.0f, 0.0f}, bd[3] = {0.0f, 0.0f, 0.0f}, bdist = 0.0f;
      int bk = -1;
      for (int k = 0; k < KT; ++k) {
        if (!(ld(k, 9) > 0.5f)) continue;
        const float a[3] = {ld(k, 0), ld(k, 1), ld(k, 2)};
        const float b[3] = {ld(k, 3), ld(k, 4), ld(k, 5)};
        const float c[3] = {ld(k, 6), ld(k, 7), ld(k, 8)};
        float p[3], dl[3];
        closest_on_triangle(cc, a, b, c, p);
        for (int i = 0; i < 3; ++i) dl[i] = cc[i] - p[i];
        const float dist = sqrtf(dot3(dl, dl));
        const float dk = rad - dist;
        if (dk > best) {
          best = dk; bk = k; bdist = dist;
          for (int i = 0; i < 3; ++i) { bp[i] = p[i]; bd[i] = dl[i]; }
        }
      }
      e.nrm[s][0] = 0.0f; e.nrm[s][1] = 0.0f; e.nrm[s][2] = 1.0f;
      if (bk >= 0 && best > e.depth[s]) {       // strictly deeper than the plane
        if (bdist > 1e-9f) {
          const float inv = 1.0f / fmaxf(bdist, 1e-9f);
          for (int i = 0; i < 3; ++i) e.nrm[s][i] = bd[i] * inv;
        } else {                                // center on the face: its normal,
          float ab[3], ac[3], ap[3], fn[3];     // turned toward the center's side
          for (int i = 0; i < 3; ++i) {
            ab[i] = ld(bk, 3 + i) - ld(bk, i);
            ac[i] = ld(bk, 6 + i) - ld(bk, i);
            ap[i] = cc[i] - ld(bk, i);
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
    if constexpr (KB > 0) {
      if constexpr (K == 0) { e.nrm[s][0] = 0.0f; e.nrm[s][1] = 0.0f; e.nrm[s][2] = 1.0f; }
      if (!(tab[L::NOBAR + s] > 0.5f)) {
        // deepest active bar (the first of equals): its closest axis point,
        // the offset to the center and its length
        float best = -1e9f, bc[3] = {0.0f, 0.0f, 0.0f}, bd[3] = {0.0f, 0.0f, 0.0f}, bdist = 0.0f;
        int bk = -1;
        for (int k = 0; k < KB; ++k) {
          const float* br = e.bar[k];
          if (!(br[7] > 0.5f)) continue;
          const float ab[3] = {br[3] - br[0], br[4] - br[1], br[5] - br[2]};
          const float rel[3] = {cx - br[0], cy - br[1], cz - br[2]};
          const float tp = clampf(dot3(rel, ab) / fmaxf(dot3(ab, ab), 1e-12f), 0.0f, 1.0f);
          float cl[3], dl[3];
          for (int a = 0; a < 3; ++a) cl[a] = br[a] + tp * ab[a];
          dl[0] = cx - cl[0]; dl[1] = cy - cl[1]; dl[2] = cz - cl[2];
          const float dist = sqrtf(dot3(dl, dl));
          const float dk = rad + br[6] - dist;
          if (dk > best) {
            best = dk; bk = k; bdist = dist;
            for (int a = 0; a < 3; ++a) { bc[a] = cl[a]; bd[a] = dl[a]; }
          }
        }
        if (bk >= 0 && best > e.depth[s]) {    // strictly deeper than the plane or a stone
          const float rb = e.bar[bk][6];
          const float inv = 1.0f / fmaxf(bdist, 1e-9f);
          for (int a = 0; a < 3; ++a) {
            e.nrm[s][a] = bdist > 1e-9f ? bd[a] * inv : (a == 2 ? 1.0f : 0.0f);
            e.cpt[s][a] = bc[a] + e.nrm[s][a] * rb;
          }
          e.depth[s] = best;
        }
      }
    }
  }

  // ---------------- Newton–Euler bias (q̈ = 0, base acceleration −g)
  {
    float alpha[NL][3], acc[NL][3], f[NL][3], n[NL][3];
    alpha[0][0] = alpha[0][1] = alpha[0][2] = 0.0f;
    acc[0][0] = -tab[L::GX]; acc[0][1] = -tab[L::GY]; acc[0][2] = -tab[L::GZ];
    for (int i = 1; i < NL; ++i) {
      const int j = i - 1, p = (int)tab[L::PARENT + i];
      float r[3], t1[3], t2[3], t3[3], wq[3];
      for (int k = 0; k < 3; ++k) r[k] = e.pos[i][k] - e.pos[p][k];
      cross3(alpha[p], r, t1);
      cross3(e.omega[p], r, t2);
      cross3(e.omega[p], t2, t3);
      for (int k = 0; k < 3; ++k) {
        acc[i][k] = acc[p][k] + (t1[k] + t3[k]);
        wq[k] = e.ja[j][k] * e.qd[6 + j];
      }
      cross3(e.omega[p], wq, t1);
      for (int k = 0; k < 3; ++k) alpha[i][k] = alpha[p][k] + t1[k];
    }
    for (int l = 0; l < NL; ++l) {
      const float m = tab[L::MASS + l];
      float rc[3], t1[3], t2[3], t3[3], Ia[3], Iwv[3];
      for (int k = 0; k < 3; ++k) rc[k] = e.comw[l][k] - e.pos[l][k];
      cross3(alpha[l], rc, t1);
      cross3(e.omega[l], rc, t2);
      cross3(e.omega[l], t2, t3);
      for (int k = 0; k < 3; ++k) f[l][k] = m * (acc[l][k] + (t1[k] + t3[k]));
      matvec3(e.Iw[l], alpha[l], Ia);
      matvec3(e.Iw[l], e.omega[l], Iwv);
      cross3(e.omega[l], Iwv, t1);
      cross3(rc, f[l], t2);
      for (int k = 0; k < 3; ++k) n[l][k] = (Ia[k] + t1[k]) + t2[k];
    }
    for (int i = NL - 1; i > 0; --i) {
      const int p = (int)tab[L::PARENT + i];
      float r[3], t1[3];
      for (int k = 0; k < 3; ++k) r[k] = e.pos[i][k] - e.pos[p][k];
      cross3(r, f[i], t1);
      for (int k = 0; k < 3; ++k) {
        f[p][k] += f[i][k];
        n[p][k] += n[i][k] + t1[k];
      }
    }
    for (int k = 0; k < 3; ++k) { e.bias[k] = f[0][k]; e.bias[3 + k] = n[0][k]; }
    for (int j = 0; j < NJ; ++j) e.bias[6 + j] = dot3(e.ja[j], n[j + 1]);
  }

  // ---------------- frame start: CRBA (composites about the base origin)
  // and the Cholesky factor, held for the frame's other substeps
  if (factorize) {
    float cm[NL], chv[NL][3], cI[NL][9];
    const float* O = e.pos[0];
    for (int l = 0; l < NL; ++l) {
      const float m = tab[L::MASS + l];
      float d[3];
      for (int k = 0; k < 3; ++k) d[k] = e.comw[l][k] - O[k];
      const float dd = dot3(d, d);
      cm[l] = m;
      for (int a = 0; a < 3; ++a) {
        chv[l][a] = m * d[a];
        for (int b = 0; b < 3; ++b)
          cI[l][3 * a + b] = e.Iw[l][3 * a + b] + m * ((a == b ? dd : 0.0f) - d[a] * d[b]);
      }
    }
    for (int i = NL - 1; i > 0; --i) {
      const int p = (int)tab[L::PARENT + i];
      cm[p] += cm[i];
      for (int k = 0; k < 3; ++k) chv[p][k] += chv[i][k];
      for (int k = 0; k < 9; ++k) cI[p][k] += cI[i][k];
    }
    // spatial momentum (Lm about O, P) of composite l moving with (w, v@O)
    auto momentum = [&](int l, const float* w, const float* v, float* Lm, float* P) {
      float t1[3], t2[3];
      matvec3(cI[l], w, Lm);
      cross3(chv[l], v, t1);
      cross3(w, chv[l], t2);
      for (int k = 0; k < 3; ++k) {
        Lm[k] += t1[k];
        P[k] = cm[l] * v[k] + t2[k];
      }
    };
    // base block: column b of the 6 base axes (lin x,y,z | ang x,y,z)
    const float zero3[3] = {0.0f, 0.0f, 0.0f};
    for (int a = 0; a < 6; ++a) {
      float ea[3] = {0.0f, 0.0f, 0.0f};
      ea[a % 3] = 1.0f;
      float Lm[3], P[3];
      if (a < 3) momentum(0, zero3, ea, Lm, P);
      else momentum(0, ea, zero3, Lm, P);
      for (int b = 0; b <= a; ++b) Lget<L>(ws, a, b) = b < 3 ? P[b] : Lm[b - 3];
    }
    for (int j = 0; j < NJ; ++j) {
      // motion axis of joint j about O, and the momentum of its composite
      float sv[3], r[3], Lm[3], P[3];
      for (int k = 0; k < 3; ++k) r[k] = O[k] - e.pos[j + 1][k];
      cross3(e.ja[j], r, sv);
      momentum(j + 1, e.ja[j], sv, Lm, P);
      const int row = 6 + j;
      for (int b = 0; b < 6; ++b) Lget<L>(ws, row, b) = b < 3 ? P[b] : Lm[b - 3];
      for (int k = 0; k < j; ++k) {
        float mk = 0.0f;
        if (tab[L::ANC + (j + 1) * NJ + k] > 0.5f) {
          float sk[3], rk[3];
          for (int d = 0; d < 3; ++d) rk[d] = O[d] - e.pos[k + 1][d];
          cross3(e.ja[k], rk, sk);
          mk = dot3(e.ja[k], Lm) + dot3(sk, P);
        }
        Lget<L>(ws, row, 6 + k) = mk;
      }
      Lget<L>(ws, row, row) = dot3(e.ja[j], Lm) + dot3(sv, P) + tab[L::JDIAG + j];
    }
    // left-looking Cholesky in place; the diagonal is clamped at 1e-9
    for (int j = 0; j < NV; ++j) {
      float djj = Lget<L>(ws, j, j);
      for (int k = 0; k < j; ++k) {
        const float ljk = Lget<L>(ws, j, k);
        djj -= ljk * ljk;
      }
      const float dinv = rsqrtf(fmaxf(djj, 1e-9f));
      ws(L::WS_DINV + j) = dinv;
      Lget<L>(ws, j, j) = djj * dinv;
      for (int i = j + 1; i < NV; ++i) {
        float s = Lget<L>(ws, i, j);
        for (int k = 0; k < j; ++k) s -= Lget<L>(ws, i, k) * Lget<L>(ws, j, k);
        Lget<L>(ws, i, j) = s * dinv;
      }
    }
  }

  // forward substitution L y = b from column `from` on (b is zero before it)
  auto fwd = [&](float* y, int from) {
    for (int i = from; i < NV; ++i) {
      float s = y[i];
      for (int k = from; k < i; ++k) s -= Lget<L>(ws, i, k) * y[k];
      y[i] = s * ws(L::WS_DINV + i);
    }
  };
  // back substitution Lᵀ x = y in place
  auto bwd = [&](float* x) {
    for (int i = NV - 1; i >= 0; --i) {
      float s = x[i];
      for (int k = i + 1; k < NV; ++k) s -= Lget<L>(ws, k, i) * x[k];
      x[i] = s * ws(L::WS_DINV + i);
    }
  };

  // ---------------- free velocity
  {
    float y[NV];
    for (int i = 0; i < 6; ++i) y[i] = -e.bias[i];
    for (int j = 0; j < NJ; ++j) {
      const float qj = e.q[7 + j];
      const float tj = e.tau[j] + (-tab[L::DAMP + j] * e.qd[6 + j] -
                                   tab[L::STIFF + j] * (qj - tab[L::SPRREF + j]));
      y[6 + j] = tj - e.bias[6 + j];
    }
    fwd(y, 0);
    bwd(y);
    for (int i = 0; i < NV; ++i) e.vfree[i] = e.qd[i] + dt * y[i];
  }

  // ---------------- rows and W = L⁻¹Jᵀ, one row at a time
  const float beta = tab[L::BETA], maxpush = tab[L::MAXPUSH];
  // point Jacobian (3 × NV) of world point x fixed to link l
  auto point_jacobian = [&](int l, const float* x, float (*Jc)[NV]) {
    float rel[3];
    for (int k = 0; k < 3; ++k) rel[k] = x[k] - e.pos[0][k];
    for (int d = 0; d < 3; ++d)
      for (int k = 0; k < 3; ++k) Jc[d][k] = d == k ? 1.0f : 0.0f;
    // e_k × rel
    Jc[0][3] = 0.0f;     Jc[1][3] = -rel[2]; Jc[2][3] = rel[1];
    Jc[0][4] = rel[2];   Jc[1][4] = 0.0f;    Jc[2][4] = -rel[0];
    Jc[0][5] = -rel[1];  Jc[1][5] = rel[0];  Jc[2][5] = 0.0f;
    for (int j = 0; j < NJ; ++j) {
      float col[3] = {0.0f, 0.0f, 0.0f};
      if (tab[L::ANC + l * NJ + j] > 0.5f) {
        float dx[3];
        for (int k = 0; k < 3; ++k) dx[k] = x[k] - e.pos[j + 1][k];
        cross3(e.ja[j], dx, col);
      }
      for (int d = 0; d < 3; ++d) Jc[d][6 + j] = col[d];
    }
  };
  // equality rows: always active, drift pulled back at a clipped rate
  auto eq_target = [&](float err) { return clampf(-beta * err, -maxpush, maxpush); };
  for (int k = 0; k < NP2P; ++k) {
    const float* rod = tab + L::P2P + 8 * k;
    const int la = (int)rod[0], lb = (int)rod[1];
    float xa[3], xb[3], Ja[3][NV], Jb[3][NV];
    matvec3(e.R[la], rod + 2, xa);
    matvec3(e.R[lb], rod + 5, xb);
    for (int d = 0; d < 3; ++d) { xa[d] += e.pos[la][d]; xb[d] += e.pos[lb][d]; }
    point_jacobian(la, xa, Ja);
    point_jacobian(lb, xb, Jb);
    for (int d = 0; d < 3; ++d) {
      const int r = 3 * k + d;
      float y[NV];
      float cv = 0.0f;
      for (int i = 0; i < NV; ++i) {
        y[i] = Ja[d][i] - Jb[d][i];
        cv += y[i] * e.vfree[i];
      }
      fwd(y, 0);
      for (int i = 0; i < NV; ++i) ws(L::WS_W + r * NV + i) = y[i];
      e.start[r] = 0;
      e.c[r] = cv - eq_target(xa[d] - xb[d]);
      e.act[r] = 1.0f;
    }
  }
  if constexpr (PLANAR) {
    const float w = e.q[3], x = e.q[4], yq = e.q[5], z = e.q[6];
    const int cols[3] = {1, 3, 5};   // base linear y, angular x, angular z
    const float errs[3] = {e.q[1], 2.0f * (w * x + yq * z), 2.0f * (w * z + x * yq)};
    for (int m = 0; m < 3; ++m) {
      const int r = 3 * NP2P + m, col = cols[m];
      float y[NV];
      for (int i = 0; i < NV; ++i) y[i] = 0.0f;
      y[col] = 1.0f;
      fwd(y, col);
      for (int i = 0; i < NV; ++i) ws(L::WS_W + r * NV + i) = y[i];
      e.start[r] = col;
      e.c[r] = e.vfree[col] - eq_target(errs[m]);
      e.act[r] = 1.0f;
    }
  }
  if constexpr (NGRAB > 0)
    for (int g = 0; g < NGRAB; ++g) {
      const float* gr = tab + L::GRAB + 4 * g;
      const int lg = (int)gr[0];
      float xg[3], Jg[3][NV];
      matvec3(e.R[lg], gr + 1, xg);
      for (int d = 0; d < 3; ++d) xg[d] += e.pos[lg][d];
      point_jacobian(lg, xg, Jg);
      for (int d = 0; d < 3; ++d) {
        const int r = L::NE0 + 3 * g + d;
        float y[NV];
        float cv = 0.0f;
        for (int i = 0; i < NV; ++i) {
          y[i] = Jg[d][i];
          cv += y[i] * e.vfree[i];
        }
        fwd(y, 0);
        for (int i = 0; i < NV; ++i) ws(L::WS_W + r * NV + i) = y[i];
        e.start[r] = 0;
        e.c[r] = cv - eq_target(xg[d] - e.gtgt[g][d]);
        e.act[r] = e.gact[g];
      }
    }
  for (int lr = 0; lr < NLIM; ++lr) {
    const int r = NE + lr;
    const int j = (int)tab[L::LIMIDX + lr];
    const float qj = e.q[7 + j];
    const float d_lo = qj - tab[L::LIMLO + j], d_hi = tab[L::LIMHI + j] - qj;
    const float sgn = d_lo <= d_hi ? 1.0f : -1.0f;
    const float gap = fminf(d_lo, d_hi), viol = -gap;
    const float b_l = fminf(beta * fmaxf(viol - tab[L::LIMSLOP], 0.0f), maxpush);
    const int col = 6 + j;
    float y[NV];
    for (int i = 0; i < NV; ++i) y[i] = 0.0f;
    y[col] = sgn;
    fwd(y, col);
    for (int i = 0; i < NV; ++i) ws(L::WS_W + r * NV + i) = y[i];
    e.start[r] = col;
    if constexpr (SPLIT) {       // the push-out goes to the position pass
      e.c[r] = sgn * e.vfree[col] + fmaxf(-viol, 0.0f) / dt;
      e.bpos[lr] = b_l;
    } else {
      e.c[r] = sgn * e.vfree[col] - (b_l - fmaxf(-viol, 0.0f) / dt);
    }
    e.act[r] = gap < tab[L::LIMMARGIN] ? 1.0f : 0.0f;
  }
  for (int s = 0; s < NS; ++s) {
    const int l = (int)tab[L::SPHLINK + s];
    float Jc[3][NV];
    point_jacobian(l, e.cpt[s], Jc);
    const float dep = e.depth[s];
    const float b_n = fminf(beta * fmaxf(dep - tab[L::SLOP], 0.0f), maxpush);
    float push;
    if constexpr (SPLIT) {       // the push-out goes to the position pass
      push = -fmaxf(-dep, 0.0f) / dt;
      e.bpos[NLIM + s] = b_n;
    } else {
      push = b_n - fmaxf(-dep, 0.0f) / dt;
    }
    const float a = dep > -tab[L::MARGIN] ? 1.0f : 0.0f;
    // rows n, t1, t2. K = 0: the normal is +z and the tangent basis x, y,
    // so the rows are z, x, y of Jc. With stones: the sphere's own normal
    // and its branchless tangent basis, projected onto Jc.
    const int comp[3] = {2, 0, 1};
    float dirs[3][3];
    if constexpr (GENERAL_NORMALS) {
      const float nx = e.nrm[s][0], ny = e.nrm[s][1], nz = e.nrm[s][2];
      const float sg = nz >= 0.0f ? 1.0f : -1.0f;
      const float ka = -1.0f / (sg + nz), kb = nx * ny * ka;
      dirs[0][0] = nx; dirs[0][1] = ny; dirs[0][2] = nz;
      dirs[1][0] = 1.0f + sg * nx * nx * ka; dirs[1][1] = sg * kb; dirs[1][2] = -sg * nx;
      dirs[2][0] = kb; dirs[2][1] = sg + ny * ny * ka; dirs[2][2] = -ny;
    }
    for (int m = 0; m < 3; ++m) {
      const int r = NE + NLIM + 3 * s + m;
      float y[NV];
      float cv = 0.0f;
      for (int i = 0; i < NV; ++i) {
        if constexpr (GENERAL_NORMALS)
          y[i] = dirs[m][0] * Jc[0][i] + dirs[m][1] * Jc[1][i] + dirs[m][2] * Jc[2][i];
        else
          y[i] = Jc[comp[m]][i];
        cv += y[i] * e.vfree[i];
      }
      fwd(y, 0);
      for (int i = 0; i < NV; ++i) ws(L::WS_W + r * NV + i) = y[i];
      e.start[r] = 0;
      e.c[r] = m == 0 ? cv - push : cv;
      e.act[r] = a;
    }
  }

  // ---------------- matrix-free block PGS: carry z = Wλ, residual of row r
  // on demand as c_r + W_r·z + cfm λ_r (the same iteration as A = WᵀW + cfm)
  const float cfm = tab[L::CFM];
  auto wdot = [&](int r1, int r2) {
    const int from = e.start[r1] > e.start[r2] ? e.start[r1] : e.start[r2];
    float s = 0.0f;
    for (int i = from; i < NV; ++i) s += ws(L::WS_W + r1 * NV + i) * ws(L::WS_W + r2 * NV + i);
    return s;
  };
  for (int r = 0; r < NR; ++r) e.diag[r] = fmaxf(wdot(r, r) + cfm, 1e-9f);
  for (int s = 0; s < NS; ++s) {
    const int t1 = NE + NLIM + 3 * s + 1, t2 = t1 + 1;
    const float a11 = fmaxf(wdot(t1, t1) + cfm, 1e-9f);
    const float a22 = fmaxf(wdot(t2, t2) + cfm, 1e-9f);
    const float a12 = wdot(t1, t2);
    const float det = fmaxf(a11 * a22 - a12 * a12, 1e-12f);
    e.finv[s][0] = a22 / det; e.finv[s][1] = a11 / det; e.finv[s][2] = -a12 / det;
  }
  // warm start: the previous substep's λ, masked by this substep's activity
  for (int i = 0; i < NV; ++i) ws(L::WS_Z + i) = 0.0f;
  for (int r = 0; r < NR; ++r) {
    const float lam = ws(L::WS_LAM + r) * e.act[r];
    ws(L::WS_LAM + r) = lam;
    for (int i = e.start[r]; i < NV; ++i) ws(L::WS_Z + i) += ws(L::WS_W + r * NV + i) * lam;
  }
  auto res = [&](int r) {
    float s = e.c[r] + cfm * ws(L::WS_LAM + r);
    for (int i = e.start[r]; i < NV; ++i) s += ws(L::WS_W + r * NV + i) * ws(L::WS_Z + i);
    return s;
  };
  auto apply = [&](int r, float nw) {
    const float d = nw - ws(L::WS_LAM + r);
    ws(L::WS_LAM + r) = nw;
    for (int i = e.start[r]; i < NV; ++i) ws(L::WS_Z + i) += ws(L::WS_W + r * NV + i) * d;
  };
  for (int it = 0; it < ITERS; ++it) {
    for (int r = 0; r < L::NE0; ++r) apply(r, ws(L::WS_LAM + r) - res(r) / e.diag[r]);
    if constexpr (NGRAB > 0)   // grab rows: unbounded, masked by the grab's activity
      for (int r = L::NE0; r < NE; ++r)
        apply(r, (ws(L::WS_LAM + r) - res(r) / e.diag[r]) * e.act[r]);
    for (int r = NE; r < NE + NLIM; ++r)
      apply(r, fmaxf(0.0f, ws(L::WS_LAM + r) - res(r) / e.diag[r]) * e.act[r]);
    for (int s = 0; s < NS; ++s) {
      const int b0 = NE + NLIM + 3 * s;
      apply(b0, fmaxf(0.0f, ws(L::WS_LAM + b0) - res(b0) / e.diag[b0]) * e.act[b0]);
      const float bound = e.fric * ws(L::WS_LAM + b0);
      const float r1 = res(b0 + 1), r2 = res(b0 + 2);
      const float d1 = -(e.finv[s][0] * r1 + e.finv[s][2] * r2);
      const float d2 = -(e.finv[s][2] * r1 + e.finv[s][1] * r2);
      const float l1 = ws(L::WS_LAM + b0 + 1), l2 = ws(L::WS_LAM + b0 + 2);
      const float n1 = clampf(l1 + d1, -bound, bound) * e.act[b0 + 1];
      const float n2 = clampf(l2 + d2, -bound, bound) * e.act[b0 + 2];
      const float e1 = n1 - l1, e2 = n2 - l2;
      ws(L::WS_LAM + b0 + 1) = n1;
      ws(L::WS_LAM + b0 + 2) = n2;
      for (int i = 0; i < NV; ++i)
        ws(L::WS_Z + i) += ws(L::WS_W + (b0 + 1) * NV + i) * e1 + ws(L::WS_W + (b0 + 2) * NV + i) * e2;
    }
  }
  for (int s = 0; s < NS; ++s) e.nimp[s] = ws(L::WS_LAM + NE + NLIM + 3 * s);

  // ---------------- split impulse: the position pass. Scalar PGS over the
  // limit rows and the contact normals only (the equality rows are masked,
  // the friction rows bounded to [0, 0] by μ = 0), from λ_pos = 0 against
  // −bias, with the same W, diagonals and activity; z_pos = Wλ_pos carried.
  if constexpr (SPLIT) {
    constexpr int NP = NLIM + NS;
    for (int i = 0; i < NV; ++i) e.zpos[i] = 0.0f;
    for (int k = 0; k < NP; ++k) e.lpos[k] = 0.0f;
    for (int it = 0; it < ITERS; ++it)
      for (int k = 0; k < NP; ++k) {
        const int r = k < NLIM ? NE + k : NE + NLIM + 3 * (k - NLIM);
        float res_p = cfm * e.lpos[k] - e.bpos[k];
        for (int i = e.start[r]; i < NV; ++i) res_p += ws(L::WS_W + r * NV + i) * e.zpos[i];
        const float nw = fmaxf(0.0f, e.lpos[k] - res_p / e.diag[r]) * e.act[r];
        const float d = nw - e.lpos[k];
        e.lpos[k] = nw;
        for (int i = e.start[r]; i < NV; ++i) e.zpos[i] += ws(L::WS_W + r * NV + i) * d;
      }
  }

  // ---------------- impulse map and integration
  float qdn[NV];
  for (int i = 0; i < NV; ++i) qdn[i] = ws(L::WS_Z + i);
  bwd(qdn);
  const float maxvel = tab[L::MAXVEL];
  for (int i = 0; i < NV; ++i) qdn[i] = clampf(e.vfree[i] + qdn[i], -maxvel, maxvel);
  // the velocity that advances the positions: with split impulse the
  // pseudo-velocity L⁻ᵀz_pos joins the real one here and nowhere else
  if constexpr (SPLIT) bwd(e.zpos);
  auto qi = [&](int i) {
    if constexpr (SPLIT) return qdn[i] + e.zpos[i];
    else return qdn[i];
  };

  for (int k = 0; k < 3; ++k) e.q[k] += dt * qi(k);
  {
    const float hx = qi(3) * (0.5f * dt), hy = qi(4) * (0.5f * dt), hz = qi(5) * (0.5f * dt);
    const float theta = sqrtf(hx * hx + hy * hy + hz * hz + 1e-24f);
    float sn, cs;
    sincosf_(theta, &sn, &cs);
    const float sc = sn / theta;
    const float dq[4] = {cs, hx * sc, hy * sc, hz * sc};
    float bq[4];
    qmul(dq, e.q + 3, bq);
    const float inv = rsqrtf(bq[0] * bq[0] + bq[1] * bq[1] + bq[2] * bq[2] + bq[3] * bq[3]);
    for (int k = 0; k < 4; ++k) e.q[3 + k] = bq[k] * inv;
  }
  const float limslop = tab[L::LIMSLOP];
  for (int j = 0; j < NJ; ++j) {
    const float raw = e.q[7 + j] + dt * qi(6 + j);
    const float lo = tab[L::LIMLO + j] - limslop, hi = tab[L::LIMHI + j] + limslop;
    float v = qdn[6 + j];
    if (raw > hi && v > 0.0f) v = 0.0f;
    if (raw < lo && v < 0.0f) v = 0.0f;
    e.q[7 + j] = clampf(raw, lo, hi);
    qdn[6 + j] = v;
  }
  for (int i = 0; i < NV; ++i) e.qd[i] = qdn[i];
}

// One call for env t: NLLC llc frames of NSUB substeps, λ zeroed once at
// the start. PD: ``tau`` holds joint targets and each frame's torque is
// gain·(target − q) at the frame's start; else the torques are held.
template <int NL, int NS, int NLIM, int NSUB, int ITERS, int K, bool PD, int NLLC, int NP2P,
          bool PLANAR, int KB, int NGRAB, int PHF, int KT, bool SPLIT>
KERNEL_DEV void frame(const float* q, const float* qd, const float* tau, const float* gz,
                      const float* fric, const float* stones, const float* bars,
                      const float* grabs, const float* hf, const float* tris, float* q_out,
                      float* qd_out,
                      float* depth_out, float* nimp_out, const float* tab, float* ws_base, int B,
                      int t) {
  using L = Layout<NL, NS, NLIM, NP2P, PLANAR, KB, NGRAB>;
  static_assert(PD || NLLC == 1, "torque mode is launched once per llc frame");
  Env<NL, NS, NLIM, K, NP2P, PLANAR, KB, NGRAB, PHF, KT, SPLIT> e;
  const WS ws{ws_base, B, t};
  float target[PD ? L::NJ : 1];
  for (int i = 0; i < L::NQ; ++i) e.q[i] = q[(long long)t * L::NQ + i];
  for (int i = 0; i < L::NV; ++i) e.qd[i] = qd[(long long)t * L::NV + i];
  for (int i = 0; i < L::NJ; ++i) {
    if constexpr (PD) target[i] = tau[(long long)t * L::NJ + i];
    else e.tau[i] = tau[(long long)t * L::NJ + i];
  }
  e.ground = gz[t];
  e.fric = fric[t];
  if constexpr (K > 0)
    for (int k = 0; k < K; ++k)
      for (int c = 0; c < STONE_C; ++c)
        e.stone[k][c] = stones[(long long)(k * STONE_C + c) * B + t];
  if constexpr (KB > 0)
    for (int k = 0; k < KB; ++k)
      for (int c = 0; c < BAR_C; ++c)
        e.bar[k][c] = bars[(long long)(k * BAR_C + c) * B + t];
  if constexpr (NGRAB > 0)
    for (int g = 0; g < NGRAB; ++g) {
      e.gact[g] = grabs[(long long)(g * GRAB_C) * B + t];
      for (int d = 0; d < 3; ++d) e.gtgt[g][d] = grabs[(long long)(g * GRAB_C + 1 + d) * B + t];
    }
  if constexpr (PHF > 0) {
    e.hp = hf + (long long)t * (PHF * PHF + 3);
    e.hx0 = e.hp[PHF * PHF];
    e.hy0 = e.hp[PHF * PHF + 1];
    e.hcell = e.hp[PHF * PHF + 2];
  }
  if constexpr (KT > 0) {
    e.tp = tris + t;
    e.tstride = B;
  }
  for (int r = 0; r < L::NR; ++r) ws(L::WS_LAM + r) = 0.0f;
  for (int llc = 0; llc < NLLC; ++llc) {
    if constexpr (PD)
      for (int j = 0; j < L::NJ; ++j)
        e.tau[j] = tab[L::PDGAIN + j] * (target[j] - e.q[7 + j]);
    for (int sub = 0; sub < NSUB; ++sub)
      substep<NL, NS, NLIM, ITERS, K, NP2P, PLANAR, KB, NGRAB, PHF, KT, SPLIT>(e, tab, ws,
                                                                              sub == 0);
  }
  for (int i = 0; i < L::NQ; ++i) q_out[(long long)t * L::NQ + i] = e.q[i];
  for (int i = 0; i < L::NV; ++i) qd_out[(long long)t * L::NV + i] = e.qd[i];
  for (int s = 0; s < NS; ++s) {
    depth_out[(long long)t * NS + s] = e.depth[s];
    nimp_out[(long long)t * NS + s] = e.nimp[s];
  }
}

#ifndef K1_HOST_CHECK
constexpr int kThreads = 32;   // one warp per block: B = 4096 spreads over 128 SMs

template <int NL, int NS, int NLIM, int NSUB, int ITERS, int K, bool PD, int NLLC, int NP2P,
          bool PLANAR, int KB, int NGRAB, int PHF, int KT, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
k1_kernel(const float* __restrict__ q, const float* __restrict__ qd,
          const float* __restrict__ tau, const float* __restrict__ gz,
          const float* __restrict__ fric, const float* __restrict__ stones,
          const float* __restrict__ bars, const float* __restrict__ grabs,
          const float* __restrict__ hf, const float* __restrict__ tris,
          float* __restrict__ q_out, float* __restrict__ qd_out,
          float* __restrict__ depth_out, float* __restrict__ nimp_out,
          const float* __restrict__ table, float* __restrict__ ws, int B) {
  using L = Layout<NL, NS, NLIM, NP2P, PLANAR, KB, NGRAB>;
  __shared__ float tab[L::SIZE];
  for (int i = threadIdx.x; i < L::SIZE; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B) return;
  frame<NL, NS, NLIM, NSUB, ITERS, K, PD, NLLC, NP2P, PLANAR, KB, NGRAB, PHF, KT, SPLIT>(
      q, qd, tau, gz, fric, stones, bars, grabs, hf, tris, q_out, qd_out, depth_out, nimp_out, tab,
      ws, B, t);
}

template <int NL, int NS, int NLIM, int NSUB, int ITERS, int K, bool PD, int NLLC, int NP2P,
          bool PLANAR, int KB, int NGRAB, int PHF, int KT, bool SPLIT>
int launch(const float* q, const float* qd, const float* tau, const float* gz, const float* fric,
           const float* stones, const float* bars, const float* grabs, const float* hf,
           const float* tris, float* q_out, float* qd_out, float* depth, float* nimp,
           const float* table, int table_size, float* ws, int B, void* stream) {
  using L = Layout<NL, NS, NLIM, NP2P, PLANAR, KB, NGRAB>;
  if (table_size != L::SIZE || B <= 0 || (K > 0 && stones == nullptr) ||
      (KB > 0 && bars == nullptr) || (NGRAB > 0 && grabs == nullptr) ||
      (PHF > 0 && hf == nullptr) || (KT > 0 && tris == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  k1_kernel<NL, NS, NLIM, NSUB, ITERS, K, PD, NLLC, NP2P, PLANAR, KB, NGRAB, PHF, KT, SPLIT>
      <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          q, qd, tau, gz, fric, stones, bars, grabs, hf, tris, q_out, qd_out, depth, nimp, table,
          ws, B);
  return (int)cudaGetLastError();
}
#endif

}  // namespace k1

// ------------------------------------------------------------ C interface
// One entry per instance: (NL, NS, NLIM, NSUB, ITERS, K, PD, NLLC, NP2P,
// PLANAR, KB, NGRAB, PHF, KT, SPLIT). ops/cuda/engine.py::INSTANTIATIONS
// lists the same names and numbers.
#define K1_INSTANCE(NAME, NL, NS, NLIM, NSUB, ITERS, K, PD, NLLC, NP2P, PLANAR, KB, NGRAB,   \
                    PHF, KT, SPLIT)                                                          \
  extern "C" int NAME##_layout(int* table_size, int* ws_per_env) {                          \
    *table_size = k1::Layout<NL, NS, NLIM, NP2P, PLANAR, KB, NGRAB>::SIZE;                   \
    *ws_per_env = k1::Layout<NL, NS, NLIM, NP2P, PLANAR, KB, NGRAB>::WS_SIZE;                \
    return 0;                                                                                \
  }                                                                                          \
  K1_ENTRY(NAME, NL, NS, NLIM, NSUB, ITERS, K, PD, NLLC, NP2P, PLANAR, KB, NGRAB, PHF, KT,   \
           SPLIT)

#ifndef K1_HOST_CHECK
#define K1_ENTRY(NAME, NL, NS, NLIM, NSUB, ITERS, K, PD, NLLC, NP2P, PLANAR, KB, NGRAB, PHF,  \
                 KT, SPLIT)                                                                  \
  extern "C" int NAME##_launch(const float* q, const float* qd, const float* tau,           \
                               const float* gz, const float* fric, const float* stones,     \
                               const float* bars, const float* grabs, const float* hf,      \
                               const float* tris, float* q_out, float* qd_out,              \
                               float* depth, float* nimp, const float* table,               \
                               int table_size, float* ws, int B, void* stream) {            \
    return k1::launch<NL, NS, NLIM, NSUB, ITERS, K, PD, NLLC, NP2P, PLANAR, KB, NGRAB, PHF,  \
                      KT, SPLIT>(q, qd, tau, gz, fric, stones, bars, grabs, hf, tris, q_out, \
                                 qd_out, depth, nimp, table, table_size, ws, B, stream);    \
  }
#else
// host check: the same per-env code as a plain loop over envs
#define K1_ENTRY(NAME, NL, NS, NLIM, NSUB, ITERS, K, PD, NLLC, NP2P, PLANAR, KB, NGRAB, PHF,  \
                 KT, SPLIT)                                                                  \
  extern "C" int NAME##_host(const float* q, const float* qd, const float* tau,             \
                             const float* gz, const float* fric, const float* stones,       \
                             const float* bars, const float* grabs, const float* hf,        \
                             const float* tris, float* q_out, float* qd_out, float* depth,  \
                             float* nimp, const float* table, int table_size, float* ws,    \
                             int B) {                                                        \
    if (table_size != k1::Layout<NL, NS, NLIM, NP2P, PLANAR, KB, NGRAB>::SIZE || B <= 0)     \
      return 1;                                                                              \
    for (int t = 0; t < B; ++t)                                                              \
      k1::frame<NL, NS, NLIM, NSUB, ITERS, K, PD, NLLC, NP2P, PLANAR, KB, NGRAB, PHF, KT,    \
                SPLIT>(q, qd, tau, gz, fric, stones, bars, grabs, hf, tris, q_out, qd_out,   \
                       depth, nimp, table, ws, B, t);                                        \
    return 0;                                                                                \
  }
#endif

// Walker3D / Child3D at the shipped EngineConfig: 22 links, 14 spheres, 21
// limit rows, 4 substeps, 4 sweeps.
#if !defined(K1_ONLY) || K1_ONLY == 0
K1_INSTANCE(k1a_nl22_ns14_nlim21_sub4_it4, 22, 14, 21, 4, 4, 0, false, 1, 0, false, 0, 0, 0, 0, false)
#endif
// ... over the 6 culled stones of the stepping-stone env
#if !defined(K1_ONLY) || K1_ONLY == 1
K1_INSTANCE(k1c_nl22_ns14_nlim21_sub4_it4_k6, 22, 14, 21, 4, 4, 6, false, 1, 0, false, 0, 0, 0, 0, false)
#endif
// ... PD-servoed, one llc frame per control step (the PD walkers)
#if !defined(K1_ONLY) || K1_ONLY == 2
K1_INSTANCE(k1b_nl22_ns14_nlim21_sub4_it4_llc1, 22, 14, 21, 4, 4, 0, true, 1, 0, false, 0, 0, 0, 0, false)
#endif
// ... PD-servoed, two llc frames per control step (λ carried across them)
#if !defined(K1_ONLY) || K1_ONLY == 3
K1_INSTANCE(k1b_nl22_ns14_nlim21_sub4_it4_llc2, 22, 14, 21, 4, 4, 0, true, 2, 0, false, 0, 0, 0, 0, false)
#endif
// Cassie at its three-rate configuration: 17 links, 5 spheres, 16 limit
// rows, PD-servoed, 10 llc frames of 2 substeps at 600 Hz per control step,
// the two achilles rods (37 rows)
#if !defined(K1_ONLY) || K1_ONLY == 4
K1_INSTANCE(k1e_nl17_ns5_nlim16_sub2_it4_llc10_p2p2, 17, 5, 16, 2, 4, 0, true, 10, 2, false, 0, 0, 0, 0, false)
#endif
// ... locked to the sagittal plane (40 rows)
#if !defined(K1_ONLY) || K1_ONLY == 5
K1_INSTANCE(k1e_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_planar, 17, 5, 16, 2, 4, 0, true, 10, 2, true, 0, 0, 0, 0, false)
#endif
// Walker2D / Crab2D at the shipped EngineConfig: 7 links, 5 spheres, 6 limit
// rows, torque mode, the planar lock (24 rows)
#if !defined(K1_ONLY) || K1_ONLY == 6
K1_INSTANCE(k1e_nl7_ns5_nlim6_sub4_it4_planar, 7, 5, 6, 4, 4, 0, false, 1, 0, true, 0, 0, 0, 0, false)
#endif
// Monkey3D at the shipped EngineConfig: 11 links, 5 spheres, 8 limit rows,
// torque mode, 16 bars, two grabs (6 + 8 + 15 = 29 rows)
#if !defined(K1_ONLY) || K1_ONLY == 7
K1_INSTANCE(k1d_nl11_ns5_nlim8_sub4_it4_kb16_ng2, 11, 5, 8, 4, 4, 0, false, 1, 0, false, 16, 2, 0, 0, false)
#endif
// Walker3D at the shipped EngineConfig over a 16 × 16 heightfield window (the
// terrain families), torque mode
#if !defined(K1_ONLY) || K1_ONLY == 8
K1_INSTANCE(k1f_nl22_ns14_nlim21_sub4_it4_hf16, 22, 14, 21, 4, 4, 0, false, 1, 0, false, 0, 0, 16, 0, false)
#endif
// Walker3D at the shipped EngineConfig over the 16 faces of a culled
// triangle mesh (the stairs), torque mode
#if !defined(K1_ONLY) || K1_ONLY == 9
K1_INSTANCE(k1g_nl22_ns14_nlim21_sub4_it4_kt16, 22, 14, 21, 4, 4, 0, false, 1, 0, false, 0, 0, 0, 16, false)
#endif
// Walker3D on the plane at the shipped EngineConfig with split impulse on,
// torque mode
#if !defined(K1_ONLY) || K1_ONLY == 10
K1_INSTANCE(k1h_nl22_ns14_nlim21_sub4_it4_si, 22, 14, 21, 4, 4, 0, false, 1, 0, false, 0, 0, 0, 0, true)
#endif
// ... over the 6 culled stones of the stepping-stone env with split impulse
#if !defined(K1_ONLY) || K1_ONLY == 11
K1_INSTANCE(k1h_nl22_ns14_nlim21_sub4_it4_k6_si, 22, 14, 21, 4, 4, 6, false, 1, 0, false, 0, 0, 0, 0, true)
#endif
// Cassie and Cassie2D at CASSIE_CONFIG with split impulse: the position pass
// in each of the 20 substeps of a control step, after the rods' rows
#if !defined(K1_ONLY) || K1_ONLY == 12
K1_INSTANCE(k1h_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_si, 17, 5, 16, 2, 4, 0, true, 10, 2, false, 0, 0, 0, 0, true)
#endif
#if !defined(K1_ONLY) || K1_ONLY == 13
K1_INSTANCE(k1h_nl17_ns5_nlim16_sub2_it4_llc10_p2p2_planar_si, 17, 5, 16, 2, 4, 0, true, 10, 2, true, 0, 0, 0, 0, true)
#endif
// Monkey3D with split impulse: the grab rows stay out of the position pass
#if !defined(K1_ONLY) || K1_ONLY == 14
K1_INSTANCE(k1h_nl11_ns5_nlim8_sub4_it4_kb16_ng2_si, 11, 5, 8, 4, 4, 0, false, 1, 0, false, 16, 2, 0, 0, true)
#endif
