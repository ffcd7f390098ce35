// Shared by the K1 kernel sources (engine_k1.cu, engine_k1w.cu): the host
// check's stand-ins for the CUDA built-ins, the packed model table's layout,
// the small vector and quaternion helpers, the floats per stone, mesh face,
// bar and grab of the packed scene inputs, and the closest point on a
// triangle.

#ifndef K1_COMMON_CUH
#define K1_COMMON_CUH

#if defined(K1_HOST_CHECK) || defined(K1W_HOST_CHECK)
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

constexpr int STONE_C = 11;   // floats per stone: center, quaternion, half extents, active
constexpr int TRI_C = 10;     // floats per mesh face: vertices a, b, c, active
constexpr int BAR_C = 8;      // floats per bar: end a, end b, radius, active
constexpr int GRAB_C = 4;     // floats per grab: active, target

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

}  // namespace k1

#endif  // K1_COMMON_CUH
