// K2: batched rays marched over one heightfield grid, one ray per thread,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel mocca_envs_tpu/ops/pallas/raycast.py::
// make_raycaster. Each ray r = o + t·d takes num_steps fixed steps,
// t = (i + 1)·dt for i = 0 … num_steps − 1 with dt = max_t / num_steps, and
// samples the bilinear height under each point. The first point at or under
// the surface ends the march: t_hit is its t and h_hit the height there; a
// ray that never dips under gives t_hit = max_t and h_hit = 0.
//
// It computes what the plain version computes (ops/raycast.py::
// raycast_reference, i.e. terrain/scene.py::hf_sample on one grid): the
// cell of (x, y) clamped to [0, H − 1.001] × [0, W − 1.001], the four
// corners read directly by index (the TPU kernel selects them with one-hot
// contractions: Mosaic has no vector gather), and the bilinear sum in the
// plain version's order. Every product and sum is rounded on its own
// (__fmul_rn, __fadd_rn), so that the compiler fuses none into an FMA and
// the kernel rounds as the plain version does, operation for operation.
//
// Interface (all f32, contiguous, row-major): origins (B,3), directions
// (B,3), grid (H,W), xy0 (2,), cell (1,) → t_hit (B,), h_hit (B,). Any B;
// threads past B return. The grid is read from global memory through the
// read-only path (__ldg): every ray reads it, so it stays in L1 / L2.
// Staging it in shared memory is left to later work (a 129² grid is 66.6 KB,
// within a block's 227 KB).
//
// What bounds it on this card. A march step is ~35 fp32 operations against
// 24 bytes in and 8 bytes out per ray (the grid read once): at 32,768 rays of
// 64 steps the work is ~73 Mflop, ~1.1 µs at the fp32 rate and ~0.3 µs of
// bytes, so one launch's latency dominates.
//
// Compiled with the host compiler (K2_HOST_CHECK defined, no CUDA), the same
// per-ray code runs as a plain loop: tests use that to check this file's
// arithmetic on machines without a card.

#ifdef K2_HOST_CHECK
#include <math.h>
#define HD inline
static inline float fmul_(float a, float b) { return a * b; }
static inline float fadd_(float a, float b) { return a + b; }
static inline float fsub_(float a, float b) { return a - b; }
static inline float fdiv_(float a, float b) { return a / b; }
static inline float ldg_(const float* p) { return *p; }
#else
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
static __device__ __forceinline__ float fmul_(float a, float b) { return __fmul_rn(a, b); }
static __device__ __forceinline__ float fadd_(float a, float b) { return __fadd_rn(a, b); }
static __device__ __forceinline__ float fsub_(float a, float b) { return __fsub_rn(a, b); }
static __device__ __forceinline__ float fdiv_(float a, float b) { return __fdiv_rn(a, b); }
static __device__ __forceinline__ float ldg_(const float* p) { return __ldg(p); }
#endif

namespace k2 {

HD float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

// bilinear height of the grid at world (px, py)
HD float sample(const float* hf, int H, int W, float x0, float y0, float cell, float px,
                float py) {
  const float u = clampf(fdiv_(fsub_(px, x0), cell), 0.0f, (float)(H - 1.001));
  const float v = clampf(fdiv_(fsub_(py, y0), cell), 0.0f, (float)(W - 1.001));
  const float fi = floorf(u), fj = floorf(v);
  const float fu = fsub_(u, fi), fv = fsub_(v, fj);
  const float gu = fsub_(1.0f, fu), gv = fsub_(1.0f, fv);
  const float* h0 = hf + (long long)fi * W + (int)fj;
  const float h00 = ldg_(h0), h01 = ldg_(h0 + 1), h10 = ldg_(h0 + W), h11 = ldg_(h0 + W + 1);
  float h = fmul_(fmul_(h00, gu), gv);
  h = fadd_(h, fmul_(fmul_(h10, fu), gv));
  h = fadd_(h, fmul_(fmul_(h01, gu), fv));
  return fadd_(h, fmul_(fmul_(h11, fu), fv));
}

HD void march(const float* origins, const float* dirs, const float* hf, int H, int W,
              float x0, float y0, float cell, float max_t, float dt, int num_steps,
              float* t_out, float* h_out, int r) {
  const float* o = origins + 3 * (long long)r;
  const float* d = dirs + 3 * (long long)r;
  const float ox = o[0], oy = o[1], oz = o[2], dx = d[0], dy = d[1], dz = d[2];
  float t_hit = max_t, h_hit = 0.0f;
  for (int i = 0; i < num_steps; ++i) {
    const float t = fmul_((float)(i + 1), dt);
    const float px = fadd_(ox, fmul_(t, dx));
    const float py = fadd_(oy, fmul_(t, dy));
    const float pz = fadd_(oz, fmul_(t, dz));
    const float h = sample(hf, H, W, x0, y0, cell, px, py);
    if (pz <= h) {
      t_hit = t;
      h_hit = h;
      break;
    }
  }
  t_out[r] = t_hit;
  h_out[r] = h_hit;
}

#ifndef K2_HOST_CHECK
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
k2_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
          const float* __restrict__ hf, int H, int W, const float* __restrict__ xy0,
          const float* __restrict__ cell, float max_t, float dt, int num_steps,
          float* __restrict__ t_out, float* __restrict__ h_out, int B) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  march(origins, dirs, hf, H, W, __ldg(xy0), __ldg(xy0 + 1), __ldg(cell), max_t, dt, num_steps,
        t_out, h_out, r);
}
#endif

}  // namespace k2

#ifndef K2_HOST_CHECK
extern "C" int k2_raycast_launch(const float* origins, const float* dirs, const float* hf, int H,
                                 int W, const float* xy0, const float* cell, float max_t,
                                 float dt, int num_steps, float* t_out, float* h_out, int B,
                                 void* stream) {
  if (B <= 0 || H < 2 || W < 2 || num_steps <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (B + k2::kThreads - 1) / k2::kThreads;
  k2::k2_kernel<<<blocks, k2::kThreads, 0, (cudaStream_t)stream>>>(
      origins, dirs, hf, H, W, xy0, cell, max_t, dt, num_steps, t_out, h_out, B);
  return (int)cudaGetLastError();
}
#else
// host check: the same per-ray code as a plain loop over rays
extern "C" int k2_raycast_host(const float* origins, const float* dirs, const float* hf, int H,
                               int W, const float* xy0, const float* cell, float max_t, float dt,
                               int num_steps, float* t_out, float* h_out, int B) {
  if (B <= 0 || H < 2 || W < 2 || num_steps <= 0) return 1;
  for (int r = 0; r < B; ++r)
    k2::march(origins, dirs, hf, H, W, xy0[0], xy0[1], cell[0], max_t, dt, num_steps, t_out,
              h_out, r);
  return 0;
}
#endif
