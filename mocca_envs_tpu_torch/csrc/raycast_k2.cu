// K2: batched rays marched over one heightfield grid, for Hopper (sm_90a).
//
// Replaces the TPU kernel mocca_envs_tpu/ops/pallas/raycast.py::
// make_raycaster. Each ray r = o + t·d takes num_steps fixed steps,
// t = (i + 1)·dt for i = 0 … num_steps − 1 with dt = max_t / num_steps, and
// samples the bilinear height under each point. The first point at or under
// the surface ends the march: t_hit is its t and h_hit the height there; a
// ray that never dips under gives t_hit = max_t and h_hit = 0.
//
// A step computes what the plain version computes (ops/raycast.py::
// raycast_reference, i.e. terrain/scene.py::hf_sample on one grid): the
// cell of (x, y) clamped to [0, H − 1.001] × [0, W − 1.001], the four
// corners read directly by index (the TPU kernel selects them with one-hot
// contractions: Mosaic has no vector gather), and the bilinear sum in the
// plain version's order. Every product, sum and quotient is rounded on its
// own (__fmul_rn, __fadd_rn, __fdiv_rn), so that the compiler fuses none
// into an FMA and the kernel rounds as the plain version does, operation
// for operation. A step depends on its index i alone, so the two designs
// below give the same bits.
//
// Two designs, both behind ops/raycast.py::make_raycaster:
//
// - the cooperative march (k2_raycast_launch, the shipped one): K2_G = 16
//   lanes per ray, two rays per warp. In round k lane ℓ takes step
//   i = k·K2_G + ℓ; a ballot over the group's lanes gives the lowest lane
//   at or under the surface, the ray's first hit, whose t and h reach the
//   writer by a shuffle. A ray stops at its first round with a hit; a lane
//   past num_steps contributes no bit. The warp runs until both its rays
//   are done. Blocks of 512 threads are persistent (as many as stay
//   resident on the card, 3 per SM at 40 registers): each takes one
//   contiguous share of the warps' ray tiles, and its warps draw tiles from
//   that share by a counter in shared memory. The grid is read through the
//   read-only path (__ldg): a 129² grid (66,564 bytes) stays in L1.
//   Built with K2_PLACE = 1, each block instead stages a grid that fits its
//   shared memory (k2_raycast_placement, chosen on the host by size) once,
//   with coalesced 16-byte loads, and reads it there; a larger grid (257² is
//   264,196 bytes, over the card's 232,448) is read through L1 by the same
//   kernel.
// - the one-thread-per-ray twin (k2_raycast_thread_launch): each thread
//   marches one ray step by step and breaks at its first hit; 128 threads a
//   block, the grid through __ldg. It is kept to hold the cooperative march
//   to, bit for bit.
//
// Interface (all f32, contiguous, row-major): origins (B,3), directions
// (B,3), grid (H,W), xy0 (2,), cell (1,) → t_hit (B,), h_hit (B,). Any B;
// fewer than 2³¹ grid cells.
//
// What bounds it on this card. A march step is 33 fp32 operations
// (ops/raycast.py::K2_OPS_PER_STEP) against 24 bytes in and 8 bytes out per
// ray and the grid read once: 32,768 rays of about 24 steps (the steps
// these rays need) are ~26 Mflop, 0.38 µs at the fp32 rate, over 0.1 µs of
// bytes. Neither design comes near it. The thread march is bound by
// latency: one ray's 64 dependent steps (two IEEE divisions, a floor and
// four gathers a step) on 8 warps per SM (32,768 rays), and a warp runs
// until its longest ray stops (one ray in 16 looks up and runs all 64).
// The cooperative march spreads a ray's steps over its lanes, so a ray
// takes ⌈steps / 16⌉ rounds and 16 times as many warps share the card:
// 2× faster than the twin at
// 32,768 rays, 5× at 4,096. Where the card is full (262,144 rays) both run
// at about the same speed, 17–18 times the bound, though the cooperative
// march issues 39 lane-steps a ray against the twin's 64: it keeps 30 of
// them active against the twin's 24 (every lane of the last round computes
// its step, past the first hit too) and adds a ballot and two shuffles a
// round. (An H100 80GB HBM3 at 700 W, k2_launch_shapes.py, which also times
// 8 and 32 lanes and the staged grid, and counts the lane-steps: at 32,768
// rays 8 lanes ran 15% slower, 32 lanes 4%, the staged grid 14%.)
//
// Compiled with the host compiler (K2_HOST_CHECK defined, no CUDA), the same
// step code runs as plain loops: the thread march over rays, and the
// cooperative march as rounds, then lanes, then the ballot as a mask and its
// lowest bit, at K2_G lanes. Tests use that to hold the two designs and this
// file's arithmetic to each other and to the plain version on machines
// without a card.

#ifndef K2_G
#define K2_G 16         // lanes per ray of the cooperative march
#endif
#ifndef K2_PLACE
#define K2_PLACE 0      // 1: stage a grid that fits in shared memory; 0: never
#endif
static_assert(K2_G == 1 || K2_G == 2 || K2_G == 4 || K2_G == 8 || K2_G == 16 || K2_G == 32,
              "K2_G must divide a warp");

#ifdef K2_HOST_CHECK
#include <math.h>
#define HD inline
static inline float fmul_(float a, float b) { return a * b; }
static inline float fadd_(float a, float b) { return a + b; }
static inline float fsub_(float a, float b) { return a - b; }
static inline float fdiv_(float a, float b) { return a / b; }
template <bool LDG>
static inline float load_(const float* p) { return *p; }
static inline int lowest_lane(unsigned mask) { return __builtin_ctz(mask); }
#else
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
static __device__ __forceinline__ float fmul_(float a, float b) { return __fmul_rn(a, b); }
static __device__ __forceinline__ float fadd_(float a, float b) { return __fadd_rn(a, b); }
static __device__ __forceinline__ float fsub_(float a, float b) { return __fsub_rn(a, b); }
static __device__ __forceinline__ float fdiv_(float a, float b) { return __fdiv_rn(a, b); }
// a grid in global memory through the read-only path, or staged in shared
template <bool LDG>
static __device__ __forceinline__ float load_(const float* p) { return LDG ? __ldg(p) : *p; }
static __device__ __forceinline__ int lowest_lane(unsigned mask) { return __ffs(mask) - 1; }
#endif

namespace k2 {

// a block's dynamic shared memory on sm_90 (opt-in), and its first 16 bytes:
// the block's tile counter
constexpr long long kSmemOptin = 232448;
constexpr int kCounterBytes = 16;

struct Grid {
  const float* hf;
  int H, W;
  float x0, y0, cell;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

HD float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

// bilinear height of the grid at world (px, py)
template <bool LDG>
HD float sample(const Grid& g, float px, float py) {
  const float u = clampf(fdiv_(fsub_(px, g.x0), g.cell), 0.0f, (float)(g.H - 1.001));
  const float v = clampf(fdiv_(fsub_(py, g.y0), g.cell), 0.0f, (float)(g.W - 1.001));
  const float fi = floorf(u), fj = floorf(v);
  const float fu = fsub_(u, fi), fv = fsub_(v, fj);
  const float gu = fsub_(1.0f, fu), gv = fsub_(1.0f, fv);
  const float* h0 = g.hf + (int)fi * g.W + (int)fj;
  const float h00 = load_<LDG>(h0), h01 = load_<LDG>(h0 + 1), h10 = load_<LDG>(h0 + g.W),
              h11 = load_<LDG>(h0 + g.W + 1);
  float h = fmul_(fmul_(h00, gu), gv);
  h = fadd_(h, fmul_(fmul_(h10, fu), gv));
  h = fadd_(h, fmul_(fmul_(h01, gu), fv));
  return fadd_(h, fmul_(fmul_(h11, fu), fv));
}

// march step i of one ray: its t and the height under its point; true where
// the point is at or under the surface. Both designs take every step here.
template <bool LDG>
HD bool step_at(const Grid& g, const Ray& ray, float dt, int i, float& t, float& h) {
  t = fmul_((float)(i + 1), dt);
  const float px = fadd_(ray.ox, fmul_(t, ray.dx));
  const float py = fadd_(ray.oy, fmul_(t, ray.dy));
  const float pz = fadd_(ray.oz, fmul_(t, ray.dz));
  h = sample<LDG>(g, px, py);
  return pz <= h;
}

// whether round k of a group of G lanes took the march's last step
HD bool last_round(int k, int num_steps) { return (k + 1) * K2_G >= num_steps; }

HD Ray load_ray(const float* origins, const float* dirs, long long r) {
  const float* o = origins + 3 * r;
  const float* d = dirs + 3 * r;
  return {o[0], o[1], o[2], d[0], d[1], d[2]};
}

// the thread march: one ray, step by step, to its first hit
HD void march(const Grid& g, const float* origins, const float* dirs, float max_t, float dt,
              int num_steps, float* t_out, float* h_out, int r) {
  const Ray ray = load_ray(origins, dirs, r);
  float t_hit = max_t, h_hit = 0.0f;
  for (int i = 0; i < num_steps; ++i) {
    float t, h;
    if (step_at<true>(g, ray, dt, i, t, h)) {
      t_hit = t;
      h_hit = h;
      break;
    }
  }
  t_out[r] = t_hit;
  h_out[r] = h_hit;
}

#ifdef K2_HOST_CHECK
// the cooperative march of one ray as a warp's group runs it: rounds, then
// the group's K2_G lanes, then the ballot as a mask and its lowest bit
inline void march_group(const Grid& g, const float* origins, const float* dirs, float max_t,
                        float dt, int num_steps, float* t_out, float* h_out, int r) {
  const Ray ray = load_ray(origins, dirs, r);
  float t_hit = max_t, h_hit = 0.0f;
  for (int k = 0;; ++k) {
    unsigned mask = 0;
    float t[K2_G], h[K2_G];
    for (int lane = 0; lane < K2_G; ++lane) {
      const int i = k * K2_G + lane;
      t[lane] = h[lane] = 0.0f;
      if (i < num_steps && step_at<true>(g, ray, dt, i, t[lane], h[lane])) mask |= 1u << lane;
    }
    if (mask) {
      const int src = lowest_lane(mask);
      t_hit = t[src];
      h_hit = h[src];
      break;
    }
    if (last_round(k, num_steps)) break;
  }
  t_out[r] = t_hit;
  h_out[r] = h_hit;
}
#else
constexpr int kThreads = 128;        // the thread march's block
constexpr int kGroupThreads = 512;   // the cooperative march's block, 3 resident per SM
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
k2_thread_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                 const float* __restrict__ hf, int H, int W, const float* __restrict__ xy0,
                 const float* __restrict__ cell, float max_t, float dt, int num_steps,
                 float* __restrict__ t_out, float* __restrict__ h_out, int B) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  const Grid g{hf, H, W, __ldg(xy0), __ldg(xy0 + 1), __ldg(cell)};
  march(g, origins, dirs, max_t, dt, num_steps, t_out, h_out, r);
}

// STAGED: the grid copied into this block's shared memory, behind the
// counter; else read through __ldg
template <bool STAGED>
__global__ void __launch_bounds__(kGroupThreads, 3)
k2_group_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                const float* __restrict__ hf, int H, int W, const float* __restrict__ xy0,
                const float* __restrict__ cell, float max_t, float dt, int num_steps,
                float* __restrict__ t_out, float* __restrict__ h_out, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* next = reinterpret_cast<int*>(smem);
  float* staged = reinterpret_cast<float*>(smem + kCounterBytes);
  if (threadIdx.x == 0) *next = 0;
  const float* grid = hf;
  if (STAGED) {
    const long long n = (long long)H * W;
    long long head = 0;
    if ((reinterpret_cast<unsigned long long>(hf) & 15) == 0) {
      const float4* src = reinterpret_cast<const float4*>(hf);
      float4* dst = reinterpret_cast<float4*>(staged);
      for (long long j = threadIdx.x; j < n / 4; j += blockDim.x) dst[j] = __ldg(src + j);
      head = n / 4 * 4;
    }
    for (long long j = head + threadIdx.x; j < n; j += blockDim.x) staged[j] = __ldg(hf + j);
    grid = staged;
  }
  __syncthreads();
  const Grid g{grid, H, W, __ldg(xy0), __ldg(xy0 + 1), __ldg(cell)};

  constexpr int kRays = 32 / K2_G;   // rays per warp
  const int lane = threadIdx.x & 31, sub = lane % K2_G, slot = lane / K2_G;
  const unsigned group = (K2_G == 32 ? kFull : (1u << K2_G) - 1u) << (slot * K2_G);
  // this block's share of the tiles of kRays rays
  const long long tiles = (B + kRays - 1) / kRays;
  const long long begin = tiles * blockIdx.x / gridDim.x;
  const long long end = tiles * (blockIdx.x + 1) / gridDim.x;
  for (;;) {
    int drawn = 0;
    if (lane == 0) drawn = atomicAdd(next, 1);
    const long long tile = begin + __shfl_sync(kFull, drawn, 0);
    if (tile >= end) break;
    const long long r = tile * kRays + slot;
    const bool live = r < B;
    const Ray ray = live ? load_ray(origins, dirs, r) : Ray{0, 0, 0, 0, 0, 0};
    float t_hit = max_t, h_hit = 0.0f;
    bool done = !live;
    for (int k = 0;; ++k) {
      const int i = k * K2_G + sub;
      float t = 0.0f, h = 0.0f;
      const bool hit = !done && i < num_steps && step_at<!STAGED>(g, ray, dt, i, t, h);
      const unsigned mask = __ballot_sync(kFull, hit) & group;
      const int src = mask ? lowest_lane(mask) : lane;
      const float t_src = __shfl_sync(kFull, t, src), h_src = __shfl_sync(kFull, h, src);
      if (!done && mask) {
        t_hit = t_src;
        h_hit = h_src;
        done = true;
      } else if (last_round(k, num_steps)) {
        done = true;
      }
      if (__all_sync(kFull, done)) break;
    }
    if (live && sub == 0) {
      t_out[r] = t_hit;
      h_out[r] = h_hit;
    }
  }
}
#endif

}  // namespace k2

// the grid's bytes in shared memory (padded to 16) behind the tile counter
static long long k2_smem_bytes(int H, int W, int staged) {
  return k2::kCounterBytes + (staged ? ((long long)H * W * 4 + 15) / 16 * 16 : 0);
}

// the shapes both designs take: a grid of at least 2 × 2 and fewer than 2³¹
// cells (indexed with 32-bit ints), at least one step and one ray
static bool k2_valid(int H, int W, int num_steps, int B) {
  return B > 0 && H >= 2 && W >= 2 && (long long)H * W <= 2147483647LL && num_steps > 0;
}

// where the cooperative march reads an H × W grid: 1 staged in each block's
// shared memory, where it fits beside the counter (and K2_PLACE allows); 0
// through the read-only path
extern "C" int k2_raycast_placement(int H, int W) {
  return K2_PLACE == 1 && k2_smem_bytes(H, W, 1) <= k2::kSmemOptin ? 1 : 0;
}

// lanes per ray of the cooperative march
extern "C" int k2_raycast_group() { return K2_G; }

#ifndef K2_HOST_CHECK
namespace {

// the persistent launch of the cooperative march for one grid placement:
// the staged kernel's shared memory opted in once, its blocks resident per
// SM (read once per device and shared-memory size)
template <bool STAGED>
int group_shape(int smem, int* blocks_per_sm, int* sms) {
  static bool opted = false;
  static int last_dev = -1, last_smem = -1, last_blocks = 0, last_sms = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != last_dev || smem != last_smem) {
    if (STAGED && !opted) {
      err = cudaFuncSetAttribute(k2::k2_group_kernel<STAGED>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)k2::kSmemOptin);
      if (err != cudaSuccess) return (int)err;
      opted = true;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&last_blocks, k2::k2_group_kernel<STAGED>,
                                                        k2::kGroupThreads, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&last_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (last_blocks < 1) return (int)cudaErrorInvalidConfiguration;
    last_dev = dev;
    last_smem = smem;
  }
  *blocks_per_sm = last_blocks;
  *sms = last_sms;
  return 0;
}

template <bool STAGED>
int launch_group(const float* origins, const float* dirs, const float* hf, int H, int W,
                 const float* xy0, const float* cell, float max_t, float dt, int num_steps,
                 float* t_out, float* h_out, int B, void* stream) {
  const int smem = (int)k2_smem_bytes(H, W, STAGED);
  int per_sm = 0, sms = 0;
  const int err = group_shape<STAGED>(smem, &per_sm, &sms);
  if (err != 0) return err;
  const long long warps = (B + 32 / K2_G - 1) / (32 / K2_G);
  const long long needed = (warps + k2::kGroupThreads / 32 - 1) / (k2::kGroupThreads / 32);
  const int blocks = (int)(needed < (long long)per_sm * sms ? needed : (long long)per_sm * sms);
  k2::k2_group_kernel<STAGED><<<blocks, k2::kGroupThreads, smem, (cudaStream_t)stream>>>(
      origins, dirs, hf, H, W, xy0, cell, max_t, dt, num_steps, t_out, h_out, B);
  return (int)cudaGetLastError();
}

}  // namespace

// the cooperative march (the shipped design), its grid placed by
// k2_raycast_placement
extern "C" int k2_raycast_launch(const float* origins, const float* dirs, const float* hf, int H,
                                 int W, const float* xy0, const float* cell, float max_t,
                                 float dt, int num_steps, float* t_out, float* h_out, int B,
                                 void* stream) {
  if (!k2_valid(H, W, num_steps, B)) return (int)cudaErrorInvalidValue;
#if K2_PLACE == 1
  if (k2_raycast_placement(H, W))
    return launch_group<true>(origins, dirs, hf, H, W, xy0, cell, max_t, dt, num_steps, t_out,
                              h_out, B, stream);
#endif
  return launch_group<false>(origins, dirs, hf, H, W, xy0, cell, max_t, dt, num_steps, t_out,
                             h_out, B, stream);
}

// the one-thread-per-ray twin
extern "C" int k2_raycast_thread_launch(const float* origins, const float* dirs, const float* hf,
                                        int H, int W, const float* xy0, const float* cell,
                                        float max_t, float dt, int num_steps, float* t_out,
                                        float* h_out, int B, void* stream) {
  if (!k2_valid(H, W, num_steps, B)) return (int)cudaErrorInvalidValue;
  const int blocks = (B + k2::kThreads - 1) / k2::kThreads;
  k2::k2_thread_kernel<<<blocks, k2::kThreads, 0, (cudaStream_t)stream>>>(
      origins, dirs, hf, H, W, xy0, cell, max_t, dt, num_steps, t_out, h_out, B);
  return (int)cudaGetLastError();
}

// the cooperative march's launch on the current card for an H × W grid:
// blocks resident per SM, threads per block, dynamic shared memory per block
extern "C" int k2_raycast_occupancy(int H, int W, int* blocks_per_sm, int* threads, int* smem) {
  const int staged = k2_raycast_placement(H, W);
  int sms = 0;
  *threads = k2::kGroupThreads;
  *smem = (int)k2_smem_bytes(H, W, staged);
#if K2_PLACE == 1
  if (staged) return group_shape<true>(*smem, blocks_per_sm, &sms);
#endif
  return group_shape<false>(*smem, blocks_per_sm, &sms);
}
#else
// host check: the thread march as a plain loop over rays
extern "C" int k2_raycast_host(const float* origins, const float* dirs, const float* hf, int H,
                               int W, const float* xy0, const float* cell, float max_t, float dt,
                               int num_steps, float* t_out, float* h_out, int B) {
  if (!k2_valid(H, W, num_steps, B)) return 1;
  const k2::Grid g{hf, H, W, xy0[0], xy0[1], cell[0]};
  for (int r = 0; r < B; ++r) k2::march(g, origins, dirs, max_t, dt, num_steps, t_out, h_out, r);
  return 0;
}

// host check: the cooperative march at K2_G lanes, ray after ray
extern "C" int k2_raycast_group_host(const float* origins, const float* dirs, const float* hf,
                                     int H, int W, const float* xy0, const float* cell,
                                     float max_t, float dt, int num_steps, float* t_out,
                                     float* h_out, int B) {
  if (!k2_valid(H, W, num_steps, B)) return 1;
  const k2::Grid g{hf, H, W, xy0[0], xy0[1], cell[0]};
  for (int r = 0; r < B; ++r)
    k2::march_group(g, origins, dirs, max_t, dt, num_steps, t_out, h_out, r);
  return 0;
}
#endif
