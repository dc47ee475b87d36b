// Whole unpreconditioned conjugate-gradient pressure solve on the 7-point
// Laplacian, in one persistent cooperative launch: the hand-written Hopper
// kernel behind ops/pressure_kernels.py:cg_solve.
//
// Replaces the TPU kernel mantaflow_tpu/ops/pressure_pallas.py:_cg_kernel,
// which keeps the whole solve resident in VMEM. Here the fields (10 of
// 8.4 MB at 128^3 in full mode) do not fit the 50 MB L2, so every iteration
// streams them from device memory: the kernel is bound by bytes per
// iteration. What it keeps off the host is the loop itself: one launch runs
// every iteration, with grid.sync() between the phases, so there is no host
// round trip per iteration.
//
// Per iteration (same update order and exit test as _cg_kernel):
//   A: tmp = A s, per-block partial of dot(tmp, s)            grid.sync
//   B: alpha = sigma / dp (0 when dp == 0); p += alpha s;
//      r -= alpha tmp, per-block partials of sum(r^2), max|r| grid.sync
//   C: done = max|r| < accuracy; beta = done ? 0 : sigma'/sigma;
//      s = r + beta s                                          grid.sync
// Every block reduces the per-block partials itself, in the same fixed
// order, so all blocks see bit-identical scalars (and leave the loop
// together) and the result is deterministic run to run.
//
// Stencil modes (pressure_pallas.py:116-137): full mode reads A0/Ai/Aj/Ak;
// unit mode reads only A0 and rebuilds the off-diagonals from the fluid mask
// (-1 on a fluid-fluid link whose lower cell is fluid and inside the
// one-cell boundary ring). Requires rhs == 0 outside fluid.
//
// Layout: contiguous float32 (sz, sy, sx) arrays, x fastest; fluid is one
// byte per cell; out-of-range neighbours read as zero.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cgr = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct CgArgs {
  const float* rhs;
  const float* a0;
  const float* ai;
  const float* aj;
  const float* ak;
  const unsigned char* fluid;
  float* p;
  float* r;
  float* s;
  float* tmp;
  double* part;  // 3 * gridDim.x: dot, sum(r^2), max|r|
  int* iters;
  float* resnorm;
  int sx, sy, sz;
  float accuracy;
  int max_iter;
};

__device__ __forceinline__ double block_sum(double v, double* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) t += sh[w];
  return t;  // valid in thread 0
}

__device__ __forceinline__ double block_max(double v, double* sh) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmax(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) t = fmax(t, sh[w]);
  return t;
}

// Reduce the per-block partials part[0..nb) the same way in every block;
// the result is broadcast to all threads of the block.
template <bool kMax>
__device__ __forceinline__ double grid_total(const double* part, int nb,
                                             double* sh, double* bcast) {
  double v = 0.0;
  for (int b = threadIdx.x; b < nb; b += kThreads)
    v = kMax ? fmax(v, part[b]) : v + part[b];
  v = kMax ? block_max(v, sh) : block_sum(v, sh);
  if (threadIdx.x == 0) *bcast = v;
  __syncthreads();
  return *bcast;
}

// fluid & inside the one-cell ring (inter2d * zin_mask of _cg_kernel)
__device__ __forceinline__ bool unit_row(const CgArgs& a, int x, int y, int z,
                                         long long i) {
  return x >= 1 && x <= a.sx - 2 && y >= 1 && y <= a.sy - 2 && z >= 1 &&
         z <= a.sz - 2 && a.fluid[i] != 0;
}

template <bool kUnit>
__device__ __forceinline__ float apply_row(const CgArgs& a, long long i) {
  const long long sxy = static_cast<long long>(a.sx) * a.sy;
  const int x = static_cast<int>(i % a.sx);
  const int y = static_cast<int>((i / a.sx) % a.sy);
  const int z = static_cast<int>(i / sxy);
  const float* s = a.s;
  float ci_p = 0.f, ci_m = 0.f, cj_p = 0.f, cj_m = 0.f, ck_p = 0.f, ck_m = 0.f;
  if (kUnit) {
    const bool mc = unit_row(a, x, y, z, i);
    const bool fc = a.fluid[i] != 0;
    if (mc && x + 1 < a.sx && a.fluid[i + 1]) ci_p = -1.f;
    if (mc && y + 1 < a.sy && a.fluid[i + a.sx]) cj_p = -1.f;
    if (mc && z + 1 < a.sz && a.fluid[i + sxy]) ck_p = -1.f;
    if (fc && x > 0 && unit_row(a, x - 1, y, z, i - 1)) ci_m = -1.f;
    if (fc && y > 0 && unit_row(a, x, y - 1, z, i - a.sx)) cj_m = -1.f;
    if (fc && z > 0 && unit_row(a, x, y, z - 1, i - sxy)) ck_m = -1.f;
  } else {
    ci_p = a.ai[i];
    cj_p = a.aj[i];
    ck_p = a.ak[i];
    if (x > 0) ci_m = a.ai[i - 1];
    if (y > 0) cj_m = a.aj[i - a.sx];
    if (z > 0) ck_m = a.ak[i - sxy];
  }
  const float s_xp = x + 1 < a.sx ? s[i + 1] : 0.f;
  const float s_xm = x > 0 ? s[i - 1] : 0.f;
  const float s_yp = y + 1 < a.sy ? s[i + a.sx] : 0.f;
  const float s_ym = y > 0 ? s[i - a.sx] : 0.f;
  const float s_zp = z + 1 < a.sz ? s[i + sxy] : 0.f;
  const float s_zm = z > 0 ? s[i - sxy] : 0.f;
  return a.a0[i] * s[i] + ci_p * s_xp + ci_m * s_xm + cj_p * s_yp +
         cj_m * s_ym + ck_p * s_zp + ck_m * s_zm;
}

template <bool kUnit>
__global__ void __launch_bounds__(kThreads) cg_kernel(CgArgs a) {
  cgr::grid_group grid = cgr::this_grid();
  __shared__ double sh[kWarps];
  __shared__ double bcast;
  const long long n = static_cast<long long>(a.sx) * a.sy * a.sz;
  const long long start = static_cast<long long>(blockIdx.x) * kThreads
                          + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const int nb = gridDim.x;
  double* part_dot = a.part;
  double* part_sum = a.part + nb;
  double* part_max = a.part + 2 * nb;

  double ls = 0.0, lm = 0.0;
  for (long long i = start; i < n; i += stride) {
    const float v = a.rhs[i];
    a.r[i] = v;
    a.s[i] = v;
    a.p[i] = 0.f;
    ls += static_cast<double>(v) * v;
    lm = fmax(lm, static_cast<double>(fabsf(v)));
  }
  ls = block_sum(ls, sh);
  lm = block_max(lm, sh);
  if (threadIdx.x == 0) { part_sum[blockIdx.x] = ls; part_max[blockIdx.x] = lm; }
  grid.sync();
  float sigma = static_cast<float>(grid_total<false>(part_sum, nb, sh, &bcast));
  float rn = static_cast<float>(grid_total<true>(part_max, nb, sh, &bcast));
  bool done = rn < a.accuracy;
  int it = 0;

  while (it < a.max_iter && !done) {
    double ld = 0.0;
    for (long long i = start; i < n; i += stride) {
      const float t = apply_row<kUnit>(a, i);
      a.tmp[i] = t;
      ld += static_cast<double>(t) * a.s[i];
    }
    ld = block_sum(ld, sh);
    if (threadIdx.x == 0) part_dot[blockIdx.x] = ld;
    grid.sync();

    const float dp = static_cast<float>(grid_total<false>(part_dot, nb, sh, &bcast));
    const float alpha = fabsf(dp) > 0.f ? sigma / dp : 0.f;
    ls = 0.0;
    lm = 0.0;
    for (long long i = start; i < n; i += stride) {
      a.p[i] = a.p[i] + alpha * a.s[i];
      const float rv = a.r[i] - alpha * a.tmp[i];
      a.r[i] = rv;
      ls += static_cast<double>(rv) * rv;
      lm = fmax(lm, static_cast<double>(fabsf(rv)));
    }
    ls = block_sum(ls, sh);
    lm = block_max(lm, sh);
    if (threadIdx.x == 0) { part_sum[blockIdx.x] = ls; part_max[blockIdx.x] = lm; }
    grid.sync();

    const float sigma_new = static_cast<float>(grid_total<false>(part_sum, nb, sh, &bcast));
    rn = static_cast<float>(grid_total<true>(part_max, nb, sh, &bcast));
    done = rn < a.accuracy;
    // s and sigma freeze on the converging iteration (beta = 0 there)
    const float beta = done ? 0.f : sigma_new / sigma;
    for (long long i = start; i < n; i += stride) a.s[i] = a.r[i] + beta * a.s[i];
    if (!done) sigma = sigma_new;
    ++it;
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.iters = it;
    *a.resnorm = rn;
  }
}

template <bool kUnit>
cudaError_t grid_blocks(int device, int* blocks) {
  int sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                           device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cg_kernel<kUnit>,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * per_sm;
  return *blocks > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

// Number of blocks of the cooperative grid: the part buffer holds 3 doubles
// per block.
extern "C" int cg_solve_grid_blocks(int unit, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(unit ? grid_blocks<true>(device, blocks)
                               : grid_blocks<false>(device, blocks));
}

extern "C" int cg_solve_launch(const float* rhs, const float* a0,
                               const float* ai, const float* aj,
                               const float* ak, const unsigned char* fluid,
                               float* p, float* r, float* s, float* tmp,
                               double* part, int nblocks, int* iters,
                               float* resnorm, int sx, int sy, int sz,
                               float accuracy, int max_iter, int unit,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CgArgs a{rhs, a0, ai, aj, ak, fluid, p, r, s, tmp, part, iters, resnorm,
           sx, sy, sz, accuracy, max_iter};
  void* params[] = {&a};
  const void* fn = unit ? reinterpret_cast<const void*>(cg_kernel<true>)
                        : reinterpret_cast<const void*>(cg_kernel<false>);
  err = cudaLaunchCooperativeKernel(fn, dim3(nblocks), dim3(kThreads), params,
                                    0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cg_solve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
