// Window-clamped trilinear semi-Lagrangian sample of one scalar grid, with the
// MacCormack clamp's corner min/max: the hand-written Hopper kernel behind
// ops/advection_kernels.py:window_pass.
//
// Replaces the TPU kernel mantaflow_tpu/ops/advection_pallas.py:
// _window_kernel_dyn (and its static twin _window_kernel), which recast the
// 8-corner gather as a select over a (2k+2)^3 window of lane rolls because a
// TPU has no fast gather. Hopper gathers from L1/L2 directly, so this kernel
// runs one thread per cell: compute the per-axis (base, frac) exactly as
// advection_fast._rel_weights does, read the 8 corners (base, base+1)^3 and
// blend them. The corners of neighbouring threads overlap, so the gathers hit
// in cache; the kernel is bound by the bytes it streams from device memory
// (positions and outputs, one float each per cell).
//
// Layout: every grid is a contiguous float32 (sz, sy, sx) array, x fastest.
// ok (optional) and have are one byte per cell (torch.bool).
//
// The z-slab instance (kSlab) replaces the same TPU kernel as it is called by
// advection_pallas.py:window_pass_zshard (_window_pass_dyn_call with z_base,
// prehalo=True and sz_clamp): one z-slab of a z-sharded grid. Its positions
// and outputs hold the slab's own sz planes; src (and ok) arrive with k+1
// halo planes on each side (sz + 2(k+1) planes). A cell at slab plane z has
// global plane z_base + z, and the window clamps against the global extent
// sz_clamp, so its corner planes are read at slab plane z + (k+1) + base.
// The arithmetic is the one-domain instance's, in its order: a slab's output
// equals the one-domain output on its planes bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kThreads = 256;

// advection_fast._rel_weights: -0.5 shift, displacement clamp to +-k, border
// clamp, floor, base capped at n-2-coord (frac may be exactly 1 at the top).
__device__ __forceinline__ void rel_base_frac(float pos, int coord, int n,
                                              int k, int& base, float& frac) {
  const float c = static_cast<float>(coord);
  const float p = pos - 0.5f;
  float rel = fminf(fmaxf(p - c, -static_cast<float>(k)),
                    static_cast<float>(k));
  const float p_abs = fminf(fmaxf(c + rel, 0.0f), static_cast<float>(n - 1));
  rel = p_abs - c;
  const int b = static_cast<int>(floorf(rel));
  // (int)(n - 2 - coord) truncates toward zero; the operand is integral
  base = min(b, static_cast<int>(static_cast<float>(n - 2) - c));
  frac = rel - static_cast<float>(base);
}

template <bool kMinMax, bool kWithOk, bool k3d, bool kSlab>
__global__ void __launch_bounds__(kThreads)
window_advect_kernel(const float* __restrict__ src,
                     const float* __restrict__ px,
                     const float* __restrict__ py,
                     const float* __restrict__ pz,
                     const unsigned char* __restrict__ ok,
                     float* __restrict__ out, float* __restrict__ minv,
                     float* __restrict__ maxv, unsigned char* __restrict__ have,
                     int sx, int sy, int sz, int k, int z_base, int sz_clamp) {
  const long long n = static_cast<long long>(sx) * sy * sz;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
  if (idx >= n) return;
  const int x = static_cast<int>(idx % sx);
  const long long t = idx / sx;
  const int y = static_cast<int>(t % sy);
  const int z = static_cast<int>(t / sy);

  int bx, by, bz = 0;
  float fx, fy, fz = 0.0f;
  rel_base_frac(px[idx], x, sx, k, bx, fx);
  rel_base_frac(py[idx], y, sy, k, by, fy);
  if (k3d) {
    if (kSlab) {
      rel_base_frac(pz[idx], z_base + z, sz_clamp, k, bz, fz);
    } else {
      rel_base_frac(pz[idx], z, sz, k, bz, fz);
    }
  }
  // the plane of src (and ok) that holds this cell's plane: past the halo
  // in the slab form
  const int zsrc = kSlab ? z + k + 1 : z;

  const long long sxy = static_cast<long long>(sx) * sy;
  const long long c0 = (static_cast<long long>(zsrc + bz) * sy + (y + by))
                       * sx + (x + bx);
  const float wz[2] = {k3d ? 1.0f - fz : 1.0f, fz};
  const float wy[2] = {1.0f - fy, fy};
  const float wx[2] = {1.0f - fx, fx};
  const int nzc = k3d ? 2 : 1;

  // accumulation order of advection_fast.window_interp: x pairs first, then
  // (z, y) pairs in offset order
  float acc = 0.0f;
  float mn = kBig, mx = -kBig;
  bool any = false;
  for (int dz = 0; dz < nzc; ++dz) {
    for (int dy = 0; dy < 2; ++dy) {
      const long long row = c0 + dz * sxy + dy * static_cast<long long>(sx);
      const float v0 = src[row];
      const float v1 = src[row + 1];
      acc = acc + (wz[dz] * wy[dy]) * (wx[0] * v0 + wx[1] * v1);
      if (kMinMax) {
        const bool ok0 = kWithOk ? ok[row] != 0 : true;
        const bool ok1 = kWithOk ? ok[row + 1] != 0 : true;
        if (ok0) { mn = fminf(mn, v0); mx = fmaxf(mx, v0); }
        if (ok1) { mn = fminf(mn, v1); mx = fmaxf(mx, v1); }
        any = any || ok0 || ok1;
      }
    }
  }
  out[idx] = acc;
  if (kMinMax) {
    minv[idx] = mn;
    maxv[idx] = mx;
    have[idx] = any ? 1 : 0;
  }
}

template <bool kMinMax, bool kWithOk>
void launch3(bool is3d, bool slab, dim3 grid, cudaStream_t stream,
             const float* src, const float* px, const float* py,
             const float* pz, const unsigned char* ok, float* out, float* minv,
             float* maxv, unsigned char* have, int sx, int sy, int sz, int k,
             int z_base, int sz_clamp) {
  if (slab) {
    window_advect_kernel<kMinMax, kWithOk, true, true>
        <<<grid, kThreads, 0, stream>>>(src, px, py, pz, ok, out, minv, maxv,
                                        have, sx, sy, sz, k, z_base, sz_clamp);
  } else if (is3d) {
    window_advect_kernel<kMinMax, kWithOk, true, false>
        <<<grid, kThreads, 0, stream>>>(src, px, py, pz, ok, out, minv, maxv,
                                        have, sx, sy, sz, k, z_base, sz_clamp);
  } else {
    window_advect_kernel<kMinMax, kWithOk, false, false>
        <<<grid, kThreads, 0, stream>>>(src, px, py, pz, ok, out, minv, maxv,
                                        have, sx, sy, sz, k, z_base, sz_clamp);
  }
}

}  // namespace

// sz: the planes of px/py/pz and of the outputs. slab = 0: one domain, src
// and ok of sz planes too (z_base and sz_clamp unused). slab = 1: a z-slab at
// global plane z_base of a 3D grid sz_clamp planes deep, src and ok of
// sz + 2(k+1) planes.
extern "C" int window_advect_launch(const float* src, const float* px,
                                    const float* py, const float* pz,
                                    const unsigned char* ok, float* out,
                                    float* minv, float* maxv,
                                    unsigned char* have, int sx, int sy,
                                    int sz, int k, int want_minmax, int slab,
                                    int z_base, int sz_clamp, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (slab && (z_base < 0 || z_base + sz > sz_clamp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(sx) * sy * sz;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  const bool is3d = slab || sz > 1;
  const bool sl = slab != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!want_minmax) {
    launch3<false, false>(is3d, sl, grid, s, src, px, py, pz, ok, out, minv,
                          maxv, have, sx, sy, sz, k, z_base, sz_clamp);
  } else if (ok == nullptr) {
    launch3<true, false>(is3d, sl, grid, s, src, px, py, pz, ok, out, minv,
                         maxv, have, sx, sy, sz, k, z_base, sz_clamp);
  } else {
    launch3<true, true>(is3d, sl, grid, s, src, px, py, pz, ok, out, minv,
                        maxv, have, sx, sy, sz, k, z_base, sz_clamp);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* window_advect_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
