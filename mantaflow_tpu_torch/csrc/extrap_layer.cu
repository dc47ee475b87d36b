// One BFS extrapolation layer for 1 or 3 (marker, value) float32 grid
// pairs: the hand-written Hopper kernel behind
// ops/extrapolation_kernels.py:extrap_layer.
//
// Replaces the TPU kernel mantaflow_tpu/ops/extrapolation_pallas.py:
// _extrap_layer_kernel, which streams 3-plane z windows of every field
// through VMEM so that the six neighbour reads come from fast memory. Here
// one thread per cell reads its six neighbours straight from device memory:
// neighbouring threads share them, so they hit in L1/L2 and the kernel
// streams each field once. It is bound by bytes (2 grids in and 2 out per
// pair, 16 bytes per cell); the pair index is the grid's y dimension, so one
// launch moves all three MAC components.
//
// Update rule (extrapolation_pallas.py:45-86, fastmarch.cpp:299-432):
//   hit(nb) = int(marker[nb]) == d           (float markers, int cast)
//   acc = sum hit*value, nbs = sum hit       (order x+1, x-1, y+1, y-1,
//                                             z+1, z-1)
//   avg = acc / max(nbs, 1) + direction
//   upd = int(marker) == 0 & nbs > 0 & interior (bnd=1)
//   marker' = upd ? d+1 : marker; value' = upd & update_values ? avg : value
// Non-interior cells never update, so their out-of-range neighbours are
// never read. The arithmetic is the plain version's, in its order (built
// with -fmad=false), so the two agree exactly.
//
// The 2D instance (k3d = false) takes the four in-plane neighbours (x+1,
// x-1, y+1, y-1) and no z interior test, on (1, sy, sx) grids, for 1, 2 or 3
// pairs: the JAX package runs 2D in its XLA layer loops
// (extrapolation.py:_nb_avg), whose update rule it is.
//
// Layout: contiguous float32 (sz, sy, sx) grids, x fastest.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct LayerArgs {
  const float* m[3];
  const float* v[3];
  float* om[3];
  float* ov[3];
  int sx, sy, sz;
  int d;
  float direction;
  int update_values;
};

template <bool k3d>
__global__ void __launch_bounds__(kThreads) extrap_layer_kernel(LayerArgs a) {
  const long long n = static_cast<long long>(a.sx) * a.sy * a.sz;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  // the pair by selects, not a dynamic index into the parameter arrays
  // (which would copy them to local memory)
  const int pair = blockIdx.y;
  const float* M = pair == 0 ? a.m[0] : (pair == 1 ? a.m[1] : a.m[2]);
  const float* V = pair == 0 ? a.v[0] : (pair == 1 ? a.v[1] : a.v[2]);
  const long long sxy = static_cast<long long>(a.sx) * a.sy;
  const int x = static_cast<int>(i % a.sx);
  const int y = static_cast<int>((i / a.sx) % a.sy);
  const int z = static_cast<int>(i / sxy);
  const float m = M[i];
  const float v = V[i];
  const bool inter = x >= 1 && x <= a.sx - 2 && y >= 1 && y <= a.sy - 2 &&
                     (!k3d || (z >= 1 && z <= a.sz - 2));
  float om = m, ov = v;
  if (inter && static_cast<int>(m) == 0) {
    const long long nb[6] = {i + 1, i - 1, i + a.sx, i - a.sx, i + sxy,
                             i - sxy};
    float acc = 0.f, nbs = 0.f;
    for (int k = 0; k < (k3d ? 6 : 4); ++k) {
      const float hit = static_cast<int>(M[nb[k]]) == a.d ? 1.f : 0.f;
      acc = acc + hit * V[nb[k]];
      nbs = nbs + hit;
    }
    if (nbs > 0.f) {
      om = static_cast<float>(a.d + 1);
      if (a.update_values) ov = acc / fmaxf(nbs, 1.f) + a.direction;
    }
  }
  float* OM = pair == 0 ? a.om[0] : (pair == 1 ? a.om[1] : a.om[2]);
  float* OV = pair == 0 ? a.ov[0] : (pair == 1 ? a.ov[1] : a.ov[2]);
  OM[i] = om;
  OV[i] = ov;
}

}  // namespace

// m/v/om/ov: arrays of n_pairs device pointers each; is3d = 0 runs the 2D
// instance on (1, sy, sx) grids.
extern "C" int extrap_layer_launch(const float* const* m,
                                   const float* const* v, float* const* om,
                                   float* const* ov, int n_pairs, int sx,
                                   int sy, int sz, int d, float direction,
                                   int update_values, int is3d, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_pairs < 1 || n_pairs > 3) return static_cast<int>(cudaErrorInvalidValue);
  LayerArgs a{};
  for (int p = 0; p < n_pairs; ++p) {
    a.m[p] = m[p];
    a.v[p] = v[p];
    a.om[p] = om[p];
    a.ov[p] = ov[p];
  }
  a.sx = sx;
  a.sy = sy;
  a.sz = sz;
  a.d = d;
  a.direction = direction;
  a.update_values = update_values;
  const long long n = static_cast<long long>(sx) * sy * sz;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  n_pairs);
  if (!is3d && sz != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is3d) {
    extrap_layer_kernel<true><<<grid, kThreads, 0, st>>>(a);
  } else {
    extrap_layer_kernel<false><<<grid, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* extrap_layer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
