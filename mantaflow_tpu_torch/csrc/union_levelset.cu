// Union particle levelset for any window half-width rw: the hand-written
// Hopper kernel behind ops/levelset_kernels.py:union_levelset, for radii
// whose window is wider than the one cell that csrc/p2g_levelset.cu fuses
// into the transfer.
//
// Replaces the TPU kernel mantaflow_tpu/ops/flip_bucket_pallas2.py:
// _ls_kernel (union_levelset_pallas), which streams source planes and
// keeps 2 rw + 1 destination planes of running minima in VMEM. Blocks on
// Hopper carry nothing between them, so this kernel gathers: one thread per
// destination cell takes the min over the slots of the (2 rw + 1)^3 source
// cells around it. A min has no summation order, so the result equals the
// plain version's up to the rounding of the same expressions (built with
// -fmad=false). In bytes it needs only the valid byte of every slot, the
// positions of the live particles and one output grid, but each cell
// visits (2 rw + 1)^3 * P slots through L1/L2 (343 * P at rw = 3): the
// cached reads and the distance arithmetic bound it, not device memory.
//
// Semantics (flip_bucket.union_levelset_bucketed):
//   d2 = r2 - 2 (e . d) + |d|^2 with e = p - centre(s), s = cell - d, over
//   the source cells that exist (no wrap); d2min 1e10 for none;
//   phi = min(sqrt(d2min) - r, r), r for none, 0.5 on the boundary ring.
//
// Layout: px, py, pz contiguous (P, T) float32, T = sz*sy*sx with x
// fastest, valid one byte per slot; phi out (sz, sy, sx) float32.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 1e10f;

struct LevelsetArgs {
  const float* px;
  const float* py;
  const float* pz;
  const unsigned char* valid;
  float* phi;
  long long T;
  int P;
  int sx, sy, sz;
  int rw;
  float radius;
};

__global__ void __launch_bounds__(kThreads)
    union_levelset_kernel(LevelsetArgs a) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= a.T) return;
  const int x = static_cast<int>(t % a.sx);
  const int y = static_cast<int>((t / a.sx) % a.sy);
  const int z = static_cast<int>(t / (static_cast<long long>(a.sx) * a.sy));

  float d2min = kBig;
  for (int dz = -a.rw; dz <= a.rw; ++dz) {
    const int zs = z - dz;
    if (zs < 0 || zs >= a.sz) continue;
    const float cz = static_cast<float>(zs) + 0.5f;
    for (int dy = -a.rw; dy <= a.rw; ++dy) {
      const int ys = y - dy;
      if (ys < 0 || ys >= a.sy) continue;
      const float cy = static_cast<float>(ys) + 0.5f;
      for (int dx = -a.rw; dx <= a.rw; ++dx) {
        const int xs = x - dx;
        if (xs < 0 || xs >= a.sx) continue;
        const float cx = static_cast<float>(xs) + 0.5f;
        const long long s = (static_cast<long long>(zs) * a.sy + ys) * a.sx + xs;
        const float c2 = static_cast<float>(dx * dx + dy * dy + dz * dz);
        for (int p = 0; p < a.P; ++p) {
          const long long idx = static_cast<long long>(p) * a.T + s;
          if (!a.valid[idx]) continue;
          const float ex = a.px[idx] - cx;
          const float ey = a.py[idx] - cy;
          const float ez = a.pz[idx] - cz;
          const float r2 = ex * ex + ey * ey + ez * ez;
          const float d2 = r2 - 2.f * (ex * static_cast<float>(dx) +
                                       ey * static_cast<float>(dy) +
                                       ez * static_cast<float>(dz)) + c2;
          d2min = fminf(d2min, d2);
        }
      }
    }
  }
  const bool inter = x >= 1 && x <= a.sx - 2 && y >= 1 && y <= a.sy - 2 &&
                     z >= 1 && z <= a.sz - 2;
  float phi = d2min >= kBig ? a.radius : sqrtf(fmaxf(d2min, 0.f)) - a.radius;
  phi = fminf(phi, a.radius);
  a.phi[t] = inter ? phi : 0.5f;
}

}  // namespace

extern "C" int union_levelset_launch(const float* px, const float* py,
                                     const float* pz,
                                     const unsigned char* valid, float* phi,
                                     long long T, int P, int sx, int sy,
                                     int sz, int rw, float radius, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  LevelsetArgs a{px, py, pz, valid, phi, T, P, sx, sy, sz, rw, radius};
  const unsigned blocks = static_cast<unsigned>((T + kThreads - 1) / kThreads);
  union_levelset_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* union_levelset_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
