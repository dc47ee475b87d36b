// Union particle levelset for any window half-width rw: the hand-written
// Hopper kernel behind ops/levelset_kernels.py:union_levelset, for radii
// whose window is wider than the one cell that csrc/p2g_levelset.cu fuses
// into the transfer.
//
// Replaces the TPU kernel mantaflow_tpu/ops/flip_bucket_pallas2.py:
// _ls_kernel (union_levelset_pallas), which streams source planes, skips
// empty tiles and keeps 2 rw + 1 destination planes of running minima in
// VMEM. What bounds the function on this card is arithmetic: every live
// particle meets the (2 rw + 1)^3 destinations of its window (343 at
// rw = 3), a few float operations each. A gather with one thread per
// destination that walks every slot of its window (343 * P valid bytes and
// the positions of the live ones through L1/L2) spends its time on the
// walk, not on the distances. This kernel stages instead:
//
// - One block per brick of kBx x kBy x kBz destination cells; thread
//   (tx, ty) of each of kGroups thread groups owns the z-column of kBz
//   destinations at (x0 + tx, y0 + ty), and the groups split each source
//   cell's particles between them (more warps per brick, no extra work).
// - A brick whose window holds no live particle (slot 0 of every source
//   cell invalid) writes phi at once.
// - The block walks the source z-planes of its window. For each it stages
//   in shared memory the live particles of the (kBx + 2 rw)(kBy + 2 rw)
//   source cells as offsets from their source cell's centre with r^2,
//   at most `pc` slots per cell at a time (chunks, so any P fits), and
//   stops at each cell's first invalid slot (buckets are gap-free,
//   ops/flip_bucket.py).
// - Each thread applies its group's staged particles of its (2 rw + 1)^2
//   source cells to each destination of its column that the particle's
//   window reaches: one shared-memory read serves up to 2 rw + 1
//   destinations, and each particle is read from device memory a few
//   times, not 343.
//
// Semantics (flip_bucket.union_levelset_bucketed), the same expression,
// built with -fmad=false, so the min equals the plain version's bit for
// bit (a min does not depend on its order):
//   d2 = r2 - 2 (e . d) + |d|^2 with e = p - centre(s), s = cell - d, over
//   the source cells that exist (no wrap); d2min 1e10 for none;
//   phi = min(sqrt(d2min) - r, r), r for none, 0.5 on the boundary ring.
//
// Layout: px, py, pz contiguous (P, T) float32, T = sz*sy*sx with x
// fastest, valid one byte per slot; phi out (sz, sy, sx) float32.

#include <cuda_runtime.h>

namespace {

// the brick; ops/levelset_kernels.py:levelset_plan mirrors these. kGroups
// thread groups share a brick: group g applies the particles g, g +
// kGroups, ... of each staged cell, and the groups' minima meet when a
// destination is written.
constexpr int kBx = 8, kBy = 8, kBz = 8, kGroups = 2;
static_assert(kGroups > 1, "the groups' minima meet through fin");
constexpr int kCol = kBx * kBy;  // z-columns of a brick
constexpr int kThreads = kCol * kGroups;
constexpr int kChunk = 8;  // most slots per cell staged at a time
constexpr float kBig = 1e10f;

struct LevelsetArgs {
  const float* __restrict__ px;
  const float* __restrict__ py;
  const float* __restrict__ pz;
  const unsigned char* __restrict__ valid;
  float* phi;
  long long T;
  int P;
  int sx, sy, sz;
  int rw;
  int pc;  // slots per cell staged at a time (<= kChunk)
  float radius;
};

__device__ __forceinline__ void write_phi(const LevelsetArgs& a, int x, int y,
                                          int z, float d2min) {
  const bool inter = x >= 1 && x <= a.sx - 2 && y >= 1 && y <= a.sy - 2 &&
                     z >= 1 && z <= a.sz - 2;
  float phi = d2min >= kBig ? a.radius : sqrtf(fmaxf(d2min, 0.f)) - a.radius;
  phi = fminf(phi, a.radius);
  a.phi[(static_cast<long long>(z) * a.sy + y) * a.sx + x] =
      inter ? phi : 0.5f;
}

// Stage slots p0 .. p0 + pc - 1 of source plane zs's tile: (ex, ey, ez, r2)
// of each cell's leading valid slots, and their count. Returns through the
// block whether any cell has one (`any`) and whether any has more slots
// than this chunk held (`full`, left for the caller's closing barrier).
__device__ __forceinline__ bool stage_chunk(const LevelsetArgs& a,
                                            float4* stage, int* cnt, int x0,
                                            int y0, int zs, int p0,
                                            int& full) {
  const int rw = a.rw, tw = kBx + 2 * rw, tile = tw * (kBy + 2 * rw);
  const long long sxy = static_cast<long long>(a.sx) * a.sy;
  const float cz = static_cast<float>(zs) + 0.5f;
  const int m = min(a.pc, a.P - p0);
  int any = 0;
  full = 0;
  for (int q = threadIdx.x; q < tile; q += kThreads) {
    const int xs = x0 - rw + q % tw, ys = y0 - rw + q / tw;
    int n = 0;
    if (xs >= 0 && xs < a.sx && ys >= 0 && ys < a.sy) {
      const long long idx0 = static_cast<long long>(p0) * a.T + zs * sxy +
                             static_cast<long long>(ys) * a.sx + xs;
      bool v[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        v[k] = k < m && a.valid[idx0 + k * a.T] != 0;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) n += (n == k && v[k]) ? 1 : 0;
      const float cx = static_cast<float>(xs) + 0.5f;
      const float cy = static_cast<float>(ys) + 0.5f;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k < n) {
          const long long idx = idx0 + k * a.T;
          const float ex = a.px[idx] - cx;
          const float ey = a.py[idx] - cy;
          const float ez = a.pz[idx] - cz;
          stage[k * tile + q] =
              make_float4(ex, ey, ez, ex * ex + ey * ey + ez * ez);
        }
      }
      full |= n == m && p0 + m < a.P;
    }
    cnt[q] = n;
    any |= n;
  }
  return __syncthreads_or(any);
}

// RW > 0: the window half-width at compile time. Thread (tx, ty) of each
// group keeps a sliding window of 2 RW + 1 running minima, acc[m] for the
// destination z = zs + m - RW of source plane zs: each staged particle
// updates all of them with dz = m - RW known to the compiler (e.z * dz is
// e.z, -e.z or a product shared by +-dz), and after plane zs the
// destination zs - RW is final. RW == 0: a.rw at run time, for windows
// wider than any scene uses; group 0 keeps the column's kBz destinations
// and tests each against the window.
template <int RW>
__global__ void __launch_bounds__(kThreads)
    union_levelset_kernel(LevelsetArgs a) {
  // [pc][tile] staged particles: (ex, ey, ez, r2); then [tile] counts
  extern __shared__ float4 stage[];
  const int rw = RW > 0 ? RW : a.rw;
  const int tw = kBx + 2 * rw, tile = tw * (kBy + 2 * rw);
  int* cnt = reinterpret_cast<int*>(stage + a.pc * tile);
  // the other groups' finished minima, by plane parity
  __shared__ float fin[2][kGroups - 1][kCol];
  const int t = threadIdx.x, g = t / kCol, col = t % kCol;
  const int tx = col % kBx, ty = col / kBx;
  const int x0 = blockIdx.x * kBx, y0 = blockIdx.y * kBy;
  const int z0 = blockIdx.z * kBz;
  const int x = x0 + tx, y = y0 + ty, zend = min(z0 + kBz, a.sz);
  const bool mine = x < a.sx && y < a.sy;
  const int zlo = max(z0 - rw, 0), zhi = min(z0 + kBz - 1 + rw, a.sz - 1);
  const long long sxy = static_cast<long long>(a.sx) * a.sy;

  // a brick whose window holds no live particle writes phi at once
  int live = 0;
  const int nwin = tile * (zhi - zlo + 1);
  for (int c = t; c < nwin; c += kThreads) {
    const int zs = zlo + c / tile, q = c % tile;
    const int xs = x0 - rw + q % tw, ys = y0 - rw + q / tw;
    if (xs >= 0 && xs < a.sx && ys >= 0 && ys < a.sy)
      live |= a.valid[zs * sxy + static_cast<long long>(ys) * a.sx + xs];
  }
  if (!__syncthreads_or(live)) {
    if (mine && g == 0)
      for (int z = z0; z < zend; ++z) write_phi(a, x, y, z, kBig);
    return;
  }

  if constexpr (RW > 0) {
    float acc[2 * RW + 1];
#pragma unroll
    for (int m = 0; m <= 2 * RW; ++m) acc[m] = kBig;
    for (int zs = z0 - RW; zs < z0 + kBz + RW; ++zs) {
      for (int p0 = 0; zs >= 0 && zs < a.sz && p0 < a.P; p0 += a.pc) {
        int full;
        if (!stage_chunk(a, stage, cnt, x0, y0, zs, p0, full)) break;
        for (int oy = 0; oy <= 2 * RW; ++oy) {
          const int dy = RW - oy;  // y - ys
          for (int ox = 0; ox <= 2 * RW; ++ox) {
            const int dx = RW - ox;
            const int q = (ty + oy) * tw + tx + ox;
            const int n = cnt[q];
            const float fdx = static_cast<float>(dx);
            const float fdy = static_cast<float>(dy);
            float c2[2 * RW + 1];
#pragma unroll
            for (int m = 0; m <= 2 * RW; ++m)
              c2[m] = static_cast<float>(dx * dx + dy * dy +
                                         (m - RW) * (m - RW));
            for (int k = g; k < n; k += kGroups) {
              const float4 e = stage[k * tile + q];
              const float exy = e.x * fdx + e.y * fdy;
              float ezn[RW + 1];  // e.z * n, exact for n = 1 and 2
#pragma unroll
              for (int j = 1; j <= RW; ++j)
                ezn[j] = e.z * static_cast<float>(j);
#pragma unroll
              for (int m = 0; m <= 2 * RW; ++m) {
                // exy + e.z dz; dz = 0 adds a zero, which leaves r2 - 2 t
                // unchanged
                const float tz = m == RW ? exy
                                 : m > RW ? exy + ezn[m - RW]
                                          : exy - ezn[RW - m];
                // r2 - 2 t rounds once either way: 2 t is exact
                const float d = __fmaf_rn(-2.f, tz, e.w) + c2[m];
                acc[m] = fminf(acc[m], d);
              }
            }
          }
        }
        if (!__syncthreads_or(full)) break;  // no cell has more slots
      }
      const int z = zs - RW;  // final after this plane
      if (z >= z0 && z < zend) {
        if (g > 0) fin[zs & 1][g - 1][col] = acc[0];
        __syncthreads();
        float d2min = acc[0];
        for (int h = 0; h < kGroups - 1; ++h)
          d2min = fminf(d2min, fin[zs & 1][h][col]);
        if (mine && g == 0) write_phi(a, x, y, z, d2min);
      }
#pragma unroll
      for (int m = 0; m < 2 * RW; ++m) acc[m] = acc[m + 1];
      acc[2 * RW] = kBig;
    }
  } else {
    float d2[kBz];
#pragma unroll
    for (int j = 0; j < kBz; ++j) d2[j] = kBig;
    for (int zs = zlo; zs <= zhi; ++zs) {
      const int dz0 = z0 - zs;  // z - zs of the brick's first destination
      for (int p0 = 0; p0 < a.P; p0 += a.pc) {
        int full;
        if (!stage_chunk(a, stage, cnt, x0, y0, zs, p0, full)) break;
        for (int oy = 0; oy <= 2 * rw && g == 0; ++oy) {
          const int dy = rw - oy;
          for (int ox = 0; ox <= 2 * rw; ++ox) {
            const int dx = rw - ox;
            const int q = (ty + oy) * tw + tx + ox;
            const int n = cnt[q];
            const float fdx = static_cast<float>(dx);
            const float fdy = static_cast<float>(dy);
            const int cxy = dx * dx + dy * dy;
            for (int k = 0; k < n; ++k) {
              const float4 e = stage[k * tile + q];
              const float exy = e.x * fdx + e.y * fdy;
#pragma unroll
              for (int j = 0; j < kBz; ++j) {
                const int dz = dz0 + j;
                if (dz >= -rw && dz <= rw) {
                  const float d =
                      e.w - 2.f * (exy + e.z * static_cast<float>(dz)) +
                      static_cast<float>(cxy + dz * dz);
                  d2[j] = fminf(d2[j], d);
                }
              }
            }
          }
        }
        if (!__syncthreads_or(full)) break;
      }
    }
    if (mine && g == 0) {
#pragma unroll
      for (int j = 0; j < kBz; ++j)
        if (z0 + j < zend) write_phi(a, x, y, z0 + j, d2[j]);
    }
  }
}

}  // namespace

// grid and pc from ops/levelset_kernels.py:levelset_plan; smem bytes =
// tile * (16 pc + 4)
extern "C" int union_levelset_launch(const float* px, const float* py,
                                     const float* pz,
                                     const unsigned char* valid, float* phi,
                                     long long T, int P, int sx, int sy,
                                     int sz, int rw, int pc, float radius,
                                     int gx, int gy, int gz, int smem,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pc < 1 || pc > kChunk) return static_cast<int>(cudaErrorInvalidValue);
  void (*fn)(LevelsetArgs) = rw == 1   ? union_levelset_kernel<1>
                             : rw == 2 ? union_levelset_kernel<2>
                             : rw == 3 ? union_levelset_kernel<3>
                                       : union_levelset_kernel<0>;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  LevelsetArgs a{px, py, pz, valid, phi, T, P, sx, sy, sz, rw, pc, radius};
  fn<<<dim3(gx, gy, gz), kThreads, smem,
       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* union_levelset_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
