// The particle-to-grid gather shared by csrc/p2g_levelset.cu (with the
// union levelset of a one-cell window fused in) and csrc/p2g_mac.cu (the
// transfer alone). kLevelset is a compile-time flag, so each source
// compiles the body it needs and nothing of the other; the transfer is the
// same device code in both, so their vel and weight are equal bit for bit.
// kSlab, also at compile time, adds the z-slab form of the sharded step
// (p2g_union_zshard_spmd): the destinations are one shard's planes (global
// zb ..) and the sources its slab extended by one plane of each neighbour
// (global zsrc = zb - 1 ..); z coordinates, the border tests and the
// levelset's interior ring are global.
//
// Semantics (flip_bucket.p2g_mac and union_levelset_bucketed):
//   face (c, cell) += w, w*v_c for every particle of source cell s = cell-d
//   whose tap d lies in the component's window (own axis {0,1}, cross
//   {-1,0,1}); w = (wz * wy) * wx, each the BUILD_INDEX linear weight
//   landing at tap d. weight < 1e-6 -> 0; vel = weight > 0 ? acc / weight
//   : 0. d2 = r2 - 2 (e . d) + |d|^2 with e = p - centre(s); d2min over
//   the 27 neighbours (1e10 for none); phi = min(sqrt(d2min) - r, r), r for
//   none, 0.5 on the boundary ring.
//
// Order of the sums. A destination adds its contributions in one fixed
// order: source plane z+1, z, z-1 (dz = -1, 0, 1), in each the source rows
// y+1, y, y-1, in each the cells x+1, x, x-1, in each the slots in
// ascending order. It depends on the destination's global coordinates and
// the slot indices only, never on where a brick or a slab starts, so a
// shard's planes equal the same planes of the one-domain result bit for
// bit, two launches are bitwise equal, and no atomics are used.
//
// Design for Hopper. Each live particle meets 27 destinations; one thread
// per destination that walked every slot of its 27 source cells read each
// particle 27 times through L1/L2 and weighted it 27 times. Here:
// - One block per brick of kBx x kBy x kBz destination cells. Thread
//   (tx, ty) of group g owns the z-column at (x0 + tx, y0 + ty): groups 0-2
//   sum velocity component g, group 3 (kLevelset) keeps d2min.
// - A brick whose window holds no live particle (slot 0 of every source
//   cell invalid) writes its outputs at once.
// - The block streams the source planes of its window from the top down.
//   For each it counts the live particles of the (kBx + 2)(kBy + 2) source
//   cells, stopping at each cell's first invalid slot (buckets are
//   gap-free, ops/flip_bucket.py), lays them out in shared memory in the
//   order above (cells in descending tile order, slots ascending), and
//   stages at most kCap of them at a time, so any P fits.
// - A particle is weighted once, when it is staged: its velocity, the tap
//   weights of its unshifted and half-shifted position on each axis, and
//   for the levelset its offset from the cell centre and r^2, with the
//   same float operations as the plain version (built with -fmad=false).
// - Each thread then applies the staged particles of its 9 source cells to
//   the three destinations of its column that the plane reaches (a sliding
//   window of registers): one shared-memory read serves three destinations.
//   After plane zs the destination zs + 1 is final and is written.
//
// Layout: slot fields are contiguous (P, T) arrays, T = sz*sy*sx with x
// fastest, valid one byte per slot; vel and weight out are (3, sz, sy, sx),
// phi (sz, sy, sx), all float32. kSlab: the slot fields hold T_src cells,
// the outputs T (the shard's planes).

#pragma once

#include <cuda_runtime.h>

#include "bucket_interp.cuh"

namespace {

// the brick; ops/p2g_kernels.py:p2g_plan mirrors these
constexpr int kBx = 8, kBy = 8, kBz = 8;
constexpr int kCol = kBx * kBy;                    // z-columns of a brick
constexpr int kTw = kBx + 2, kTile = kTw * (kBy + 2);  // source cells a plane
constexpr int kScan = (kTile + 31) / 32;  // tile cells per lane of the scan
constexpr int kCountUnroll = 8;  // valid bytes read at once per cell
constexpr int kStageUnroll = 2;  // particles loaded at once per thread
constexpr float kBig = 1e10f;
// particles staged at a time: 1024 keeps two blocks per SM and stages most
// planes of a developed dam in one turn
constexpr int kCap = 1024;

// staged fields of a particle, one record of kRec floats: the velocity, per
// axis the tap weights of the unshifted position (taps 0, 1) and of the
// half-shifted one (taps -1, 0, 1), with the levelset e and r^2
constexpr int kFV = 0, kFW = 3, kFE = 18;

template <bool kLevelset>
struct P2gShape {
  static constexpr int kGroups = kLevelset ? 4 : 3;
  static constexpr int kThreads = kCol * kGroups;
  static constexpr int kRec = kLevelset ? 22 : 18;
  static constexpr int kSmem = 4 * kRec * kCap;  // staging bytes
};
static_assert(kTile <= P2gShape<false>::kThreads, "one counting thread a cell");
static_assert(P2gShape<true>::kSmem <= 232448,
              "the staging fits one block's shared memory (227 KB)");

__host__ __device__ constexpr int unshifted(int ax, int d) {
  return kFW + 5 * ax + d;
}
__host__ __device__ constexpr int shifted(int ax, int d) {
  return kFW + 5 * ax + 3 + d;
}

struct P2gArgs {
  const float* __restrict__ px;
  const float* __restrict__ py;
  const float* __restrict__ pz;
  const float* __restrict__ vx;
  const float* __restrict__ vy;
  const float* __restrict__ vz;
  const unsigned char* __restrict__ valid;
  float* vel;     // (3, T)
  float* weight;  // (3, T)
  float* phi;     // (T), with kLevelset
  long long T;
  int P;
  int sx, sy, sz;  // sz: the domain's z extent
  float radius;    // with kLevelset
  long long T_src;  // kSlab: cells of the slot fields
  int zb, zsrc;     // kSlab: global z of the outputs' and sources' plane 0
};

// The shared memory a launch of `kernel` needs: `smem` bytes of staging
// (above the 48 KB default, P2gShape::kSmem), and the largest carveout, so
// that as many blocks fit an SM as the staging allows, whatever kernel ran
// before.
inline cudaError_t p2g_smem_attributes(void (*kernel)(P2gArgs), int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Linear weight that a particle with axis base b (relative to its source
// cell) and fraction w1 puts on tap d (flip_bucket._tap_weights).
__device__ __forceinline__ float tap_weight(int b_rel, float w1, int d) {
  return b_rel == d ? 1.f - w1 : (b_rel == d - 1 ? w1 : 0.f);
}

// Writes destination (x, y, z) of group g: velocity component g with its
// weight, or (g == 3) phi.
__device__ __forceinline__ void write_dest(const P2gArgs& a, int g, int x,
                                           int y, int z, int zb, float acc,
                                           float wsum) {
  const long long o =
      (static_cast<long long>(z - zb) * a.sy + y) * a.sx + x;
  if (g < 3) {
    const float ws = wsum < 1e-6f ? 0.f : wsum;
    a.weight[g * a.T + o] = ws;
    a.vel[g * a.T + o] = ws > 0.f ? acc / fmaxf(ws, 1e-30f) : 0.f;
  } else {
    const bool inter = x >= 1 && x <= a.sx - 2 && y >= 1 && y <= a.sy - 2 &&
                       z >= 1 && z <= a.sz - 2;
    float phi = acc >= kBig ? a.radius : sqrtf(fmaxf(acc, 0.f)) - a.radius;
    phi = fminf(phi, a.radius);
    a.phi[o] = inter ? phi : 0.5f;
  }
}

// Group G's work on the staged particles b0 .. of the plane: G < 3 adds
// component G's w and w*v to acc/ws[m] of destination z = zs + 1 - m
// (dz = 1 - m), G == 3 takes the min of d2 into acc[m]. A tile row's three
// source cells x+1, x, x-1 lie next to each other in the staged order, so
// each row is one run of particles (fewer idle lanes than a loop per
// cell); dx follows from where a particle lies in the run. Cells and slots
// in the order of the sums (see the top of this file). Record i holds
// KREC floats from st + i * KREC.
template <int G, int KREC>
__device__ __forceinline__ void apply(const float* st, const int* cnt,
                                      const int* off, int b0, int tx, int ty,
                                      float acc[3], float ws[3]) {
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    if (G == 1 && dy == -1) continue;
    // the row's cells: q1 (dx = 1), q1 + 1 (dx = 0), q1 + 2 (dx = -1);
    // component 0 takes no dx = -1
    const int q1 = (ty + 1 - dy) * kTw + tx;
    const int e0 = off[q1 + 1] - b0;  // first particle with dx <= 0
    const int e1 = off[q1] - b0;      // first particle with dx = 1
    const int lo = max(G == 0 ? e0 : off[q1 + 2] - b0, 0);
    const int hi = min(e1 + cnt[q1], kCap);
    for (int i = lo; i < hi; ++i) {
      const float* r = st + i * KREC;
      const int dx = i < e0 ? -1 : (i < e1 ? 0 : 1);
      if constexpr (G == 3) {
        const float ex = r[kFE + 0], ey = r[kFE + 1], ez = r[kFE + 2];
        const float r2 = r[kFE + 3];
        const float fdx = static_cast<float>(dx);
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const int dz = 1 - m;
          const float c2 = static_cast<float>(dx * dx + dy * dy + dz * dz);
          const float d2 = r2 - 2.f * (ex * fdx +
                                       ey * static_cast<float>(dy) +
                                       ez * static_cast<float>(dz)) + c2;
          acc[m] = fminf(acc[m], d2);
        }
      } else {
        const float v = r[kFV + G];
        const float wx = r[(G == 0 ? unshifted(0, 0) : shifted(0, 0)) + dx];
        const float wy = r[G == 1 ? unshifted(1, dy) : shifted(1, dy)];
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const int dz = 1 - m;
          if (G == 2 && dz == -1) continue;
          const float wz = r[G == 2 ? unshifted(2, dz) : shifted(2, dz)];
          const float w = (wz * wy) * wx;
          ws[m] = ws[m] + w;
          acc[m] = acc[m] + w * v;
        }
      }
    }
  }
}

template <bool kLevelset, bool kSlab>
__device__ __forceinline__ void p2g_gather(const P2gArgs& a) {
  using Sh = P2gShape<kLevelset>;
  // [kCap][kRec] staged particles
  extern __shared__ float st[];
  __shared__ int cnt[kTile], off[kTile], sums[2];  // sums: total, max count
  const int t = threadIdx.x, g = t / kCol, col = t % kCol;
  const int tx = col % kBx, ty = col / kBx;
  const long long sxy = static_cast<long long>(a.sx) * a.sy;
  const long long T_src = kSlab ? a.T_src : a.T;
  const int zb = kSlab ? a.zb : 0, zsrc = kSlab ? a.zsrc : 0;
  const int lz = static_cast<int>(a.T / sxy);  // output planes
  const int x0 = blockIdx.x * kBx, y0 = blockIdx.y * kBy;
  const int z0 = zb + blockIdx.z * kBz, zend = min(z0 + kBz, zb + lz);
  const int x = x0 + tx, y = y0 + ty;
  const bool mine = x < a.sx && y < a.sy;
  const int zlo = max(z0 - 1, 0), zhi = min(zend, a.sz - 1);

  // a brick whose window holds no live particle writes its outputs at once
  // (planes outer: a flat loop over the window's cells, c / kTile and
  // c % kTile, ran past its bound in the z-slab form as nvcc compiled it
  // for sm_90a, and read beyond the slot fields)
  int live = 0;
  for (int zs = zlo; zs <= zhi; ++zs) {
    for (int q = t; q < kTile; q += Sh::kThreads) {
      const int xs = x0 - 1 + q % kTw, ys = y0 - 1 + q / kTw;
      if (xs >= 0 && xs < a.sx && ys >= 0 && ys < a.sy)
        live |= a.valid[(zs - zsrc) * sxy +
                        static_cast<long long>(ys) * a.sx + xs];
    }
  }
  if (!__syncthreads_or(live)) {
    if (mine)
      for (int z = z0; z < zend; ++z) write_dest(a, g, x, y, z, zb, kBig, 0.f);
    return;
  }

  // m = 0, 1, 2: destinations zs + 1, zs, zs - 1 of source plane zs
  float acc[3], ws[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    acc[m] = g < 3 ? 0.f : kBig;
    ws[m] = 0.f;
  }
  for (int zs = zend; zs >= z0 - 1; --zs) {
    if (zs >= 0 && zs < a.sz) {
      const long long plane = (zs - zsrc) * sxy;
      // each cell's live particles: its leading valid slots
      if (t < kTile) {
        const int xs = x0 - 1 + t % kTw, ys = y0 - 1 + t / kTw;
        int n = 0;
        if (xs >= 0 && xs < a.sx && ys >= 0 && ys < a.sy) {
          const unsigned char* v =
              a.valid + plane + static_cast<long long>(ys) * a.sx + xs;
          for (int p0 = 0; p0 < a.P; p0 += kCountUnroll) {
            bool b[kCountUnroll];
#pragma unroll
            for (int k = 0; k < kCountUnroll; ++k)
              b[k] = p0 + k < a.P && v[(p0 + k) * T_src] != 0;
            int m = 0;
#pragma unroll
            for (int k = 0; k < kCountUnroll; ++k)
              m += (m == k && b[k]) ? 1 : 0;
            n += m;
            if (m < kCountUnroll) break;
          }
        }
        cnt[t] = n;
      }
      __syncthreads();
      // offsets in descending tile order (one warp scans)
      if (t < 32) {
        int local = 0, most = 0;
#pragma unroll
        for (int j = 0; j < kScan; ++j) {
          const int r = t * kScan + j;
          if (r < kTile) {
            local += cnt[kTile - 1 - r];
            most = max(most, cnt[kTile - 1 - r]);
          }
        }
        int incl = local;
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, incl, s);
          if (t >= s) incl += u;
        }
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
          most = max(most, __shfl_xor_sync(0xffffffffu, most, s));
        int run = incl - local;
#pragma unroll
        for (int j = 0; j < kScan; ++j) {
          const int r = t * kScan + j;
          if (r < kTile) {
            off[kTile - 1 - r] = run;
            run += cnt[kTile - 1 - r];
          }
        }
        if (t == 31) {
          sums[0] = incl;
          sums[1] = most;
        }
      }
      __syncthreads();
      const int total = sums[0], pairs = sums[1] * kTile;
      for (int b0 = 0; b0 < total; b0 += kCap) {
        // stage particles b0 .. b0 + kCap - 1: slot k of cell q, q fastest
        for (int j0 = t; j0 < pairs; j0 += kStageUnroll * Sh::kThreads) {
          float f[kStageUnroll][6];
          int dst[kStageUnroll], qs[kStageUnroll];
#pragma unroll
          for (int u = 0; u < kStageUnroll; ++u) {
            const int j = j0 + u * Sh::kThreads;
            const int k = j / kTile, q = j % kTile;
            dst[u] = -1;
            qs[u] = q;
            if (j < pairs && k < cnt[q]) {
              const int i = off[q] + k - b0;
              if (i >= 0 && i < kCap) {
                dst[u] = i;
                const long long idx =
                    k * T_src + plane +
                    static_cast<long long>(y0 - 1 + q / kTw) * a.sx + x0 - 1 +
                    q % kTw;
                f[u][0] = a.px[idx];
                f[u][1] = a.py[idx];
                f[u][2] = a.pz[idx];
                f[u][3] = a.vx[idx];
                f[u][4] = a.vy[idx];
                f[u][5] = a.vz[idx];
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kStageUnroll; ++u) {
            const int i = dst[u];
            if (i < 0) continue;
            float* r = st + i * Sh::kRec;
            const int src[3] = {x0 - 1 + qs[u] % kTw, y0 - 1 + qs[u] / kTw,
                                zs};
            const int n[3] = {a.sx, a.sy, a.sz};
#pragma unroll
            for (int ax = 0; ax < 3; ++ax) {
              r[kFV + ax] = f[u][3 + ax];
              int b;
              float w1;
              axw(f[u][ax] - 0.f, n[ax], b, w1);
#pragma unroll
              for (int d = 0; d <= 1; ++d)
                r[unshifted(ax, d)] = tap_weight(b - src[ax], w1, d);
              axw(f[u][ax] - 0.5f, n[ax], b, w1);
#pragma unroll
              for (int d = -1; d <= 1; ++d)
                r[shifted(ax, d)] = tap_weight(b - src[ax], w1, d);
            }
            if constexpr (kLevelset) {
              // union levelset: the offset from this cell's centre
              const float ex = f[u][0] - (static_cast<float>(src[0]) + 0.5f);
              const float ey = f[u][1] - (static_cast<float>(src[1]) + 0.5f);
              const float ez = f[u][2] - (static_cast<float>(src[2]) + 0.5f);
              r[kFE + 0] = ex;
              r[kFE + 1] = ey;
              r[kFE + 2] = ez;
              r[kFE + 3] = ex * ex + ey * ey + ez * ez;
            }
          }
        }
        __syncthreads();
        if (mine) {
          switch (g) {
            case 0:
              apply<0, Sh::kRec>(st, cnt, off, b0, tx, ty, acc, ws);
              break;
            case 1:
              apply<1, Sh::kRec>(st, cnt, off, b0, tx, ty, acc, ws);
              break;
            case 2:
              apply<2, Sh::kRec>(st, cnt, off, b0, tx, ty, acc, ws);
              break;
            default:
              if constexpr (kLevelset)
                apply<3, Sh::kRec>(st, cnt, off, b0, tx, ty, acc, ws);
          }
        }
        __syncthreads();
      }
    }
    // destination zs + 1 has all three of its planes
    const int z = zs + 1;
    if (mine && z >= z0 && z < zend)
      write_dest(a, g, x, y, z, zb, acc[0], ws[0]);
    acc[0] = acc[1];
    acc[1] = acc[2];
    acc[2] = g < 3 ? 0.f : kBig;
    ws[0] = ws[1];
    ws[1] = ws[2];
    ws[2] = 0.f;
  }
}

}  // namespace
