// Bucketed particle advection with the deferred FLIP blend fused into the
// first stage, over the live slots only: the hand-written Hopper kernel
// behind ops/advect_bucket_kernels.py (advect_blend_live, the step's form,
// and advect_blend, which first copies every slot through), and in its
// z-slab form (advect_live_kernel<true, ...>) behind advect_blend_slab_live /
// advect_blend_slab, one launch per shard of the sharded step.
//
// advect_live_kernel<kSlab, kBlend, kStop>: kBlend = false is the form
// without the blend (advect_pallas; ops/advect_bucket_kernels.py:advect):
// positions only, vel_old, pending and the slot velocities neither read nor
// written. kStop = false is stop_in_obstacle=False: no stage is zeroed for
// leaving the bounds or entering an obstacle, and no final bisection; the
// clamp to [0, n-1] stays, and the obstacle mask is neither read nor staged.
//
// Replaces the TPU kernel mantaflow_tpu/ops/flip_bucket_pallas.py:
// _advect_kernel/_advect_tile (advect_blend_pallas, advect_pallas; the
// z_base form advect_blend_zshard_spmd). The TPU has no gather, so it
// evaluates the MAC grid at particle positions as a sum over a window of
// tap planes (54-108 taps per stage), fed by five overlapping z-plane
// blocks in VMEM, and skips empty tiles and slot chunks.
//
// Semantics (flip_bucket.advect_bucketed after flip_update_bucketed):
//   blend (where *pending): v = r (v + vnew - vold) + (1-r) vnew
//   stages: u = clip(interpolMAC(vel, q) * dt, -1, 1), with kStop zeroed
//     where q is out of bounds (bnd=1) or, unless ring_only, in an obstacle
//     (the own cell's flag at stage 1, flags at trunc(q) after); Euler /
//     RK2 midpoint / the fork's RK4 (2,2,2,1)/6
//   p' = clip(p + clip(du, -1, 1), 0, n-1) (KnClampPositions), then with
//   kStop bisectBacktracePos with 4 probes when p' is in an obstacle
// The blend and stage 1 share their weights. The arithmetic keeps the plain
// version's operation order (built with -fmad=false), so the two agree to
// float rounding of the same sums.
//
// Only the live slots are read and written: the slots of a cell up to its
// first invalid one (the buckets are gap-free, ops/flip_bucket.py). The
// step's one consumer, the rebin, reads nothing else; advect_blend fills
// its outputs with copies of the inputs before the launch.
//
// Design for Hopper. At PPC 24 on the developed 128^3 dam 92 % of the
// slots are dead, and a warp of one thread per slot ran the whole RK4 path
// for its few live lanes. Here:
// - One block per tile of kTx x kTy x kTz cells. Each warp counts a row of
//   32 x-cells: it reads valid slot row by slot row (kCountUnroll rows at
//   once) up to the first row no lane holds, one ballot mask per slot row.
//   A tile with no live slot exits.
// - A block-wide scan of the masks' popcounts turns them into a dense list
//   of live slots, slot row first, then the tile's cells in x-fastest
//   order: every lane of a warp works, and where a row is full, neighbouring
//   lanes load and store neighbouring addresses.
// - The tile's window of vel (two cells below, three above), vel_old (one
//   each side) and the obstacle mask (one below, two above) goes into
//   shared memory, so every corner tap of every stage and probe is a
//   shared-memory load. A live tile starts the grids' copies (cp.async)
//   right after the count and waits for them after the scan. The windows
//   follow from the clip of every stage displacement to one cell: for a
//   drift-0 position in its own cell c (c <= p < c+1 on each axis) every
//   stage position, probe and p' lies in [c-1, c+2] (a sum rounded up
//   reaches c+2 at most), its x-component corners in [c-1, c+3], the
//   staggered ones in [c-2, c+2], its flags cell in [c-1, c+2], and
//   vel_old is read at the drift-0 position alone. A particle outside its
//   own cell (none after a rebin that kept the CFL contract) takes the
//   same arithmetic on the global grids.
//
// Layout: slot fields are contiguous (P, T) arrays, T = nz*sy*sx with x
// fastest, valid one byte per slot; vel/vel_old are (3, gnz, sy, sx)
// float32; obs (unless ring_only) one byte per cell; dt and pending are
// device scalars (float32, bool), read by the kernel so the step needs no
// host sync.
//
// The z-slab form (kSlab, the port of _advect_kernel with z_base and
// sz_global, advect_blend_zshard_spmd): the slot fields are one shard's
// cells, global planes zb .. zb+nz-1; the grids and obs hold the shard's
// planes with two planes of each neighbour (zero past the domain's ends),
// planes zlo .. zlo+gnz-1 of the domain. The positions stay global, and
// every clamp and bounds test uses the domain's z extent sz. The one-domain
// kernel is the same body with zb = zlo = 0 and gnz = sz.

#include <cuda_runtime.h>

#include <type_traits>

#include "bucket_interp.cuh"

namespace {

// ops/advect_bucket_kernels.py:advect_plan mirrors these
constexpr int kTx = 32, kTy = 4, kTz = 2;  // tile cells in x, y, z
constexpr int kThreads = 256;
constexpr int kMinBlocksPerSm = 4;

constexpr int kCells = kTx * kTy * kTz;
constexpr int kGroups = kTy * kTz;  // rows of 32 x-cells
constexpr int kWarps = kThreads / 32;
constexpr int kCountUnroll = 8;  // slot rows of valid read at once
// staged windows: cells below and above the tile on each axis
constexpr int kVelLo = 2, kVelHi = 3;
constexpr int kOldLo = 1, kOldHi = 1;
constexpr int kObsLo = 1, kObsHi = 2;
constexpr int kVx = kTx + kVelLo + kVelHi, kVy = kTy + kVelLo + kVelHi,
              kVz = kTz + kVelLo + kVelHi;
constexpr int kOx = kTx + kOldLo + kOldHi, kOy = kTy + kOldLo + kOldHi,
              kOz = kTz + kOldLo + kOldHi;
constexpr int kBx = kTx + kObsLo + kObsHi, kBy = kTy + kObsLo + kObsHi,
              kBz = kTz + kObsLo + kObsHi;
constexpr int kVelWin = kVx * kVy * kVz, kOldWin = kOx * kOy * kOz,
              kObsWin = kBx * kBy * kBz;
static_assert(kTx == 32, "a tile row is one warp's lanes");
static_assert(kGroups % kWarps == 0 || kWarps % kGroups == 0, "rows");
// a list entry: slot row << kCellBits | the tile's cell (P < 256 with the
// 16-bit entries of a tile of 256 cells)
constexpr int kCellBits = kCells <= 256 ? 8 : 16;
using Entry = std::conditional_t<kCells <= 256, unsigned short, unsigned>;

// The block's dynamic shared memory for P slot rows (the host's
// advect_plan computes the same): staged vel and vel_old, one mask and
// one list offset per slot row and tile row, the list, staged obs.
__host__ __device__ inline long long live_smem_bytes(int P) {
  return 4LL * 3 * (kVelWin + kOldWin) + 8LL * P * kGroups +
         static_cast<long long>(sizeof(Entry)) * P * kCells + kObsWin;
}

struct AdvectArgs {
  const float* __restrict__ px;
  const float* __restrict__ py;
  const float* __restrict__ pz;
  const unsigned char* __restrict__ valid;
  const float* __restrict__ vx;  // blend inputs (kBlend)
  const float* __restrict__ vy;
  const float* __restrict__ vz;
  const float* __restrict__ vel;      // (3, gnz, sy, sx)
  const float* __restrict__ vel_old;  // (3, gnz, sy, sx)
  const unsigned char* __restrict__ obs;  // (gnz, sy, sx): kStop, !ring_only
  const float* dt;
  const unsigned char* pending;
  float* opx;
  float* opy;
  float* opz;
  float* ovx;
  float* ovy;
  float* ovz;
  long long T;
  int P;
  int sx, sy, sz;  // sz: the domain's z extent
  int nz;          // the slot fields' planes (T = nz * sy * sx)
  int zb;          // global z of the slot fields' plane 0
  int zlo, gnz;    // the grids' planes zlo .. zlo+gnz-1
  float flip_ratio, pic_ratio;  // r and (1 - r), rounded to float once
  int mode;  // 0 Euler, 1 RK2, 2 RK4
  int ring_only;
};

// The grids one particle's taps read: the global arrays, or (kStaged) the
// block's windows in shared memory, whose cell (0, 0, 0) is the tile
// origin (ox, oy, oz) less the window's low halo.
template <bool kStaged>
struct Grids {
  const AdvectArgs& a;
  const float* svel;
  const float* sold;
  const unsigned char* sobs;
  int ox, oy, oz;  // global coordinates of the tile's first cell

  __device__ __forceinline__ const float* vel_row(int c, int z, int y,
                                                  int x) const {
    if constexpr (kStaged)
      return svel + ((c * kVz + z - oz + kVelLo) * kVy + y - oy + kVelLo) *
                        kVx + x - ox + kVelLo;
    const long long sxy = static_cast<long long>(a.sx) * a.sy;
    return a.vel + (c * static_cast<long long>(a.gnz) + z - a.zlo) * sxy +
           static_cast<long long>(y) * a.sx + x;
  }
  __device__ __forceinline__ const float* old_row(int c, int z, int y,
                                                  int x) const {
    if constexpr (kStaged)
      return sold + ((c * kOz + z - oz + kOldLo) * kOy + y - oy + kOldLo) *
                        kOx + x - ox + kOldLo;
    const long long sxy = static_cast<long long>(a.sx) * a.sy;
    return a.vel_old + (c * static_cast<long long>(a.gnz) + z - a.zlo) * sxy +
           static_cast<long long>(y) * a.sx + x;
  }
  __device__ __forceinline__ bool obs_at(int z, int y, int x) const {
    if constexpr (kStaged)
      return sobs[((z - oz + kObsLo) * kBy + y - oy + kObsLo) * kBx + x - ox +
                  kObsLo] != 0;
    return a.obs[(static_cast<long long>(z - a.zlo) * a.sy + y) * a.sx + x] !=
           0;
  }
};

__device__ __forceinline__ bool in_bounds(const AdvectArgs& a, float qx,
                                          float qy, float qz) {
  return qx >= 1.f && qx < static_cast<float>(a.sx - 1) && qy >= 1.f &&
         qy < static_cast<float>(a.sy - 1) && qz >= 1.f &&
         qz < static_cast<float>(a.sz - 1);
}

// flags at trunc(q), clamped into the grid (particle.h:485-492)
template <class G>
__device__ __forceinline__ bool obstacle_at(const G& g, float qx, float qy,
                                            float qz) {
  const AdvectArgs& a = g.a;
  if (a.ring_only) return !in_bounds(a, qx, qy, qz);
  const int ix = min(max(static_cast<int>(qx), 0), a.sx - 1);
  const int iy = min(max(static_cast<int>(qy), 0), a.sy - 1);
  const int iz = min(max(static_cast<int>(qz), 0), a.sz - 1);
  return g.obs_at(iz, iy, ix);
}

__device__ __forceinline__ float clip1(float u) {
  return fminf(fmaxf(u, -1.f), 1.f);
}

// Component c of a MAC grid at q, in mac_comp's order (bucket_interp.cuh):
// z taps outer, y taps, x pairs inner, acc += (wz*wy) * (wx0 g0 + wx1 g1).
template <bool kOld, class G>
__device__ __forceinline__ float mac_at(const G& g, int c, float qx, float qy,
                                        float qz) {
  const AdvectArgs& a = g.a;
  int bx, by, bz;
  float wx, wy, wz;
  axw(qx - (c == 0 ? 0.f : 0.5f), a.sx, bx, wx);
  axw(qy - (c == 1 ? 0.f : 0.5f), a.sy, by, wy);
  axw(qz - (c == 2 ? 0.f : 0.5f), a.sz, bz, wz);
  const float wxs[2] = {1.f - wx, wx};
  const float wys[2] = {1.f - wy, wy};
  const float wzs[2] = {1.f - wz, wz};
  float acc = 0.f;
  for (int iz = 0; iz < 2; ++iz) {
    for (int iy = 0; iy < 2; ++iy) {
      const float* row = kOld ? g.old_row(c, bz + iz, by + iy, bx)
                              : g.vel_row(c, bz + iz, by + iy, bx);
      const float inner = wxs[0] * row[0] + wxs[1] * row[1];
      acc = acc + (wzs[iz] * wys[iy]) * inner;
    }
  }
  return acc;
}

// dt-scale, clamp and obstacle stage-zeroing of a raw evaluation.
// own_cell: the stage-1 probe reads the bucket cell's own flag.
template <bool kStop, class G>
__device__ __forceinline__ void to_step(const G& g, float dt,
                                        const float raw[3], float qx, float qy,
                                        float qz, bool own_cell, int cx,
                                        int cy, int cz, float u[3]) {
  const AdvectArgs& a = g.a;
  for (int k = 0; k < 3; ++k) u[k] = clip1(raw[k] * dt);
  if constexpr (!kStop) return;
  bool bad = !in_bounds(a, qx, qy, qz);
  if (!a.ring_only)
    bad = bad || (own_cell ? g.obs_at(cz, cy, cx)
                           : obstacle_at(g, qx, qy, qz));
  if (bad) u[0] = u[1] = u[2] = 0.f;
}

template <bool kStop, class G>
__device__ __forceinline__ void eval_u(const G& g, float dt, float qx,
                                       float qy, float qz, float u[3]) {
  float raw[3];
  for (int c = 0; c < 3; ++c) raw[c] = mac_at<false>(g, c, qx, qy, qz);
  to_step<kStop>(g, dt, raw, qx, qy, qz, false, 0, 0, 0, u);
}

// One live slot i of cell (cx, cy, cz), cz global, its drift-0 position
// (x0, y0, z0): the blend (kBlend), the stages, the clamp and (kStop) the
// bisection.
template <bool kBlend, bool kStop, class G>
__device__ __forceinline__ void advect_slot(const G& g, long long i, int cx,
                                            int cy, int cz, float x0,
                                            float y0, float z0) {
  const AdvectArgs& a = g.a;
  const float dt = *a.dt;

  // stage 1 at the drift-0 positions, shared with the blend
  float raw[3];
  for (int c = 0; c < 3; ++c) raw[c] = mac_at<false>(g, c, x0, y0, z0);
  if constexpr (kBlend) {
    const float pv[3] = {a.vx[i], a.vy[i], a.vz[i]};
    float nv[3];
    const bool pend = *a.pending != 0;
    for (int c = 0; c < 3; ++c) {
      const float vold = mac_at<true>(g, c, x0, y0, z0);
      nv[c] = pend ? a.flip_ratio * (pv[c] + (raw[c] - vold)) +
                         a.pic_ratio * raw[c]
                   : pv[c];
    }
    a.ovx[i] = nv[0];
    a.ovy[i] = nv[1];
    a.ovz[i] = nv[2];
  }
  float u0[3];
  to_step<kStop>(g, dt, raw, x0, y0, z0, true, cx, cy, cz, u0);

  float du[3];
  if (a.mode == 0) {
    for (int k = 0; k < 3; ++k) du[k] = u0[k];
  } else if (a.mode == 1) {
    eval_u<kStop>(g, dt, x0 + 0.5f * u0[0], y0 + 0.5f * u0[1],
                  z0 + 0.5f * u0[2], du);
  } else {
    float u1[3], u2[3], u3[3];
    eval_u<kStop>(g, dt, x0 + 0.5f * u0[0], y0 + 0.5f * u0[1],
                  z0 + 0.5f * u0[2], u1);
    eval_u<kStop>(g, dt, x0 + 0.5f * u1[0], y0 + 0.5f * u1[1],
                  z0 + 0.5f * u1[2], u2);
    eval_u<kStop>(g, dt, x0 + u2[0], y0 + u2[1], z0 + u2[2], u3);
    for (int k = 0; k < 3; ++k)
      du[k] = (2.f * u0[k] + 2.f * u1[k] + 2.f * u2[k] + u3[k]) / 6.f;
  }

  // KnClampPositions (particle.h:508-525)
  float nx = fminf(fmaxf(x0 + clip1(du[0]), 0.f), static_cast<float>(a.sx - 1));
  float ny = fminf(fmaxf(y0 + clip1(du[1]), 0.f), static_cast<float>(a.sy - 1));
  float nz = fminf(fmaxf(z0 + clip1(du[2]), 0.f), static_cast<float>(a.sz - 1));
  if (kStop && obstacle_at(g, nx, ny, nz)) {
    // bisectBacktracePos (particle.h:494-505): 4 bisection probes
    float s = 0.f;
    for (int k = 1; k < 5; ++k) {
      const float t = s + 1.f / static_cast<float>(1 << k);
      const bool obs = obstacle_at(g, x0 * (1.f - t) + nx * t,
                                   y0 * (1.f - t) + ny * t,
                                   z0 * (1.f - t) + nz * t);
      s = obs ? s : t;
    }
    nx = x0 * (1.f - s) + nx * s;
    ny = y0 * (1.f - s) + ny * s;
    nz = z0 * (1.f - s) + nz * s;
  }
  a.opx[i] = nx;
  a.opy[i] = ny;
  a.opz[i] = nz;
}

// One 4-byte cp.async into shared memory: src_bytes 4 copies *src, 0
// writes zero (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The window of cells (x0 .. x0+kNx-1, y0 .., z0 ..) of a (.., gnz, sy,
// sx) grid: whether cell r of the window (x fastest) lies in the domain's
// rows and columns and the grid's planes, and its offset in one component.
template <int kNx, int kNy>
__device__ __forceinline__ bool window_cell(const AdvectArgs& a, int r,
                                            int x0, int y0, int z0,
                                            long long& off) {
  const int x = x0 + r % kNx, y = y0 + r / kNx % kNy,
            zp = z0 + r / (kNx * kNy) - a.zlo;
  off = (static_cast<long long>(zp) * a.sy + y) * a.sx + x;
  return x >= 0 && x < a.sx && y >= 0 && y < a.sy && zp >= 0 && zp < a.gnz;
}

// Starts the copies of the window of kNz planes of kNy rows of kNx cells
// from global cell (x0, y0, z0) of the three components of a (3, gnz, sy,
// sx) grid into dst (kNz*kNy*kNx floats a component), zero outside the
// domain and the grid's planes; cp_async_wait_all completes them.
template <int kNx, int kNy, int kNz>
__device__ __forceinline__ void stage_grid_async(float* dst, const float* src,
                                                 const AdvectArgs& a, int x0,
                                                 int y0, int z0) {
  constexpr int kWin = kNx * kNy * kNz;
  const long long comp = static_cast<long long>(a.gnz) * a.sy * a.sx;
  for (int e = threadIdx.x; e < 3 * kWin; e += kThreads) {
    long long off;
    const int c = e / kWin;
    const bool in = window_cell<kNx, kNy>(a, e % kWin, x0, y0, z0, off);
    cp_async4(dst + e, in ? src + c * comp + off : src, in ? 4 : 0);
  }
}

template <bool kSlab, bool kBlend, bool kStop>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
    advect_live_kernel(AdvectArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[kWarps];
  const int P = a.P;
  float* svel = reinterpret_cast<float*>(smem);
  float* sold = svel + 3 * kVelWin;
  unsigned* masks = reinterpret_cast<unsigned*>(sold + 3 * kOldWin);
  int* offs = reinterpret_cast<int*>(masks + P * kGroups);  // [P][kGroups]
  Entry* list = reinterpret_cast<Entry*>(offs + P * kGroups);
  unsigned char* sobs = reinterpret_cast<unsigned char*>(list + P * kCells);

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int tx0 = blockIdx.x * kTx, ty0 = blockIdx.y * kTy,
            tz0 = blockIdx.z * kTz;  // tz0: the slot fields' plane
  const long long sxy = static_cast<long long>(a.sx) * a.sy;

  // 1. each row of 32 x-cells: one ballot mask per slot row
  bool any = false;
  for (int g = warp; g < kGroups; g += kWarps) {
    const int x = tx0 + lane, y = ty0 + g % kTy, z = tz0 + g / kTy;
    const bool in = x < a.sx && y < a.sy && z < a.nz;
    const unsigned char* v =
        a.valid + (in ? (z * sxy + static_cast<long long>(y) * a.sx + x) : 0);
    int p0 = 0;
    for (; p0 < P; p0 += kCountUnroll) {
      bool b[kCountUnroll];
#pragma unroll
      for (int u = 0; u < kCountUnroll; ++u)
        b[u] = in && p0 + u < P && __ldg(v + (p0 + u) * a.T) != 0;
      unsigned last = 0;
#pragma unroll
      for (int u = 0; u < kCountUnroll; ++u) {
        last = __ballot_sync(0xffffffffu, b[u]);
        if (lane == 0 && p0 + u < P) masks[(p0 + u) * kGroups + g] = last;
        any = any || last != 0;
      }
      if (last == 0) break;
    }
    // the slot rows past the first empty one hold no live slot
    for (int p = p0 + kCountUnroll + lane; p < P; p += 32)
      masks[p * kGroups + g] = 0;
  }
  if (!__syncthreads_or(any)) return;

  // 2. the tile's grid windows: vel and vel_old copied asynchronously
  // while the obstacle window is loaded and the list is built
  const int zt = a.zb + tz0;  // global z of the tile's first plane
  stage_grid_async<kVx, kVy, kVz>(svel, a.vel, a, tx0 - kVelLo, ty0 - kVelLo,
                                  zt - kVelLo);
  if (kBlend)
    stage_grid_async<kOx, kOy, kOz>(sold, a.vel_old, a, tx0 - kOldLo,
                                    ty0 - kOldLo, zt - kOldLo);
  if (kStop && !a.ring_only) {
    for (int e = t; e < kObsWin; e += kThreads) {
      long long off;
      const bool in = window_cell<kBx, kBy>(a, e, tx0 - kObsLo, ty0 - kObsLo,
                                            zt - kObsLo, off);
      sobs[e] = in ? __ldg(a.obs + off) : 0;
    }
  }

  // 3. the list: an exclusive scan of the masks' popcounts in (slot row,
  // tile row) order, each thread over a run of them
  const int U = P * kGroups;
  const int per = (U + kThreads - 1) / kThreads;
  const int u0 = min(t * per, U), u1 = min(u0 + per, U);
  int mine = 0;
  for (int u = u0; u < u1; ++u) mine += __popc(masks[u]);
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int base = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    base += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
  }
  int run = base + incl - mine;
  for (int u = u0; u < u1; ++u) {
    offs[u] = run;
    run += __popc(masks[u]);
  }
  __syncthreads();
  for (int u = warp; u < U; u += kWarps) {
    const unsigned m = masks[u];
    if ((m >> lane) & 1u)
      list[offs[u] + __popc(m & ((1u << lane) - 1u))] =
          static_cast<Entry>(u / kGroups) << kCellBits |
          static_cast<Entry>((u % kGroups) * 32 + lane);
  }

  cp_async_wait_all();
  __syncthreads();

  // 4. the live slots
  const Grids<true> staged{a, svel, sold, sobs, tx0, ty0, zt};
  const Grids<false> global{a, svel, sold, sobs, tx0, ty0, zt};
  for (int k = t; k < total; k += kThreads) {
    const Entry e = list[k];
    const int p = static_cast<int>(e >> kCellBits);
    const int c = static_cast<int>(e & ((1u << kCellBits) - 1u));
    const int x = tx0 + c % 32, y = ty0 + (c / 32) % kTy,
              z = tz0 + c / (32 * kTy);
    const long long i = p * a.T + z * sxy + static_cast<long long>(y) * a.sx +
                        x;
    const float x0 = a.px[i], y0 = a.py[i], z0 = a.pz[i];
    const int zg = a.zb + z;
    const bool own = x0 >= static_cast<float>(x) &&
                     x0 < static_cast<float>(x + 1) &&
                     y0 >= static_cast<float>(y) &&
                     y0 < static_cast<float>(y + 1) &&
                     z0 >= static_cast<float>(zg) &&
                     z0 < static_cast<float>(zg + 1);
    if (own)
      advect_slot<kBlend, kStop>(staged, i, x, y, zg, x0, y0, z0);
    else
      advect_slot<kBlend, kStop>(global, i, x, y, zg, x0, y0, z0);
  }
}

template <bool kSlab, bool kBlend>
void (*pick_stop(int stop))(AdvectArgs) {
  return stop ? advect_live_kernel<kSlab, kBlend, true>
              : advect_live_kernel<kSlab, kBlend, false>;
}

template <bool kSlab>
void (*pick_blend(int blend, int stop))(AdvectArgs) {
  return blend ? pick_stop<kSlab, true>(stop) : pick_stop<kSlab, false>(stop);
}

}  // namespace

// The launch plan (tiles bx x by x bz, smem bytes of dynamic shared
// memory) comes from ops/advect_bucket_kernels.py:advect_plan.
extern "C" int advect_bucket_launch(
    const float* px, const float* py, const float* pz,
    const unsigned char* valid, const float* vx, const float* vy,
    const float* vz, const float* vel, const float* vel_old,
    const unsigned char* obs, const float* dt, const unsigned char* pending,
    float* opx, float* opy, float* opz, float* ovx, float* ovy, float* ovz,
    long long T, int P, int sx, int sy, int sz, int zb, int zlo, int gnz,
    float flip_ratio, float pic_ratio, int mode, int ring_only, int slab,
    int blend, int stop, int bx, int by, int bz, long long smem, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem != live_smem_bytes(P)) return static_cast<int>(cudaErrorInvalidValue);
  // slab: T cells of planes zb.. of the domain's sz; the grids and obs hold
  // planes zlo .. zlo+gnz-1. Otherwise T is the whole domain's.
  const int nz = static_cast<int>(T / (static_cast<long long>(sx) * sy));
  AdvectArgs a{px, py, pz, valid, vx, vy, vz, vel, vel_old, obs, dt, pending,
               opx, opy, opz, ovx, ovy, ovz, T, P, sx, sy, sz, nz, zb, zlo,
               gnz, flip_ratio, pic_ratio, mode, ring_only};
  void (*fn)(AdvectArgs) = slab ? pick_blend<true>(blend, stop)
                                : pick_blend<false>(blend, stop);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<dim3(bx, by, bz), kThreads, static_cast<size_t>(smem),
       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* advect_bucket_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
