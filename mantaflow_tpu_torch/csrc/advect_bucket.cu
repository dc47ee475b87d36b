// Bucketed particle advection with the deferred FLIP blend fused into the
// first stage: the hand-written Hopper kernel behind
// ops/advect_bucket_kernels.py:advect_blend, and in its z-slab form
// (advect_bucket_zshard_kernel) behind advect_blend_slab, one launch per
// shard of the sharded step.
//
// Replaces the TPU kernel mantaflow_tpu/ops/flip_bucket_pallas.py:
// _advect_kernel/_advect_tile (advect_blend_pallas, advect_pallas). The TPU
// has no gather, so it evaluates the MAC grid at particle positions as a
// sum over a window of tap planes (54-108 taps per stage), fed by five
// overlapping z-plane blocks in VMEM, and skips empty tiles and slot chunks.
// Hopper gathers from L1/L2, so this kernel runs one thread per bucket slot
// and reads the 8 corners of each interpolation directly. That is the same
// function: every stage displacement is clamped to one cell per axis, so
// every stage position lies inside its tap window
// (flip_bucket.py:_TAPS), and the BUILD_INDEX clamp of _axw keeps both
// corners inside the grid. The blend and the stage-1 velocity share their
// weights, as on the TPU. It is bound by bytes: the seven (P, T) slot
// fields are read once and six written once (invalid slots just pass
// through); the grid corners (vel, and vel_old for the blend) are shared by
// the particles of a cell and its neighbours and hit in cache.
//
// Semantics (flip_bucket.advect_bucketed after flip_update_bucketed):
//   blend (where *pending): v = r (v + vnew - vold) + (1-r) vnew
//   stages: u = clip(interpolMAC(vel, q) * dt, -1, 1), zeroed where q is out
//     of bounds (bnd=1) or, unless ring_only, in an obstacle (the own cell's
//     flag at stage 1, flags at trunc(q) after); Euler / RK2 midpoint / the
//     fork's RK4 (2,2,2,1)/6
//   p' = clip(p + clip(du, -1, 1), 0, n-1) (KnClampPositions), then
//   bisectBacktracePos with 4 probes when p' is in an obstacle
// The arithmetic keeps the plain version's operation order (built with
// -fmad=false), so the two agree to float rounding of the same sums.
//
// Layout: slot fields are contiguous (P, T) arrays, T = sz*sy*sx with x
// fastest, valid one byte per slot; vel/vel_old are (3, sz, sy, sx) float32;
// obs (unless ring_only) one byte per cell; dt and pending are device
// scalars (float32, bool), read by the kernel so the step needs no host
// sync.
//
// The z-slab form (the port of _advect_kernel with z_base and sz_global,
// advect_blend_zshard_spmd): the slot fields are one shard's cells, the
// grids and obs hold the shard's planes with two planes of each neighbour
// (zero past the domain's ends), planes zlo .. zlo+nz-1 of the domain. The
// positions stay global, and every clamp and bounds test uses the domain's
// z extent sz: a stage moves at most one cell, so every corner read lies
// within two planes of the slab. The one-domain kernel is the same body
// with zlo = 0 and nz = sz fixed at compile time, so its code is what it
// was.

#include <cuda_runtime.h>

#include "bucket_interp.cuh"

namespace {

constexpr int kThreads = 256;
// Four resident blocks per SM cap the kernel at 64 registers (24 bytes
// spill). The corner gathers wait on L1/L2, so occupancy hides them: left to
// itself nvcc takes 79 registers (three blocks per SM), and on an H100 at
// PPC 24 the kernel took 1767 instead of 1475 us per launch.
constexpr int kMinBlocksPerSm = 4;

struct AdvectArgs {
  const float* px;
  const float* py;
  const float* pz;
  const unsigned char* valid;
  const float* vx;  // blend inputs
  const float* vy;
  const float* vz;
  const float* vel;      // (3, sz, sy, sx)
  const float* vel_old;  // (3, sz, sy, sx)
  const unsigned char* obs;  // (sz, sy, sx), unless ring_only
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
  int zlo, nz;     // z-slab form: the grids' planes zlo .. zlo+nz-1
  long long own_off;  // z-slab form: a slot's own cell in obs, less cell
  float flip_ratio, pic_ratio;  // r and (1 - r), rounded to float once
  int mode;  // 0 Euler, 1 RK2, 2 RK4
  int ring_only;
};

__device__ __forceinline__ bool in_bounds(const AdvectArgs& a, float qx,
                                          float qy, float qz) {
  return qx >= 1.f && qx < static_cast<float>(a.sx - 1) && qy >= 1.f &&
         qy < static_cast<float>(a.sy - 1) && qz >= 1.f &&
         qz < static_cast<float>(a.sz - 1);
}

template <bool kSlab>
__device__ __forceinline__ int grid_zlo(const AdvectArgs& a) {
  return kSlab ? a.zlo : 0;
}

template <bool kSlab>
__device__ __forceinline__ int grid_nz(const AdvectArgs& a) {
  return kSlab ? a.nz : a.sz;
}

// flags at trunc(q), clamped into the grid (particle.h:485-492)
template <bool kSlab>
__device__ __forceinline__ bool obstacle_at(const AdvectArgs& a, float qx,
                                            float qy, float qz) {
  if (a.ring_only) return !in_bounds(a, qx, qy, qz);
  const int ix = min(max(static_cast<int>(qx), 0), a.sx - 1);
  const int iy = min(max(static_cast<int>(qy), 0), a.sy - 1);
  const int iz = min(max(static_cast<int>(qz), 0), a.sz - 1) -
                 grid_zlo<kSlab>(a);
  return a.obs[(static_cast<long long>(iz) * a.sy + iy) * a.sx + ix] != 0;
}

__device__ __forceinline__ float clip1(float u) {
  return fminf(fmaxf(u, -1.f), 1.f);
}

// dt-scale, clamp and obstacle stage-zeroing of a raw evaluation.
// own_cell: the stage-1 probe reads the bucket cell's own flag.
template <bool kSlab>
__device__ __forceinline__ void to_step(const AdvectArgs& a, float dt,
                                        const float raw[3], float qx, float qy,
                                        float qz, bool own_cell,
                                        long long cell, float u[3]) {
  for (int k = 0; k < 3; ++k) u[k] = clip1(raw[k] * dt);
  bool bad = !in_bounds(a, qx, qy, qz);
  if (!a.ring_only)
    bad = bad || (own_cell ? a.obs[cell + (kSlab ? a.own_off : 0)] != 0
                           : obstacle_at<kSlab>(a, qx, qy, qz));
  if (bad) u[0] = u[1] = u[2] = 0.f;
}

template <bool kSlab>
__device__ __forceinline__ float interp(const AdvectArgs& a, const float* g,
                                        int c, float qx, float qy, float qz) {
  return mac_comp(g, c, a.sx, a.sy, a.sz, grid_zlo<kSlab>(a),
                  grid_nz<kSlab>(a), qx, qy, qz);
}

template <bool kSlab>
__device__ __forceinline__ void eval_u(const AdvectArgs& a, float dt,
                                       float qx, float qy, float qz,
                                       float u[3]) {
  float raw[3];
  for (int c = 0; c < 3; ++c) raw[c] = interp<kSlab>(a, a.vel, c, qx, qy, qz);
  to_step<kSlab>(a, dt, raw, qx, qy, qz, false, 0, u);
}

template <bool kSlab>
__device__ __forceinline__ void advect_slot(const AdvectArgs& a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= a.T * a.P) return;
  const float x0 = a.px[i], y0 = a.py[i], z0 = a.pz[i];
  const bool live = a.valid[i] != 0;
  if (!live) {
    a.opx[i] = x0;
    a.opy[i] = y0;
    a.opz[i] = z0;
    a.ovx[i] = a.vx[i];
    a.ovy[i] = a.vy[i];
    a.ovz[i] = a.vz[i];
    return;
  }
  const long long cell = i % a.T;
  const float dt = *a.dt;

  // stage 1 at the drift-0 positions, shared with the blend
  float raw[3];
  for (int c = 0; c < 3; ++c) raw[c] = interp<kSlab>(a, a.vel, c, x0, y0, z0);
  const float pv[3] = {a.vx[i], a.vy[i], a.vz[i]};
  float nv[3];
  const bool pend = *a.pending != 0;
  for (int c = 0; c < 3; ++c) {
    const float vold = interp<kSlab>(a, a.vel_old, c, x0, y0, z0);
    nv[c] = pend ? a.flip_ratio * (pv[c] + (raw[c] - vold)) +
                       a.pic_ratio * raw[c]
                 : pv[c];
  }
  a.ovx[i] = nv[0];
  a.ovy[i] = nv[1];
  a.ovz[i] = nv[2];
  float u0[3];
  to_step<kSlab>(a, dt, raw, x0, y0, z0, true, cell, u0);

  float du[3];
  if (a.mode == 0) {
    for (int k = 0; k < 3; ++k) du[k] = u0[k];
  } else if (a.mode == 1) {
    eval_u<kSlab>(a, dt, x0 + 0.5f * u0[0], y0 + 0.5f * u0[1],
                  z0 + 0.5f * u0[2], du);
  } else {
    float u1[3], u2[3], u3[3];
    eval_u<kSlab>(a, dt, x0 + 0.5f * u0[0], y0 + 0.5f * u0[1],
                  z0 + 0.5f * u0[2], u1);
    eval_u<kSlab>(a, dt, x0 + 0.5f * u1[0], y0 + 0.5f * u1[1],
                  z0 + 0.5f * u1[2], u2);
    eval_u<kSlab>(a, dt, x0 + u2[0], y0 + u2[1], z0 + u2[2], u3);
    for (int k = 0; k < 3; ++k)
      du[k] = (2.f * u0[k] + 2.f * u1[k] + 2.f * u2[k] + u3[k]) / 6.f;
  }

  // KnClampPositions (particle.h:508-525)
  float nx = fminf(fmaxf(x0 + clip1(du[0]), 0.f), static_cast<float>(a.sx - 1));
  float ny = fminf(fmaxf(y0 + clip1(du[1]), 0.f), static_cast<float>(a.sy - 1));
  float nz = fminf(fmaxf(z0 + clip1(du[2]), 0.f), static_cast<float>(a.sz - 1));
  if (obstacle_at<kSlab>(a, nx, ny, nz)) {
    // bisectBacktracePos (particle.h:494-505): 4 bisection probes
    float s = 0.f;
    for (int k = 1; k < 5; ++k) {
      const float t = s + 1.f / static_cast<float>(1 << k);
      const bool obs = obstacle_at<kSlab>(a, x0 * (1.f - t) + nx * t,
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

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
    advect_bucket_kernel(AdvectArgs a) {
  advect_slot<false>(a);
}

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
    advect_bucket_zshard_kernel(AdvectArgs a) {
  advect_slot<true>(a);
}

}  // namespace

extern "C" int advect_bucket_launch(
    const float* px, const float* py, const float* pz,
    const unsigned char* valid, const float* vx, const float* vy,
    const float* vz, const float* vel, const float* vel_old,
    const unsigned char* obs, const float* dt, const unsigned char* pending,
    float* opx, float* opy, float* opz, float* ovx, float* ovy, float* ovz,
    long long T, int P, int sx, int sy, int sz, int zb, int zlo, int nz,
    float flip_ratio, float pic_ratio, int mode, int ring_only, int slab,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // slab: T cells of planes zb.. of the domain's sz; the grids and obs hold
  // planes zlo .. zlo+nz-1. Otherwise T is the whole domain's.
  const long long own_off = static_cast<long long>(zb - zlo) * sx * sy;
  AdvectArgs a{px, py, pz, valid, vx, vy, vz, vel, vel_old, obs, dt, pending,
               opx, opy, opz, ovx, ovy, ovz, T, P, sx, sy, sz, zlo, nz,
               own_off, flip_ratio, pic_ratio, mode, ring_only};
  const long long n = T * P;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (slab)
    advect_bucket_zshard_kernel<<<blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(a);
  else
    advect_bucket_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* advect_bucket_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
