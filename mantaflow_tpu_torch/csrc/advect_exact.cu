// Exact-gather semi-Lagrangian / MacCormack advection (clamp mode 2) of one
// 3D grid in at most three passes: the hand-written Hopper kernels behind
// ops/advection_exact_kernels.py, which ops/advection.py's drivers
// (advect_real, advect_vec3, advect_mac) launch on CUDA float32 grids.
//
// Replaces no TPU kernel: the JAX package runs its exact-gather advection
// (mantaflow_tpu/ops/advection.py) in XLA. The port ran it as whole-grid
// PyTorch ops: rolls for the centred and face velocities, four corner-table
// gathers a field, the correction, the clamp's corner tables and the
// outflow extrapolation's 27-neighbour loop, some 2,000 launches a smoke
// step, so the host issuing them set the step's time. Here one thread a
// cell does a pass's whole arithmetic in registers:
//
//   advect_exact_fwd      the backtrace (the centred velocity, or each MAC
//                         component's face velocity), the clamped trilinear
//                         lookup, zero outside the interior;
//   advect_exact_bwd      the mirrored trace into the forward field, the
//                         MacCormack correction, the clamp to the range of
//                         the original's 2x2x2 corners at trunc(x - u dt),
//                         the interior mask: the final field;
//   advect_exact_outflow  (MAC grids) applyOutflowBC into a fresh grid:
//                         cells that are not outflow copy their input.
//
// Each pass streams a few floats a cell from device memory and reads the
// rest (the lookups' corners, the velocity's neighbours) from cache: it is
// bound by bytes. The terms are ops/advection.py's float32 terms in its
// order, each rounded (built with -fmad=false, so no product is contracted
// into a sum), so the passes give the plain version's values.
//
// Layout: contiguous float32 (sz, sy, sx) grids, x fastest; MAC grids and
// the velocity (3, sz, sy, sx); flags int32 (sz, sy, sx). dt is read from
// device memory where dt_ptr is given (a 0-dim tensor), else dt_val.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFluid = 1;
constexpr int kEmpty = 4;
constexpr int kOutflow = 16;

struct Grid {
  int sx, sy, sz;
  long long sxy, n;
};

__device__ __forceinline__ Grid make_grid(int sx, int sy, int sz) {
  const long long sxy = static_cast<long long>(sx) * sy;
  return Grid{sx, sy, sz, sxy, sxy * sz};
}

// torch.clamp of a float: a NaN passes through
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// amin / amax: a NaN wins
__device__ __forceinline__ float min_nan(float v, float acc) {
  return (v < acc || isnan(v)) ? v : acc;
}

__device__ __forceinline__ float max_nan(float v, float acc) {
  return (v > acc || isnan(v)) ? v : acc;
}

// core/interp.py:_axis_weights: the lower corner, clamped to [0, n-2], and
// the upper corner's weight
__device__ __forceinline__ void axis_weights(float p, int n, int& i0,
                                             float& w1) {
  const float pc = clampf(p, 0.0f, static_cast<float>(n - 1));
  i0 = min(max(static_cast<int>(pc), 0), n - 2);
  w1 = pc - static_cast<float>(i0);
}

// core/interp.py:interpol (trilerp_gather): the cell-centred lookup, its
// corners combined in the reference's nested-lerp order (interpol.h:72-84)
__device__ __forceinline__ float interpol(const float* __restrict__ d,
                                          const Grid& g, float px, float py,
                                          float pz) {
  int xi, yi, zi;
  float s1, t1, f1;
  axis_weights(px - 0.5f, g.sx, xi, s1);
  axis_weights(py - 0.5f, g.sy, yi, t1);
  axis_weights(pz - 0.5f, g.sz, zi, f1);
  const float* r = d + (static_cast<long long>(zi) * g.sy + yi) * g.sx + xi;
  const float r0 = r[0], r1 = r[1], r2 = r[g.sx], r3 = r[g.sx + 1];
  const float* q = r + g.sxy;
  const float r4 = q[0], r5 = q[1], r6 = q[g.sx], r7 = q[g.sx + 1];
  const float s0 = 1.0f - s1, t0 = 1.0f - t1, f0 = 1.0f - f1;
  const float lo = (r0 * t0 + r2 * t1) * s0 + (r1 * t0 + r3 * t1) * s1;
  const float hi = (r4 * t0 + r6 * t1) * s0 + (r5 * t0 + r7 * t1) * s1;
  return lo * f0 + hi * f1;
}

// The velocity that carries the value at cell i, times dt: core/mac.py's
// get_centered for a scalar grid (comp < 0), else at_mac_x/_y/_z for MAC
// component comp; each average summed in the plain version's order. Only
// for interior cells (the neighbours are in the grid).
__device__ __forceinline__ void carried(const float* __restrict__ vel,
                                        const Grid& g, long long i, int comp,
                                        float dt, float& vx, float& vy,
                                        float& vz) {
  const float* u = vel;
  const float* v = vel + g.n;
  const float* w = vel + 2 * g.n;
  const long long sx = g.sx, sxy = g.sxy;
  float ax, ay, az;
  if (comp < 0) {
    ax = 0.5f * (u[i] + u[i + 1]);
    ay = 0.5f * (v[i] + v[i + sx]);
    az = 0.5f * (w[i] + w[i + sxy]);
  } else if (comp == 0) {
    ax = u[i];
    ay = 0.25f * (((v[i] + v[i - 1]) + v[i + sx]) + v[i + sx - 1]);
    az = 0.25f * (((w[i] + w[i - 1]) + w[i + sxy]) + w[i + sxy - 1]);
  } else if (comp == 1) {
    ax = 0.25f * (((u[i] + u[i - sx]) + u[i + 1]) + u[i - sx + 1]);
    ay = v[i];
    az = 0.25f * (((w[i] + w[i - sx]) + w[i + sxy]) + w[i + sxy - sx]);
  } else {
    ax = 0.25f * (((u[i] + u[i - sxy]) + u[i + 1]) + u[i - sxy + 1]);
    ay = 0.25f * (((v[i] + v[i - sxy]) + v[i + sx]) + v[i - sxy + sx]);
    az = w[i];
  }
  vx = ax * dt;
  vy = ay * dt;
  vz = az * dt;
}

struct Cell {
  long long i;
  int x, y, z;
  bool inside;  // the interior: bnd = 1
};

__device__ __forceinline__ bool cell_of(const Grid& g, Cell& c) {
  c.i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c.i >= g.n) return false;
  c.x = static_cast<int>(c.i % g.sx);
  const long long t = c.i / g.sx;
  c.y = static_cast<int>(t % g.sy);
  c.z = static_cast<int>(t / g.sy);
  c.inside = c.x >= 1 && c.x < g.sx - 1 && c.y >= 1 && c.y < g.sy - 1
             && c.z >= 1 && c.z < g.sz - 1;
  return true;
}

__device__ __forceinline__ float read_dt(const float* dt_ptr, float dt_val) {
  return dt_ptr != nullptr ? *dt_ptr : dt_val;
}

// ops/advection.py:semi_lagrange (kMac false) / semi_lagrange_mac, the
// first-order trace and the linear lookup: src sampled at x - u dt, zero
// outside the interior
template <bool kMac>
__global__ void __launch_bounds__(kThreads)
advect_exact_fwd(const float* __restrict__ vel, const float* __restrict__ src,
                 float* __restrict__ out, const float* __restrict__ dt_ptr,
                 float dt_val, int sx, int sy, int sz) {
  const Grid g = make_grid(sx, sy, sz);
  Cell c;
  if (!cell_of(g, c)) return;
  constexpr int kComps = kMac ? 3 : 1;
  if (!c.inside) {
    for (int k = 0; k < kComps; ++k) out[k * g.n + c.i] = 0.0f;
    return;
  }
  const float dt = read_dt(dt_ptr, dt_val);
  const float xc = static_cast<float>(c.x) + 0.5f;
  const float yc = static_cast<float>(c.y) + 0.5f;
  const float zc = static_cast<float>(c.z) + 0.5f;
  for (int k = 0; k < kComps; ++k) {
    float vx, vy, vz;
    carried(vel, g, c.i, kMac ? k : -1, dt, vx, vy, vz);
    out[k * g.n + c.i] = interpol(src + k * g.n, g, xc - vx, yc - vy,
                                  zc - vz);
  }
}

// The backward trace, the correction and the clamp of one component at an
// interior cell, or the correction alone on the boundary ring (where the
// forward and backward fields are zero). ok_corr: the correction's fluid
// test; front: the clamp's first-order fallback test (MAC only).
template <bool kMac>
__device__ __forceinline__ float maccormack(
    const float* __restrict__ vel, const float* __restrict__ orig,
    const float* __restrict__ fwd, const int* __restrict__ flags,
    const Grid& g, const Cell& c, int comp, float dt, float coef,
    bool ok_corr, bool front) {
  const float f = fwd[c.i];
  const float o = orig[c.i];
  float vx = 0.0f, vy = 0.0f, vz = 0.0f, b = 0.0f;
  if (c.inside) {
    carried(vel, g, c.i, comp, dt, vx, vy, vz);
    // x - u * (-dt): the same float32 value as x + u * dt
    b = interpol(fwd, g, (static_cast<float>(c.x) + 0.5f) + vx,
                 (static_cast<float>(c.y) + 0.5f) + vy,
                 (static_cast<float>(c.z) + 0.5f) + vz);
  }
  const float corr = f + coef * (o - b);
  const float next = ok_corr ? corr : f;
  if (!c.inside) return next;
  // doClampComponent: the corners of the original at trunc(x - u dt), x
  // the integer cell, clamped to [0, n-2]
  const int i0 = min(max(static_cast<int>(static_cast<float>(c.x) - vx), 0),
                     g.sx - 2);
  const int j0 = min(max(static_cast<int>(static_cast<float>(c.y) - vy), 0),
                     g.sy - 2);
  const int k0 = min(max(static_cast<int>(static_cast<float>(c.z) - vz), 0),
                     g.sz - 2);
  const long long base = (static_cast<long long>(k0) * g.sy + j0) * g.sx + i0;
  float mn = 3.4e38f, mx = -3.4e38f;
  bool have = false;
  for (int dz = 0; dz < 2; ++dz) {
    for (int dy = 0; dy < 2; ++dy) {
      for (int dx = 0; dx < 2; ++dx) {
        const long long q = base + dz * g.sxy + dy * g.sx + dx;
        const float val = orig[q];
        // scalar grids: only corners that are fluid or empty
        const bool ok = kMac || (flags[q] & (kFluid | kEmpty)) != 0;
        have = have || ok;
        mn = min_nan(ok ? val : 3.4e38f, mn);
        mx = max_nan(ok ? val : -3.4e38f, mx);
      }
    }
  }
  const float clamped = (next < mn || next > mx) ? f : next;
  if (kMac) return front ? clamped : f;
  return have ? clamped : f;
}

// ops/advection.py's order-2 drivers after the forward pass:
// semi_lagrange(..., -dt) into the forward field, _maccormack_correct(_mac)
// and _maccormack_clamp(_mac) in clamp mode 2
template <bool kMac>
__global__ void __launch_bounds__(kThreads)
advect_exact_bwd(const int* __restrict__ flags, const float* __restrict__ vel,
                 const float* __restrict__ orig,
                 const float* __restrict__ fwd, float* __restrict__ out,
                 const float* __restrict__ dt_ptr, float dt_val, float coef,
                 int sx, int sy, int sz) {
  const Grid g = make_grid(sx, sy, sz);
  Cell c;
  if (!cell_of(g, c)) return;
  const float dt = read_dt(dt_ptr, dt_val);
  const int fl = flags[c.i];
  const bool fluid = (fl & kFluid) != 0;
  if (!kMac) {
    out[c.i] = maccormack<false>(vel, orig, fwd, flags, g, c, -1, dt, coef,
                                 fluid, true);
    return;
  }
  const bool okf = (fl & (kFluid | kEmpty)) != 0;
  const long long stride[3] = {1, g.sx, g.sxy};
  const int coord[3] = {c.x, c.y, c.z};
  for (int k = 0; k < 3; ++k) {
    // the lower face's cell along the component's axis, where there is one
    const bool edge = coord[k] == 0;
    const int nb = edge ? 0 : flags[c.i - stride[k]];
    const bool ok_corr = fluid && (edge || (nb & kFluid) != 0);
    const bool front = okf && (edge || (nb & (kFluid | kEmpty)) != 0);
    out[k * g.n + c.i] = maccormack<true>(
        vel, orig + k * g.n, fwd + k * g.n, flags, g, c, k, dt, coef, ok_corr,
        front);
  }
}

// ops/advection.py:apply_outflow_bc at one cell of a MAC grid: the bulk
// velocity over the 3x3x3 fluid-or-outflow neighbours (out-of-grid ones
// masked, the wrapped reads times 0 as the plain version's rolls), then per
// axis the lower and upper fluid neighbours' contributions, averaged.
__global__ void __launch_bounds__(kThreads)
advect_exact_outflow(const int* __restrict__ flags,
                     const float* __restrict__ vel,
                     const float* __restrict__ prev, float* __restrict__ out,
                     const float* __restrict__ dt_ptr, float dt_val, int sx,
                     int sy, int sz) {
  const Grid g = make_grid(sx, sy, sz);
  Cell c;
  if (!cell_of(g, c)) return;
  if ((flags[c.i] & kOutflow) == 0) {
    for (int k = 0; k < 3; ++k) out[k * g.n + c.i] = vel[k * g.n + c.i];
    return;
  }
  const float ts = clamp_lo(read_dt(dt_ptr, dt_val) * 4.0f, 1.0f);
  float acc[3] = {0.0f, 0.0f, 0.0f};
  float cnt = 0.0f;
  for (int dz = -1; dz <= 1; ++dz) {
    const int z = c.z + dz;
    const int zw = (z + g.sz) % g.sz;
    for (int dy = -1; dy <= 1; ++dy) {
      const int y = c.y + dy;
      const int yw = (y + g.sy) % g.sy;
      for (int dx = -1; dx <= 1; ++dx) {
        const int x = c.x + dx;
        const int xw = (x + g.sx) % g.sx;
        const long long q = (static_cast<long long>(zw) * g.sy + yw) * g.sx
                            + xw;
        const bool in = x >= 0 && x < g.sx && y >= 0 && y < g.sy && z >= 0
                        && z < g.sz;
        const float mf =
            (in && (flags[q] & (kFluid | kOutflow)) != 0) ? 1.0f : 0.0f;
        for (int k = 0; k < 3; ++k) acc[k] = acc[k] + vel[k * g.n + q] * mf;
        cnt = cnt + mf;
      }
    }
  }
  float bulk[3], delta[3], dst[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < 3; ++k) {
    bulk[k] = cnt > 0.0f ? acc[k] / clamp_lo(cnt, 1.0f) : 0.0f;
    delta[k] = vel[k * g.n + c.i] - prev[k * g.n + c.i];
  }
  const long long stride[3] = {1, g.sx, g.sxy};
  const int coord[3] = {c.x, c.y, c.z};
  const int extent[3] = {g.sx, g.sy, g.sz};
  float total = 0.0f;
  for (int a = 0; a < 3; ++a) {
    const float factor = ts * clamp_lo(bulk[a], 1.0f);
    bool fl_at[5];  // fluid at offsets -2..2 along the axis, in the grid
    for (int d = -2; d <= 2; ++d) {
      const int p = coord[a] + d;
      fl_at[d + 2] = p >= 0 && p < extent[a]
                     && (flags[c.i + d * stride[a]] & kFluid) != 0;
    }
    const bool d0 = fl_at[1] || fl_at[3];
    const bool lower = d0 ? fl_at[1] : fl_at[0];
    const bool upper = d0 ? fl_at[3] : fl_at[4];
    for (int k = 0; k < 3; ++k) {
      const float* v = vel + k * g.n;
      const float lo = lower ? delta[k] / factor + v[c.i - stride[a]] : 0.0f;
      const float up = upper ? delta[k] / factor + v[c.i + stride[a]] : 0.0f;
      dst[k] = dst[k] + lo;
      dst[k] = dst[k] + up;
    }
    total = (total + (lower ? 1.0f : 0.0f)) + (upper ? 1.0f : 0.0f);
  }
  for (int k = 0; k < 3; ++k) {
    out[k * g.n + c.i] =
        total > 0.0f ? dst[k] / clamp_lo(total, 1.0f) : dst[k];
  }
}

}  // namespace

// pass 0: advect_exact_fwd of src into out; pass 1: advect_exact_bwd (src
// the original grid, aux the forward field); pass 2: advect_exact_outflow
// (src the grid before the advection, aux the advected MAC grid). mac: src,
// aux and out are MAC grids (3, sz, sy, sx). coef: float32(strength * 0.5).
extern "C" int advect_exact_launch(int pass, int mac, const int* flags,
                                   const float* vel, const float* src,
                                   const float* aux, float* out,
                                   const float* dt_ptr, float dt_val,
                                   float coef, int sx, int sy, int sz,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sx < 2 || sy < 2 || sz < 2 || pass < 0 || pass > 2
      || (pass == 2 && !mac)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(sx) * sy * sz;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pass == 0 && mac) {
    advect_exact_fwd<true><<<grid, kThreads, 0, s>>>(vel, src, out, dt_ptr,
                                                     dt_val, sx, sy, sz);
  } else if (pass == 0) {
    advect_exact_fwd<false><<<grid, kThreads, 0, s>>>(vel, src, out, dt_ptr,
                                                      dt_val, sx, sy, sz);
  } else if (pass == 1 && mac) {
    advect_exact_bwd<true><<<grid, kThreads, 0, s>>>(
        flags, vel, src, aux, out, dt_ptr, dt_val, coef, sx, sy, sz);
  } else if (pass == 1) {
    advect_exact_bwd<false><<<grid, kThreads, 0, s>>>(
        flags, vel, src, aux, out, dt_ptr, dt_val, coef, sx, sy, sz);
  } else {
    advect_exact_outflow<<<grid, kThreads, 0, s>>>(flags, aux, src, out,
                                                   dt_ptr, dt_val, sx, sy,
                                                   sz);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* advect_exact_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
