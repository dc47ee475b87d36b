// Whole unpreconditioned conjugate-gradient pressure solve on the 7-point
// Laplacian, in one persistent cooperative launch: the hand-written Hopper
// kernel behind ops/pressure_kernels.py:cg_solve.
//
// Replaces the TPU kernel mantaflow_tpu/ops/pressure_pallas.py:_cg_kernel,
// which keeps the whole solve resident in VMEM. An H100 has no such store:
// 128^3 in full mode is ten fields of 8.4 MB, more than the 50 MB L2, and a
// grid-stride design that sweeps them three times per iteration is bound by
// device memory. This kernel keeps on chip what no other block reads:
//
// - Persistent grid, one block per SM. Block b owns the contiguous (z, y)
//   rows [nrows b / nb, nrows (b + 1) / nb) for the whole solve; its thread
//   t takes the block's local cells t, t + kThreads, ... , so every phase
//   sees the same thread-to-cell map.
// - r, s and tmp of the first `onchip` local cells live in the block's
//   dynamic shared memory, and beside them each cell's stencil row as a
//   16-bit code (14 bytes a cell: at 128^3 and 132 SMs a block owns at
//   most 125 rows = 16,000 cells, 224,000 bytes); p lives in registers
//   (kRegCells per thread), touched only by the update phase. The stencil
//   reads a neighbour's s from shared memory when the block owns it (x +- 1,
//   and y +- 1 inside the block's rows).
// - The row code (kA0 ... kZm below): A0 as an integer 0-7 and one bit for
//   each of the row's six links (the cell's own +x/+y/+z links and its
//   -x/-y/-z neighbours' links to it), set where the link is -1. The
//   prologue packs every on-chip cell's row once a solve, from A0-Ak in
//   device memory, and checks that each coefficient is exactly a value the
//   code holds (bit for bit: +0.0 and -1.0, and 0.0-7.0 on the diagonal).
//   The blocks' verdicts meet at the prologue's grid barrier: if every
//   block packed, every block runs the packed stencil; if any saw another
//   value (face fractions, the ghost-fluid diagonal, I + alpha L), every
//   block runs the float stencil, which reads A0-Ak from device memory
//   each iteration. The input alone decides; a device-side tally (two
//   counters: packed solves, the rest) records which way each solve went.
// - The packed stencil rounds A0 s_c first, as the compiled float stencil
//   does (its product and the first add are not fused), and subtracts s
//   for each -1 link (a product by -1 is exact, one by 0 adds nothing): the
//   two stencils give the same iterates bit for bit. Only the cells with a
//   link to z +- 1 read s there.
// - Per iteration only s crosses device memory between blocks: the other
//   blocks' neighbours (z +- 1, the rows at the block's ends) are read from
//   it, and the direction update writes it once. The packed stencil starts
//   the z +- 1 loads of kBatch cells before it uses the first, so that they
//   wait on the L2 together, and takes a path without range tests in a
//   block that keeps all its cells on chip within one z-plane of rows (x
//   +- 1 on chip, z +- 1 in other blocks: every block at the benchmark's
//   shapes).
// - Cells beyond a block's on-chip capacity (kThreads * kRegCells, e.g. at
//   192^3) keep r, p and tmp in the device-memory scratch the wrapper
//   allocates and read their coefficients as floats, in the same kernel:
//   one code path, slower there.
// - Reductions: one partial per block; sum(r^2) and max|r| reduced
//   together. Every block reduces the partials in the same fixed order, so
//   all blocks see bit-identical scalars, leave the loop together, and a
//   solve is deterministic run to run.
//
// What bounds it then (an H100, PERF.md): on the packed path the three
// grid barriers per iteration with their reductions (7.7 us of an
// iteration's 16-18 at 2.1 M cells), then the s halo through the L2 (two
// planes read and one written a cell) and the instructions of the
// shared-memory phases; on the float path the coefficients' reads through
// the L2 besides (30 us an iteration).
//
// Per iteration (same update order and exit test as _cg_kernel):
//   A: tmp = A s, per-block partial of dot(tmp, s)            grid.sync
//   B: alpha = sigma / dp (0 when dp == 0); p += alpha s;
//      r -= alpha tmp, per-block partials of sum(r^2), max|r| grid.sync
//   C: done = max|r| < accuracy; beta = done ? 0 : sigma'/sigma;
//      s = r + beta s                                          grid.sync
//
// Stencil modes (pressure_pallas.py:116-137): full mode reads A0/Ai/Aj/Ak
// (packed or as floats, above); unit mode reads only A0 and rebuilds the
// off-diagonals from the fluid mask (-1 on a fluid-fluid link whose lower
// cell is fluid and inside the one-cell boundary ring), and packs nothing.
// Requires rhs == 0 outside fluid.
//
// Layout: contiguous float32 (sz, sy, sx) arrays, x fastest; fluid is one
// byte per cell; out-of-range neighbours read as zero.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cgr = cooperative_groups;

// A block's on-chip cells: r | s | tmp as floats, then the row codes,
// CgArgs::onchip cells each
extern __shared__ float cg_onchip[];

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRegCells = 16;  // cells per thread with p in registers
constexpr int kOnChip = kThreads * kRegCells;  // on-chip cells of a block
constexpr int kBatch = 4;  // cells whose z +- 1 loads the packed stencil
                           // has in flight together

// A cell's row code (ops/pressure_kernels.py:pack_stencil writes the same):
// A0 and one bit a link, set where the link is -1 and its far cell lies
// inside the grid (a link to outside multiplies the zero read there)
constexpr unsigned kA0 = 7u;       // A0, an integer 0-7
constexpr unsigned kXp = 1u << 3;  // Ai of the cell
constexpr unsigned kYp = 1u << 4;  // Aj of the cell
constexpr unsigned kZp = 1u << 5;  // Ak of the cell
constexpr unsigned kXm = 1u << 6;  // Ai of the -x neighbour
constexpr unsigned kYm = 1u << 7;  // Aj of the -y neighbour
constexpr unsigned kZm = 1u << 8;  // Ak of the -z neighbour
constexpr unsigned kMinusOne = 0xBF800000u;  // -1.0f

struct CgArgs {
  const float* __restrict__ rhs;
  const float* __restrict__ a0;
  const float* __restrict__ ai;
  const float* __restrict__ aj;
  const float* __restrict__ ak;
  const unsigned char* __restrict__ fluid;
  float* p;
  float* r;    // scratch of the off-chip cells
  float* s;    // read across blocks: device memory (and shared on chip)
  float* tmp;  // scratch of the off-chip cells
  double* part;  // 4 * gridDim.x: dot, sum(r^2), max|r|, a block's verdict
  int* iters;
  float* resnorm;
  unsigned long long* tally;  // [packed solves, the rest]
  int sx, sy, sz;
  int onchip;  // local cells per block kept on chip (<= kOnChip)
  float accuracy;
  int max_iter;
};

// Block-wide sum and max of (s, m), in a fixed order; every thread gets
// the totals. sh holds 2 * kWarps + 2 doubles.
__device__ __forceinline__ void block_sum_max(double& s, double& m,
                                              double* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, o);
    m = fmax(m, __shfl_down_sync(0xffffffffu, m, o));
  }
  if (lane == 0) { sh[warp] = s; sh[kWarps + warp] = m; }
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? sh[lane] : 0.0;
    m = lane < kWarps ? sh[kWarps + lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, o);
      m = fmax(m, __shfl_down_sync(0xffffffffu, m, o));
    }
    if (lane == 0) { sh[2 * kWarps] = s; sh[2 * kWarps + 1] = m; }
  }
  __syncthreads();
  s = sh[2 * kWarps];
  m = sh[2 * kWarps + 1];
}

// The totals over the blocks' partials, the same in every block.
__device__ __forceinline__ void grid_sum_max(const double* psum,
                                             const double* pmax, int nb,
                                             double& s, double& m,
                                             double* sh) {
  s = 0.0;
  m = 0.0;
  for (int b = threadIdx.x; b < nb; b += kThreads) {
    s += psum[b];
    if (pmax) m = fmax(m, pmax[b]);
  }
  block_sum_max(s, m, sh);
}

// t, hidden from the compiler: each phase computes its cells' addresses
// anew rather than keeping kRegCells sets of them live across the solve
// (which spills: with 196 KB of shared memory the L1 is small, and spills
// go to the L2)
__device__ __forceinline__ int opaque(int t) {
  asm volatile("" : "+r"(t));
  return t;
}

// The position (x, y, z) of a block's local cell, stepped by kThreads cells.
struct Walk {
  int x, y, z, stx, sty, stz;
  __device__ Walk(long long row0, int t, int sx, int sy) {
    const long long row = row0 + t / sx;
    x = t % sx;
    y = static_cast<int>(row % sy);
    z = static_cast<int>(row / sy);
    const int strow = kThreads / sx;
    stx = kThreads % sx;
    sty = strow % sy;
    stz = strow / sy;
  }
  __device__ __forceinline__ void step(int sx, int sy) {
    x += stx;
    const int cx = x >= sx;
    x -= cx ? sx : 0;
    y += sty + cx;
    const int cy = y >= sy;
    y -= cy ? sy : 0;
    z += stz + cy;
  }
};

// fluid & inside the one-cell ring (inter2d * zin_mask of _cg_kernel)
__device__ __forceinline__ bool unit_row(const CgArgs& a, int x, int y, int z,
                                         long long i) {
  return x >= 1 && x <= a.sx - 2 && y >= 1 && y <= a.sy - 2 && z >= 1 &&
         z <= a.sz - 2 && a.fluid[i] != 0;
}

// s at local cell L + off of a block (global cell i + off): from shared
// memory when the block keeps it on chip, else from device memory
__device__ __forceinline__ float s_at(const CgArgs& a, const float* ss,
                                      int nchip, int L, long long i,
                                      int off) {
  const int Ln = L + off;
  return Ln >= 0 && Ln < nchip ? ss[Ln] : a.s[i + off];
}

// (A s)[i] of local cell L (on chip when L < nchip)
template <bool kUnit>
__device__ __forceinline__ float apply_cell(const CgArgs& a, const float* ss,
                                            int nchip, int L, long long i,
                                            int x, int y, int z) {
  const int sxy = a.sx * a.sy;
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
  const float s_c = s_at(a, ss, nchip, L, i, 0);
  const float s_xp = x + 1 < a.sx ? s_at(a, ss, nchip, L, i, 1) : 0.f;
  const float s_xm = x > 0 ? s_at(a, ss, nchip, L, i, -1) : 0.f;
  const float s_yp = y + 1 < a.sy ? s_at(a, ss, nchip, L, i, a.sx) : 0.f;
  const float s_ym = y > 0 ? s_at(a, ss, nchip, L, i, -a.sx) : 0.f;
  const float s_zp = z + 1 < a.sz ? s_at(a, ss, nchip, L, i, sxy) : 0.f;
  const float s_zm = z > 0 ? s_at(a, ss, nchip, L, i, -sxy) : 0.f;
  return a.a0[i] * s_c + ci_p * s_xp + ci_m * s_xm + cj_p * s_yp +
         cj_m * s_ym + ck_p * s_zp + ck_m * s_zm;
}

// Adds v's bit to the row code where v is -1 and `inside`; false where v
// is neither +0 nor -1
__device__ __forceinline__ bool pack_link(float v, bool inside, unsigned bit,
                                          unsigned& code) {
  const unsigned u = __float_as_uint(v);
  code |= u == kMinusOne && inside ? bit : 0u;
  return u == kMinusOne || u == 0u;
}

// The row code of cell i at (x, y, z); false where a coefficient of the row
// is not exactly a value the code holds
__device__ __forceinline__ bool pack_row(const CgArgs& a, long long i, int x,
                                         int y, int z, unsigned& code) {
  const float d = a.a0[i];
  const int k = __float2int_rz(d);
  bool ok = k >= 0 && k <= static_cast<int>(kA0) &&
            __float_as_uint(static_cast<float>(k)) == __float_as_uint(d);
  code = static_cast<unsigned>(k) & kA0;
  ok &= pack_link(a.ai[i], x + 1 < a.sx, kXp, code);
  ok &= pack_link(a.aj[i], y + 1 < a.sy, kYp, code);
  ok &= pack_link(a.ak[i], z + 1 < a.sz, kZp, code);
  if (x > 0) ok &= pack_link(a.ai[i - 1], true, kXm, code);
  if (y > 0) ok &= pack_link(a.aj[i - a.sx], true, kYm, code);
  if (z > 0)
    ok &= pack_link(a.ak[i - static_cast<long long>(a.sx) * a.sy], true, kZm,
                    code);
  return ok;
}

// p, hidden from the compiler: it indexes from p with 32-bit offsets
// rather than adding them to p's parts
__device__ __forceinline__ const float* opaque_ptr(const float* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// The block's reduction space
__shared__ double sh[2 * kWarps + 2];

// The packed stencil: tmp = A s and the thread's partial of dot(tmp, s),
// in apply_cell's order. The on-chip cells' rows are apply_cell's
// expression on exact coefficients: A0 s_c rounded first (apply_cell's
// contraction, measured bit for bit), then each -1 link subtracts its s (a
// product by -1 is exact, one by 0 adds nothing). A neighbour's s comes
// from shared memory when the block keeps it on chip. kAny false: the
// block keeps all its cells on chip and owns at most a z-plane of rows, so
// x +- 1 is on chip and z +- 1 in another block; kAny true tests each
// neighbour, and reads the off-chip cells' coefficients as floats.
template <bool kAny>
__device__ __forceinline__ double stencil_packed(
    const CgArgs& a, const float* ss, float* st, const unsigned short* sc,
    int nchip, int nloc, long long row0, long long base, int t) {
  const int sx = a.sx, sxy = a.sx * a.sy;
  const float* sg = opaque_ptr(a.s + base);
  double ld = 0.0;
#pragma unroll 1
  for (int k0 = 0; k0 < kRegCells && k0 * kThreads < nchip; k0 += kBatch) {
    float zm[kBatch], zp[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int L = (k0 + u) * kThreads + t;
      const unsigned c = L < nchip ? sc[L] : 0u;
      zm[u] = 0.f;
      zp[u] = 0.f;
      if (c & kZm) zm[u] = kAny && L >= sxy ? ss[L - sxy] : sg[L - sxy];
      if (c & kZp)
        zp[u] = kAny && L + sxy < nchip ? ss[L + sxy] : sg[L + sxy];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int L = (k0 + u) * kThreads + t;
      if (L < nchip) {
        const unsigned c = sc[L];
        const float s_c = ss[L];
        float acc = __fmul_rn(static_cast<float>(c & kA0), s_c);
        if (c & kXp) acc -= !kAny || L + 1 < nchip ? ss[L + 1] : sg[L + 1];
        if (c & kXm) acc -= ss[L - 1];
        if (c & kYp) acc -= L + sx < nchip ? ss[L + sx] : sg[L + sx];
        if (c & kYm) acc -= L >= sx ? ss[L - sx] : sg[L - sx];
        if (c & kZp) acc -= zp[u];
        if (c & kZm) acc -= zm[u];
        st[L] = acc;
        ld += static_cast<double>(acc) * s_c;
      }
    }
  }
  if (kAny && nloc > kOnChip) {
    Walk w(row0, kOnChip + t, a.sx, a.sy);
    for (int L = kOnChip + t; L < nloc; L += kThreads) {
      const long long i = base + L;
      const float tv = apply_cell<false>(a, ss, nchip, L, i, w.x, w.y, w.z);
      a.tmp[i] = tv;
      ld += static_cast<double>(tv) * a.s[i];
      w.step(a.sx, a.sy);
    }
  }
  return ld;
}

template <bool kUnit>
__global__ void __launch_bounds__(kThreads, 1) cg_kernel(CgArgs a) {
  cgr::grid_group grid = cgr::this_grid();
  const int nb = gridDim.x, t = threadIdx.x;
  const long long nrows = static_cast<long long>(a.sy) * a.sz;
  const long long row0 = nrows * blockIdx.x / nb;
  const long long row1 = nrows * (blockIdx.x + 1) / nb;
  const long long base = row0 * a.sx;  // first cell of the block
  const int nloc = static_cast<int>((row1 - row0) * a.sx);
  const int nchip = min(nloc, a.onchip);
  float* sr = cg_onchip;
  float* ss = cg_onchip + a.onchip;
  float* st = cg_onchip + 2 * a.onchip;
  unsigned short* sc =
      reinterpret_cast<unsigned short*>(cg_onchip + 3 * a.onchip);
  double* part_dot = a.part;
  double* part_sum = a.part + nb;
  double* part_max = a.part + 2 * nb;
  double* part_bad = a.part + 3 * nb;

  // p of the on-chip cells: only the update phase touches it, whose loop
  // is unrolled (the stencil's loop is not, and keeps few registers)
  float p_c[kRegCells];

  double ls = 0.0, lm = 0.0;
#pragma unroll
  for (int k = 0; k < kRegCells; ++k) {
    const int L = k * kThreads + t;
    p_c[k] = 0.f;
    if (L < nchip) {
      const float v = a.rhs[base + L];
      sr[L] = v;
      ss[L] = v;
      a.s[base + L] = v;
      ls += static_cast<double>(v) * v;
      lm = fmax(lm, static_cast<double>(fabsf(v)));
    }
  }
  for (int L = kOnChip + t; L < nloc; L += kThreads) {
    const long long i = base + L;
    const float v = a.rhs[i];
    a.r[i] = v;
    a.s[i] = v;
    a.p[i] = 0.f;
    ls += static_cast<double>(v) * v;
    lm = fmax(lm, static_cast<double>(fabsf(v)));
  }
  // the on-chip cells' row codes; unit mode packs nothing
  const Walk w0(row0, t, a.sx, a.sy);
  bool bad = kUnit;
  if (!kUnit) {
    Walk w = w0;
    for (int L = t; L < nchip; L += kThreads) {
      unsigned code;
      bad |= !pack_row(a, base + L, w.x, w.y, w.z, code);
      sc[L] = static_cast<unsigned short>(code);
      w.step(a.sx, a.sy);
    }
  }
  bad = __syncthreads_or(bad);
  block_sum_max(ls, lm, sh);
  if (t == 0) {
    part_sum[blockIdx.x] = ls;
    part_max[blockIdx.x] = lm;
    part_bad[blockIdx.x] = bad ? 1.0 : 0.0;
  }
  grid.sync();
  double tot_s, tot_m;
  grid_sum_max(part_sum, part_max, nb, tot_s, tot_m, sh);
  float sigma = static_cast<float>(tot_s);
  float rn = static_cast<float>(tot_m);
  bool done = rn < a.accuracy;
  int it = 0;
  // the packed stencil when every block packed its rows; this block's
  // cells all on chip within a z-plane of rows, or not
  bad = false;
  for (int b = t; b < nb; b += kThreads) bad |= part_bad[b] != 0.0;
  const bool packed = !kUnit && !__syncthreads_or(bad);
  const bool any = nchip < nloc || nloc > a.sx * a.sy;
  if (blockIdx.x == 0 && t == 0) atomicAdd(&a.tally[packed ? 0 : 1], 1ull);

  while (it < a.max_iter && !done) {
    // A: tmp = A s
    double ld = 0.0;
    if (packed && !any) {
      ld = stencil_packed<false>(a, ss, st, sc, nchip, nloc, row0, base,
                                 opaque(t));
    } else if (packed) {
      ld = stencil_packed<true>(a, ss, st, sc, nchip, nloc, row0, base,
                                opaque(t));
    } else {
      Walk w = w0;
      for (int L = opaque(t); L < nloc; L += kThreads) {
        const long long i = base + L;
        const float tv =
            apply_cell<kUnit>(a, ss, nchip, L, i, w.x, w.y, w.z);
        if (L < nchip) {
          st[L] = tv;
          ld += static_cast<double>(tv) * ss[L];
        } else {
          a.tmp[i] = tv;
          ld += static_cast<double>(tv) * a.s[i];
        }
        w.step(a.sx, a.sy);
      }
    }
    double unused = 0.0;
    block_sum_max(ld, unused, sh);
    if (t == 0) part_dot[blockIdx.x] = ld;
    grid.sync();

    // B: p += alpha s; r -= alpha tmp
    grid_sum_max(part_dot, nullptr, nb, tot_s, tot_m, sh);
    const float dp = static_cast<float>(tot_s);
    const float alpha = fabsf(dp) > 0.f ? sigma / dp : 0.f;
    ls = 0.0;
    lm = 0.0;
    const int tb = opaque(t);
#pragma unroll
    for (int k = 0; k < kRegCells; ++k) {
      const int L = k * kThreads + tb;
      if (L < nchip) {
        p_c[k] = p_c[k] + alpha * ss[L];
        const float rv = sr[L] - alpha * st[L];
        sr[L] = rv;
        ls += static_cast<double>(rv) * rv;
        lm = fmax(lm, static_cast<double>(fabsf(rv)));
      }
    }
    for (int L = kOnChip + t; L < nloc; L += kThreads) {
      const long long i = base + L;
      a.p[i] = a.p[i] + alpha * a.s[i];
      const float rv = a.r[i] - alpha * a.tmp[i];
      a.r[i] = rv;
      ls += static_cast<double>(rv) * rv;
      lm = fmax(lm, static_cast<double>(fabsf(rv)));
    }
    block_sum_max(ls, lm, sh);
    if (t == 0) { part_sum[blockIdx.x] = ls; part_max[blockIdx.x] = lm; }
    grid.sync();

    // C: s = r + beta s
    grid_sum_max(part_sum, part_max, nb, tot_s, tot_m, sh);
    const float sigma_new = static_cast<float>(tot_s);
    rn = static_cast<float>(tot_m);
    done = rn < a.accuracy;
    // s and sigma freeze on the converging iteration (beta = 0 there)
    const float beta = done ? 0.f : sigma_new / sigma;
    for (int L = opaque(t); L < nchip; L += kThreads) {
      const float sn = sr[L] + beta * ss[L];
      ss[L] = sn;
      a.s[base + L] = sn;
    }
    for (int L = kOnChip + t; L < nloc; L += kThreads) {
      const long long i = base + L;
      a.s[i] = a.r[i] + beta * a.s[i];
    }
    if (!done) sigma = sigma_new;
    ++it;
    grid.sync();
  }
#pragma unroll
  for (int k = 0; k < kRegCells; ++k) {
    const int L = k * kThreads + t;
    if (L < nchip) a.p[base + L] = p_c[k];
  }
  if (blockIdx.x == 0 && t == 0) {
    *a.iters = it;
    *a.resnorm = rn;
  }
}

}  // namespace

// One block per SM, `onchip` cells of each kept in 14 * onchip bytes of
// shared memory: the wrapper's plan (ops/pressure_kernels.py:cg_plan). A
// block that owns more cells than kOnChip needs onchip == kOnChip, so that
// its off-chip cells start at local cell kOnChip. part holds 4 * nblocks
// doubles; tally two counters that each solve adds 1 to, the first when
// the solve ran the packed stencil.
extern "C" int cg_solve_launch(const float* rhs, const float* a0,
                               const float* ai, const float* aj,
                               const float* ak, const unsigned char* fluid,
                               float* p, float* r, float* s, float* tmp,
                               double* part, int nblocks, int onchip,
                               int* iters, float* resnorm,
                               unsigned long long* tally, int sx, int sy,
                               int sz, float accuracy, int max_iter, int unit,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nrows = static_cast<long long>(sy) * sz;
  const long long max_cells = (nrows + nblocks - 1) / nblocks * sx;
  if (onchip < 1 || onchip > kOnChip ||
      (onchip < kOnChip && onchip < max_cells) ||
      static_cast<long long>(sx) * sy + kOnChip >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = unit ? reinterpret_cast<const void*>(cg_kernel<true>)
                        : reinterpret_cast<const void*>(cg_kernel<false>);
  const int smem = static_cast<int>(3 * sizeof(float) +
                                    sizeof(unsigned short)) * onchip;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  CgArgs a{rhs, a0, ai, aj, ak, fluid, p, r, s, tmp, part, iters, resnorm,
           tally, sx, sy, sz, onchip, accuracy, max_iter};
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(nblocks), dim3(kThreads), params,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cg_solve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
