// The whole bucket rebin after an advection step, its x, y and z passes in
// one launch: the hand-written Hopper kernel behind
// ops/rebin_kernels.py:rebin_fused (rebin_fused_kernel<false>, once per
// step on one device) and, in its z-slab form, rebin_fused_slab
// (rebin_fused_kernel<true>, once per shard and step of the sharded step).
//
// Replaces the TPU kernels mantaflow_tpu/ops/flip_bucket_pallas.py:
// _rebin_fused_kernel (rebin_fused: all three passes in one kernel, which
// builds each merge from rank and indicator contractions in a VMEM ring of
// whole planes, because the TPU has no gather), the three-pass form it
// stands for (_rebin_xy_kernel, _rebin_pass_kernel, _rebin_zpass_kernel,
// _rebin_zpass_stream_kernel) and the z-slab pass _rebin_zpass_kernel_sh.
// The three-pass kernels stay in csrc/rebin.cu and csrc/rebin_zshard.cu.
//
// Semantics (flip_bucket.rebin: flip_bucket._rebin_axis for x, then y,
// then z; a stable 3-way merge per axis):
//   e = clip(trunc(p_axis) - c, -1, 1); a mover whose target leaves the
//   domain stays; arrivals at cell c in order: movers from c+1 (e == -1),
//   stayers (e == 0), movers from c-1 (e == +1), source slot order kept in
//   each group; the first P are kept, the rest are added to *dropped; the
//   slots after the arrivals are parked at the cell centre with zero
//   velocity and valid = 0. A permutation: the result is bit-exact.
// One pass moves particles along its own axis only, so a particle's three
// codes e_x, e_y, e_z follow from its cell before the rebin, and the z
// pass of a cell merges the xy results of the planes z+1, z and z-1 of its
// own column.
//
// Design for Hopper. It is bound by the bytes it writes: all seven fields
// of every slot, 25 P bytes a cell. The three-pass kernels wrote them three
// times, each thread storing arrival k at slot row k, so a warp's store
// touched up to 32 slot rows.
// - One block per tile of kTx x rows (x, y) columns and a run of kRun
//   output planes (ops/rebin_kernels.py:rebin_plan picks rows from P),
//   one thread per column. It streams the input planes of its run and one
//   more on each side from the bottom up.
// - Staging, per input plane, over the tile and a ring of one cell around
//   it: each cell's live slots are counted up to its first invalid one
//   (the buckets are gap-free, ops/flip_bucket.py), and each live
//   particle's three codes packed into one byte in shared memory; its
//   position is read once per block that stages it.
// - The x and y merges build lists of references to staged particles,
//   not copies: the x merge over the tile's cells and one row on each side,
//   the y merge over the tile's cells, into a ring of three planes held by
//   the column's own thread (16-bit references with e_z).
// - After plane z+1, the z merge of plane z (ring planes z+1, z, z-1) and
//   the write: for each slot row, the warp writes its 32 consecutive x
//   cells at once, each arrival's six fields read from the input where
//   its reference points. Every float store is one 128-byte row
//   (streaming: the next kernel reads it from device memory), every valid
//   store one 32-byte sector.
// - Short runs (kRun 4, 4096 blocks at 128^3) spread a dam's dense
//   planes, whose staging costs dependent memory round trips, over more
//   blocks; on the card they beat runs of 2, 8, 16 and 32 (PERF.md).
// - A cell's overflow counts where the block owns the cell: the rows on
//   either side and the planes outside the run belong to other blocks (in
//   the slab form, the halo planes to the neighbouring shards). One atomic
//   add per block.
// - A plane whose tile window holds no live slot skips its merges.
//
// kSlab (rebin_fused_slab, the sharded step): the input is one shard's
// pre-rebin slab extended by one plane of each neighbour (global planes
// zb - 1 .. zb + nz, empty slots past the domain's ends), the output the
// shard's nz planes from global plane zb; coordinates, border tests and
// parked centres are global, and *dropped gets the overflow of the
// shard's own cells, so the shards' counts sum to the one-domain count.
//
// Layout: fields are contiguous (P, T) arrays, slot-major, T = planes*sy*sx
// with x fastest; valid is one byte per slot (torch.bool).

#include <cuda_runtime.h>

namespace {

// ops/rebin_kernels.py:rebin_plan mirrors these
constexpr int kTx = 32;    // tile width in x: one warp row
constexpr int kRun = 4;    // output planes per block
constexpr int kRefBits = 14;  // a reference p * window + cell < 2^14
constexpr int kRefMask = (1 << kRefBits) - 1;
constexpr int kCountUnroll = 8;  // valid bytes read at once per cell
constexpr int kStageUnroll = 4;  // positions read at once per cell
constexpr int kEmitUnroll = 4;   // slot rows written at once
constexpr int kMaxThreads = kTx * 4;
constexpr int kMinBlocks = 5;  // blocks an SM holds at P 24 (96 registers)

struct FusedArgs {
  const float* __restrict__ px;
  const float* __restrict__ py;
  const float* __restrict__ pz;
  const float* __restrict__ vx;
  const float* __restrict__ vy;
  const float* __restrict__ vz;
  const unsigned char* __restrict__ valid;
  float* opx;
  float* opy;
  float* opz;
  float* ovx;
  float* ovy;
  float* ovz;
  unsigned char* ovalid;
  int* dropped;
  long long T;     // output cells: nz planes
  long long T_in;  // input cells: nz planes (kSlab: nz + 2)
  int P;
  int sx, sy, sz;  // sz: the domain's z extent
  int zb;          // global z of output plane 0
  int nz;          // output planes
  int rows;        // tile rows in y; blockDim.x == kTx * rows
};

// The block's shared memory for P slots and a tile of `rows` rows:
// counts (window cells, x-merge cells, three ring planes of columns),
// x-merge lists, ring lists, z-merge lists, codes.
__host__ __device__ inline long long fused_smem_bytes(int P, int rows) {
  const long long W = (kTx + 2) * (rows + 2), XS = kTx * (rows + 2),
                  C = kTx * rows;
  return 4 * (W + XS + 3 * C) + 2LL * P * (XS + 4 * C) + P * W;
}

__device__ __forceinline__ int move_code(float p, int c, int n) {
  int e = static_cast<int>(p) - c;
  e = e < -1 ? -1 : (e > 1 ? 1 : e);
  const int tgt = c + e;
  if (tgt < 0 || tgt >= n) e = 0;
  return e + 1;  // 0: to c-1, 1: stays, 2: to c+1
}

template <bool kSlab>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    rebin_fused_kernel(FusedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_drop;
  const int rows = a.rows, P = a.P;
  const int Wx = kTx + 2, W = Wx * (rows + 2), XS = kTx * (rows + 2),
            C = kTx * rows;
  int* wcnt = reinterpret_cast<int*>(smem);              // [W]
  int* xcnt = wcnt + W;                                  // [XS]
  int* rcnt = xcnt + XS;                                 // [3][C]
  unsigned short* xl = reinterpret_cast<unsigned short*>(rcnt + 3 * C);
  unsigned short* ring = xl + P * XS;                    // [3][P][C]
  unsigned short* zl = ring + 3 * P * C;                 // [P][C]
  unsigned char* codes =
      reinterpret_cast<unsigned char*>(zl + P * C);      // [P][W]

  const int t = threadIdx.x;
  const long long sxy = static_cast<long long>(a.sx) * a.sy;
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * rows;
  const int zlo = a.zb + blockIdx.z * kRun;              // global
  const int zhi = min(zlo + kRun, a.zb + a.nz);          // global, exclusive
  // the input's plane 0 and planes
  const int in_z0 = kSlab ? a.zb - 1 : a.zb;
  const int n_in = kSlab ? a.nz + 2 : a.nz;
  // this thread's column
  const int cx = t % kTx, cy = t / kTx;
  const int gx = x0 + cx, gy = y0 + cy;
  const bool col_in = gx < a.sx && gy < a.sy;
  if (t == 0) s_drop = 0;

  for (int gz = zlo - 1, k = 0; gz <= zhi; ++gz, ++k) {
    const int r = k % 3;
    const int j = gz - in_z0;
    const bool plane_in = j >= 0 && j < n_in && gz >= 0 && gz < a.sz;
    const bool owned = gz >= zlo && gz < zhi;
    const long long plane = static_cast<long long>(j) * sxy;

    // staging: each window cell's live slots and their codes
    int live = 0;
    for (int w = t; w < W; w += C) {
      const int wx = w % Wx, wy = w / Wx;
      const int sxc = x0 - 1 + wx, syc = y0 - 1 + wy;
      int n = 0;
      if (plane_in && sxc >= 0 && sxc < a.sx && syc >= 0 && syc < a.sy) {
        const long long cell =
            plane + static_cast<long long>(syc) * a.sx + sxc;
        const unsigned char* v = a.valid + cell;
        for (int p0 = 0; p0 < P; p0 += kCountUnroll) {
          bool b[kCountUnroll];
#pragma unroll
          for (int u = 0; u < kCountUnroll; ++u)
            b[u] = p0 + u < P && __ldg(v + (p0 + u) * a.T_in) != 0;
          int m = 0;
#pragma unroll
          for (int u = 0; u < kCountUnroll; ++u) m += (m == u && b[u]) ? 1 : 0;
          n += m;
          if (m < kCountUnroll) break;
        }
        for (int p0 = 0; p0 < n; p0 += kStageUnroll) {
          float fx[kStageUnroll], fy[kStageUnroll], fz[kStageUnroll];
#pragma unroll
          for (int u = 0; u < kStageUnroll; ++u) {
            if (p0 + u < n) {
              const long long i = (p0 + u) * a.T_in + cell;
              fx[u] = __ldg(a.px + i);
              fy[u] = __ldg(a.py + i);
              fz[u] = __ldg(a.pz + i);
            }
          }
#pragma unroll
          for (int u = 0; u < kStageUnroll; ++u) {
            if (p0 + u < n) {
              const int c = move_code(fx[u], sxc, a.sx) |
                            move_code(fy[u], syc, a.sy) << 2 |
                            move_code(fz[u], gz, a.sz) << 4;
              codes[(p0 + u) * W + w] = static_cast<unsigned char>(c);
            }
          }
        }
      }
      wcnt[w] = n;
      live |= n;
    }
    if (!__syncthreads_or(live)) {
      rcnt[r * C + t] = 0;
    } else {
      // x merge: the tile's cells and one row on each side
      for (int xc = t; xc < XS; xc += C) {
        const int xx = xc % kTx, yy = xc / kTx;
        int n = 0;
        if (x0 + xx < a.sx) {
          // g = 0: movers from x+1 (code 0), 1: stayers, 2: movers from x-1
          for (int g = 0; g < 3; ++g) {
            const int ws = yy * Wx + xx + 2 - g;
            const int cnt = wcnt[ws];
            for (int p = 0; p < cnt; ++p) {
              const int ref = p * W + ws;
              if ((codes[ref] & 3) != g) continue;
              if (n < P) xl[n * XS + xc] = static_cast<unsigned short>(ref);
              ++n;
            }
          }
        }
        if (n > P) {
          if (owned && yy >= 1 && yy <= rows && y0 - 1 + yy < a.sy)
            atomicAdd(&s_drop, n - P);
          n = P;
        }
        xcnt[xc] = n;
      }
      __syncthreads();
      // y merge: the tile's cells, into the ring plane of this column
      int n = 0;
      if (col_in) {
        for (int g = 0; g < 3; ++g) {
          const int xs = (cy + 2 - g) * kTx + cx;
          const int cnt = xcnt[xs];
          for (int s = 0; s < cnt; ++s) {
            const int ref = xl[s * XS + xs];
            const int c = codes[ref];
            if (((c >> 2) & 3) != g) continue;
            if (n < P)
              ring[(r * P + n) * C + t] =
                  static_cast<unsigned short>(ref | (c >> 4) << kRefBits);
            ++n;
          }
        }
      }
      if (n > P) {
        if (owned) atomicAdd(&s_drop, n - P);
        n = P;
      }
      rcnt[r * C + t] = n;
      // the next plane's staging writes the codes and counts read above
      __syncthreads();
    }
    if (k < 2) continue;

    // z merge of plane go = gz - 1 from the ring planes gz (g = 0, movers
    // down), go (g = 1, stayers) and go - 1 (g = 2, movers up)
    const int go = gz - 1;
    int n = 0;
    if (col_in) {
      for (int g = 0; g < 3; ++g) {
        const int rs = (k - g) % 3;
        const int cnt = rcnt[rs * C + t];
        for (int s = 0; s < cnt; ++s) {
          const int e = ring[(rs * P + s) * C + t];
          if ((e >> kRefBits) != g) continue;
          if (n < P)
            zl[n * C + t] = static_cast<unsigned short>(
                (e & kRefMask) | g << kRefBits);
          ++n;
        }
      }
    }
    if (n > P) {
      atomicAdd(&s_drop, n - P);
      n = P;
    }
    if (!col_in) continue;
    // the write: slot row s of the column's cell
    const long long o0 = static_cast<long long>(go - a.zb) * sxy +
                         static_cast<long long>(gy) * a.sx + gx;
    const float cxf = static_cast<float>(gx) + 0.5f;
    const float cyf = static_cast<float>(gy) + 0.5f;
    const float czf = static_cast<float>(go) + 0.5f;
    // kEmitUnroll slot rows at a time: their loads, then their stores
    for (int s0 = 0; s0 < P; s0 += kEmitUnroll) {
      float f[kEmitUnroll][6];
#pragma unroll
      for (int u = 0; u < kEmitUnroll; ++u) {
        if (s0 + u < n) {
          const int e = zl[(s0 + u) * C + t];
          const int g = e >> kRefBits, ref = e & kRefMask;
          const int p = ref / W, w = ref - p * W;
          const int wy = w / Wx, wx = w - wy * Wx;
          const long long i =
              p * a.T_in + static_cast<long long>(go + 1 - g - in_z0) * sxy +
              static_cast<long long>(y0 - 1 + wy) * a.sx + (x0 - 1 + wx);
          f[u][0] = __ldg(a.px + i);
          f[u][1] = __ldg(a.py + i);
          f[u][2] = __ldg(a.pz + i);
          f[u][3] = __ldg(a.vx + i);
          f[u][4] = __ldg(a.vy + i);
          f[u][5] = __ldg(a.vz + i);
        }
      }
      // streaming stores: the output is read once, by the next kernel
#pragma unroll
      for (int u = 0; u < kEmitUnroll; ++u) {
        const int s = s0 + u;
        if (s >= P) break;
        const bool arr = s < n;
        const long long o = s * a.T + o0;
        __stcs(a.opx + o, arr ? f[u][0] : cxf);
        __stcs(a.opy + o, arr ? f[u][1] : cyf);
        __stcs(a.opz + o, arr ? f[u][2] : czf);
        __stcs(a.ovx + o, arr ? f[u][3] : 0.f);
        __stcs(a.ovy + o, arr ? f[u][4] : 0.f);
        __stcs(a.ovz + o, arr ? f[u][5] : 0.f);
        a.ovalid[o] = arr ? 1 : 0;
      }
    }
  }
  __syncthreads();
  if (t == 0 && s_drop > 0) atomicAdd(a.dropped, s_drop);
}

}  // namespace

// in/out: arrays of 6 device pointers (px py pz vx vy vz). T: output cells
// (nz = T / (sx sy) planes from global plane zb); slab: the input holds
// T_in = T + 2 sx sy cells from global plane zb - 1, else T_in = T. rows,
// grid and smem from ops/rebin_kernels.py:rebin_plan. *dropped is
// incremented by the overflow of the output's cells.
extern "C" int rebin_fused_launch(const float* const* in,
                                  const unsigned char* valid,
                                  float* const* out, unsigned char* ovalid,
                                  int* dropped, long long T, long long T_in,
                                  int P, int sx, int sy, int sz, int zb,
                                  int slab, int rows, int gx, int gy, int gz,
                                  long long smem, int device, void* stream) {
  const long long sxy = static_cast<long long>(sx) * sy;
  if (sxy <= 0 || T % sxy != 0 || (slab && T_in != T + 2 * sxy) ||
      (!slab && T_in != T))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nz = static_cast<int>(T / sxy);
  if ((rows != 4 && rows != 2 && rows != 1) || P < 1 ||
      P * (kTx + 2) * (rows + 2) > (1 << kRefBits) ||
      gx != (sx + kTx - 1) / kTx || gy != (sy + rows - 1) / rows ||
      gz != (nz + kRun - 1) / kRun || smem != fused_smem_bytes(P, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  void (*fn)(FusedArgs) =
      slab ? rebin_fused_kernel<true> : rebin_fused_kernel<false>;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fn,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  FusedArgs a{in[0], in[1], in[2], in[3], in[4], in[5], valid,
              out[0], out[1], out[2], out[3], out[4], out[5], ovalid,
              dropped, T, T_in, P, sx, sy, sz, zb, nz, rows};
  fn<<<dim3(gx, gy, gz), kTx * rows, static_cast<size_t>(smem),
       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rebin_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
