// The rebin gather shared by csrc/rebin.cu (one axis pass over the whole
// domain, or an x or y pass over a z-slab) and csrc/rebin_zshard.cu (the z
// pass of a z-slab, read from the slab extended by one plane of each
// neighbour): the three-pass rebin, off the FLIP step's path since the
// fused kernel (csrc/rebin_fused.cu) took its place. One thread per
// destination cell walks the slots of its three source cells along the
// axis and copies the arrivals in merge order.
// kHalo is a compile-time flag, so the one-domain pass compiles the body it
// had and nothing of the extended read.
//
// Semantics (flip_bucket._rebin_axis, a stable 3-way merge):
//   e = clip(trunc(p_axis) - c, -1, 1); a mover whose target leaves the
//   domain stays; arrivals at cell c in order: movers from c+1 (e == -1),
//   stayers (e == 0), movers from c-1 (e == +1), source slot order kept in
//   each group; the first P are kept, the rest are added to *dropped; the
//   slots after the arrivals are parked at the cell centre with zero
//   velocity and valid = 0. A permutation: the result is bit-exact.
// Coordinates are global: a slab's z cell index, the border test and the
// parked centre add its offset zb and use the domain's z extent sz.
//
// Layout: fields are contiguous (P, T) arrays, slot-major, T = planes*sy*sx
// with x fastest; valid is one byte per slot (torch.bool). With kHalo the
// inputs hold T_in = T + 2*sy*sx cells: the slab's planes after one plane
// of the shard below, before one of the shard above.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct RebinArgs {
  const float* in[6];  // px py pz vx vy vz
  const unsigned char* valid;
  float* out[6];
  unsigned char* ovalid;
  int* dropped;
  long long T;     // output cells
  long long T_in;  // input cells (kHalo only)
  int P;
  int sx, sy, sz;  // sz: the z extent the border test uses
  int zb;          // global z of output plane 0
  int axis;        // 0 = x, 1 = y, 2 = z (always 2 with kHalo)
};

template <bool kHalo>
__device__ __forceinline__ void rebin_gather(const RebinArgs& a) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= a.T) return;
  const long long sxy = static_cast<long long>(a.sx) * a.sy;
  const int x = static_cast<int>(t % a.sx);
  const int y = static_cast<int>((t / a.sx) % a.sy);
  const int z = static_cast<int>(t / sxy) + a.zb;
  const int axis = kHalo ? 2 : a.axis;
  const int c = axis == 0 ? x : (axis == 1 ? y : z);
  const int n_axis = axis == 0 ? a.sx : (axis == 1 ? a.sy : a.sz);
  const long long stride = axis == 0 ? 1
                           : (axis == 1 ? static_cast<long long>(a.sx) : sxy);
  // the destination cell's own index in the input, and the input's size
  const long long own = kHalo ? t + sxy : t;
  const long long T_in = kHalo ? a.T_in : a.T;
  // by selects, not a dynamic index into the parameter array
  const float* pa = axis == 0 ? a.in[0] : (axis == 1 ? a.in[1] : a.in[2]);

  int count = 0;
  // g = 0: movers from c+1 (e == -1); 1: stayers; 2: movers from c-1
  for (int g = 0; g < 3; ++g) {
    const int cs = c + 1 - g;
    if (cs < 0 || cs >= n_axis) continue;
    const long long src = own + (1 - g) * stride;
    const int want = g - 1;  // the source at c - want reaches c with e == want
    for (int p = 0; p < a.P; ++p) {
      const long long idx = static_cast<long long>(p) * T_in + src;
      if (!a.valid[idx]) continue;
      int e = static_cast<int>(pa[idx]) - cs;
      e = e < -1 ? -1 : (e > 1 ? 1 : e);
      const int tgt = cs + e;
      if (tgt < 0 || tgt >= n_axis) e = 0;
      if (e != want) continue;
      if (count < a.P) {
        const long long o = static_cast<long long>(count) * a.T + t;
        for (int f = 0; f < 6; ++f) a.out[f][o] = a.in[f][idx];
        a.ovalid[o] = 1;
      }
      ++count;
    }
  }
  if (count > a.P) atomicAdd(a.dropped, count - a.P);
  const float centre[3] = {static_cast<float>(x) + 0.5f,
                           static_cast<float>(y) + 0.5f,
                           static_cast<float>(z) + 0.5f};
  for (int s = count; s < a.P; ++s) {
    const long long o = static_cast<long long>(s) * a.T + t;
    for (int f = 0; f < 3; ++f) a.out[f][o] = centre[f];
    for (int f = 3; f < 6; ++f) a.out[f][o] = 0.f;
    a.ovalid[o] = 0;
  }
}

}  // namespace
