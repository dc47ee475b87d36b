// The particle-to-grid gather shared by csrc/p2g_levelset.cu (with the
// union levelset of a one-cell window fused in) and csrc/p2g_mac.cu (the
// transfer alone). One thread per destination cell walks the slots of the
// 27 source cells whose tap windows reach it, adds each particle's weight
// for its own tap, and, with kLevelset, keeps the least squared distance.
// The result is deterministic; it differs from the plain version only in
// the order of the float sums. kLevelset is a compile-time flag, so each
// source compiles the body it needs and nothing of the other. kSlab, also
// at compile time, adds the z-slab form of the sharded step
// (p2g_union_zshard_spmd): the destinations are one shard's planes (global
// zb ..) and the sources its slab extended by one plane of each neighbour
// (global zsrc = zb - 1 ..); z coordinates, the border tests and the
// levelset's interior ring are global, so a shard's planes equal the same
// planes of the one-domain result bit for bit.
//
// Semantics (flip_bucket.p2g_mac and union_levelset_bucketed):
//   face (c, cell) += w, w*v_c for every particle of source cell s = cell-d
//   whose tap d lies in the component's window (own axis {0,1}, cross
//   {-1,0,1}); w = prod over axes of the BUILD_INDEX linear weight landing
//   at tap d. weight < 1e-6 -> 0; vel = weight > 0 ? acc / weight : 0.
//   d2 = r2 - 2 (e . d) + |d|^2 with e = p - centre(s); d2min over the 27
//   neighbours (1e10 for none); phi = min(sqrt(d2min) - r, r), r for none,
//   0.5 on the boundary ring.
//
// Layout: slot fields are contiguous (P, T) arrays, T = sz*sy*sx with x
// fastest, valid one byte per slot; vel and weight out are (3, sz, sy, sx),
// phi (sz, sy, sx), all float32. kSlab: the slot fields hold T_src cells,
// the outputs T (the shard's planes).

#pragma once

#include <cuda_runtime.h>

#include "bucket_interp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 1e10f;

struct P2gArgs {
  const float* px;
  const float* py;
  const float* pz;
  const float* vx;
  const float* vy;
  const float* vz;
  const unsigned char* valid;
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

// Linear weight that a particle with axis base b (relative to its source
// cell) and fraction w1 puts on tap d (flip_bucket._tap_weights).
__device__ __forceinline__ float tap_weight(int b_rel, float w1, int d) {
  return b_rel == d ? 1.f - w1 : (b_rel == d - 1 ? w1 : 0.f);
}

template <bool kLevelset, bool kSlab>
__device__ __forceinline__ void p2g_gather(const P2gArgs& a) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= a.T) return;
  const long long T_src = kSlab ? a.T_src : a.T;
  const int zsrc = kSlab ? a.zsrc : 0;
  const int x = static_cast<int>(t % a.sx);
  const int y = static_cast<int>((t / a.sx) % a.sy);
  const int z = static_cast<int>(t / (static_cast<long long>(a.sx) * a.sy)) +
                (kSlab ? a.zb : 0);
  const int n[3] = {a.sx, a.sy, a.sz};
  const float* vel[3] = {a.vx, a.vy, a.vz};

  float acc[3] = {0.f, 0.f, 0.f};
  float wsum[3] = {0.f, 0.f, 0.f};
  float d2min = kBig;
  for (int dz = -1; dz <= 1; ++dz) {
    const int zs = z - dz;
    if (zs < 0 || zs >= a.sz) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int ys = y - dy;
      if (ys < 0 || ys >= a.sy) continue;
      for (int dx = -1; dx <= 1; ++dx) {
        const int xs = x - dx;
        if (xs < 0 || xs >= a.sx) continue;
        const long long s =
            (static_cast<long long>(zs - zsrc) * a.sy + ys) * a.sx + xs;
        const int src[3] = {xs, ys, zs};
        const int d[3] = {dx, dy, dz};
        const float c2 = static_cast<float>(dx * dx + dy * dy + dz * dz);
        for (int p = 0; p < a.P; ++p) {
          const long long idx = static_cast<long long>(p) * T_src + s;
          if (!a.valid[idx]) continue;
          const float q[3] = {a.px[idx], a.py[idx], a.pz[idx]};
          if constexpr (kLevelset) {
            // union levelset: distance to this cell's centre
            const float ex = q[0] - (static_cast<float>(xs) + 0.5f);
            const float ey = q[1] - (static_cast<float>(ys) + 0.5f);
            const float ez = q[2] - (static_cast<float>(zs) + 0.5f);
            const float r2 = ex * ex + ey * ey + ez * ez;
            const float d2 = r2 - 2.f * (ex * static_cast<float>(dx) +
                                         ey * static_cast<float>(dy) +
                                         ez * static_cast<float>(dz)) + c2;
            d2min = fminf(d2min, d2);
          }
          // p2g: component c takes taps {0,1} on its own axis
          for (int c = 0; c < 3; ++c) {
            if (d[c] == -1) continue;
            float wa[3];
            for (int ax = 0; ax < 3; ++ax) {
              int b;
              float w1;
              axw(q[ax] - (ax == c ? 0.f : 0.5f), n[ax], b, w1);
              wa[ax] = tap_weight(b - src[ax], w1, d[ax]);
            }
            const float w = (wa[2] * wa[1]) * wa[0];
            wsum[c] = wsum[c] + w;
            acc[c] = acc[c] + w * vel[c][idx];
          }
        }
      }
    }
  }
  for (int c = 0; c < 3; ++c) {
    const float ws = wsum[c] < 1e-6f ? 0.f : wsum[c];
    a.weight[c * a.T + t] = ws;
    a.vel[c * a.T + t] = ws > 0.f ? acc[c] / fmaxf(ws, 1e-30f) : 0.f;
  }
  if constexpr (kLevelset) {
    const bool inter = x >= 1 && x <= a.sx - 2 && y >= 1 && y <= a.sy - 2 &&
                       z >= 1 && z <= a.sz - 2;
    float phi =
        d2min >= kBig ? a.radius : sqrtf(fmaxf(d2min, 0.f)) - a.radius;
    phi = fminf(phi, a.radius);
    a.phi[t] = inter ? phi : 0.5f;
  }
}

}  // namespace
