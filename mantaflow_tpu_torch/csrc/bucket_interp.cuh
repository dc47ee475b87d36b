// Device functions shared by the bucket kernels: the BUILD_INDEX axis
// weights and the MAC interpolation at a particle position, in the plain
// versions' operation order (ops/flip_bucket.py:_axw, _mac_eval).

#pragma once

#include <cuda_runtime.h>

namespace {

// interpol.h BUILD_INDEX: trunc, then the border clamp of flip_bucket._axw
__device__ __forceinline__ void axw(float p, int n, int& idx, float& w) {
  idx = static_cast<int>(p);
  w = p - static_cast<float>(idx);
  if (p < 0.f) {
    idx = 0;
    w = 0.f;
  }
  if (p >= static_cast<float>(n - 1)) {
    idx = n - 2;
    w = 1.f;
  }
}

// Component c of the MAC grid g at q, summed in _mac_eval's order: z taps
// outer, y taps, x pairs inner, acc += (wz*wy) * (wx0 g0 + wx1 g1). The
// clamp of axw keeps all 8 corners inside the domain. g holds planes
// zlo .. zlo+nz-1 of the domain's sz (a z-slab with its halo planes, or the
// whole grid: zlo = 0, nz = sz): (3, nz, sy, sx).
__device__ __forceinline__ float mac_comp(const float* g, int c, int sx,
                                          int sy, int sz, int zlo, int nz,
                                          float qx, float qy, float qz) {
  int bx, by, bz;
  float wx, wy, wz;
  axw(qx - (c == 0 ? 0.f : 0.5f), sx, bx, wx);
  axw(qy - (c == 1 ? 0.f : 0.5f), sy, by, wy);
  axw(qz - (c == 2 ? 0.f : 0.5f), sz, bz, wz);
  const long long sxy = static_cast<long long>(sx) * sy;
  const float* G = g + c * sxy * nz;
  const float wxs[2] = {1.f - wx, wx};
  const float wys[2] = {1.f - wy, wy};
  const float wzs[2] = {1.f - wz, wz};
  float acc = 0.f;
  for (int iz = 0; iz < 2; ++iz) {
    for (int iy = 0; iy < 2; ++iy) {
      const float* row = G + (bz - zlo + iz) * sxy +
                         static_cast<long long>(by + iy) * sx + bx;
      const float inner = wxs[0] * row[0] + wxs[1] * row[1];
      acc = acc + (wzs[iz] * wys[iy]) * inner;
    }
  }
  return acc;
}

}  // namespace
