// Particle-to-grid transfer alone (mapPartsToMAC's velocity and weight
// grids): the hand-written Hopper kernel behind ops/p2g_kernels.py:p2g_mac,
// for the steps that build no levelset (no ghost fluid) or a wide one
// (csrc/union_levelset.cu).
//
// Replaces the TPU kernel mantaflow_tpu/ops/flip_bucket_pallas2.py:
// _p2g_kernel (p2g_mac_pallas), a source-plane scatter into a ring of VMEM
// plane accumulators. On Hopper it is the gather of p2g_gather.cuh without
// the levelset (the same device code as csrc/p2g_levelset.cu, compiled
// with the flag off): one block per brick of destination cells over source
// planes staged in shared memory, deterministic, no atomics.

#include <cuda_runtime.h>

#include "p2g_gather.cuh"

namespace {

constexpr int kThreads = P2gShape<false>::kThreads;

__global__ void __launch_bounds__(kThreads) p2g_mac_kernel(P2gArgs a) {
  p2g_gather<false, false>(a);
}

}  // namespace

// grid from ops/p2g_kernels.py:p2g_plan
extern "C" int p2g_mac_launch(const float* px, const float* py,
                              const float* pz, const float* vx,
                              const float* vy, const float* vz,
                              const unsigned char* valid, float* vel,
                              float* weight, long long T, int P, int sx,
                              int sy, int sz, int gx, int gy, int gz,
                              int device, void* stream) {
  if (T != static_cast<long long>(sx) * sy * sz ||
      gx != (sx + kBx - 1) / kBx || gy != (sy + kBy - 1) / kBy ||
      gz != (sz + kBz - 1) / kBz)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int smem = P2gShape<false>::kSmem;
  err = p2g_smem_attributes(p2g_mac_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  P2gArgs a{px, py, pz, vx, vy, vz, valid, vel, weight, nullptr, T, P,
            sx, sy, sz, 0.f, T, 0, 0};
  p2g_mac_kernel<<<dim3(gx, gy, gz), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* p2g_mac_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
