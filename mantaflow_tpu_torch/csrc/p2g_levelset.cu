// Fused particle-to-grid transfer and union particle levelset (radius
// window 1): the hand-written Hopper kernel behind
// ops/p2g_kernels.py:p2g_union, and in its z-slab form
// (p2g_levelset_zshard_kernel) behind p2g_union_slab, one launch per shard
// of the sharded step (the port of _p2g_ls_kernel as
// p2g_union_zshard_spmd calls it: sources over a one-plane halo-extended
// slab, a global z offset and z extent).
//
// Replaces the TPU kernel mantaflow_tpu/ops/flip_bucket_pallas2.py:
// _p2g_ls_kernel (p2g_union_pallas), a source-centric streaming scatter:
// each grid step takes one z plane of source buckets and adds its tap
// contributions into a ring of three VMEM plane accumulators. Blocks on
// Hopper run in no order, so a scatter would need atomics, whose order of
// sums changes from run to run. This kernel gathers instead, one block per
// brick of destination cells over source planes staged in shared memory
// (the body, its order of sums, semantics and layout are in
// p2g_gather.cuh, shared with p2g_mac.cu).

#include <cuda_runtime.h>

#include "p2g_gather.cuh"

namespace {

constexpr int kThreads = P2gShape<true>::kThreads;

__global__ void __launch_bounds__(kThreads) p2g_levelset_kernel(P2gArgs a) {
  p2g_gather<true, false>(a);
}

__global__ void __launch_bounds__(kThreads)
    p2g_levelset_zshard_kernel(P2gArgs a) {
  p2g_gather<true, true>(a);
}

}  // namespace

// grid from ops/p2g_kernels.py:p2g_plan
extern "C" int p2g_levelset_launch(const float* px, const float* py,
                                   const float* pz, const float* vx,
                                   const float* vy, const float* vz,
                                   const unsigned char* valid, float* vel,
                                   float* weight, float* phi, long long T,
                                   long long T_src, int P, int sx, int sy,
                                   int sz, int zb, float radius, int slab,
                                   int gx, int gy, int gz, int device,
                                   void* stream) {
  // slab: the outputs are T cells of planes zb.. of the domain's sz, the
  // slot fields T_src = T + 2*sx*sy cells from plane zb - 1
  const long long sxy = static_cast<long long>(sx) * sy;
  if ((slab && T_src != T + 2 * sxy) || (!slab && T_src != T) ||
      T % sxy != 0 || gx != (sx + kBx - 1) / kBx ||
      gy != (sy + kBy - 1) / kBy || gz != (T / sxy + kBz - 1) / kBz)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  void (*fn)(P2gArgs) = slab ? p2g_levelset_zshard_kernel : p2g_levelset_kernel;
  constexpr int smem = P2gShape<true>::kSmem;
  err = p2g_smem_attributes(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  P2gArgs a{px, py, pz, vx, vy, vz, valid, vel, weight, phi, T, P,
            sx, sy, sz, radius, T_src, zb, zb - 1};
  fn<<<dim3(gx, gy, gz), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* p2g_levelset_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
