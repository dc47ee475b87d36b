// One axis pass of the bucket rebin: the hand-written Hopper kernel behind
// ops/rebin_kernels.py:rebin_pass. Three launches (x, y, z) make the whole
// rebin (rebin_three_pass); on a z-slab it runs the x and y passes, before
// the z pass of csrc/rebin_zshard.cu (rebin_zshard_three_pass). The FLIP
// step runs neither: its rebin is csrc/rebin_fused.cu, all three passes in
// one launch (one per shard on the sharded step), held bitwise against
// these passes.
//
// Replaces the TPU kernels mantaflow_tpu/ops/flip_bucket_pallas.py:
// _rebin_xy_kernel (x then y in one plane-local pass), _rebin_pass_kernel
// (one x or y pass, when the fused form does not fit VMEM) and
// _rebin_zpass_kernel (the z pass over a 3-plane window); the opt-in
// _rebin_zpass_stream_kernel and _rebin_fused_kernel compute the same
// function. The TPU splits the rebin into plane-local and z passes to fit
// VMEM and builds each pass from rank/indicator contractions because it has
// no gather. On Hopper every pass is one gather kernel: one thread per
// destination cell walks the slots of its three source cells along the axis
// and copies the arrivals in merge order (the body, its semantics and
// layout are in rebin_gather.cuh, shared with rebin_zshard.cu). It is bound
// by bytes: each pass reads and writes the seven (P, T) fields once (the
// source-cell reads of the axis coordinate and valid mask are shared by
// three neighbouring destinations and hit in L2).

#include <cuda_runtime.h>

#include "rebin_gather.cuh"

namespace {

__global__ void __launch_bounds__(kThreads) rebin_pass_kernel(RebinArgs a) {
  rebin_gather<false>(a);
}

}  // namespace

// in/out: arrays of 6 device pointers (px py pz vx vy vz). *dropped is
// incremented by the pass's overflow. zb: global z of plane 0 (a slab's
// offset, for the parked centres of an x or y pass; 0 for the whole
// domain).
extern "C" int rebin_launch(const float* const* in,
                                 const unsigned char* valid,
                                 float* const* out, unsigned char* ovalid,
                                 int* dropped, long long T, int P, int sx,
                                 int sy, int sz, int zb, int axis, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  RebinArgs a{};
  for (int f = 0; f < 6; ++f) {
    a.in[f] = in[f];
    a.out[f] = out[f];
  }
  a.valid = valid;
  a.ovalid = ovalid;
  a.dropped = dropped;
  a.T = T;
  a.T_in = T;
  a.P = P;
  a.sx = sx;
  a.sy = sy;
  a.sz = sz;
  a.zb = zb;
  a.axis = axis;
  const unsigned blocks = static_cast<unsigned>((T + kThreads - 1) / kThreads);
  rebin_pass_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rebin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
