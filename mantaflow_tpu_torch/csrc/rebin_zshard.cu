// The z pass of the rebin on one z-slab of the sharded FLIP step: the
// hand-written Hopper kernel behind ops/rebin_kernels.py:rebin_zpass_halo,
// after the slab's x and y passes (csrc/rebin.cu), in
// rebin_zshard_three_pass. The sharded step itself rebins each slab in one
// launch of csrc/rebin_fused.cu's slab form, held bitwise against this
// three-pass form.
//
// Replaces the TPU kernel mantaflow_tpu/ops/flip_bucket_pallas.py:
// _rebin_zpass_kernel_sh (_rebin_z_sharded, rebin_zshard_spmd), which
// streams the halo-extended slab plane by plane through three overlapping
// z-plane blocks in VMEM and merges each plane's candidates by ranked
// delivery, skipping planes with no movers. On Hopper it is the gather of
// rebin_gather.cuh with the extended read compiled in: one thread per
// destination cell of the slab walks the slots of its source cells in the
// extended input (the planes above, its own and below: global planes
// zb+t+1, zb+t, zb+t-1) and copies the arrivals in merge order. Plane
// indices, the border test and the parked centres are global. No plane is
// skipped: with no movers the gather copies each slot to where it was, and
// an invalid slot is parked where it already was parked. It is bound by
// bytes, like the one-domain pass: the slab's seven fields are read once
// (the two halo planes once more) and written once.
//
// Overflow is added to the shard's own *dropped; the step sums the shards'
// counts on the lead.

#include <cuda_runtime.h>

#include "rebin_gather.cuh"

namespace {

__global__ void __launch_bounds__(kThreads) rebin_zshard_kernel(RebinArgs a) {
  rebin_gather<true>(a);
}

}  // namespace

// in: 6 device pointers to (P, T_in) fields, T_in = T + 2*sx*sy (the slab
// with one halo plane on each side); out: 6 pointers to (P, T) fields. sz:
// the global z extent; zb: the global z of the slab's first plane.
extern "C" int rebin_zshard_launch(const float* const* in,
                                   const unsigned char* valid,
                                   float* const* out, unsigned char* ovalid,
                                   int* dropped, long long T, long long T_in,
                                   int P, int sx, int sy, int sz, int zb,
                                   int device, void* stream) {
  if (T_in != T + 2LL * sx * sy) return static_cast<int>(cudaErrorInvalidValue);
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
  a.T_in = T_in;
  a.P = P;
  a.sx = sx;
  a.sy = sy;
  a.sz = sz;
  a.zb = zb;
  a.axis = 2;
  const unsigned blocks = static_cast<unsigned>((T + kThreads - 1) / kThreads);
  rebin_zshard_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rebin_zshard_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
