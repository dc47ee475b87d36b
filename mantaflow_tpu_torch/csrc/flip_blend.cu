// The FLIP/PIC velocity blend on the bucket layout, standalone: the
// hand-written Hopper kernel behind ops/blend_kernels.py:flip_update, which
// finalize_buckets runs before particle velocities are read (inside a run
// the blend is fused into csrc/advect_bucket.cu's first stage).
//
// Replaces the TPU kernel mantaflow_tpu/ops/flip_bucket_pallas2.py:
// _blend_kernel (flip_update_pallas), which evaluates both MAC grids at the
// particles as a sum over 54 window taps of three z planes held in VMEM,
// because the TPU has no gather. Hopper gathers from L1/L2, so this kernel
// runs one thread per bucket slot and reads the 8 corners of each
// interpolation directly, both grids sharing their weights: the first stage
// of csrc/advect_bucket.cu without the motion, through the same device
// function (bucket_interp.cuh), so finalize_buckets applies what the fused
// kernel would have applied. It is bound by bytes: every slot's valid byte
// and velocity are read and its velocity written (invalid slots pass
// through, as in the plain version), the positions of the live particles
// are read, and the two grids' corners hit in cache.
//
// Semantics (flip_bucket.flip_update_bucketed):
//   v = r (v + (vnew - vold)) + (1 - r) vnew on valid slots, with vnew and
//   vold the MAC interpolation of vel and vel_old at the particle.
// Built with -fmad=false: the arithmetic keeps the plain version's order
// and rounding.
//
// Layout: slot fields contiguous (P, T) float32, T = sz*sy*sx with x
// fastest, valid one byte per slot; vel, vel_old (3, sz, sy, sx) float32.

#include <cuda_runtime.h>

#include "bucket_interp.cuh"

namespace {

constexpr int kThreads = 256;

struct BlendArgs {
  const float* px;
  const float* py;
  const float* pz;
  const unsigned char* valid;
  const float* vx;
  const float* vy;
  const float* vz;
  const float* vel;      // (3, sz, sy, sx)
  const float* vel_old;  // (3, sz, sy, sx)
  float* ovx;
  float* ovy;
  float* ovz;
  long long T;
  int P;
  int sx, sy, sz;
  float flip_ratio, pic_ratio;  // r and (1 - r), rounded to float once
};

__global__ void __launch_bounds__(kThreads) flip_blend_kernel(BlendArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= a.T * a.P) return;
  float nv[3] = {a.vx[i], a.vy[i], a.vz[i]};
  if (a.valid[i]) {
    const float x0 = a.px[i], y0 = a.py[i], z0 = a.pz[i];
    for (int c = 0; c < 3; ++c) {
      const float vnew = mac_comp(a.vel, c, a.sx, a.sy, a.sz, 0, a.sz, x0, y0, z0);
      const float vold = mac_comp(a.vel_old, c, a.sx, a.sy, a.sz, 0, a.sz, x0, y0, z0);
      nv[c] = a.flip_ratio * (nv[c] + (vnew - vold)) + a.pic_ratio * vnew;
    }
  }
  a.ovx[i] = nv[0];
  a.ovy[i] = nv[1];
  a.ovz[i] = nv[2];
}

}  // namespace

extern "C" int flip_blend_launch(const float* px, const float* py,
                                 const float* pz, const unsigned char* valid,
                                 const float* vx, const float* vy,
                                 const float* vz, const float* vel,
                                 const float* vel_old, float* ovx, float* ovy,
                                 float* ovz, long long T, int P, int sx,
                                 int sy, int sz, float flip_ratio,
                                 float pic_ratio, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  BlendArgs a{px, py, pz, valid, vx, vy, vz, vel, vel_old, ovx, ovy, ovz,
              T, P, sx, sy, sz, flip_ratio, pic_ratio};
  const long long n = T * P;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  flip_blend_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flip_blend_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
