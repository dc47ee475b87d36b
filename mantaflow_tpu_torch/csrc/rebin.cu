// One axis pass of the bucket rebin: the hand-written Hopper kernel behind
// ops/rebin_kernels.py:rebin_pass. Three launches (x, y, z) make the whole
// rebin after an advection step.
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
// and copies the arrivals in merge order. It is bound by bytes: each pass
// reads and writes the seven (P, T) fields once (the source-cell reads of
// the axis coordinate and valid mask are shared by three neighbouring
// destinations and hit in L2).
//
// Semantics (flip_bucket._rebin_axis, a stable 3-way merge):
//   e = clip(trunc(p_axis) - c, -1, 1); a mover whose target leaves the
//   domain stays; arrivals at cell c in order: movers from c+1 (e == -1),
//   stayers (e == 0), movers from c-1 (e == +1), source slot order kept in
//   each group; the first P are kept, the rest are added to *dropped; the
//   slots after the arrivals are parked at the cell centre with zero
//   velocity and valid = 0. A permutation: the result is bit-exact.
//
// Layout: fields are contiguous (P, T) arrays, slot-major, T = sz*sy*sx
// with x fastest; valid is one byte per slot (torch.bool).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct RebinArgs {
  const float* in[6];  // px py pz vx vy vz
  const unsigned char* valid;
  float* out[6];
  unsigned char* ovalid;
  int* dropped;
  long long T;
  int P;
  int sx, sy, sz;
  int axis;  // 0 = x, 1 = y, 2 = z
};

__global__ void __launch_bounds__(kThreads) rebin_pass_kernel(RebinArgs a) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= a.T) return;
  const int x = static_cast<int>(t % a.sx);
  const int y = static_cast<int>((t / a.sx) % a.sy);
  const int z = static_cast<int>(t / (static_cast<long long>(a.sx) * a.sy));
  const int c = a.axis == 0 ? x : (a.axis == 1 ? y : z);
  const int n_axis = a.axis == 0 ? a.sx : (a.axis == 1 ? a.sy : a.sz);
  const long long stride = a.axis == 0 ? 1
                           : (a.axis == 1 ? static_cast<long long>(a.sx)
                                          : static_cast<long long>(a.sx) * a.sy);
  // by selects, not a dynamic index into the parameter array
  const float* pa = a.axis == 0 ? a.in[0] : (a.axis == 1 ? a.in[1] : a.in[2]);

  int count = 0;
  // g = 0: movers from c+1 (e == -1); 1: stayers; 2: movers from c-1
  for (int g = 0; g < 3; ++g) {
    const int cs = c + 1 - g;
    if (cs < 0 || cs >= n_axis) continue;
    const long long src = t + (1 - g) * stride;
    const int want = g - 1;  // the source at c - want reaches c with e == want
    for (int p = 0; p < a.P; ++p) {
      const long long idx = static_cast<long long>(p) * a.T + src;
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

// in/out: arrays of 6 device pointers (px py pz vx vy vz). *dropped is
// incremented by the pass's overflow.
extern "C" int rebin_launch(const float* const* in,
                                 const unsigned char* valid,
                                 float* const* out, unsigned char* ovalid,
                                 int* dropped, long long T, int P, int sx,
                                 int sy, int sz, int axis, int device,
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
  a.P = P;
  a.sx = sx;
  a.sy = sy;
  a.sz = sz;
  a.axis = axis;
  const unsigned blocks = static_cast<unsigned>((T + kThreads - 1) / kThreads);
  rebin_pass_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rebin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
