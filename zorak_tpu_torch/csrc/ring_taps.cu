// Sum of constant-gain delay taps of one ring buffer for NVIDIA Hopper
// (sm_90a), f64:
//
//   acc[t] = init[t];  for k in order:  acc[t] = acc[t] + g[k] * buf[s[k] + t]
//
// for t in [0, L), where buf is a ring region laid out in write order,
// [history | this segment's write stream], and s[k] = mod - delay[k] is a
// tap's static offset into it.  Replaces the tap reads of
// zorak_tpu/lowering/specialize.py (ring_hist_full, ring_delayed) together
// with the multiply-add chain that consumes them, which the reference
// leaves to XLA to fuse.  In eager PyTorch every tap is two launches (a
// multiply and an add) and two passes over L samples; a delay network has
// 16 to about 200 taps a channel.
//
// What bounds it: bytes.  Every tap reads L samples, but all taps of a
// chain read the same (mod + L) * 8 bytes, which stay in the L2 cache, so
// from device memory the work is the buffer once, init once and the
// output once.
//
// What the design does about it: one thread per output sample folds all
// taps in registers, in the chain's own order, multiply and add as two
// roundings (--fmad=false), so the result equals the node-by-node
// emission bit for bit.  Neighbouring threads read neighbouring samples of
// every tap.  The taps' offsets and gains are staged through shared
// memory, kTaps at a time.  A tap whose window does not lie inside the
// buffer contributes NaN instead of reading outside it.
//
// Plain C interface (loaded with ctypes); the entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBlock = 256;
constexpr int kTaps = 256;    // taps staged in shared memory at once

__global__ void __launch_bounds__(kBlock)
ring_tap_sum_kernel(const double* __restrict__ buf, long long buf_len,
                    const long long* __restrict__ starts,
                    const double* __restrict__ gains, int n_taps,
                    const double* __restrict__ init, double init_scalar,
                    double* __restrict__ out, long long length) {
  __shared__ long long s_start[kTaps];
  __shared__ double s_gain[kTaps];

  const long long t = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const bool live = t < length;
  double acc = live ? (init != nullptr ? init[t] : init_scalar) : 0.0;
  for (int k0 = 0; k0 < n_taps; k0 += kTaps) {
    const int count = n_taps - k0 < kTaps ? n_taps - k0 : kTaps;
    __syncthreads();
    for (int i = threadIdx.x; i < count; i += kBlock) {
      s_start[i] = starts[k0 + i];
      s_gain[i] = gains[k0 + i];
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int i = 0; i < count; ++i) {
        const long long s = s_start[i];
        const bool inside = s >= 0 && s + length <= buf_len;
        const double v = inside ? buf[s + t] : nan("");
        acc = acc + s_gain[i] * v;
      }
    }
  }
  if (live) out[t] = acc;
}

}  // namespace

// buf: [buf_len] f64; starts: [n_taps] i64; gains: [n_taps] f64;
// init: [length] f64 or null (then init_scalar); out: [length] f64.
extern "C" int zorak_ring_tap_sum(const void* buf, long long buf_len,
                                  const void* starts, const void* gains,
                                  int n_taps, const void* init,
                                  double init_scalar, void* out,
                                  long long length, void* stream) {
  if (length <= 0) return 0;
  const long long blocks = (length + kBlock - 1) / kBlock;
  ring_tap_sum_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(buf), buf_len,
      static_cast<const long long*>(starts),
      static_cast<const double*>(gains), n_taps,
      static_cast<const double*>(init), init_scalar,
      static_cast<double*>(out), length);
  return static_cast<int>(cudaGetLastError());
}
