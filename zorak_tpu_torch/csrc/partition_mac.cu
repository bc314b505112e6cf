// The frequency-domain multiply-accumulate of uniform partitioned
// convolution for NVIDIA Hopper (sm_90a), complex64:
//
//   Y[l][f][b] = sum over p = 0 .. parts-1, ascending, of X[l][f-p][b] * H[p][b]
//
// with X[l][g] = 0 for g < 0 (the zero history rows of the reference) and
// each complex product written out as (xr*hr - xi*hi, xr*hi + xi*hr).
// Replaces the `mac` scan of `partitioned_convolve` in
// zorak_tpu/kernels/convolution.py, which XLA runs as `parts` passes of a
// multiply-add over the whole [frames, bins] spectrum, reading and writing
// the accumulator each time (so does a plain PyTorch loop).
//
// What bounds it on an H100: the operations.  A complex MAC is 8 f32
// instructions (4 multiplies, 4 adds; no contraction), 1.97 G MACs at the
// bench shape (32 lanes x 469 frames x 2,049 bins x 64 partitions), about
// 0.47 ms at the FP32 instruction rate, where the bytes (X and H read once,
// Y written once) allow 0.15 ms.
//
// What the design does about it: every operand comes from on chip.  A
// block takes 32 bins (a warp's lanes, so every load of a frame row is
// 256 contiguous bytes) and kWarps tiles of kFrames output frames; each
// thread keeps its kFrames accumulators in registers and walks the input
// frames g from the newest its tile needs down to the oldest, loading
// X[g] once and adding X[g] * H[f-g] into every accumulator f with
// 0 <= f-g < parts.  Walking g downwards gives each output frame its
// partitions in ascending order, the reference's order.  The
// partitions' spectra for the block's bins are staged in shared memory,
// kParts at a time (16 KB), in ascending order.  Compiled with
// --fmad=false: every multiply and add rounds on its own, as in the plain
// PyTorch version (kernels/convolution.py), which it equals bit for bit.
//
// Plain C interface (loaded with ctypes); the entry point returns
// cudaGetLastError() after its launch, 0 when the launch was accepted.

#include <cuda_runtime.h>

namespace {

constexpr int kBins = 32;    // bins a block: one warp's lanes
constexpr int kWarps = 8;    // frame tiles a block, one a warp
constexpr int kFrames = 16;  // output frames a thread, in registers
constexpr int kParts = 64;   // partitions staged in shared memory at once

__global__ void __launch_bounds__(kBins * kWarps)
partition_mac_kernel(const float2* __restrict__ x,
                     const float2* __restrict__ h, float2* __restrict__ y,
                     int n_frames, int bins, int parts) {
  __shared__ float2 hs[kParts][kBins];
  const int bl = threadIdx.x;
  const int b = blockIdx.x * kBins + bl;
  const int f0 = (blockIdx.y * kWarps + threadIdx.y) * kFrames;
  const long long lane_off = (long long)blockIdx.z * n_frames * bins;
  const float2* xl = x + lane_off;
  const bool active = b < bins && f0 < n_frames;

  float acc_r[kFrames], acc_i[kFrames];
#pragma unroll
  for (int j = 0; j < kFrames; ++j) acc_r[j] = acc_i[j] = 0.0f;

  for (int p0 = 0; p0 < parts; p0 += kParts) {
    const int np = parts - p0 < kParts ? parts - p0 : kParts;
    __syncthreads();  // the previous group's partitions are read
    for (int k = threadIdx.y * kBins + bl; k < np * kBins;
         k += kBins * kWarps) {
      const int pp = k / kBins, bb = blockIdx.x * kBins + k % kBins;
      hs[pp][k % kBins] = bb < bins ? h[(long long)(p0 + pp) * bins + bb]
                                    : make_float2(0.0f, 0.0f);
    }
    __syncthreads();
    if (!active) continue;
    // output frame f0 + j takes partition p0 + q from input frame
    // g = f0 + j - p0 - q, q = 0 .. np-1; g runs from the newest to the
    // oldest so that q ascends for every j
    const int g_hi = f0 + kFrames - 1 - p0;
    const int g_lo = f0 - p0 - (np - 1);
    for (int g = g_hi; g >= g_lo; --g) {
      const float2 xv = (g >= 0 && g < n_frames)
                            ? xl[(long long)g * bins + b]
                            : make_float2(0.0f, 0.0f);
      const int q0 = f0 - p0 - g;  // partition of accumulator j is q0 + j
#pragma unroll
      for (int j = 0; j < kFrames; ++j) {
        const int q = q0 + j;
        if (q >= 0 && q < np) {
          const float2 hv = hs[q][bl];
          const float pr = __fsub_rn(__fmul_rn(xv.x, hv.x),
                                     __fmul_rn(xv.y, hv.y));
          const float pi = __fadd_rn(__fmul_rn(xv.x, hv.y),
                                     __fmul_rn(xv.y, hv.x));
          acc_r[j] = __fadd_rn(acc_r[j], pr);
          acc_i[j] = __fadd_rn(acc_i[j], pi);
        }
      }
    }
  }
  if (!active) return;
  float2* yl = y + lane_off;
#pragma unroll
  for (int j = 0; j < kFrames; ++j)
    if (f0 + j < n_frames)
      yl[(long long)(f0 + j) * bins + b] = make_float2(acc_r[j], acc_i[j]);
}

}  // namespace

// x, y: [lanes, n_frames, bins] complex64 (re, im interleaved);
// h: [parts, bins] complex64.
extern "C" int zorak_partition_mac(const void* x, const void* h, void* y,
                                   long long lanes, long long n_frames,
                                   long long bins, long long parts,
                                   void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (lanes <= 0 || n_frames <= 0 || bins <= 0) return 0;
  const dim3 grid((unsigned)((bins + kBins - 1) / kBins),
                  (unsigned)((n_frames + kFrames * kWarps - 1)
                             / (kFrames * kWarps)),
                  (unsigned)lanes);
  partition_mac_kernel<<<grid, dim3(kBins, kWarps), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(h),
      static_cast<float2*>(y), (int)n_frames, (int)bins, (int)parts);
  return static_cast<int>(cudaGetLastError());
}
