// The STFT pipeline's framing, overlap-add and spectral gain for NVIDIA
// Hopper (sm_90a), f32.  Three kernels around cuFFT's batched rFFT/irFFT:
//
//   K7a frame_window_kernel
//       out[l][f][i] = (f*hop + i < T ? x[l][f*hop + i] : 0) * w[i]
//     replaces `_frame` x window of zorak_tpu/kernels/stft.py (`_frame`,
//     `stft`), a gather over a zero-padded copy that XLA fuses with the
//     multiply.  One block a frame row, threads along the frame: loads and
//     stores coalesced, no padded copy.
//
//   K7b overlap_add_norm_kernel
//       y[l][t] = (sum over the frames f covering t of
//                  fr[l][f][t - f*hop] * w[t - f*hop]) * inv[t],  t < T
//     replaces the synthesis window, `_overlap_add` and the normalisation
//     of `istft` (the shifted slice-adds, or the scatter where hop does
//     not divide the size, then the multiply by the f32 reciprocal of the
//     window-power sum; `inv` is that reciprocal, computed on the host).
//     A thread an output sample gathers its frames, so nothing is
//     scattered and no accumulator array exists.  The order is the
//     reference's: where hop divides size the slice-adds give output block
//     j frame j first, then j-1, ... (descending); otherwise the scatter
//     adds frames in ascending order.  The sum starts from +0.0 as the
//     reference's zero accumulator does.
//
//   K7c gate_gain_kernel
//       s = clip((|X| / max(thr, 1e-12) - 1) / 2, 0, 1)
//       X * (m + ((1 - m) * s) * s * (3 - 2 s))
//     replaces the gain pass of `spectral_gate.gate` (one threshold a
//     lane; the percentile and median that set it stay plain PyTorch).
//     |X| is sqrt(re*re + im*im) with each step rounded, and the gain
//     multiplies the real and imaginary parts.  NaN passes through the
//     threshold and the clip as in torch.clamp.
//
// What bounds them on an H100: the bytes.  Each reads its input once and
// writes its output once with a handful of f32 operations an element
// (K7a 8 bytes an element moved, K7b 4 bytes a frame sample + 4 an output
// sample, K7c 16 bytes a bin); none reuses data, so the design is one
// coalesced pass.  The file is compiled with --fmad=false and every
// multiply, add and divide rounds on its own, as the plain PyTorch
// versions in kernels/stft.py do: each kernel equals its plain version
// bit for bit.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after its launch, 0 when the launch was accepted.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
frame_window_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, long long t, int size, int hop,
                    long long n_frames) {
  const long long row = blockIdx.x;            // lane * n_frames + frame
  const long long lane = row / n_frames;
  const long long f = row - lane * n_frames;
  const float* xl = x + lane * t;
  const long long pos0 = f * hop;
  float* o = out + row * size;
  for (int i = threadIdx.x; i < size; i += kThreads) {
    const long long pos = pos0 + i;
    const float v = pos < t ? xl[pos] : 0.0f;
    o[i] = __fmul_rn(v, w[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
overlap_add_norm_kernel(const float* __restrict__ fr,
                        const float* __restrict__ w,
                        const float* __restrict__ inv, float* __restrict__ y,
                        long long n_frames, int size, int hop, long long t_out,
                        int descending) {
  const long long lane = blockIdx.y;
  const float* frl = fr + lane * n_frames * size;
  // 32-bit sample and frame indices (the wrapper checks t_out < 2^31)
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < t_out;
       t += gridDim.x * kThreads) {
    // the frames f with f*hop <= t < f*hop + size
    int f_hi = t / hop;
    if (f_hi > n_frames - 1) f_hi = (int)(n_frames - 1);
    const int f_lo = t >= size ? (t - size) / hop + 1 : 0;
    float acc = 0.0f;
    if (descending) {
      for (int f = f_hi; f >= f_lo; --f) {
        const int i = t - f * hop;
        acc = __fadd_rn(acc, __fmul_rn(frl[(long long)f * size + i], w[i]));
      }
    } else {
      for (int f = f_lo; f <= f_hi; ++f) {
        const int i = t - f * hop;
        acc = __fadd_rn(acc, __fmul_rn(frl[(long long)f * size + i], w[i]));
      }
    }
    y[lane * t_out + t] = __fmul_rn(acc, inv[t]);
  }
}

__global__ void __launch_bounds__(kThreads)
gate_gain_kernel(const float2* __restrict__ spec, const float* __restrict__ thr,
                 float m, float one_minus_m, float2* __restrict__ out,
                 long long per_lane) {
  const long long lane = blockIdx.y;
  float th = thr[lane];
  th = th < 1e-12f ? 1e-12f : th;                         // NaN stays
  const float2* sl = spec + lane * per_lane;
  float2* ol = out + lane * per_lane;
  for (long long k = blockIdx.x * (long long)kThreads + threadIdx.x;
       k < per_lane; k += (long long)gridDim.x * kThreads) {
    const float2 v = sl[k];
    const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(v.x, v.x),
                                           __fmul_rn(v.y, v.y)));
    float s = __fdiv_rn(__fsub_rn(__fdiv_rn(mag, th), 1.0f), 2.0f);
    s = s < 0.0f ? 0.0f : s;                              // NaN stays
    s = s > 1.0f ? 1.0f : s;
    const float g = __fadd_rn(
        m, __fmul_rn(__fmul_rn(__fmul_rn(one_minus_m, s), s),
                     __fsub_rn(3.0f, __fmul_rn(2.0f, s))));
    ol[k] = make_float2(__fmul_rn(v.x, g), __fmul_rn(v.y, g));
  }
}

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < 132LL * 16 ? blocks : 132LL * 16);
}

}  // namespace

// x: [lanes, t]; w: [size]; out: [lanes, n_frames, size].
extern "C" int zorak_frame_window(const void* x, const void* w, void* out,
                                  long long lanes, long long t, int size,
                                  int hop, long long n_frames, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (lanes <= 0 || n_frames <= 0 || size <= 0) return 0;
  frame_window_kernel<<<(unsigned)(lanes * n_frames), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), t, size, hop, n_frames);
  return static_cast<int>(cudaGetLastError());
}

// fr: [lanes, n_frames, size]; w: [size]; inv: [>= t_out]; y: [lanes, t_out].
extern "C" int zorak_overlap_add_norm(const void* fr, const void* w,
                                      const void* inv, void* y,
                                      long long lanes, long long n_frames,
                                      int size, int hop, long long t_out,
                                      int descending, void* stream) {
  cudaGetLastError();
  if (lanes <= 0 || t_out <= 0) return 0;
  const dim3 grid(grid_for(t_out * lanes) / (unsigned)lanes + 1,
                  (unsigned)lanes);
  overlap_add_norm_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fr), static_cast<const float*>(w),
      static_cast<const float*>(inv), static_cast<float*>(y), n_frames, size,
      hop, t_out, descending);
  return static_cast<int>(cudaGetLastError());
}

// spec, out: [lanes, per_lane] complex64 (re, im interleaved); thr: [lanes].
extern "C" int zorak_gate_gain(const void* spec, const void* thr, float m,
                               float one_minus_m, void* out, long long lanes,
                               long long per_lane, void* stream) {
  cudaGetLastError();
  if (lanes <= 0 || per_lane <= 0) return 0;
  const dim3 grid(grid_for(per_lane * lanes) / (unsigned)lanes + 1,
                  (unsigned)lanes);
  gate_gain_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), static_cast<const float*>(thr), m,
      one_minus_m, static_cast<float2*>(out), per_lane);
  return static_cast<int>(cudaGetLastError());
}
