// Switching (attack/release) one-pole scan for NVIDIA Hopper (sm_90a).
//
//   z[t] = x[t] + (z[t-1] - x[t]) * (up if x[t] > z[t-1] else dn)
//
// Replaces the TPU kernel zorak_tpu/kernels/pallas_scan.py
// (switching_scan_pallas, body _kernel).  There, one TPU core walks
// 1024-sample chunks as sequential grid steps and keeps the carry in
// VMEM scratch between them.  Blocks on a GPU run in no order, so none of
// that carries over: here one thread owns one lane and runs the whole
// time loop itself, with the carry in a register.
//
// What bounds it: the pole depends on the state, so the recurrence is not
// associative and time cannot be split across threads.  Each step waits
// on the previous step's compare, select, subtract, multiply and add.
// The paths that call it (the VAR and RED followers) have one lane per
// file, so the kernel is bound by that serial chain of T dependent steps,
// far above the 2 * sizeof(T) bytes a step moves.
//
// What the design does about it: keep global loads off the chain.  Input
// is [T, lanes] with lanes fastest, so neighbouring threads read
// neighbouring addresses at each step.  The time loop runs in chunks of
// UNROLL samples held in registers, and the next chunk's loads are issued
// before the current chunk's chain runs (double buffering), so a step
// waits only on arithmetic.  Making the chain itself shorter is left to a
// later change.  switching_chain_kernel below runs the chain alone, with
// no memory traffic, to measure that floor.
//
// Exactness: the file is compiled with --fmad=false so that the multiply
// and the add stay two roundings, as in the plain PyTorch version
// (zorak_tpu_torch/kernels/switching_scan.py, switching_scan_reference);
// the two then agree bit for bit.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 32;

template <typename T>
__device__ __forceinline__ T switching_step(T z, T xt, T up, T dn) {
  const T pole = (xt > z) ? up : dn;
  return xt + (z - xt) * pole;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
switching_scan_kernel(const T* __restrict__ x, const T* __restrict__ up,
                      const T* __restrict__ dn, const T* __restrict__ z0,
                      T* __restrict__ y, long long n_t, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const T u = up[lane];
  const T d = dn[lane];
  T z = z0[lane];
  const long long stride = lanes;
  const T* xp = x + lane;
  T* yp = y + lane;
  const long long n_full = n_t - n_t % kUnroll;

  T cur[kUnroll];
  if (n_full > 0) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) cur[k] = xp[k * stride];
  }
  for (long long t = 0; t < n_full; t += kUnroll) {
    T nxt[kUnroll];
    const bool more = t + kUnroll < n_full;
    if (more) {
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        nxt[k] = xp[(t + kUnroll + k) * stride];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      z = switching_step(z, cur[k], u, d);
      cur[k] = z;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) yp[(t + k) * stride] = cur[k];
    if (more) {
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) cur[k] = nxt[k];
    }
  }
  for (long long t = n_full; t < n_t; ++t) {
    z = switching_step(z, xp[t * stride], u, d);
    yp[t * stride] = z;
  }
}

// Timing probe, not a kernel of any path: one thread runs the same
// dependent chain for the full chunks of n_t steps, with x cycling
// through kUnroll values held in registers, so no load or store is on it.
// Its time per step is the chain's latency, the floor under
// switching_scan_kernel when each thread owns one lane.
template <typename T>
__global__ void switching_chain_kernel(const T* __restrict__ x,
                                       const T* __restrict__ up,
                                       const T* __restrict__ dn,
                                       const T* __restrict__ z0,
                                       T* __restrict__ z_out, long long n_t) {
  T xr[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) xr[k] = x[k];
  const T u = *up;
  const T d = *dn;
  T z = *z0;
  for (long long t = 0; t + kUnroll <= n_t; t += kUnroll) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) z = switching_step(z, xr[k], u, d);
  }
  *z_out = z;
}

template <typename T>
int launch_chain(const void* x, const void* up, const void* dn,
                 const void* z0, void* z_out, long long n_t, void* stream) {
  cudaGetLastError();
  switching_chain_kernel<T><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(up),
      static_cast<const T*>(dn), static_cast<const T*>(z0),
      static_cast<T*>(z_out), n_t);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* up, const void* dn, const void* z0,
           void* y, long long n_t, int lanes, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  const int blocks = (lanes + kThreads - 1) / kThreads;
  switching_scan_kernel<T><<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(up),
      static_cast<const T*>(dn), static_cast<const T*>(z0),
      static_cast<T*>(y), n_t, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int zorak_switching_scan_f32(const void* x, const void* up,
                                        const void* dn, const void* z0,
                                        void* y, long long n_t, int lanes,
                                        void* stream) {
  return launch<float>(x, up, dn, z0, y, n_t, lanes, stream);
}

extern "C" int zorak_switching_scan_f64(const void* x, const void* up,
                                        const void* dn, const void* z0,
                                        void* y, long long n_t, int lanes,
                                        void* stream) {
  return launch<double>(x, up, dn, z0, y, n_t, lanes, stream);
}

extern "C" int zorak_switching_chain_f32(const void* x, const void* up,
                                         const void* dn, const void* z0,
                                         void* z_out, long long n_t,
                                         void* stream) {
  return launch_chain<float>(x, up, dn, z0, z_out, n_t, stream);
}

extern "C" int zorak_switching_chain_f64(const void* x, const void* up,
                                         const void* dn, const void* z0,
                                         void* z_out, long long n_t,
                                         void* stream) {
  return launch_chain<double>(x, up, dn, z0, z_out, n_t, stream);
}
