// Sums of constant-gain delay taps of ring buffers for NVIDIA Hopper
// (sm_90a), f64, a batch of chains in one launch.  For each chain c and
// t in [0, L):
//
//   acc[t] = init[t];  for k in order:  acc[t] = acc[t] + g[k] * buf[s[k] + t]
//
// where buf is the chain's ring region in write order, [history | this
// segment's write stream], read in place: buffer index i < mod is
// ring[(start + i) % mod] (start: the host-known cursor of the oldest
// sample), i >= mod is stream[i - mod].  s[k] = mod - delay[k] is a tap's
// static offset.  A history-only chain (every delay >= L) has no stream.
// A launch serves a batch of files that share the tap tables and the
// cursors (the files of one plugin rendered together): each chain names a
// file stride for its ring, stream, init and output (0 where the files
// share one row), and blockIdx.z picks the file.
// Replaces the tap reads of zorak_tpu/lowering/specialize.py
// (ring_hist_full, ring_delayed) together with the multiply-add chain that
// consumes them, which the reference leaves to XLA to fuse.
//
// What bounds it: the on-chip reads.  The fold keeps two roundings a tap
// (a DMUL and a DADD, never a fused multiply-add, so the sum equals the
// node-by-node emission bit for bit), which rules out the tensor cores and
// any regrouping; each tap and sample then needs its own 8-byte read from
// shared memory, about twice the time of its two f64 instructions.  From
// device memory the work is one pass: the part of the ring the taps reach,
// the stream, init and output once.
//
// What the design does about it (the staged kernel): a block takes a tile
// of R * 256 output samples of one chain (blockIdx.y picks the chain) of
// one file (blockIdx.z) and
// copies the window its taps read, [min s + t0, max s + t0 + tile), into
// shared memory once with 16-byte cp.async copies (8-byte where source and
// destination disagree mod 16), split at the ring's wrap and at the
// stream.  Each thread then folds R samples, 256 apart (a warp reads 32
// neighbouring doubles, no bank conflict), in R independent registers
// that hide the DADD's latency; the tap table is staged beside the window
// and read four taps at a time.  A chain whose window does not fit is cut,
// on the host, into runs of taps in chain order whose windows do
// ("windows"); the sums stay in registers from one run to the next.
//
// The global kernel is the earlier design, kept to be timed beside it: a
// thread a sample, every tap read from device memory through the caches.
//
// Plain C interface (loaded with ctypes); the entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChains = 16;   // chains in one launch (kernel parameter)
constexpr int kGlobalTaps = 256; // taps the global kernel stages at once

// One chain of a launch; the layout matches ring_taps.py's _Chain.  File f
// reads ring + f * ring_fstride and so on; out_fstride is length.
struct Chain {
  const double* ring;     // [mod] a file
  const double* stream;   // [length] a file, or null: history only
  const double* init;     // init[t * init_stride] a file, or null: init_scalar
  double* out;            // [length] a file
  long long mod;
  long long start;        // ring index of buffer index 0, in [0, mod)
  long long init_stride;
  long long window_begin; // its runs of taps in the window table
  long long window_end;
  double init_scalar;
  long long ring_fstride;
  long long stream_fstride;
  long long init_fstride;
  long long out_fstride;
};

// Chain c of the launch as file f sees it.
__device__ __forceinline__ Chain file_chain(const Chain& c, long long f) {
  Chain ch = c;
  ch.ring += f * c.ring_fstride;
  if (ch.stream != nullptr) ch.stream += f * c.stream_fstride;
  if (ch.init != nullptr) ch.init += f * c.init_fstride;
  ch.out += f * c.out_fstride;
  return ch;
}

struct Chains {
  Chain c[kMaxChains];
};

// A window: taps [x, y) of the concatenated tables, min start z, max w.
using Window = int4;

__device__ __forceinline__ double init_at(const Chain& ch, long long t) {
  return ch.init != nullptr ? ch.init[t * ch.init_stride] : ch.init_scalar;
}

// Address of buffer index i (0 <= i < mod + length).
__device__ __forceinline__ const double* at(const Chain& ch, long long i) {
  if (i >= ch.mod) return ch.stream + (i - ch.mod);
  long long r = ch.start + i;
  if (r >= ch.mod) r -= ch.mod;
  return ch.ring + r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp8(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp16(double* dst, const double* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The block copies n doubles, src (global) to dst (shared), asynchronously.
__device__ __forceinline__ void copy_async(double* dst, const double* src,
                                           long long n) {
  if (n <= 0) return;
  const uintptr_t g = reinterpret_cast<uintptr_t>(src);
  if (((g ^ smem_addr(dst)) & 15) != 0) {
    for (long long i = threadIdx.x; i < n; i += kThreads) cp8(dst + i, src + i);
    return;
  }
  const long long head = (g & 15) != 0 ? 1 : 0;
  const long long pairs = (n - head) >> 1;
  if (threadIdx.x == 0 && head) cp8(dst, src);
  if (threadIdx.x == 1 && ((n - head) & 1)) cp8(dst + n - 1, src + n - 1);
  for (long long p = threadIdx.x; p < pairs; p += kThreads) {
    cp16(dst + head + 2 * p, src + head + 2 * p);
  }
}

// The block copies buffer indices [a, b) of the chain to dst: the ring up
// to its end, the ring from its start after the wrap, then the stream.
__device__ __forceinline__ void stage(double* dst, long long a, long long b,
                                      const Chain& ch) {
  long long i = a;
  if (i < ch.mod) {
    const long long e = b < ch.mod ? b : ch.mod;
    long long r = ch.start + i;
    if (r >= ch.mod) r -= ch.mod;
    const long long n1 = e - i < ch.mod - r ? e - i : ch.mod - r;
    copy_async(dst, ch.ring + r, n1);
    copy_async(dst + n1, ch.ring, e - i - n1);
    dst += e - i;
    i = e;
  }
  if (i < b) copy_async(dst, ch.stream + (i - ch.mod), b - i);
}

template <int R>
__device__ __forceinline__ void tap(double (&acc)[R], const double* w,
                                    double g) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r] = __dadd_rn(acc[r], __dmul_rn(g, w[r * kThreads]));
  }
}

// dynamic shared memory: gains [taps], starts [taps] (taps a multiple of
// 4), then the window, one double more than the largest for alignment
template <int R>
__global__ void __launch_bounds__(kThreads)
ring_tap_sum_staged(Chains chains, const int* __restrict__ starts,
                    const double* __restrict__ gains,
                    const Window* __restrict__ windows, long long length,
                    int table_taps) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* sh_g = reinterpret_cast<double*>(smem);
  int* sh_s = reinterpret_cast<int*>(sh_g + table_taps);
  double* sh_w = reinterpret_cast<double*>(sh_s + table_taps);

  const Chain ch = file_chain(chains.c[blockIdx.y], blockIdx.z);
  const long long t0 = static_cast<long long>(blockIdx.x) * (R * kThreads);
  const long long buf_len = ch.mod + (ch.stream != nullptr ? length : 0);
  double acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long t = t0 + threadIdx.x + r * kThreads;
    acc[r] = t < length ? init_at(ch, t) : 0.0;
  }
  for (long long wi = ch.window_begin; wi < ch.window_end; ++wi) {
    const Window win = windows[wi];
    const int n = win.y - win.x;
    const long long a = win.z + t0;
    const long long hi = win.w + t0 + R * kThreads;
    const long long b = hi < buf_len ? hi : buf_len;
    // the first piece's source and the window agree mod 16 bytes
    const int shift = static_cast<int>(
        (reinterpret_cast<uintptr_t>(at(ch, a)) >> 3) & 1);
    double* w = sh_w + shift;
    __syncthreads();   // every read of the previous window is done
    stage(w, a, b, ch);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      sh_s[i] = starts[win.x + i] - win.z;
      sh_g[i] = gains[win.x + i];
    }
    cp_wait_all();
    __syncthreads();
    const double* wt = w + threadIdx.x;
    int k = 0;
    for (; k + 4 <= n; k += 4) {
      const int4 s4 = *reinterpret_cast<const int4*>(sh_s + k);
      const double2 g01 = *reinterpret_cast<const double2*>(sh_g + k);
      const double2 g23 = *reinterpret_cast<const double2*>(sh_g + k + 2);
      tap<R>(acc, wt + s4.x, g01.x);
      tap<R>(acc, wt + s4.y, g01.y);
      tap<R>(acc, wt + s4.z, g23.x);
      tap<R>(acc, wt + s4.w, g23.y);
    }
    for (; k < n; ++k) tap<R>(acc, wt + sh_s[k], sh_g[k]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long t = t0 + threadIdx.x + r * kThreads;
    if (t < length) ch.out[t] = acc[r];
  }
}

__global__ void __launch_bounds__(kThreads)
ring_tap_sum_global(Chains chains, const int* __restrict__ starts,
                    const double* __restrict__ gains,
                    const Window* __restrict__ windows, long long length) {
  __shared__ int s_start[kGlobalTaps];
  __shared__ double s_gain[kGlobalTaps];

  const Chain ch = file_chain(chains.c[blockIdx.y], blockIdx.z);
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = t < length;
  double acc = live ? init_at(ch, t) : 0.0;
  const int k_begin = windows[ch.window_begin].x;
  const int k_end = windows[ch.window_end - 1].y;
  for (int k0 = k_begin; k0 < k_end; k0 += kGlobalTaps) {
    const int count = k_end - k0 < kGlobalTaps ? k_end - k0 : kGlobalTaps;
    __syncthreads();
    for (int i = threadIdx.x; i < count; i += kThreads) {
      s_start[i] = starts[k0 + i];
      s_gain[i] = gains[k0 + i];
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int i = 0; i < count; ++i) {
        acc = __dadd_rn(acc, __dmul_rn(s_gain[i], *at(ch, s_start[i] + t)));
      }
    }
  }
  if (live) ch.out[t] = acc;
}

template <int R>
int launch_staged(const Chains& chains, int n_chains, int files,
                  const int* starts, const double* gains,
                  const Window* windows, long long length, int table_taps,
                  int smem_bytes, cudaStream_t stream) {
  // above 48 KB a block's shared memory is opted into, once for the
  // largest size asked so far
  static int opted = 48 * 1024;
  if (smem_bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        ring_tap_sum_staged<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem_bytes;
  }
  const long long tiles = (length + R * kThreads - 1) / (R * kThreads);
  ring_tap_sum_staged<R><<<dim3(static_cast<unsigned>(tiles), n_chains,
                                files),
                           kThreads, smem_bytes, stream>>>(
      chains, starts, gains, windows, length, table_taps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// chains: [n_chains] of Chain (host memory, passed to the kernel by
// value); starts: [K] i32; gains: [K] f64; windows: [W] of 4 i32.
// files: the batch, 1 to 65535 (the grid's third axis).
// tile: samples a block, 256 * {1, 2, 4, 8}; 0 runs the global kernel.
// table_taps, smem_bytes: the staged kernel's shared memory, computed by
// the caller from the windows (ring_taps.py, TapTables).
extern "C" int zorak_ring_tap_sum(const void* chains, int n_chains,
                                  const void* starts, const void* gains,
                                  const void* windows, long long length,
                                  int files, int tile, int table_taps,
                                  int smem_bytes, void* stream) {
  if (length <= 0 || n_chains <= 0 || files <= 0) return 0;
  if (n_chains > kMaxChains || files > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Chains batch;
  for (int c = 0; c < n_chains; ++c) {
    batch.c[c] = static_cast<const Chain*>(chains)[c];
  }
  const auto* s = static_cast<const int*>(starts);
  const auto* g = static_cast<const double*>(gains);
  const auto* w = static_cast<const Window*>(windows);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: {
      const long long blocks = (length + kThreads - 1) / kThreads;
      ring_tap_sum_global<<<dim3(static_cast<unsigned>(blocks), n_chains,
                                 files),
                            kThreads, 0, st>>>(batch, s, g, w, length);
      return static_cast<int>(cudaGetLastError());
    }
    case kThreads:
      return launch_staged<1>(batch, n_chains, files, s, g, w, length,
                              table_taps, smem_bytes, st);
    case 2 * kThreads:
      return launch_staged<2>(batch, n_chains, files, s, g, w, length,
                              table_taps, smem_bytes, st);
    case 4 * kThreads:
      return launch_staged<4>(batch, n_chains, files, s, g, w, length,
                              table_taps, smem_bytes, st);
    case 8 * kThreads:
      return launch_staged<8>(batch, n_chains, files, s, g, w, length,
                              table_taps, smem_bytes, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
