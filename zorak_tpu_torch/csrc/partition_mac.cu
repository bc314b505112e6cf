// The frequency-domain multiply-accumulate of uniform partitioned
// convolution for NVIDIA Hopper (sm_90a), complex64:
//
//   Y[l][f][b] = scale * sum over p = 0 .. parts-1, ascending, of
//                X[l][f-p][b] * H[p][b]
//
// with X[l][g] = 0 for g < 0 (the zero history rows of the reference),
// each complex product written out as (xr*hr - xi*hi, xr*hi + xi*hr), and
// `scale` a power of two (irfft's 1/N, folded in exactly).  Replaces the
// `mac` scan of `partitioned_convolve`,
// zorak_tpu/kernels/convolution.py:73-80, which XLA runs as `parts` passes
// of a multiply-add over the whole [frames, bins] spectrum, reading and
// writing the accumulator each time (so does a plain PyTorch loop).
//
// What bounds it on an H100: the operations.  A complex MAC is 8 f32
// instructions (4 multiplies, 4 adds; no contraction), 1.97 G MACs at the
// bench shape (32 lanes x 469 frames x 2,049 bins x 64 partitions), about
// 0.47 ms at the FP32 instruction rate, where the bytes (X and H read once,
// Y written once) allow 0.15 ms.  The FP32 pipe takes one warp instruction
// a clock on each SM sub-partition, so every other instruction (a load, an
// index, a predicate) costs a slot the MACs could have had.
//
// What the design does about it (partition_mac.cuh holds the walk):
// partitions outermost, over a window of R input frames in registers.  A
// thread owns R output frames of one bin; each step p costs one shared
// load of the new frame X[f0 - p], one of H[p] and R complex MACs with no
// predicate, about 8R + 3 slots for 8R useful ones.  A block (32 bins x W
// warps x R frames) stages with cp.async the X rows and H rows of a group
// of 64 partitions in shared memory (zeros for history rows, a ragged
// frame tile and bins past the last), so X is read from device memory
// about (W*R + 63) / (W*R) times and H, 1 MB, stays in L2; where there is
// more than one group, the next is staged while this one is walked.
// Compiled with --fmad=false: every multiply and add rounds on its own, as
// in the plain PyTorch version (kernels/convolution.py), which it equals
// bit for bit.
//
// The earlier design (a thread walks the input frames newest first into
// 16 accumulators, one predicated shared load of H a MAC) stays under
// `zorak_partition_mac_earlier`, for timing against this one only.
//
// Plain C interface (loaded with ctypes); an entry point returns
// cudaGetLastError() after its launch, 0 when the launch was accepted.
//
// Built with a host C++ compiler instead of nvcc (no __CUDACC__), the file
// is its host form: `zorak_partition_mac_host` runs the same walk, block
// after block and thread after thread, with plain copies for cp.async.

#include "partition_mac.cuh"

// (R, W, PG) of the device kernels: frames a thread, warps a block,
// partitions a group.  The first is the default (kernels/convolution.py).
#define PM_DEVICE_TILES(X) X(16, 8, 64) X(16, 4, 64) X(32, 4, 64) X(32, 2, 64)

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 8 bytes from src into shared memory, or 8 zero bytes where !valid
// (src is then any readable address; nothing is read from it)
__device__ __forceinline__ void cp8(PmC* dst, const PmC* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The block copies the stage of the group that starts at partition p0:
// warp w the rows w, w + W, ..., lane bl the bin b0 + bl of each (offsets
// carried from row to row: the copies are most of a block's non-MAC work).
template <int R, int W, int PG>
__device__ __forceinline__ void stage_group(PmC* s, const PmC* xl,
                                            const PmC* h, int f_blk, int b0,
                                            int p0, int n_frames, int bins,
                                            int parts) {
  using T = PmTile<R, W, PG>;
  const int b = b0 + threadIdx.x;
  const bool in_bins = b < bins;
  PmC* dst = s + threadIdx.y * kPmBins + threadIdx.x;
  int g = T::row_frame(f_blk, p0, threadIdx.y);
  long long off = (long long)g * bins + b;  // of X[g][b] in the lane
  for (int r = threadIdx.y; r < T::kRows; r += W) {
    const bool ok = in_bins && (unsigned)g < (unsigned)n_frames;
    cp8(dst, xl + (ok ? off : 0), ok);
    dst += W * kPmBins;
    g += W;
    off += (long long)W * bins;
  }
  dst = s + (T::kRows + threadIdx.y) * kPmBins + threadIdx.x;
  int p = p0 + threadIdx.y;
  off = (long long)p * bins + b;  // of H[p][b]
  for (int r = threadIdx.y; r < PG; r += W) {
    const bool ok = in_bins && p < parts;
    cp8(dst, h + (ok ? off : 0), ok);
    dst += W * kPmBins;
    p += W;
    off += (long long)W * bins;
  }
}

template <int R, int W, int PG>
__global__ void __launch_bounds__(kPmBins * W)
partition_mac_kernel(const PmC* __restrict__ x, const PmC* __restrict__ h,
                     PmC* __restrict__ y, int n_frames, int bins, int parts,
                     float scale) {
  using T = PmTile<R, W, PG>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PmC* smem = reinterpret_cast<PmC*>(smem_raw);
  const int bl = threadIdx.x, w = threadIdx.y;
  const int b0 = blockIdx.x * kPmBins;
  const int f_blk = blockIdx.y * T::kFrames;
  const int f0 = f_blk + w * R;
  const long long lane_off = (long long)blockIdx.z * n_frames * bins;
  const PmC* xl = x + lane_off;
  const int groups = (parts + PG - 1) / PG;

  stage_group<R, W, PG>(smem, xl, h, f_blk, b0, 0, n_frames, bins, parts);
  cp_commit();
  PmThread<R> t;
  for (int k = 0; k < groups; ++k) {
    const PmC* cur = smem + (k & 1) * T::kStage;
    if (k + 1 < groups) {  // stage the next group while this one is walked
      stage_group<R, W, PG>(smem + ((k + 1) & 1) * T::kStage, xl, h, f_blk,
                            b0, (k + 1) * PG, n_frames, bins, parts);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (f0 < n_frames) {  // a warp wholly past the last frame only stages
      if (k == 0) pm_begin<R, PG>(t, cur, w, bl);
      pm_group<R, PG>(t, cur, cur + T::kRows * kPmBins, w, bl,
                      min(PG, parts - k * PG));
    }
    __syncthreads();  // every warp is done with `cur` before it is restaged
  }
  const int b = b0 + bl;
  if (f0 >= n_frames || b >= bins) return;
  PmC* yl = y + lane_off;
  PM_UNROLL
  for (int j = 0; j < R; ++j)
    if (f0 + j < n_frames)
      yl[(long long)(f0 + j) * bins + b] = pm_result<R>(t, j, scale);
}

template <int R, int W, int PG>
int launch(const PmC* x, const PmC* h, PmC* y, long long lanes,
           long long n_frames, long long bins, long long parts, float scale,
           cudaStream_t stream) {
  using T = PmTile<R, W, PG>;
  const long long tiles = (n_frames + T::kFrames - 1) / T::kFrames;
  if (tiles > 65535 || lanes > 65535) return cudaErrorInvalidConfiguration;
  // two stages where there is a next group to stage ahead
  const int smem = (parts > PG ? 2 : 1) * T::kStage * (int)sizeof(PmC);
  // above 48 KB a block's shared memory is opted into, once for the
  // largest size asked so far
  static int opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        partition_mac_kernel<R, W, PG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  const dim3 grid((unsigned)((bins + kPmBins - 1) / kPmBins), (unsigned)tiles,
                  (unsigned)lanes);
  partition_mac_kernel<R, W, PG><<<grid, dim3(kPmBins, W), smem, stream>>>(
      x, h, y, (int)n_frames, (int)bins, (int)parts, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- the earlier design, for timing against this one only -----------------
namespace earlier {

constexpr int kBins = 32;    // bins a block: one warp's lanes
constexpr int kWarps = 8;    // frame tiles a block, one a warp
constexpr int kFrames = 16;  // output frames a thread, in registers
constexpr int kParts = 64;   // partitions staged in shared memory at once

__global__ void __launch_bounds__(kBins * kWarps)
partition_mac_earlier_kernel(const float2* __restrict__ x,
                          const float2* __restrict__ h,
                          float2* __restrict__ y, int n_frames, int bins,
                          int parts) {
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

}  // namespace earlier
}  // namespace

// x, y: [lanes, n_frames, bins] complex64 (re, im interleaved);
// h: [parts, bins] complex64; scale a power of two; (r, w, pg) one of
// PM_DEVICE_TILES (cudaErrorInvalidValue otherwise).
extern "C" int zorak_partition_mac(const void* x, const void* h, void* y,
                                   long long lanes, long long n_frames,
                                   long long bins, long long parts,
                                   float scale, int r, int w, int pg,
                                   void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (lanes <= 0 || n_frames <= 0 || bins <= 0) return 0;
  const PmC* xc = static_cast<const PmC*>(x);
  const PmC* hc = static_cast<const PmC*>(h);
  PmC* yc = static_cast<PmC*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PM_LAUNCH(R, W, PG)                                               \
  if (r == R && w == W && pg == PG)                                       \
    return launch<R, W, PG>(xc, hc, yc, lanes, n_frames, bins, parts,     \
                            scale, s);
  PM_DEVICE_TILES(PM_LAUNCH)
#undef PM_LAUNCH
  return cudaErrorInvalidValue;
}

// The earlier design (no scale, its one tile), for timing only.
extern "C" int zorak_partition_mac_earlier(const void* x, const void* h,
                                           void* y, long long lanes,
                                           long long n_frames, long long bins,
                                           long long parts, void* stream) {
  using namespace earlier;
  cudaGetLastError();
  if (lanes <= 0 || n_frames <= 0 || bins <= 0) return 0;
  const dim3 grid((unsigned)((bins + kBins - 1) / kBins),
                  (unsigned)((n_frames + kFrames * kWarps - 1)
                             / (kFrames * kWarps)),
                  (unsigned)lanes);
  partition_mac_earlier_kernel<<<grid, dim3(kBins, kWarps), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(h),
      static_cast<float2*>(y), (int)n_frames, (int)bins, (int)parts);
  return static_cast<int>(cudaGetLastError());
}

#else  // the host form

#include <algorithm>
#include <vector>

namespace {

// The kernel's blocks one after another; in a block each group is staged
// (plain copies, zeros where cp.async zero-fills), then every thread
// walks it, as the kernel's warps do between its two barriers.
template <int R, int W, int PG>
void host_walk(const PmC* x, const PmC* h, PmC* y, long long lanes,
               int n_frames, int bins, int parts, float scale) {
  using T = PmTile<R, W, PG>;
  std::vector<PmC> stage(T::kStage);
  std::vector<PmThread<R>> threads(W * kPmBins);
  const int groups = (parts + PG - 1) / PG;
  for (long long l = 0; l < lanes; ++l) {
    const PmC* xl = x + l * n_frames * bins;
    PmC* yl = y + l * n_frames * bins;
    for (int f_blk = 0; f_blk < n_frames; f_blk += T::kFrames) {
      for (int b0 = 0; b0 < bins; b0 += kPmBins) {
        for (int k = 0; k < groups; ++k) {
          for (int r = 0; r < T::kRows; ++r) {
            const int g = T::row_frame(f_blk, k * PG, r);
            for (int bl = 0; bl < kPmBins; ++bl) {
              const int b = b0 + bl;
              stage[r * kPmBins + bl] = b < bins && g >= 0 && g < n_frames
                                            ? xl[(long long)g * bins + b]
                                            : PmC{0.0f, 0.0f};
            }
          }
          PmC* hs = stage.data() + T::kRows * kPmBins;
          for (int r = 0; r < PG; ++r) {
            const int p = k * PG + r;
            for (int bl = 0; bl < kPmBins; ++bl) {
              const int b = b0 + bl;
              hs[r * kPmBins + bl] = b < bins && p < parts
                                         ? h[(long long)p * bins + b]
                                         : PmC{0.0f, 0.0f};
            }
          }
          for (int w = 0; w < W; ++w) {
            if (f_blk + w * R >= n_frames) continue;
            for (int bl = 0; bl < kPmBins; ++bl) {
              PmThread<R>& t = threads[w * kPmBins + bl];
              if (k == 0) pm_begin<R, PG>(t, stage.data(), w, bl);
              pm_group<R, PG>(t, stage.data(), hs, w, bl,
                              std::min(PG, parts - k * PG));
            }
          }
        }
        for (int w = 0; w < W; ++w) {
          const int f0 = f_blk + w * R;
          for (int bl = 0; bl < kPmBins && b0 + bl < bins; ++bl)
            for (int j = 0; j < R && f0 + j < n_frames; ++j)
              yl[(long long)(f0 + j) * bins + b0 + bl] =
                  pm_result<R>(threads[w * kPmBins + bl], j, scale);
        }
      }
    }
  }
}

}  // namespace

// As zorak_partition_mac, on host memory; (r, w, pg) one of
// PM_DEVICE_TILES or (4, 2, 8), a small walk for tests.  Returns 0, or -1
// for a tile it does not have.
extern "C" int zorak_partition_mac_host(const void* x, const void* h, void* y,
                                        long long lanes, long long n_frames,
                                        long long bins, long long parts,
                                        float scale, int r, int w, int pg) {
  const PmC* xc = static_cast<const PmC*>(x);
  const PmC* hc = static_cast<const PmC*>(h);
  PmC* yc = static_cast<PmC*>(y);
#define PM_WALK(R, W, PG)                                                 \
  if (r == R && w == W && pg == PG) {                                     \
    host_walk<R, W, PG>(xc, hc, yc, lanes, (int)n_frames, (int)bins,      \
                        (int)parts, scale);                               \
    return 0;                                                             \
  }
  PM_DEVICE_TILES(PM_WALK)
  PM_WALK(4, 2, 8)
#undef PM_WALK
  return -1;
}

#endif  // __CUDACC__
