// First-order linear recurrences for NVIDIA Hopper (sm_90a), f64:
//
//   z[r][t] = a[r][t] * z[r][t-1] + b[r][t],   z[r][-1] = z0[r]
//
// for k independent rows of L samples, with `a` one value per row or one
// per sample.  Replaces the three doubling-scan solvers of
// zorak_tpu/lowering/eelmath.py (linrec_assoc_scan,
// linrec_doubling_scalar_batch, linrec_doubling_vector_batch), which the
// reference leaves to XLA as ceil(log2 L) stages of shifted multiply-adds.
// In eager PyTorch each stage is several launches and a full pass over
// [k, L]; this kernel reads a and b once and writes z once.
//
// What bounds it: the recurrence is a chain of L dependent multiply-adds
// per row, and a segment has few rows (one or two a channel), so the chain
// of one row, not the 16 to 24 bytes a step moves, is the limit.
//
// What the design does about it: the simple one.  A block owns one row.
// Thread 0 walks time with `z = a * z + b`, multiply and add as two
// roundings (the file is compiled with --fmad=false), which is the
// sequential golden's own order, so the result equals a sequential loop
// bit for bit.  Nothing but the chain is left on that thread: the block's
// other warps stage the row through shared memory in tiles of kTile
// samples with cp.async, one tile ahead, and write the tile before back
// with coalesced stores while thread 0 walks, one barrier a tile.  Thread
// 0 holds kUnroll steps in registers; its loads of the next kUnroll and
// its stores of these are 16 bytes each and sit between the chain's
// steps, so they issue while the chain waits on itself.  Rows run side
// by side on their own SMs.  The doubling order of the plain PyTorch
// versions (zorak_tpu_torch/lowering/eelmath.py) differs from this order
// by rounding only.
//
// linrec_chain_kernel runs the chain alone, a and b cycling through
// registers with no memory traffic, to measure the floor under a row.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128; // warp 0 walks, the other warps copy
constexpr int kTile = 512;    // samples of a row staged at once
constexpr int kUnroll = 16;   // steps the walking thread holds in registers
constexpr int kChain = 32;    // values the chain probe cycles through

// Copies 8 bytes, or writes zeros where `valid` is false (the source is
// then not read), so that the ragged last tile needs no branch.
__device__ __forceinline__ void cp_async8(double* smem, const double* gmem,
                                          bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n cp.async.wait_group 0;\n" ::);
}

// kVecA: a is [k, n] (one coefficient a sample); else a is [k].
template <bool kVecA>
__global__ void __launch_bounds__(kThreads)
linrec_scan_kernel(const double* __restrict__ a, const double* __restrict__ b,
                   const double* __restrict__ z0, double* __restrict__ y,
                   long long n) {
  __shared__ __align__(16) double sb[2][kTile];
  __shared__ __align__(16) double sa[kVecA ? 2 : 1][kVecA ? kTile : 2];
  __shared__ __align__(16) double so[2][kTile];

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const bool copier = tid >= kWarp;
  const int cid = tid - kWarp;                 // index among the copiers
  constexpr int kCopiers = kThreads - kWarp;
  const double* brow = b + row * n;
  const double* arow = kVecA ? a + row * n : a + row;
  double* yrow = y + row * n;
  const long long tiles = (n + kTile - 1) / kTile;

  auto stage = [&](long long tile, int buf) {
    const long long base = tile * kTile;
    for (int i = cid; i < kTile; i += kCopiers) {
      const bool ok = base + i < n;
      const long long t = ok ? base + i : 0;
      cp_async8(&sb[buf][i], brow + t, ok);
      if (kVecA) cp_async8(&sa[buf][i], arow + t, ok);
    }
  };
  auto write_back = [&](long long tile, int buf) {
    const long long base = tile * kTile;
    for (int i = cid; i < kTile && base + i < n; i += kCopiers)
      yrow[base + i] = so[buf][i];
  };

  if (copier) {
    stage(0, 0);
    cp_async_wait_all();
  }
  __syncthreads();
  double z = z0[row];
  const double a_row = kVecA ? 0.0 : arow[0];
  for (long long tile = 0; tile < tiles; ++tile) {
    const int buf = static_cast<int>(tile & 1);
    if (copier) {
      // the tile ahead comes in and the tile before goes out while
      // thread 0 walks this one
      if (tile + 1 < tiles) stage(tile + 1, buf ^ 1);
      if (tile > 0) write_back(tile - 1, buf ^ 1);
      cp_async_wait_all();
    } else if (tid == 0) {
      const long long base = tile * kTile;
      const int count =
          static_cast<int>(n - base < kTile ? n - base : kTile);
      // blocks of kUnroll steps: this block's operands sit in registers,
      // the next block's loads and this block's stores (16 bytes each)
      // are spread between the chain's steps, where the thread would
      // otherwise wait for the multiply and the add before it
      const double2* sb2 = reinterpret_cast<const double2*>(sb[buf]);
      const double2* sa2 = reinterpret_cast<const double2*>(sa[buf]);
      double2* so2 = reinterpret_cast<double2*>(so[buf]);
      double2 bv[kUnroll / 2], av[kUnroll / 2], bn[kUnroll / 2],
          an[kUnroll / 2];
      const int full = count / kUnroll * kUnroll;
      if (full > 0) {
#pragma unroll
        for (int j = 0; j < kUnroll / 2; ++j) {
          bn[j] = sb2[j];
          an[j] = kVecA ? sa2[j] : make_double2(a_row, a_row);
        }
      }
      for (int i0 = 0; i0 < full; i0 += kUnroll) {
        const bool more = i0 + kUnroll < full;
#pragma unroll
        for (int j = 0; j < kUnroll / 2; ++j) {
          bv[j] = bn[j];
          av[j] = an[j];
        }
#pragma unroll
        for (int j = 0; j < kUnroll / 2; ++j) {
          if (more) {
            bn[j] = sb2[(i0 + kUnroll) / 2 + j];
            if (kVecA) an[j] = sa2[(i0 + kUnroll) / 2 + j];
          }
          double2 o;
          z = av[j].x * z + bv[j].x;
          o.x = z;
          z = av[j].y * z + bv[j].y;
          o.y = z;
          so2[i0 / 2 + j] = o;
        }
      }
      for (int i = full; i < count; ++i) {   // the ragged end of a row
        z = (kVecA ? sa[buf][i] : a_row) * z + sb[buf][i];
        so[buf][i] = z;
      }
    }
    __syncthreads();
  }
  if (copier) write_back(tiles - 1, static_cast<int>((tiles - 1) & 1));
}

// One thread, n / kChain * kChain steps, a and b from registers.
__global__ void linrec_chain_kernel(const double* __restrict__ a,
                                    const double* __restrict__ b,
                                    const double* __restrict__ z0,
                                    double* __restrict__ z_out, long long n) {
  double av[kChain], bv[kChain];
#pragma unroll
  for (int i = 0; i < kChain; ++i) {
    av[i] = a[i];
    bv[i] = b[i];
  }
  double z = z0[0];
  for (long long t = 0; t + kChain <= n; t += kChain) {
#pragma unroll
    for (int i = 0; i < kChain; ++i) z = av[i] * z + bv[i];
  }
  z_out[0] = z;
}

}  // namespace

// a: [k] (vec_a == 0) or [k, n]; b, y: [k, n]; z0: [k]; all f64, contiguous.
extern "C" int zorak_linrec_scan(const void* a, const void* b, const void* z0,
                                 void* y, long long k, long long n, int vec_a,
                                 void* stream) {
  if (k <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(k));
  if (vec_a) {
    linrec_scan_kernel<true><<<grid, kThreads, 0, s>>>(
        static_cast<const double*>(a), static_cast<const double*>(b),
        static_cast<const double*>(z0), static_cast<double*>(y), n);
  } else {
    linrec_scan_kernel<false><<<grid, kThreads, 0, s>>>(
        static_cast<const double*>(a), static_cast<const double*>(b),
        static_cast<const double*>(z0), static_cast<double*>(y), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// a, b: [32]; z0, z_out: [1].
extern "C" int zorak_linrec_chain(const void* a, const void* b, const void* z0,
                                  void* z_out, long long n, void* stream) {
  linrec_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(a), static_cast<const double*>(b),
      static_cast<const double*>(z0), static_cast<double*>(z_out), n);
  return static_cast<int>(cudaGetLastError());
}
