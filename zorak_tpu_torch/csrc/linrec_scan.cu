// First-order linear recurrences for NVIDIA Hopper (sm_90a), f64:
//
//   z[r][t] = a[r][t] * z[r][t-1] + b[r][t],   z[r][-1] = z0[r]
//
// for k independent rows of L samples, with `a` one value per row or one
// per sample.  Replaces the three doubling-scan solvers of
// zorak_tpu/lowering/eelmath.py (linrec_assoc_scan,
// linrec_doubling_scalar_batch, linrec_doubling_vector_batch), which the
// reference leaves to XLA as ceil(log2 L) stages of shifted multiply-adds.
//
// What bounds it: the bytes, 16 to 24 a sample (a and b read once, z
// written once), if time is cut across threads; one thread walking a row
// is bound instead by its chain of L dependent multiply-adds (8.2 ns a
// step on an H100), and a segment has only one or two rows a wave.
//
// What the design does about it: a chunked affine scan.  z -> a*z + b is
// an affine map, and maps compose, so each row is cut into chunks of
// `chunk` samples and solved in three launches, in a fixed order:
//   1. linrec_chunk_kernel<., false> (compose): a thread per chunk but the
//      last walks its samples once and composes its map z -> A*z + B
//      (A <- a*A, B <- a*B + b), recording A, B and the largest |A| and
//      |B| it passed through (M, N; M = inf where A or B is not finite);
//   2. linrec_carry_kernel: a warp per row, one thread of which walks the
//      maps in order from z0 and writes each chunk's start carry,
//      z <- A*z + B.  Where that step could differ from the sequential
//      loop in more than rounding (A, B or z not finite, or
//      |z|*M + N > 2^1000, so that some sample in the chunk might
//      overflow: one test, |z|*M + N <= 2^1000, fails in every such
//      case), it walks the chunk's samples one by one instead, so NaN
//      and inf land where the sequential loop puts them (a NaN carry
//      stays NaN through a*z + b whatever a and b are: no walk).  The test is
//      off the chain: the thread steps 32 maps, each lane then tests its
//      own map against the carry it was entered with, and the 32 are
//      redone one by one where any test failed;
//   3. linrec_chunk_kernel<., true> (apply): a thread per chunk walks its
//      samples again from its start carry, z <- a*z + b, and writes z.
// Chunk 0 starts from z0, so it equals the sequential loop bit for bit;
// the others differ from it by the rounding of the composed maps (within
// 1e-9 x max|z| on every case drawn; exact where every value is an
// integer below 2^53, as in a sample counter).  The order of every
// operation is fixed, so the result is the same from run to run, and
// kernels/linrec_scan.py's `linrec_chunked` repeats it in NumPy bit for
// bit.  The file is compiled with --fmad=false: multiply and add stay two
// roundings, as in the NumPy mirror.
//
// Memory: a block of phases 1 and 3 is one warp, 32 chunks of one row.  It
// loads a segment of kSeg samples of each of its chunks' b (and a) with
// coalesced loads, a row of 32 contiguous doubles to a load, into
// registers while it walks the segment before, then stores them to a
// tile in shared memory from which each thread reads its own row, so
// that no global load sits on a thread's chain; phase 3's output leaves
// through a tile the same way, as coalesced stores.  (Copies of 8 bytes
// a thread with cp.async, kept in flight several segments deep, cost an
// H100 more than the walk they fed.)
//
// linrec_chain_kernel runs one thread's chain alone, a and b cycling
// through registers with no memory traffic: the floor under a row walked
// by one thread, which this design no longer is.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSeg = 32;           // samples of a chunk staged at once
constexpr int kPitch = kSeg + 1;   // a tile row, padded against bank conflicts
constexpr int kTile = kWarp * kPitch;
constexpr int kBatch = 4;          // groups of 32 maps a lane loads ahead
constexpr int kChain = 32;         // values the chain probe cycles through
constexpr double kSafe = 0x1p1000; // |z| * M + N at most this: no overflow

struct Map {
  double A, B, M, N;  // z -> A*z + B; max |A|, max |B| along the chunk
};

// Phases 1 (kApply false) and 3 (kApply true).  Block (x, row): chunks
// 32x .. 32x + 31 of the row, thread q owning chunk 32x + q.  Phase 1
// covers chunks 0 .. n_chunks - 2 (the last chunk's map is never used),
// phase 3 all of them.
template <bool kVecA, bool kApply>
__global__ void __launch_bounds__(kWarp)
linrec_chunk_kernel(const double* __restrict__ a, const double* __restrict__ b,
                    const double* __restrict__ z0,
                    const double* __restrict__ zs, double* __restrict__ y,
                    Map* __restrict__ maps, long long n, long long chunk,
                    long long n_chunks, long long n_owned) {
  __shared__ double sb[kTile];
  __shared__ double sa[kVecA ? kTile : 1];
  __shared__ double sy[kApply ? kTile : 1];

  const int q = threadIdx.x;
  const long long row = blockIdx.y;
  const long long c0 = static_cast<long long>(blockIdx.x) * kWarp;
  const long long c = c0 + q;
  const bool owner = c < n_owned;
  // samples of this thread's chunk; longest of the block's chunks
  const long long count = owner ? min(chunk, n - c * chunk) : 0;
  const long long span = min(chunk, n - c0 * chunk);
  const long long n_seg = (span + kSeg - 1) / kSeg;
  const double* brow = b + row * n;
  const double* arow = kVecA ? a + row * n : a + row;
  double* yrow = y + row * n;

  // Row i of segment j: samples j*kSeg .. j*kSeg + kSeg - 1 of chunk
  // c0 + i; lane q loads element q of every row (a row is 32 contiguous
  // doubles: one coalesced load a row) into registers, and stores them
  // to the tile once the segment before has been walked.  `whole`: the
  // block's 32 chunks exist and are full.
  const bool whole = c0 + kWarp <= n_owned && (c0 + kWarp) * chunk <= n;
  double pb[kWarp], pa[kVecA ? kWarp : 1];
  auto fetch = [&](long long j) {
    const long long s = j * kSeg + q;
#pragma unroll
    for (int i = 0; i < kWarp; ++i) {
      const long long ci = c0 + i;
      const bool ok = whole ? s < chunk
                            : ci < n_owned && s < min(chunk, n - ci * chunk);
      const long long t = ci * chunk + s;
      pb[i] = ok ? brow[t] : 0.0;
      if (kVecA) pa[i] = ok ? arow[t] : 0.0;
    }
  };
  auto store = [&](long long j) {
    const long long s = j * kSeg + q;
#pragma unroll
    for (int i = 0; i < kWarp; ++i) {
      const long long ci = c0 + i;
      const bool ok = whole ? s < chunk
                            : ci < n_owned && s < min(chunk, n - ci * chunk);
      if (ok) yrow[ci * chunk + s] = sy[i * kPitch + q];
    }
  };

  const double a_row = kVecA ? 0.0 : arow[0];
  double z = 0.0, A = 1.0, B = 0.0, M = 0.0, N = 0.0;
  if (kApply && owner) z = c == 0 ? z0[row] : zs[row * n_chunks + c];

  fetch(0);
  for (long long j = 0; j < n_seg; ++j) {
    __syncwarp();               // the tiles of segment j - 1 are read
#pragma unroll
    for (int i = 0; i < kWarp; ++i) {
      sb[i * kPitch + q] = pb[i];
      if (kVecA) sa[i * kPitch + q] = pa[i];
    }
    __syncwarp();               // segment j is in the tile
    if (j + 1 < n_seg) fetch(j + 1);   // lands while segment j is walked
    const double* xb = sb + q * kPitch;
    const double* xa = sa + q * kPitch;
    double* yo = sy + q * kPitch;
    const long long left = count - j * kSeg;   // samples of mine left
    if (left >= kSeg) {
#pragma unroll
      for (int k = 0; k < kSeg; ++k) {
        const double av = kVecA ? xa[k] : a_row;
        if (kApply) {
          z = av * z + xb[k];
          yo[k] = z;
        } else {
          A = av * A;
          B = av * B + xb[k];
          M = fmax(M, fabs(A));
          N = fmax(N, fabs(B));
        }
      }
    } else {
      for (int k = 0; k < left; ++k) {
        const double av = kVecA ? xa[k] : a_row;
        if (kApply) {
          z = av * z + xb[k];
          yo[k] = z;
        } else {
          A = av * A;
          B = av * B + xb[k];
          M = fmax(M, fabs(A));
          N = fmax(N, fabs(B));
        }
      }
    }
    if (kApply) {
      __syncwarp();             // segment j's output is in the tile
      store(j);
    }
  }
  if (!kApply && owner) {
    Map m;
    m.A = A;
    m.B = B;
    m.M = isfinite(A) && isfinite(B) ? M : INFINITY;
    m.N = N;
    maps[row * (n_chunks - 1) + c] = m;
  }
}

// Phase 2.  Block `row`, one warp.  Lane q holds map g0 + q of each group
// of 32 (kBatch groups loaded ahead); thread 0 walks a group's maps from
// shared memory, z <- A*z + B, nothing else on its chain; then each lane
// tests its own map against the carry it was entered with, and where any
// test failed thread 0 walks the group again, a chunk at a time, walking
// the samples of each chunk whose test fails.  zs[row][c] for c >= 1
// (chunk 0 starts from z0).
template <bool kVecA>
__global__ void __launch_bounds__(kWarp)
linrec_carry_kernel(const double* __restrict__ a, const double* __restrict__ b,
                    const double* __restrict__ z0, const Map* __restrict__ maps,
                    double* __restrict__ zs, long long n, long long chunk,
                    long long n_chunks) {
  __shared__ Map sm[kWarp];
  __shared__ double sz[kWarp + 1];  // sz[0]: the group's entry carry
  const int q = threadIdx.x;
  const long long row = blockIdx.x;
  const long long n_maps = n_chunks - 1;
  const Map* mrow = maps + row * n_maps;
  const double* brow = b + row * n;
  const double* arow = kVecA ? a + row * n : a + row;
  Map next[kBatch];
  auto load = [&](long long b0) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (b0 + u * kWarp + q < n_maps) next[u] = mrow[b0 + u * kWarp + q];
  };
  if (q == 0) sz[0] = z0[row];
  load(0);
  for (long long b0 = 0; b0 < n_maps; b0 += kBatch * kWarp) {
    Map cur[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) cur[u] = next[u];
    if (b0 + kBatch * kWarp < n_maps) load(b0 + kBatch * kWarp);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long g0 = b0 + u * kWarp;
      if (g0 >= n_maps) break;
      const int count = static_cast<int>(min(static_cast<long long>(kWarp),
                                             n_maps - g0));
      sm[q] = cur[u];
      __syncwarp();
      if (q == 0) {
        double zz = sz[0];
#pragma unroll
        for (int g = 0; g < kWarp; ++g) {
          if (g < count) {
            zz = sm[g].A * zz + sm[g].B;
            sz[g + 1] = zz;
          }
        }
      }
      __syncwarp();
      const bool ok = q >= count || fabs(sz[q]) * cur[u].M + cur[u].N <= kSafe;
      if (!__all_sync(0xffffffffu, ok) && q == 0) {
        double zz = sz[0];
        for (int g = 0; g < count; ++g) {
          const Map m = sm[g];
          if (fabs(zz) * m.M + m.N <= kSafe) {
            zz = m.A * zz + m.B;
          } else if (!isnan(zz)) {  // the chunk's samples, as the loop has
            // them; a NaN carry stays NaN through any a and b
            const long long t0 = (g0 + g) * chunk;
            for (long long t = t0; t < t0 + chunk; ++t)
              zz = (kVecA ? arow[t] : arow[0]) * zz + brow[t];
          }
          sz[g + 1] = zz;
        }
      }
      __syncwarp();
      if (q < count) zs[row * n_chunks + g0 + q + 1] = sz[q + 1];
      __syncwarp();
      if (q == 0) sz[0] = sz[count];
      __syncwarp();
    }
  }
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

template <bool kVecA>
int launch(const double* a, const double* b, const double* z0, double* y,
           double* ws, long long k, long long n, long long chunk,
           cudaStream_t s) {
  const long long n_chunks = (n + chunk - 1) / chunk;
  // ws: maps [k][n_chunks - 1], then start carries [k][n_chunks]
  Map* maps = reinterpret_cast<Map*>(ws);
  double* zs = ws + 4 * k * (n_chunks - 1);
  const unsigned rows = static_cast<unsigned>(k);
  if (n_chunks > 1) {
    const dim3 grid(static_cast<unsigned>((n_chunks - 1 + kWarp - 1) / kWarp),
                    rows);
    linrec_chunk_kernel<kVecA, false><<<grid, kWarp, 0, s>>>(
        a, b, z0, zs, y, maps, n, chunk, n_chunks, n_chunks - 1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    linrec_carry_kernel<kVecA><<<rows, kWarp, 0, s>>>(a, b, z0, maps, zs, n,
                                                       chunk, n_chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((n_chunks + kWarp - 1) / kWarp), rows);
  linrec_chunk_kernel<kVecA, true><<<grid, kWarp, 0, s>>>(
      a, b, z0, zs, y, maps, n, chunk, n_chunks, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: [k] (vec_a == 0) or [k, n]; b, y: [k, n]; z0: [k]; ws: at least
// 5 * k * ceil(n / chunk) f64 of scratch; all f64, contiguous; k rows of
// the grid's y dimension (k <= 65535).
extern "C" int zorak_linrec_scan(const void* a, const void* b, const void* z0,
                                 void* y, void* ws, long long k, long long n,
                                 long long chunk, int vec_a, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (k <= 0 || n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* av = static_cast<const double*>(a);
  const auto* bv = static_cast<const double*>(b);
  const auto* zv = static_cast<const double*>(z0);
  auto* yv = static_cast<double*>(y);
  auto* wv = static_cast<double*>(ws);
  return vec_a ? launch<true>(av, bv, zv, yv, wv, k, n, chunk, s)
               : launch<false>(av, bv, zv, yv, wv, k, n, chunk, s);
}

// a, b: [32]; z0, z_out: [1].
extern "C" int zorak_linrec_chain(const void* a, const void* b, const void* z0,
                                  void* z_out, long long n, void* stream) {
  linrec_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(a), static_cast<const double*>(b),
      static_cast<const double*>(z0), static_cast<double*>(z_out), n);
  return static_cast<int>(cudaGetLastError());
}
