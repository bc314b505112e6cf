// The Faust stages' recurrences and noise for NVIDIA Hopper (sm_90a), f64:
//
//   affine_scan (K9a)   z[t] = a[t] * z[t-1] + b[t]: `onepole` (b = (1.0 -
//                       a) * x, formed here in that order) and `integrator`
//                       (b = x); the pole one value a call or one a sample
//   maxplus_scan (K9b)  z[t] = max(a * z[t-1], x[t]): `max_follower`,
//                       max as torch.maximum (NaN wins)
//   biquad_scan (K9c)   the transposed direct-form II biquad: the state
//                       s' = M s + v * x[t], M = [[-a1, 1], [-a2, 0]] and
//                       v = (b1 - a1*b0, b2 - a2*b0), and y[t] = b0 * x[t]
//                       + s[0] before sample t
//   lcg_noise (K9d)     Faust's int32 LCG, s <- 1103515245 * s + 12345 mod
//                       2^32, the k-th output the (k+1)-th state read as
//                       int32 over 2^31
//
// Replaces zorak_tpu/models/dspkit.py's onepole (:52), integrator (:66),
// max_follower (:78) and biquad_tf2 (:138), each a lax.associative_scan
// that the reference leaves to XLA, and lcg_noise (:244), a host loop.  In
// plain PyTorch each scan is a Hillis-Steele doubling ladder of about 22
// stages of several tensor ops at T = 2,880,000, and the noise an int64
// doubling ladder of the same depth (kernels/dsp_scan.py's *_plain).
//
// What bounds them: the bytes, x read and y written once (46 MB a 60 s
// channel), 13.8 us on an H100; the noise only writes (6.9 us).  A row has
// one to eight rows beside it, so the work must spread across time.
//
// What the design does about it (K9a-c): a chunked scan in three launches,
// in an order fixed by the position in the row alone, so that a row's
// result does not depend on the rows beside it or on the grid:
//   1. walk (compose): a thread a chunk of kChunk samples composes the
//      chunk's map from its samples, x (and a per-sample pole) staged
//      through shared memory with coalesced loads, a segment's loads in
//      flight while the one before is walked;
//   2. carry: a block a row scans the row's chunk maps in parallel, tile by
//      tile of kTileMaps maps: each of kScanThreads threads composes its
//      kPerThread maps in order (thread 0's first map applied to the tile's
//      carry, so that every composite's value is a state), a Hillis-Steele
//      scan across the threads in shared memory (strides 1, 2, .., 512),
//      then each thread applies its maps again from the state before them
//      and writes each chunk's start state; the tile's last state carries
//      into the next tile;
//   3. walk (apply): a thread a chunk walks its samples again from its
//      start state and writes y, staged out through shared memory.
// The maps and start states lie in the scratch in the carry block's order
// (ds_slot), so that its loads and stores are coalesced (in chunk order a
// warp's load touches 32 lines); scripts/dsp_scan_phases.py times the
// phases.  The walk is specialised on a per-sample pole, which a scalar
// pole's call does not stage.
// For the biquad M is the same in every chunk, so a chunk's map is the pair
// (M^kChunk, w) and only w is scanned: the matrices a composite needs are
// M^(2^j), squared from M by thread 0 of the carry block.  Chunk 0 walks
// from z0 as the sequential loop does; the others start from the scanned
// states, which differ from the ladder's by rounding (within 1e-9 x
// max|y| on every case drawn).  NaN propagates forward in every order.  An
// infinite state meeting a product of poles that underflowed to 0 gives
// NaN (0 * inf), in the ladder and here, at places the two orders put
// differently; with no product underflowing, inf lands as in the ladder.
//
// K9d: a thread per index of a grid-stride loop; each thread jumps to its
// first index by composing the affine step in uint32 (which wraps mod 2^32
// natively) by squaring, then steps by the grid's stride, the composed
// map of that many steps.  Exact: equal to the host loop bit for bit.
//
// Plain C interface (loaded with ctypes): an entry point takes a pointer to
// its argument struct (the layout of dsp_scan.py's ctypes structures, every
// field 8 bytes) and a stream, and returns cudaGetLastError(), 0 when every
// launch was accepted.  Built with --fmad=false: multiply and add round
// apart, as in the host form.
//
// Built with a host C++ compiler instead of nvcc (no __CUDACC__), the file
// is its host form: the `_host` entry points run the same arithmetic in the
// same order (the block scan as a loop over its strides), for tests where
// there is no GPU.

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DS_HD __host__ __device__ __forceinline__
#define DS_UNROLL _Pragma("unroll")
#else
#define DS_HD inline
#define DS_UNROLL
#endif

namespace {

constexpr long long kChunk = 128;     // samples of a chunk
constexpr int kChunkLog = 7;          // kChunk = 2^kChunkLog
constexpr int kPerThread = 8;         // maps a scanning thread composes
constexpr int kPerThreadLog = 3;
constexpr int kScanThreads = 1024;    // threads of the carry block
constexpr int kScanSteps = 10;        // log2(kScanThreads)
constexpr long long kTileMaps = kPerThread * kScanThreads;
constexpr int kPowers = kChunkLog + kPerThreadLog + kScanSteps;  // M^(2^j)
constexpr int kWalkThreads = 64;      // chunks of a walking block
constexpr int kSeg = 32;              // samples of each chunk staged at once
constexpr int kPitch = kSeg + 1;      // a tile row, padded against conflicts
constexpr int kLcgThreads = 256;
constexpr long long kLcgBlocks = 1056;   // 8 blocks an SM of 132
constexpr uint32_t kLcgA = 1103515245u;
constexpr uint32_t kLcgC = 12345u;

static_assert(kChunk == (1 << kChunkLog), "kChunk is 2^kChunkLog");
static_assert(kPerThread == (1 << kPerThreadLog), "kPerThread is a power");
static_assert(kScanThreads == (1 << kScanSteps), "kScanThreads is a power");
static_assert(kChunk % kSeg == 0, "a chunk is whole segments");

enum : long long { kOnepole = 0, kIntegrator = 1, kMaxplus = 2, kBiquad = 3 };

struct DsScanArgs {
  const double* x;       // x[r * x_rs + t]
  long long x_rs;
  const double* a;       // the pole a[r * a_rs + t * a_ts]; null: a_value
  long long a_rs, a_ts;
  double a_value;
  const double* z0;      // the carry into chunk 0, z0[r * z0_rs]; null:
  long long z0_rs;       // z0_value (K9a, K9b)
  double z0_value;
  double b0, v0, v1, na1, na2, s0, s1;   // K9c: -a1, -a2; s the start state
  double* y;             // [rows, length] contiguous
  double* ws;            // the scratch, ws_n doubles: maps, start states
  long long ws_n;
  long long rows, length, kind;
};

struct DsLcgArgs {
  double* out;           // [n]
  long long n, seed;
};

// ---- the arithmetic every form shares ------------------------------------

// torch.maximum: NaN where either is NaN
DS_HD double ds_max(double u, double v) {
  if (u != u) return u;
  if (v != v) return v;
  return u > v ? u : v;
}

struct V2 {
  double p, q;
};

struct M2 {
  double a, b, c, d;   // [[a, b], [c, d]]
};

DS_HD M2 m2_mul(const M2& l, const M2& r) {
  return {l.a * r.a + l.b * r.c, l.a * r.b + l.b * r.d,
          l.c * r.a + l.d * r.c, l.c * r.b + l.d * r.d};
}

// l v + w
DS_HD V2 m2_apply(const M2& l, const V2& v, const V2& w) {
  return {(l.a * v.p + l.b * v.q) + w.p, (l.c * v.p + l.d * v.q) + w.q};
}

// pw[j] = M^(2^j), by squaring
DS_HD void bq_powers(const DsScanArgs& g, M2* pw) {
  pw[0] = {g.na1, 1.0, g.na2, 0.0};
  for (int j = 1; j < kPowers; ++j) pw[j] = m2_mul(pw[j - 1], pw[j - 1]);
}

DS_HD double ds_pole(const DsScanArgs& g, long long r, long long t) {
  return g.a != nullptr ? g.a[r * g.a_rs + t * g.a_ts] : g.a_value;
}

DS_HD double ds_z0(const DsScanArgs& g, long long r) {
  return g.z0 != nullptr ? g.z0[r * g.z0_rs] : g.z0_value;
}

// K9a and K9b.  Map: z -> A*z + B (affine) or max(A*z, B) (max-plus).
template <long long kKind>
struct PoleScan {
  struct Map {
    double A, B;
  };
  using State = double;

  DS_HD static double b(double a, double x) {
    return kKind == kOnepole ? (1.0 - a) * x : x;
  }
  DS_HD static double follow(double A, double z, double B) {
    return kKind == kMaxplus ? ds_max(A * z, B) : A * z + B;
  }
  // a chunk's first sample's map, then each later sample composed after it
  DS_HD static Map first(const DsScanArgs&, double a, double x) {
    return {a, b(a, x)};
  }
  DS_HD static Map extend(const DsScanArgs&, const Map& m, double a,
                          double x) {
    return {a * m.A, follow(a, m.B, b(a, x))};
  }
  // one sample: the state after it, which is also y
  DS_HD static double step(const DsScanArgs&, State* z, double a, double x) {
    *z = follow(a, *z, b(a, x));
    return *z;
  }
  // later l after earlier e: a composite of one chunk's maps (serial) or
  // of 2^k threads' (the block scan)
  DS_HD static Map serial(const Map& l, const Map& e, const M2*) {
    return {l.A * e.A, follow(l.A, e.B, l.B)};
  }
  DS_HD static Map across(const Map& l, const Map& e, int, const M2*) {
    return {l.A * e.A, follow(l.A, e.B, l.B)};
  }
  DS_HD static State apply(const Map& m, State z, const M2*) {
    return follow(m.A, z, m.B);
  }
  DS_HD static Map fold(const Map& m, State z, const M2*) {
    return {m.A, follow(m.A, z, m.B)};
  }
  DS_HD static State state(const Map& m) { return m.B; }
  DS_HD static State start(const DsScanArgs& g, long long r) {
    return ds_z0(g, r);
  }
};

// K9c.  Map: the vector w of (M^kChunk, w); the matrices are pw[].  (The
// pole arguments are unused.)
struct BiquadScan {
  using Map = V2;
  using State = V2;

  DS_HD static Map first(const DsScanArgs& g, double, double x) {
    return {g.v0 * x, g.v1 * x};
  }
  DS_HD static Map extend(const DsScanArgs& g, const Map& w, double,
                          double x) {
    return {(g.na1 * w.p + w.q) + g.v0 * x, g.na2 * w.p + g.v1 * x};
  }
  DS_HD static double step(const DsScanArgs& g, State* s, double, double x) {
    const double y = g.b0 * x + s->p;
    *s = extend(g, *s, 0.0, x);
    return y;
  }
  DS_HD static Map serial(const Map& l, const Map& e, const M2* pw) {
    return m2_apply(pw[kChunkLog], e, l);
  }
  DS_HD static Map across(const Map& l, const Map& e, int k, const M2* pw) {
    return m2_apply(pw[kChunkLog + kPerThreadLog + k], e, l);
  }
  DS_HD static State apply(const Map& w, State s, const M2* pw) {
    return m2_apply(pw[kChunkLog], s, w);
  }
  DS_HD static Map fold(const Map& w, State s, const M2* pw) {
    return apply(w, s, pw);
  }
  DS_HD static State state(const Map& w) { return w; }
  DS_HD static State start(const DsScanArgs& g, long long) {
    return {g.s0, g.s1};
  }
};

DS_HD long long ds_chunks(long long length) {
  return (length + kChunk - 1) / kChunk;
}

// A row's chunk maps and start states take whole tiles of slots.  Within
// a tile, chunk i's slot puts each carry thread's kPerThread chunks
// kScanThreads apart, so that the carry block's loads and stores are
// coalesced (thread j's u-th map beside thread j + 1's).
DS_HD long long ds_row_slots(long long length) {
  return (ds_chunks(length) + kTileMaps - 1) / kTileMaps * kTileMaps;
}

DS_HD long long ds_slot(long long c) {
  const long long base = c / kTileMaps * kTileMaps, i = c - base;
  return base + (i % kPerThread) * kScanThreads + i / kPerThread;
}

// the scratch: row r's maps, then (after every row's) its start states;
// the doubles it takes
DS_HD long long ds_ws(const DsScanArgs& g) {
  return 4 * g.rows * ds_row_slots(g.length);
}

template <class Op>
DS_HD typename Op::Map* ds_maps(const DsScanArgs& g, long long r) {
  return reinterpret_cast<typename Op::Map*>(g.ws) +
         r * ds_row_slots(g.length);
}

template <class Op>
DS_HD typename Op::State* ds_starts(const DsScanArgs& g, long long r) {
  const long long slots = ds_row_slots(g.length);
  return reinterpret_cast<typename Op::State*>(g.ws + 2 * g.rows * slots) +
         r * slots;
}

// One thread's maps of a tile: composed in order, the first applied to the
// carry where `fold`.  own >= 1.  (The loops run kPerThread times and
// stop at `own`, so that on the card `mine` stays in registers.)
template <class Op>
DS_HD typename Op::Map ds_compose(const typename Op::Map* mine, int own,
                                  bool fold, typename Op::State carry,
                                  const M2* pw) {
  typename Op::Map agg = fold ? Op::fold(mine[0], carry, pw) : mine[0];
  DS_UNROLL
  for (int u = 1; u < kPerThread; ++u) {
    if (u >= own) break;
    agg = Op::serial(mine[u], agg, pw);
  }
  return agg;
}

// one thread's maps again, from the state before them: each chunk's start,
// at starts[u * kScanThreads] (its slot)
template <class Op>
DS_HD void ds_restart(const typename Op::Map* mine, int own,
                      typename Op::State s, typename Op::State* starts,
                      const M2* pw) {
  DS_UNROLL
  for (int u = 0; u < kPerThread; ++u) {
    if (u >= own) break;
    starts[u * kScanThreads] = s;
    s = Op::apply(mine[u], s, pw);
  }
}

DS_HD int ds_own(long long n_maps, long long m0) {
  const long long own = n_maps - m0;
  return own <= 0 ? 0 : (own >= kPerThread ? kPerThread
                                          : static_cast<int>(own));
}

DS_HD void lcg_power(unsigned long long e, uint32_t* pa, uint32_t* pc) {
  uint32_t ra = 1u, rc = 0u, ba = kLcgA, bc = kLcgC;
  while (e != 0) {
    if (e & 1u) {           // r <- b after r
      rc = ba * rc + bc;
      ra = ba * ra;
    }
    bc = ba * bc + bc;      // b <- b after b
    ba = ba * ba;
    e >>= 1;
  }
  *pa = ra;
  *pc = rc;
}

// thread `i` of `threads`: the outputs i, i + threads, ...
DS_HD void lcg_thread(const DsLcgArgs& g, long long i, long long threads) {
  uint32_t a, c, sa, sc;
  lcg_power(static_cast<unsigned long long>(i) + 1, &a, &c);
  lcg_power(static_cast<unsigned long long>(threads), &sa, &sc);
  uint32_t s = a * static_cast<uint32_t>(g.seed) + c;
  for (long long k = i; k < g.n; k += threads) {
    g.out[k] = static_cast<double>(static_cast<int32_t>(s)) / 2147483648.0;
    s = sa * s + sc;
  }
}

DS_HD long long lcg_threads(long long n) {
  const long long blocks = (n + kLcgThreads - 1) / kLcgThreads;
  return (blocks < kLcgBlocks ? blocks : kLcgBlocks) * kLcgThreads;
}

#ifdef __CUDACC__

// Segment j of the block's chunks, loaded into registers: v[u] is sample
// j * kSeg + e % kSeg of chunk c0 + e / kSeg, where e = u * kWalkThreads +
// threadIdx.x (0 past the row's end), so that a warp loads 32 contiguous
// doubles at once
template <int kN>
__device__ void seg_load(double (&v)[kN], const double* p, long long rs,
                         long long ts, long long r, long long c0, int j,
                         long long length) {
#pragma unroll
  for (int u = 0; u < kSeg; ++u) {
    const int e = u * kWalkThreads + threadIdx.x;
    const long long t = (c0 + e / kSeg) * kChunk + j * kSeg + e % kSeg;
    v[u] = t < length ? p[r * rs + t * ts] : 0.0;
  }
}

// the registers into the tile: chunk c0 + i's samples at tile[i * kPitch]
template <int kN>
__device__ void seg_store(double* tile, const double (&v)[kN]) {
#pragma unroll
  for (int u = 0; u < kSeg; ++u) {
    const int e = u * kWalkThreads + threadIdx.x;
    tile[(e / kSeg) * kPitch + e % kSeg] = v[u];
  }
}

__device__ void seg_out(const double* tile, double* y, long long r,
                        long long c0, int j, long long length) {
#pragma unroll
  for (int u = 0; u < kSeg; ++u) {
    const int e = u * kWalkThreads + threadIdx.x;
    const long long t = (c0 + e / kSeg) * kChunk + j * kSeg + e % kSeg;
    if (t < length) y[r * length + t] = tile[(e / kSeg) * kPitch + e % kSeg];
  }
}

// Phases 1 (kApply false: each chunk's map) and 3 (kApply true: y), with
// the pole one a sample (kVecA) or the call's.  Block (x, row): chunks 64x
// .. 64x + 63 of the row, thread q owning chunk 64x + q.  A segment's
// loads are issued while the one before is walked; phase 3 writes its
// output over the x tile, each thread its own row.
template <class Op, bool kApply, bool kVecA>
__global__ void __launch_bounds__(kWalkThreads)
walk_kernel(const DsScanArgs g) {
  constexpr int kTileA = kVecA ? kWalkThreads * kPitch : 1;
  __shared__ double sx[kWalkThreads * kPitch];
  __shared__ double sa[kTileA];
  const long long r = blockIdx.y;
  const long long c0 = static_cast<long long>(blockIdx.x) * kWalkThreads;
  const int q = threadIdx.x;
  const long long c = c0 + q;
  const long long n_chunks = ds_chunks(g.length);
  const long long left = c < n_chunks ? g.length - c * kChunk : 0;
  const long long count = left < kChunk ? left : kChunk;
  const long long rest = g.length - c0 * kChunk;   // from the block's start
  const int n_seg = rest >= kChunk ? static_cast<int>(kChunk / kSeg)
                                   : static_cast<int>((rest + kSeg - 1) / kSeg);
  typename Op::Map m{};
  typename Op::State z{};
  if (kApply && count > 0) z = ds_starts<Op>(g, r)[ds_slot(c)];
  double vx[kSeg], va[kVecA ? kSeg : 1];
  seg_load(vx, g.x, g.x_rs, 1, r, c0, 0, g.length);
  if (kVecA) seg_load(va, g.a, g.a_rs, g.a_ts, r, c0, 0, g.length);
  for (int j = 0; j < n_seg; ++j) {
    __syncthreads();                  // the tiles' last readers are done
    seg_store(sx, vx);
    if (kVecA) seg_store(sa, va);
    __syncthreads();
    if (j + 1 < n_seg) {              // lands while segment j is walked
      seg_load(vx, g.x, g.x_rs, 1, r, c0, j + 1, g.length);
      if (kVecA) seg_load(va, g.a, g.a_rs, g.a_ts, r, c0, j + 1, g.length);
    }
    double* xs = sx + q * kPitch;
    const double* as = sa + (kVecA ? q * kPitch : 0);
    for (int k = 0; k < kSeg; ++k) {
      const long long s = j * kSeg + k;
      if (s >= count) break;
      const double av = kVecA ? as[k] : g.a_value;
      if (kApply) {
        xs[k] = Op::step(g, &z, av, xs[k]);
      } else {
        m = s == 0 ? Op::first(g, av, xs[k]) : Op::extend(g, m, av, xs[k]);
      }
    }
    if (kApply) {
      __syncthreads();
      seg_out(sx, g.y, r, c0, j, g.length);
    }
  }
  if (!kApply && count > 0) ds_maps<Op>(g, r)[ds_slot(c)] = m;
}

// Phase 2.  Block `row`, kScanThreads threads; thread j holds maps
// base + j*kPerThread .. + kPerThread - 1 of each tile.  A thread with no
// map of the tile takes no part: the threads with maps are a prefix, and
// each reads only threads below it.
template <class Op>
__global__ void __launch_bounds__(kScanThreads)
carry_kernel(const DsScanArgs g) {
  using Map = typename Op::Map;
  using State = typename Op::State;
  __shared__ Map sh[kScanThreads];
  __shared__ M2 pw[kPowers];
  const long long r = blockIdx.x;
  const int j = threadIdx.x;
  const long long n_maps = ds_chunks(g.length);
  const Map* maps = ds_maps<Op>(g, r);
  State* starts = ds_starts<Op>(g, r);
  if (j == 0) bq_powers(g, pw);
  __syncthreads();
  State carry = Op::start(g, r);
  for (long long base = 0; base < n_maps; base += kTileMaps) {
    const long long m0 = base + static_cast<long long>(j) * kPerThread;
    const int own = ds_own(n_maps, m0);
    Map mine[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u)
      if (u < own) mine[u] = maps[base + u * kScanThreads + j];
    Map agg{};
    if (own > 0) agg = ds_compose<Op>(mine, own, j == 0, carry, pw);
    sh[j] = agg;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanSteps; ++k) {
      const int d = 1 << k;
      const bool act = own > 0 && j >= d;
      Map v{};
      if (act) v = Op::across(agg, sh[j - d], k, pw);
      __syncthreads();
      if (act) {
        agg = v;
        sh[j] = v;
      }
      __syncthreads();
    }
    if (own > 0)
      ds_restart<Op>(mine, own, j == 0 ? carry : Op::state(sh[j - 1]),
                     starts + base + j, pw);
    carry = Op::state(sh[kScanThreads - 1]);   // read only if a tile follows
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kLcgThreads)
lcg_kernel(const DsLcgArgs g, long long threads) {
  lcg_thread(g, static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
             threads);
}

template <class Op, bool kApply>
void walk(const DsScanArgs& g, dim3 grid, cudaStream_t s) {
  if (g.a != nullptr)
    walk_kernel<Op, kApply, true><<<grid, kWalkThreads, 0, s>>>(g);
  else
    walk_kernel<Op, kApply, false><<<grid, kWalkThreads, 0, s>>>(g);
}

template <class Op>
int launch(const DsScanArgs& g, cudaStream_t s) {
  const long long n_chunks = ds_chunks(g.length);
  const dim3 grid(static_cast<unsigned>((n_chunks + kWalkThreads - 1) /
                                        kWalkThreads),
                  static_cast<unsigned>(g.rows));
  walk<Op, false>(g, grid, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  carry_kernel<Op><<<static_cast<unsigned>(g.rows), kScanThreads, 0, s>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  walk<Op, true>(g, grid, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows <= 65535 (the walks' grid y); a scratch of fewer than ds_ws(g)
// doubles is refused
extern "C" int zorak_dsp_scan(const void* args, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  const DsScanArgs& g = *static_cast<const DsScanArgs*>(args);
  if (g.rows <= 0 || g.length <= 0) return 0;
  if (g.ws_n < ds_ws(g)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (g.kind) {
    case kOnepole: return launch<PoleScan<kOnepole>>(g, s);
    case kIntegrator: return launch<PoleScan<kIntegrator>>(g, s);
    case kMaxplus: return launch<PoleScan<kMaxplus>>(g, s);
    case kBiquad: return launch<BiquadScan>(g, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int zorak_lcg_noise(const void* args, void* stream) {
  cudaGetLastError();
  const DsLcgArgs& g = *static_cast<const DsLcgArgs*>(args);
  if (g.n <= 0) return 0;
  const long long threads = lcg_threads(g.n);
  lcg_kernel<<<static_cast<unsigned>(threads / kLcgThreads), kLcgThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(g, threads);
  return static_cast<int>(cudaGetLastError());
}

#else  // the host form

// the three phases of each row, the block scan's strides as a loop
template <class Op>
void host_scan(const DsScanArgs& g) {
  using Map = typename Op::Map;
  using State = typename Op::State;
  const long long n_maps = ds_chunks(g.length);
  M2 pw[kPowers];
  bq_powers(g, pw);
  static thread_local Map agg[kScanThreads], mine[kScanThreads][kPerThread];
  for (long long r = 0; r < g.rows; ++r) {
    const double* x = g.x + r * g.x_rs;
    Map* maps = ds_maps<Op>(g, r);
    State* starts = ds_starts<Op>(g, r);
    for (long long c = 0; c < n_maps; ++c) {
      const long long t0 = c * kChunk;
      const long long t1 = t0 + kChunk < g.length ? t0 + kChunk : g.length;
      Map m = Op::first(g, ds_pole(g, r, t0), x[t0]);
      for (long long t = t0 + 1; t < t1; ++t)
        m = Op::extend(g, m, ds_pole(g, r, t), x[t]);
      maps[ds_slot(c)] = m;
    }
    State carry = Op::start(g, r);
    for (long long base = 0; base < n_maps; base += kTileMaps) {
      int owns[kScanThreads];
      for (int j = 0; j < kScanThreads; ++j) {
        const long long m0 = base + static_cast<long long>(j) * kPerThread;
        owns[j] = ds_own(n_maps, m0);
        for (int u = 0; u < owns[j]; ++u)
          mine[j][u] = maps[base + u * kScanThreads + j];
        if (owns[j] > 0)
          agg[j] = ds_compose<Op>(mine[j], owns[j], j == 0, carry, pw);
      }
      for (int k = 0; k < kScanSteps; ++k) {
        const int d = 1 << k;
        for (int j = kScanThreads - 1; j >= d; --j)   // j - d still the old
          if (owns[j] > 0) agg[j] = Op::across(agg[j], agg[j - d], k, pw);
      }
      for (int j = 0; j < kScanThreads && owns[j] > 0; ++j)
        ds_restart<Op>(mine[j], owns[j],
                       j == 0 ? carry : Op::state(agg[j - 1]),
                       starts + base + j, pw);
      carry = Op::state(agg[kScanThreads - 1]);
    }
    for (long long c = 0; c < n_maps; ++c) {
      State z = starts[ds_slot(c)];
      const long long t0 = c * kChunk;
      const long long t1 = t0 + kChunk < g.length ? t0 + kChunk : g.length;
      for (long long t = t0; t < t1; ++t)
        g.y[r * g.length + t] = Op::step(g, &z, ds_pole(g, r, t), x[t]);
    }
  }
}

}  // namespace

extern "C" int zorak_dsp_scan_host(const void* args) {
  const DsScanArgs& g = *static_cast<const DsScanArgs*>(args);
  if (g.rows <= 0 || g.length <= 0) return 0;
  if (g.ws_n < ds_ws(g)) return 1;
  switch (g.kind) {
    case kOnepole: host_scan<PoleScan<kOnepole>>(g); return 0;
    case kIntegrator: host_scan<PoleScan<kIntegrator>>(g); return 0;
    case kMaxplus: host_scan<PoleScan<kMaxplus>>(g); return 0;
    case kBiquad: host_scan<BiquadScan>(g); return 0;
    default: return 1;
  }
}

extern "C" int zorak_lcg_noise_host(const void* args) {
  const DsLcgArgs& g = *static_cast<const DsLcgArgs*>(args);
  if (g.n <= 0) return 0;
  const long long threads = lcg_threads(g.n);
  for (long long i = 0; i < threads; ++i) lcg_thread(g, i, threads);
  return 0;
}

#endif  // __CUDACC__
