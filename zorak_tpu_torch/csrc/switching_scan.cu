// Switching (attack/release) one-pole scan for NVIDIA Hopper (sm_90a).
//
//   z[t] = x[t] + (z[t-1] - x[t]) * (up if x[t] > z[t-1] else dn)
//
// Replaces the TPU kernel zorak_tpu/kernels/pallas_scan.py
// (switching_scan_pallas, body _kernel).  There, one TPU core walks
// 1024-sample chunks as sequential grid steps and keeps the carry in VMEM
// scratch between them.  Blocks on a GPU run in no order, so none of that
// carries over.
//
// What bounds it: the pole depends on the state, so the recurrence is not
// associative, and one thread walking T steps is bound by the chain of T
// dependent compare, select, subtract, multiply and add, far above the
// 2 * sizeof(T) bytes a step moves.  The VAR and RED followers have one
// lane per file, so a thread per lane leaves the card almost empty.
//
// What the design does about it: an exact chunk-parallel scan in two
// kernels.  switching_speculate_kernel cuts [T, lanes] into chunks of
// `chunk` steps, one thread per (chunk, lane).  Chunk 0 starts from z0;
// chunk c > 0 starts from a guess, x[c*chunk - warmup], runs `warmup`
// steps over the samples before its chunk without writing, then runs its
// own steps, writes them to y and records the state it started its chunk
// with and the state it ended with.  switching_fixup_kernel then walks
// each lane's chunks in order with the true carry: where the carry equals
// the recorded start in its bits the chunk is already exact, else it
// re-runs the chunk from the carry until its state equals the speculative
// y[t] in its bits.
//
// Exactness: both poles lie in (0, 1), so the step contracts, two
// trajectories driven by the same input come closer and, in floating
// point, become bit-identical at some step; from there on they are equal,
// since the step is deterministic.  The fix-up compares bit patterns (not
// floats: -0.0 == 0.0 and NaN != NaN), so by induction over the chunks y
// is the sequential loop's, whatever the input; an input on which the
// trajectories never merge (a decay in silence) costs a serial re-run.
// The file is compiled with --fmad=false so that the multiply and the add
// stay two roundings, as in the plain PyTorch version
// (zorak_tpu_torch/kernels/switching_scan.py, switching_scan_reference).
//
// Memory: a block (one warp) stages its input tile, kSeg steps of its
// chunks and lanes, through shared memory with cp.async, kStages segments
// in flight, so no global load sits on the chain; its output goes through
// a double buffer in shared memory and leaves as coalesced stores.
// threadIdx.x is lane-fastest from kLaneTile lanes up and chunk-fastest
// below.  One chunk (chunk >= T) skips both phases: switching_walk_kernel
// runs the fix-up's walk from z0, a thread per lane.
// switching_chain_kernel runs the chain alone, with no memory traffic, to
// measure the floor under one thread's steps.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 32;    // threads of a speculate block: one warp
constexpr int kSeg = 32;      // steps of one staged segment
constexpr int kStages = 3;    // input segments in shared memory
constexpr int kGroup = 32;    // chunk records the fix-up loads at once
constexpr int kUnroll = 32;   // steps a walk holds in registers
// from this many lanes up a block is 32 lanes of one chunk, lane-fastest;
// below, 32 chunks of one lane, chunk-fastest
constexpr int kLaneTile = 8;

template <typename T>
__device__ __forceinline__ T switching_step(T z, T xt, T up, T dn) {
  const T pole = (xt > z) ? up : dn;
  return xt + (z - xt) * pole;
}

__device__ __forceinline__ unsigned long long bits(double v) {
  return static_cast<unsigned long long>(__double_as_longlong(v));
}
__device__ __forceinline__ unsigned int bits(float v) {
  return __float_as_uint(v);
}

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// Copies sizeof(T) bytes, or writes zeros where `valid` is false (the
// source is then not read), so that a copy needs no branch.
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(addr), "l"(gmem), "n"(sizeof(T)),
                  "r"(valid ? static_cast<int>(sizeof(T)) : 0));
}
// A store under a predicate: written as a branch, each of a row of stores
// became a divergent branch of its own.
__device__ __forceinline__ void st_global_if(double* p, double v, bool ok) {
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
               " @q st.global.f64 [%0], %1;\n}\n"
               :: "l"(p), "d"(v), "r"(static_cast<int>(ok)));
}
__device__ __forceinline__ void st_global_if(float* p, float v, bool ok) {
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
               " @q st.global.f32 [%0], %1;\n}\n"
               :: "l"(p), "f"(v), "r"(static_cast<int>(ok)));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Bits [a, b) of a row mask, 0 <= a, b <= 32.
__device__ __forceinline__ unsigned row_mask(long long a, long long b) {
  const unsigned hi = b >= 32 ? ~0u : (1u << b) - 1u;
  const unsigned lo = a >= 32 ? ~0u : (1u << a) - 1u;
  return a < b ? hi & ~lo : 0u;
}

// Phase 1.  A block holds TC chunks x TL lanes, one thread each.  Every
// thread walks the same `warm + chunk` relative steps r; its time is
// t = c*chunk - warm + r.  It steps where t lies in [max(0, t_first),
// min(T, c*chunk + chunk)), writes y where r >= warm, and records the
// state at r == warm and the state at its end in ws[c][lane].
//
// A block is one warp, so that the few warps of a short scan spread over
// as many SMs.  It copies its tile a row at a time: row i is kSeg steps of
// chunk c0 + i (TL == 1) or the TL lanes of step i (TL == 32); with
// lanes == 1 or lanes >= 32 its 32 addresses are contiguous.  The tile is
// under 48 KB.
template <typename T, int TL>
struct Tile {
  static constexpr int TC = kBlock / TL;                       // chunks
  static constexpr int ROW = kSeg * TL + (TL == 1 ? 1 : 0);    // pad: banks
  static constexpr int SIZE = TC * ROW;
  static constexpr int SMEM =
      (kStages + 2) * SIZE * static_cast<int>(sizeof(T));
  __device__ static constexpr int OFF(int i) {      // smem offset of element i
    return TL == 1 ? i * ROW : i * TL;
  }
};

template <typename T, int TL>
__global__ void __launch_bounds__(kBlock)
switching_speculate_kernel(const T* __restrict__ x, const T* __restrict__ up,
                           const T* __restrict__ dn, const T* __restrict__ z0,
                           T* __restrict__ y, T* __restrict__ ws,
                           long long n_t, int lanes, long long chunk,
                           long long warm, long long n_chunks) {
  using I = long long;
  using G = Tile<T, TL>;
  static_assert(kBlock == 32 && kSeg == 32, "row mapping assumes one warp");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);  // [kStages][SIZE]
  T* sy = sx + kStages * G::SIZE;          // [2][SIZE]

  const int q = threadIdx.x;
  const I c0 = static_cast<I>(blockIdx.x) * G::TC;
  const int l0 = blockIdx.y * TL;
  const I span = warm + chunk;

  // this thread's trajectory: chunk c, lane `lane`
  const int lc = q / TL, ll = q % TL;
  const I c = c0 + lc;
  const int lane = l0 + ll;
  const bool owner = c < n_chunks && lane < lanes;
  const I t_first = c * chunk - warm;
  T u = 0, d = 0, z = 0, zs = 0;
  I r_lo = 0, r_hi = 0;
  if (owner) {
    u = up[lane];
    d = dn[lane];
    if (t_first <= 0) {  // the warm-up reaches t = 0: an exact start
      r_lo = -t_first;
      z = z0[lane];
    } else {
      z = x[t_first * lanes + lane];
    }
    r_hi = min(span, n_t - t_first);
  }

  // this thread's share of the copies: row i of segment j lies at time
  // t(i) = tj + i*chunk (TL == 1) or tj + i (TL == 32), tj = T0 + j*kSeg
  const int cl = TL == 1 ? 0 : q;                  // lane within the tile
  const I T0 = c0 * chunk - warm + (TL == 1 ? q : 0);
  const I pitch = TL == 1 ? chunk : 1;             // time between rows
  unsigned vmask = 0;  // rows whose chunk and lane exist
  if (l0 + cl < lanes)
    vmask = TL == 1 ? row_mask(static_cast<I>(0),
                               min(static_cast<I>(32), n_chunks - c0))
                    : ~0u;
  const T* xg = x + l0 + cl;
  T* yg = y + l0 + cl;
  // rows whose time lies in [lo, hi)
  auto rows = [&](I tj, I lo, I hi) {
    if (tj >= lo && tj + 31 * pitch < hi) return ~0u;  // the usual case
    const I a = lo - tj <= 0 ? 0 : (lo - tj + pitch - 1) / pitch;
    const I b = hi - tj <= 0 ? 0 : (hi - tj + pitch - 1) / pitch;
    return row_mask(min(a, static_cast<I>(32)), min(b, static_cast<I>(32)));
  };

  // Row masks of a segment's copies and stores, then the copies and
  // stores themselves, predicated and branch-free: masked rows copy zeros
  // and read nothing.
  auto fetch_mask = [&](I j) { return vmask & rows(T0 + j * kSeg, 0, n_t); };
  auto store_mask = [&](I j) {  // rows in their chunk's own steps
    const I tj = T0 + j * kSeg;
    if (TL == 1) {
      const I r = j * kSeg + q;
      return r >= warm && r < span ? vmask & rows(tj, 0, n_t) : 0u;
    }
    return vmask & rows(tj, T0 + warm, min(n_t, T0 + span));
  };
  auto fetch = [&](I j, T* dst, unsigned m) {
    const I tj = T0 + j * kSeg;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      cp_async(dst + q + G::OFF(i), xg + (tj + i * pitch) * lanes,
               m >> i & 1u);
  };
  auto store = [&](I j, const T* src, unsigned m) {
    const I tj = T0 + j * kSeg;
    T v[32];  // all loads first: a load behind each store would wait on it
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = src[q + G::OFF(i)];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      st_global_if(yg + (tj + i * pitch) * lanes, v[i], m >> i & 1u);
  };

  const I n_seg = (span + kSeg - 1) / kSeg;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    fetch(s, sx + s * G::SIZE, s < n_seg ? fetch_mask(s) : 0u);
    cp_async_commit();
  }
  int stage = 0;  // j % kStages
  for (I j = 0; j < n_seg; ++j) {
    cp_async_wait<kStages - 2>();  // this thread's copies of segment j
    __syncthreads();               // everyone's; segment j-1 consumed
    if (j > 0) store(j - 1, sy + ((j - 1) & 1) * G::SIZE, store_mask(j - 1));
    const I r0 = j * kSeg;
    if (owner && r0 + kSeg > r_lo && r0 < r_hi) {
      const T* xs = sx + stage * G::SIZE + lc * G::ROW + ll;
      T* ys = sy + (j & 1) * G::SIZE + lc * G::ROW + ll;
      if (r0 >= r_lo && r0 + kSeg <= r_hi && !(warm > r0 && warm < r0 + kSeg)) {
        if (r0 == warm) zs = z;
        T v[kSeg];
#pragma unroll
        for (int k = 0; k < kSeg; ++k) v[k] = xs[k * TL];
#pragma unroll
        for (int k = 0; k < kSeg; ++k) {
          z = switching_step(z, v[k], u, d);
          v[k] = z;
        }
#pragma unroll
        for (int k = 0; k < kSeg; ++k) ys[k * TL] = v[k];
      } else {  // the segment holds t = 0, the chunk's start or T
#pragma unroll 1
        for (int k = 0; k < kSeg; ++k) {
          const I r = r0 + k;
          if (r == warm) zs = z;
          if (r >= r_lo && r < r_hi) z = switching_step(z, xs[k * TL], u, d);
          ys[k * TL] = z;
        }
      }
    }
    const I jn = j + kStages - 1;  // into the stage segment j-1 left
    if (jn < n_seg)
      fetch(jn, sx + (stage == 0 ? kStages - 1 : stage - 1) * G::SIZE,
            fetch_mask(jn));
    cp_async_commit();
    stage = stage == kStages - 1 ? 0 : stage + 1;
  }
  __syncthreads();
  store(n_seg - 1, sy + ((n_seg - 1) & 1) * G::SIZE, store_mask(n_seg - 1));
  if (owner) {
    using P = typename Pair<T>::type;
    P rec;
    rec.x = zs;
    rec.y = z;
    reinterpret_cast<P*>(ws)[c * lanes + lane] = rec;
  }
}

// Runs steps [t0, t1) of one lane (x, y offset to the lane) from z and
// writes them to y: full blocks of kUnroll steps with x loaded a block
// ahead, so no load sits on the chain, then the tail.  With kMerge it
// re-runs a speculated chunk: after each block the state is held to the
// speculative y at the block's last step, read before the block was
// written (and in the tail, at each step), equal once the trajectories
// merged and from there to the chunk's end, and it stops there.  Returns
// whether they merged; *z_out is the state after the last step it ran.
template <bool kMerge, typename T>
__device__ __forceinline__ bool walk(const T* __restrict__ x,
                                     T* __restrict__ y, long long lanes,
                                     T u, T d, T z, long long t0,
                                     long long t1, T* z_out,
                                     unsigned long long& steps) {
  const long long t_full = t1 - (t1 - t0) % kUnroll;
  T cur[kUnroll];
  T spec = 0;
  if (t_full > t0) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) cur[k] = x[(t0 + k) * lanes];
    if (kMerge) spec = y[(t0 + kUnroll - 1) * lanes];
  }
  for (long long t = t0; t < t_full; t += kUnroll) {
    T nxt[kUnroll];
    T spec_n = spec;
    const bool more = t + kUnroll < t_full;
    if (more) {
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        nxt[k] = x[(t + kUnroll + k) * lanes];
      if (kMerge) spec_n = y[(t + 2 * kUnroll - 1) * lanes];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      z = switching_step(z, cur[k], u, d);
      cur[k] = z;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) y[(t + k) * lanes] = cur[k];
    steps += kUnroll;
    if (kMerge && bits(z) == bits(spec)) {
      *z_out = z;
      return true;
    }
    if (more) {
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) cur[k] = nxt[k];
      spec = spec_n;
    }
  }
  for (long long t = t_full; t < t1; ++t) {
    z = switching_step(z, x[t * lanes], u, d);
    ++steps;
    if (kMerge && bits(z) == bits(y[t * lanes])) {
      *z_out = z;
      return true;
    }
    y[t * lanes] = z;
  }
  *z_out = z;
  return false;
}

// Phase 2.  One thread per lane walks its chunks in order with the true
// carry and adds the steps it re-ran to *reruns.  Each lane is a block of
// its own: lanes sharing a warp would take turns through their re-runs.
template <typename T>
__global__ void __launch_bounds__(1)
switching_fixup_kernel(const T* __restrict__ x, const T* __restrict__ up,
                       const T* __restrict__ dn, T* __restrict__ y,
                       const T* __restrict__ ws, long long n_t, int lanes,
                       long long chunk, long long n_chunks,
                       unsigned long long* __restrict__ reruns) {
  using P = typename Pair<T>::type;
  __shared__ P recs[kGroup];  // a group of chunk records, loaded at once
  const int lane = blockIdx.x;
  const T u = up[lane];
  const T d = dn[lane];
  const P* rec = reinterpret_cast<const P*>(ws);
  T carry = rec[lane].y;  // chunk 0 started from z0: exact
  unsigned long long steps = 0;
  for (long long cg = 1; cg < n_chunks; cg += kGroup) {
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      if (cg + g < n_chunks) recs[g] = rec[(cg + g) * lanes + lane];
    const int n_g = static_cast<int>(min(static_cast<long long>(kGroup),
                                         n_chunks - cg));
    for (int g = 0; g < n_g; ++g) {
      const P r = recs[g];
      if (bits(carry) == bits(r.x)) {
        carry = r.y;
      } else {
        const long long t0 = (cg + g) * chunk;
        T z;
        carry = walk<true>(x + lane, y + lane, lanes, u, d, carry, t0,
                           min(n_t, t0 + chunk), &z, steps)
                    ? r.y
                    : z;
      }
    }
  }
  if (steps) atomicAdd(reruns, steps);
}

// One chunk (chunk >= T, no phase 1): the same walk from z0 with nothing
// to merge with, a thread per lane.  A kernel of its own: as a branch of
// the fix-up kernel the two walks needed more than 255 registers in f64,
// spilled, and both ran slower.
template <typename T>
__global__ void __launch_bounds__(1)
switching_walk_kernel(const T* __restrict__ x, const T* __restrict__ up,
                      const T* __restrict__ dn, const T* __restrict__ z0,
                      T* __restrict__ y, long long n_t, int lanes) {
  const int lane = blockIdx.x;
  unsigned long long steps = 0;
  T z;
  walk<false>(x + lane, y + lane, lanes, up[lane], dn[lane], z0[lane], 0,
              n_t, &z, steps);
}

// Timing probe, not a kernel of any path: one thread runs the same
// dependent chain for the full chunks of n_t steps, with x cycling
// through kUnroll values held in registers, so no load or store is on it.
// Its time per step is the chain's latency, the floor under one thread's
// steps in switching_speculate_kernel.
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

template <typename T, int TL>
void launch_speculate(const T* x, const T* up, const T* dn, const T* z0, T* y,
                      T* ws, long long n_t, int lanes, long long chunk,
                      long long warm, long long n_chunks,
                      cudaStream_t stream) {
  using G = Tile<T, TL>;
  static_assert(G::SMEM <= 48 * 1024, "no opt-in to more shared memory");
  const dim3 grid(static_cast<unsigned>((n_chunks + G::TC - 1) / G::TC),
                  static_cast<unsigned>((lanes + TL - 1) / TL));
  switching_speculate_kernel<T, TL><<<grid, kBlock, G::SMEM, stream>>>(
      x, up, dn, z0, y, ws, n_t, lanes, chunk, warm, n_chunks);
}

// chunk in [1, n_t] and warm in [0, (n_chunks - 1) * chunk], as the
// wrapper normalises them; ws holds 2 * n_chunks * lanes values.
template <typename T>
int launch(const void* xv, const void* upv, const void* dnv, const void* z0v,
           void* yv, void* wsv, void* reruns, long long n_t, int lanes,
           long long chunk, long long warm, void* stream_v) {
  cudaGetLastError();  // clear an error left by an earlier call
  const T* x = static_cast<const T*>(xv);
  const T* up = static_cast<const T*>(upv);
  const T* dn = static_cast<const T*>(dnv);
  const T* z0 = static_cast<const T*>(z0v);
  T* y = static_cast<T*>(yv);
  T* ws = static_cast<T*>(wsv);
  const auto stream = static_cast<cudaStream_t>(stream_v);
  const long long n_chunks = (n_t + chunk - 1) / chunk;
  if (n_chunks == 1) {
    switching_walk_kernel<T><<<lanes, 1, 0, stream>>>(x, up, dn, z0, y, n_t,
                                                       lanes);
    return static_cast<int>(cudaGetLastError());
  }
  if (lanes >= kLaneTile)
    launch_speculate<T, 32>(x, up, dn, z0, y, ws, n_t, lanes, chunk, warm,
                            n_chunks, stream);
  else
    launch_speculate<T, 1>(x, up, dn, z0, y, ws, n_t, lanes, chunk, warm,
                           n_chunks, stream);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switching_fixup_kernel<T><<<lanes, 1, 0, stream>>>(
      x, up, dn, y, ws, n_t, lanes, chunk, n_chunks,
      static_cast<unsigned long long*>(reruns));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int zorak_switching_scan_f32(const void* x, const void* up,
                                        const void* dn, const void* z0,
                                        void* y, void* ws, void* reruns,
                                        long long n_t, int lanes,
                                        long long chunk, long long warm,
                                        void* stream) {
  return launch<float>(x, up, dn, z0, y, ws, reruns, n_t, lanes, chunk, warm,
                       stream);
}

extern "C" int zorak_switching_scan_f64(const void* x, const void* up,
                                        const void* dn, const void* z0,
                                        void* y, void* ws, void* reruns,
                                        long long n_t, int lanes,
                                        long long chunk, long long warm,
                                        void* stream) {
  return launch<double>(x, up, dn, z0, y, ws, reruns, n_t, lanes, chunk, warm,
                        stream);
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
