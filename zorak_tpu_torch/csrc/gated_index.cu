// The gated regime's index program and the dynamic ring read for NVIDIA
// Hopper (sm_90a): four kernels of integer arithmetic, selects and
// gathers, one CUDA block a file row (or a row of a region) for the three
// that scan, one thread a sample for the read.
//
// A gated cursor advances only in the samples where its gate is truthy
// ((x < 0) | (x > 0), NaN falsy), so its position at sample t is
//
//   anchor + (fires up to t, inclusive or exclusive) + offset   mod M
//
// with `anchor` the cursor's carried value converted as eelmath.to_i64
// converts it (trunc, NaN to 0, saturation at +-2^63), taken `& (M-1)`
// for a power of two M and as a non-negative remainder otherwise, every
// add wrapping as int64 adds do.
//
//   gated_cursor (K6a)      a gate's prefix sums, then every reader of its
//                           cursor: the position as f64 (+ its region's
//                           origin), the position as int64, or the value a
//                           ring holds there; and the cursor's next
//                           carried value, the fmod-remainder of (anchor +
//                           the file's fires) by M.  With no gate every
//                           sample fires: the ungated cursor (start + t)
//                           mod M.
//   gated_draws (K6b)       the gated rand() sites' draws: within a sample
//                           a site's index counts the sites before it that
//                           fire, across samples the fires before it, from
//                           each file's consumed count; gathered from the
//                           render's pool with the index clamped into it.
//   gated_ring_write (K6c)  a gate's ring writes: each region's ring
//                           copied, then every fired sample's value stored
//                           at its exclusive cursor position.
//   dyn_ring_read (K3b)     a read whose slot changes every sample: a
//                           gather from the ring where the segment does not
//                           write the region, else from [history | the
//                           segment's writes] at the delay the write cursor
//                           gives, with the same-sample writer's value
//                           where the delay is 0.
//
// Replaces zorak_tpu/lowering/specialize.py's gate_mask and gcursor_idx
// (:4217-4238), gated_rand_vals (:4173-4202), the gated ring write-back
// (:4758-4803), cursor_idx (:4208) and dyn_ring_read (:4432-4478), which
// the reference leaves to XLA; in plain PyTorch they are about 60 launches
// a gate and segment (masks, int64 cumsums, to_i64's ladders, remainders,
// gathers, a ring copy and a scatter).
//
// What bounds them: the bytes, and far below them the launch.  A segment
// of the tank (1,024 samples, eight rings of 8,192 cells) moves about
// 1.1 MB, mostly the rings copied by K6c; every other kernel reads a gate
// and writes a few rows of 8 KB.  The design keeps each to one launch and
// one pass: the scans are block-wide (a warp's shuffles, then the warps'
// sums in shared memory, tile after tile with the running sum carried), so
// a row of any length costs one block; every reader of a gate is served
// by that one scan.  Every result is integer arithmetic, a conversion, a
// select or a gather, so each kernel equals its plain version
// (kernels/gated_index.py) bit for bit.
//
// Plain C interface (loaded with ctypes): an entry point takes a pointer
// to its argument struct (the layouts of gated_index.py's ctypes
// structures, every field 8 bytes) and a stream, launches with the struct
// by value, and returns cudaGetLastError(), 0 when the launch was
// accepted.
//
// Built with a host C++ compiler instead of nvcc (no __CUDACC__), the file
// is its host form: the `_host` entry points run the same per-sample
// bodies with the prefix sums taken in a loop, for tests where there is no
// GPU.

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define GI_HD __host__ __device__ __forceinline__
#else
#define GI_HD inline
#endif

namespace {

constexpr int kMaxReaders = 16;   // readers of one gated_cursor launch
constexpr int kMaxSites = 64;     // rand sites of one gated_draws launch
constexpr int kMaxRegions = 16;   // regions of one gated_ring_write launch
constexpr int kReadThreads = 256;

// A value a file and sample: p[f * fs + t * ts] (a stride 0 shares it).
struct GiStream {
  const double* p;
  long long fs, ts;
};

// A cursor's carried value: p[f * fs] where p is set (the device's, one a
// file), else `value` (the host's) and `ivalue`, its to_i64.
struct GiAnchor {
  const double* p;
  long long fs;
  double value;
  long long ivalue;
};

enum : long long { kPosition = 0, kValue = 1, kIndex = 2 };

struct GiReader {
  long long kind;        // kPosition: f64 (+ origin); kValue; kIndex: int64
  long long offset, mod, incl;
  double origin;
  long long add_origin;
  const double* ring;    // kValue: file f's row at ring + f * ring_fs
  long long ring_fs;
  void* out;             // [nf, length] contiguous
};

struct GiCursorArgs {
  GiStream gate;
  long long has_gate;    // 0: every sample fires
  GiAnchor anchor;
  long long nf, length, n_readers;
  double* carry;         // [nf] or null
  double carry_mod;
  GiReader r[kMaxReaders];
};

struct GiSite {
  GiStream gate;
  long long has_gate;
};

struct GiDrawArgs {
  GiAnchor used;
  const double* pool;
  long long pool_n;
  double* vals;          // [nf, length, n_sites] contiguous
  double* used_next;     // [nf]
  long long nf, length, n_sites;
  GiSite s[kMaxSites];
};

struct GiRegion {
  const double* ring;    // file f's row at ring + f * ring_fs
  long long ring_fs;
  GiStream value;
  double* out;           // [nf, mod] contiguous
  long long offset, mod;
};

struct GiWriteArgs {
  GiStream gate;
  GiAnchor anchor;
  long long nf, length, n_regions;
  GiRegion g[kMaxRegions];
};

enum : long long { kGather = 0, kNoEarlier = 1, kEarlier = 2, kEarlierSame = 3 };

struct GiReadArgs {
  GiStream src;          // the ring (kGather) or [history | writes]
  long long src_n;       // a row's cells (kGather clamps into them)
  GiStream slot;
  GiAnchor cursor;       // the write cursor (not kGather)
  long long offset, mod, mode;
  GiStream same;         // kEarlierSame: the same-sample writer's stream
  double* out;           // [rows, length] contiguous
  long long rows, length;
};

// ---- the arithmetic every form shares ------------------------------------

GI_HD long long gi_add(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

GI_HD bool gi_truthy(double x) { return x < 0.0 || x > 0.0; }

// eelmath.to_i64: truncate toward zero, NaN gives 0, saturate outside int64
GI_HD long long gi_to_i64(double x) {
  const double t = trunc(x);
  if (!(t == t)) return 0;
  if (t >= 9223372036854775808.0) return INT64_MAX;
  if (t <= -9223372036854775808.0) return INT64_MIN;
  return static_cast<long long>(t);
}

// torch.remainder of int64: the sign of the divisor
GI_HD long long gi_remainder(long long a, long long m) {
  long long r = a % m;
  if (r != 0 && ((r < 0) != (m < 0))) r += m;
  return r;
}

// a cursor position as the emitter takes it: & (M-1) for a power of two
GI_HD long long gi_ring_pos(long long pos, long long mod) {
  if ((mod & (mod - 1)) == 0) return pos & (mod - 1);
  return gi_remainder(pos, mod);
}

// torch.remainder of float64
GI_HD double gi_fremainder(double a, double b) {
  double m = fmod(a, b);
  if (m != 0.0 && ((b < 0.0) != (m < 0.0))) m += b;
  return m;
}

GI_HD double gi_at(const GiStream& s, long long f, long long t) {
  return s.p[f * s.fs + t * s.ts];
}

GI_HD void gi_anchor(const GiAnchor& a, long long f, double* af,
                     long long* ai) {
  if (a.p != nullptr) {
    *af = a.p[f * a.fs];
    *ai = gi_to_i64(*af);
  } else {
    *af = a.value;
    *ai = a.ivalue;
  }
}

GI_HD long long gi_fires(const GiStream& gate, long long has_gate,
                         long long f, long long t) {
  return has_gate ? (gi_truthy(gi_at(gate, f, t)) ? 1 : 0) : 1;
}

// K6a at sample t of file f: `incl` fires up to t, `m` t's own
GI_HD void gi_cursor_sample(const GiCursorArgs& a, long long f, long long t,
                            long long incl, long long m, long long anchor) {
  const long long excl = incl - m;
  const long long o = f * a.length + t;
  for (long long i = 0; i < a.n_readers; ++i) {
    const GiReader& r = a.r[i];
    const long long idx =
        gi_ring_pos(gi_add(gi_add(anchor, r.incl ? incl : excl), r.offset),
                    r.mod);
    if (r.kind == kPosition) {
      double v = static_cast<double>(idx);
      if (r.add_origin) v = v + r.origin;
      static_cast<double*>(r.out)[o] = v;
    } else if (r.kind == kValue) {
      static_cast<double*>(r.out)[o] = r.ring[f * r.ring_fs + idx];
    } else {
      static_cast<long long*>(r.out)[o] = idx;
    }
  }
}

GI_HD void gi_cursor_end(const GiCursorArgs& a, long long f, long long fires,
                         double anchor) {
  if (a.carry != nullptr)
    a.carry[f] = gi_fremainder(anchor + static_cast<double>(fires),
                               a.carry_mod);
}

GI_HD long long gi_draw_fires(const GiDrawArgs& a, long long f, long long t) {
  long long n = 0;
  for (long long s = 0; s < a.n_sites; ++s)
    n += gi_fires(a.s[s].gate, a.s[s].has_gate, f, t);
  return n;
}

// K6b at sample t: `before` the fires of every site before sample t
GI_HD void gi_draw_sample(const GiDrawArgs& a, long long f, long long t,
                          long long before, long long used) {
  const long long base = gi_add(used, before);
  double* out = a.vals + (f * a.length + t) * a.n_sites;
  long long within = 0;
  for (long long s = 0; s < a.n_sites; ++s) {
    long long idx = gi_add(base, within);
    idx = idx < 0 ? 0 : (idx > a.pool_n - 1 ? a.pool_n - 1 : idx);
    out[s] = a.pool[idx];
    within += gi_fires(a.s[s].gate, a.s[s].has_gate, f, t);
  }
}

// K6c: a fired sample's store; `excl` the fires before it
GI_HD void gi_write_sample(const GiRegion& g, long long f, long long t,
                           long long excl, long long anchor) {
  const long long pos =
      gi_ring_pos(gi_add(gi_add(anchor, excl), g.offset), g.mod);
  g.out[f * g.mod + pos] = gi_at(g.value, f, t);
}

// K3b at sample t of row f
GI_HD void gi_read_sample(const GiReadArgs& a, long long f, long long t) {
  const long long sigma = gi_to_i64(gi_at(a.slot, f, t));
  double v;
  if (a.mode == kGather) {
    // the plan keeps the slot inside the ring; the clamp keeps the read
    // inside the row where it would not be (the plain version raises)
    const long long i = sigma < 0 ? 0 : (sigma >= a.src_n ? a.src_n - 1
                                                         : sigma);
    v = gi_at(a.src, f, i);
  } else {
    double cf;
    long long w0c;
    gi_anchor(a.cursor, f, &cf, &w0c);
    w0c = gi_add(w0c, a.offset);
    const long long d = gi_add(gi_add(w0c, t), -sigma);
    if (a.mode == kNoEarlier) {
      const long long dtil = gi_remainder(gi_add(d, -1), a.mod) + 1;
      v = gi_at(a.src, f, a.mod + t - dtil);
    } else {
      const long long dtil = gi_remainder(d, a.mod);
      v = (a.mode == kEarlierSame && dtil == 0)
              ? gi_at(a.same, f, t)
              : gi_at(a.src, f, a.mod + t - dtil);
    }
  }
  a.out[f * a.length + t] = v;
}

#ifdef __CUDACC__

// Inclusive sum of v over the block (blockDim.x a multiple of 32);
// *total the block's whole sum.  `sums` holds 32 values of shared memory.
__device__ long long block_scan(long long v, long long* sums,
                                long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < warps ? sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += n;
    }
    sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += sums[warp - 1];
  *total = sums[warps - 1];
  __syncthreads();                      // sums is reused by the next tile
  return v;
}

__global__ void gi_cursor_kernel(const GiCursorArgs a) {
  __shared__ long long sums[32];
  const long long f = blockIdx.x;
  double af;
  long long ai;
  gi_anchor(a.anchor, f, &af, &ai);
  long long run = 0;
  for (long long t0 = 0; t0 < a.length; t0 += blockDim.x) {
    const long long t = t0 + threadIdx.x;
    const long long m =
        t < a.length ? gi_fires(a.gate, a.has_gate, f, t) : 0;
    long long total;
    const long long incl = run + block_scan(m, sums, &total);
    if (t < a.length) gi_cursor_sample(a, f, t, incl, m, ai);
    run += total;
  }
  if (threadIdx.x == 0) gi_cursor_end(a, f, run, af);
}

__global__ void gi_draws_kernel(const GiDrawArgs a) {
  __shared__ long long sums[32];
  const long long f = blockIdx.x;
  double uf;
  long long ui;
  gi_anchor(a.used, f, &uf, &ui);
  long long run = 0;
  for (long long t0 = 0; t0 < a.length; t0 += blockDim.x) {
    const long long t = t0 + threadIdx.x;
    const long long n = t < a.length ? gi_draw_fires(a, f, t) : 0;
    long long total;
    const long long incl = run + block_scan(n, sums, &total);
    if (t < a.length) gi_draw_sample(a, f, t, incl - n, ui);
    run += total;
  }
  if (threadIdx.x == 0)
    a.used_next[f] = uf + static_cast<double>(run);
}

// block (region, file): the ring's row copied, then the fired samples
// stored; a tile's stores land after the last tile's (the barriers of the
// scan), and within a tile the positions are distinct where mod >= the
// tile, so the last fired sample of a cell wins, as in the scatter
__global__ void gi_write_kernel(const GiWriteArgs a) {
  __shared__ long long sums[32];
  const GiRegion& g = a.g[blockIdx.x];
  const long long f = blockIdx.y;
  for (long long i = threadIdx.x; i < g.mod; i += blockDim.x)
    g.out[f * g.mod + i] = g.ring[f * g.ring_fs + i];
  __syncthreads();
  double af;
  long long ai;
  gi_anchor(a.anchor, f, &af, &ai);
  long long run = 0;
  for (long long t0 = 0; t0 < a.length; t0 += blockDim.x) {
    const long long t = t0 + threadIdx.x;
    const long long m = t < a.length ? gi_fires(a.gate, 1, f, t) : 0;
    long long total;
    const long long incl = run + block_scan(m, sums, &total);
    if (m) gi_write_sample(g, f, t, incl - m, ai);
    run += total;
  }
}

__global__ void gi_read_kernel(const GiReadArgs a) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.rows * a.length) return;
  gi_read_sample(a, i / a.length, i % a.length);
}

int scan_threads(long long length) {
  const long long n = (length + 31) / 32 * 32;
  return static_cast<int>(n < 32 ? 32 : (n > 1024 ? 1024 : n));
}

}  // namespace

extern "C" int zorak_gated_cursor(const void* args, void* stream) {
  const GiCursorArgs& a = *static_cast<const GiCursorArgs*>(args);
  gi_cursor_kernel<<<static_cast<unsigned>(a.nf), scan_threads(a.length), 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zorak_gated_draws(const void* args, void* stream) {
  const GiDrawArgs& a = *static_cast<const GiDrawArgs*>(args);
  gi_draws_kernel<<<static_cast<unsigned>(a.nf), scan_threads(a.length), 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zorak_gated_ring_write(const void* args, void* stream) {
  const GiWriteArgs& a = *static_cast<const GiWriteArgs*>(args);
  const dim3 grid(static_cast<unsigned>(a.n_regions),
                  static_cast<unsigned>(a.nf));
  gi_write_kernel<<<grid, scan_threads(a.length), 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zorak_dyn_ring_read(const void* args, void* stream) {
  const GiReadArgs& a = *static_cast<const GiReadArgs*>(args);
  const long long n = a.rows * a.length;
  gi_read_kernel<<<static_cast<unsigned>((n + kReadThreads - 1) /
                                         kReadThreads),
                   kReadThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

#else  // the host form

}  // namespace

extern "C" int zorak_gated_cursor_host(const void* args) {
  const GiCursorArgs& a = *static_cast<const GiCursorArgs*>(args);
  for (long long f = 0; f < a.nf; ++f) {
    double af;
    long long ai;
    gi_anchor(a.anchor, f, &af, &ai);
    long long run = 0;
    for (long long t = 0; t < a.length; ++t) {
      const long long m = gi_fires(a.gate, a.has_gate, f, t);
      run += m;
      gi_cursor_sample(a, f, t, run, m, ai);
    }
    gi_cursor_end(a, f, run, af);
  }
  return 0;
}

extern "C" int zorak_gated_draws_host(const void* args) {
  const GiDrawArgs& a = *static_cast<const GiDrawArgs*>(args);
  for (long long f = 0; f < a.nf; ++f) {
    double uf;
    long long ui;
    gi_anchor(a.used, f, &uf, &ui);
    long long run = 0;
    for (long long t = 0; t < a.length; ++t) {
      gi_draw_sample(a, f, t, run, ui);
      run += gi_draw_fires(a, f, t);
    }
    a.used_next[f] = uf + static_cast<double>(run);
  }
  return 0;
}

extern "C" int zorak_gated_ring_write_host(const void* args) {
  const GiWriteArgs& a = *static_cast<const GiWriteArgs*>(args);
  for (long long r = 0; r < a.n_regions; ++r) {
    const GiRegion& g = a.g[r];
    for (long long f = 0; f < a.nf; ++f) {
      for (long long i = 0; i < g.mod; ++i)
        g.out[f * g.mod + i] = g.ring[f * g.ring_fs + i];
      double af;
      long long ai;
      gi_anchor(a.anchor, f, &af, &ai);
      long long run = 0;
      for (long long t = 0; t < a.length; ++t) {
        if (gi_fires(a.gate, 1, f, t)) {
          gi_write_sample(g, f, t, run, ai);
          ++run;
        }
      }
    }
  }
  return 0;
}

extern "C" int zorak_dyn_ring_read_host(const void* args) {
  const GiReadArgs& a = *static_cast<const GiReadArgs*>(args);
  for (long long f = 0; f < a.rows; ++f)
    for (long long t = 0; t < a.length; ++t) gi_read_sample(a, f, t);
  return 0;
}

#endif  // __CUDACC__
