// The device side of a generated section: K10's @block (block_section)
// and K11's whole plugin (device_exec).
//
// zorak_tpu_torch/lowering/devgen.py prints each audio-coupled section as
// CUDA C through shadow/cgen.py's expression emitter; what that emitter
// routes through its host callback or its C prelude lives here: the heap,
// the bulk copies, the pending slider masks, the staged MIDI queues and
// the WDL FFT family.  Everything else of the EEL2 scalar contract comes
// from scan_ops.cuh.
//
// Every function is __host__ __device__: the same generated text builds
// with nvcc for the card and with g++ for the tests (its host form), and
// the two give the same bits wherever no libm call is made.  Build with
// two roundings a multiply-add (nvcc --fmad=false, g++ -ffp-contract=off).
//
// A section runs in phases (lowering/devgen.py): thread 0 alone runs the
// ordered code, and every thread of the file's CUDA block runs the FFT
// family and the loops whose iterations are independent, a strided share
// each, between barriers.  The same text serves the host form: there a
// block step runs the threads' shares one after another (ZB_STEPS).
//
// The heap follows the reference's device sections
// (zorak_tpu/lowering/devgen.py `_mem_addr`), not the golden's growable
// heap: a section owns `mem_size` cells, a dynamic address is clamped to
// [0, mem_size - 1], a bulk operation's start is clamped so that the whole
// run stays inside, and an FFT whose region leaves the heap is a silent
// no-op.  (A static address past the heap is refused when the source is
// generated.)
//
// K11's sections use the reference's reduced heap instead (devgen.py
// `_mem_addr`, `_mem_get`, `_mem_set` under reduced_heap): a dynamic
// address is raised to at least 0 and not clamped above, a read at or
// past mem_size gives 0, and a write there is dropped; every dynamic write
// and every FFT region that leaves the heap inside its page raise the
// high-water slot (`hiwater`) to its address, so that the executor can
// see that the render needs a larger heap.  K10 leaves `hiwater` null.

#pragma once

#include "scan_ops.cuh"

#ifdef __CUDACC__
#define ZB_FN static __host__ __device__
#else
#define ZB_FN static inline
#endif
// a read of a table no section writes (twiddles, permutations): through
// the read-only data cache on the card
#ifdef __CUDA_ARCH__
#define ZB_LDG(p) __ldg(p)
#else
#define ZB_LDG(p) (*(p))
#endif

#define ZB_MIDI_OUT_CAP 64   // staged sends a block; later ones drop
#define ZB_PAGE 65536        // WDL's page: an FFT region stays inside one

// What a section reads besides its code: one file's view and its tables.
struct ZB {
  double* V;               // the var slots of the section (DeviceSection.slots)
  double* M;               // the heap row: [plugin heap | MIDI out table]
  long long mem_size;      // plugin heap cells
  long long mo_base;       // the MIDI out table: [count | CAP rows of 4]
  double samplesblock;
  const double* midi_ev;   // this block's staged host events [k][4]
  double midi_n;           // how many there are
  double* scratch;         // FFT workspace of this file
  const double* tw;        // cos, sin of 2 pi k / tw_n, k < tw_n / 2
  long long tw_n;
  unsigned long long* serial_runs;  // block loops run on thread 0 (or null)
  // K11 only (K10 leaves them zero):
  const double* pool;      // the staged MT19937 draws (u32 values), shared
  long long pool_n;        // how many
  double* hiwater;         // the reduced heap's high-water slot (or null)
};

// -- phases: who runs what ------------------------------------------------------
//
// ZT is the calling thread of a file's CUDA block: t of nt.  On the card
// every thread calls the phases with its own t.  In the host form the
// phases are called once, and a block step runs the threads t = 0 ... nt - 1
// (or nt - 1 ... 0 where `desc`) one after another, so that the tests see
// every split the card makes.
struct ZT {
  long long t, nt;
  int desc;
};
#ifdef __CUDA_ARCH__
// thread 0 alone, then a barrier
#define ZB_SOLO(team, ...) \
  do { if ((team).t == 0) { __VA_ARGS__; } __syncthreads(); } while (0)
// every thread its strided share (t, nt in scope), then a barrier
#define ZB_STEPS(team, ...) \
  do { const long long t = (team).t, nt = (team).nt; __VA_ARGS__; \
       __syncthreads(); } while (0)
#else
#define ZB_SOLO(team, ...) do { __VA_ARGS__; } while (0)
#define ZB_STEPS(team, ...) \
  do { for (long long zb_k = 0; zb_k < (team).nt; ++zb_k) { \
    const long long nt = (team).nt; \
    const long long t = (team).desc ? nt - 1 - zb_k : zb_k; \
    (void)t; __VA_ARGS__; } } while (0)
#endif

// -- the heap ------------------------------------------------------------------

// EEL2 bracket addressing trunc(base + idx + 1e-5), clamped to the heap.
ZB_FN long long zb_addr(const ZB* S, double base, double idx) {
  long long a = zt_i64(base + idx + 1.0e-5);
  if (a < 0) a = 0;
  if (a >= S->mem_size) a = S->mem_size - 1;
  return a;
}
ZB_FN double zb_mget(const ZB* S, double base, double idx) {
  return S->M[zb_addr(S, base, idx)];
}
ZB_FN double zb_mset(ZB* S, double v, double base, double idx) {
  S->M[zb_addr(S, base, idx)] = v;
  return v;
}

// The reduced heap: trunc(base + idx + 1e-5), raised to 0 and not clamped
// above; reads past the heap give 0, writes there drop and mark the high
// water (every dynamic write raises it to its address, as the reference's
// does).
ZB_FN long long zb_raddr(const ZB* S, double base, double idx) {
  (void)S;
  const long long a = zt_i64(base + idx + 1.0e-5);
  return a < 0 ? 0 : a;
}
ZB_FN double zb_rat(const ZB* S, long long a) {
  return a < S->mem_size ? S->M[a] : 0.0;
}
ZB_FN double zb_rmget(const ZB* S, double base, double idx) {
  return zb_rat(S, zb_raddr(S, base, idx));
}
ZB_FN void zb_rmset(ZB* S, long long a, double v) {
  const double hw = (double)a;
  if (*S->hiwater < hw) *S->hiwater = hw;
  if (a < S->mem_size) S->M[a] = v;
}

// -- rand() over the staged pool ------------------------------------------------
//
// rand(limit) = u32 * (1/4294967295) * max(floor(limit), 1), the u32 the
// pool's cell at the cursor (*pos, a var slot).  The cursor counts past the
// pool's end and the read clamps; the executor refuses a render that used
// more draws than the pool held.
ZB_FN double zb_rand(ZB* S, double* pos, double limit) {
  const double c = *pos;
  long long i = zt_i64(c);
  if (i < 0) i = 0;
  if (i > S->pool_n - 1) i = S->pool_n - 1;
  const double u = ZB_LDG(S->pool + i);
  *pos = c + 1.0;
  double top = floor(limit);
  if (!(top >= 1.0)) top = 1.0;
  return u * (1.0 / 4294967295.0) * top;
}

// memset/memcpy's run: n = max(0, trunc(len)) cells (at most the heap)
// from blob_address(dest), the start clamped so that the run stays inside.
ZB_FN long long zb_run_len(const ZB* S, double len) {
  long long n = zt_i64(len);
  if (n < 0) n = 0;
  return n > S->mem_size ? S->mem_size : n;
}
ZB_FN long long zb_run_start(const ZB* S, double x, long long n) {
  long long a = zt_i64(x + 1.0e-5);
  if (a < 0) a = 0;
  return a > S->mem_size - n ? S->mem_size - n : a;
}
ZB_FN double zb_memset(ZB* S, double dest, double val, double len) {
  const long long n = zb_run_len(S, len);
  const long long d = zb_run_start(S, dest, n);
  for (long long i = 0; i < n; ++i) S->M[d + i] = val;
  return dest;
}
// overlap-safe, as memmove
ZB_FN double zb_memcpy(ZB* S, double dest, double src, double len) {
  const long long n = zb_run_len(S, len);
  const long long d = zb_run_start(S, dest, n);
  const long long s = zb_run_start(S, src, n);
  if (d < s) {
    for (long long i = 0; i < n; ++i) S->M[d + i] = S->M[s + i];
  } else if (d > s) {
    for (long long i = n - 1; i >= 0; --i) S->M[d + i] = S->M[s + i];
  }
  return dest;
}

// -- pending slider masks (sliderchange / slider_automate) --------------------

// A mask as the golden holds it: trunc toward zero, non-positive -> 0.
ZB_FN unsigned long long zb_mask_bits(double m) {
  const long long i = zt_i64(m);
  return i > 0 ? (unsigned long long)i : 0ull;
}
// OR `mask` into the pending slot `*slot` (a mask held as a double).
ZB_FN double zb_pend_or(double* slot, double mask) {
  *slot = (double)(zb_mask_bits(*slot) | zb_mask_bits(mask));
  return 0.0;
}

// -- MIDI ----------------------------------------------------------------------

// The next staged host event at cursor slot *pos, or nullptr when the
// block's queue is spent (the out-params are then left as they were).
ZB_FN const double* zb_midirecv(ZB* S, double* pos) {
  const double p = *pos;
  if (!(p < S->midi_n)) return nullptr;
  *pos = p + 1.0;
  return S->midi_ev + 4 * zt_i64(p);
}

// Append (offset, b1, b2, b3) to the block's OUT table, bytes masked as
// the golden masks them; past ZB_MIDI_OUT_CAP sends drop.  Returns b1.
ZB_FN double zb_midisend(ZB* S, double ofs, double b1, double b2, double b3) {
  double* T = S->M + S->mo_base;
  const long long n = zt_i64(T[0]);
  if (n < ZB_MIDI_OUT_CAP) {
    double* row = T + 1 + 4 * n;
    const long long o = zt_i64(ofs);
    row[0] = (double)(o > 0 ? o : 0);
    row[1] = (double)(zt_i64(b1) & 255);
    row[2] = (double)(zt_i64(b2) & 255);
    row[3] = (double)(zt_i64(b3) & 255);
  }
  T[0] = (double)(n + 1 < ZB_MIDI_OUT_CAP ? n + 1 : ZB_MIDI_OUT_CAP);
  return b1;
}
// The three-argument form: msg23 = b2 + 256 * b3.
ZB_FN double zb_midisend3(ZB* S, double ofs, double b1, double m23) {
  const long long m = zt_i64(m23);
  return zb_midisend(S, ofs, b1, (double)(m & 255), (double)((m >> 8) & 255));
}

// -- the WDL FFT family (runtime/fftops.py's contract) -------------------------
//
// Sizes are powers of two in [16, 32768]; a region must lie inside one
// page of 65,536 doubles and, here, inside the heap, or the call is a
// silent no-op.  The transforms are an iterative radix-2 in f64 on the
// calling thread, through the section's scratch row, with the twiddles of
// a table the host fills once (cos and sin of 2 pi k / tw_n).  `perm` is
// the port's perm_table of the size, a constant table of the generated
// source: natural[k] = wdl[perm[k]].

// fftops._round_index: trunc(v +- 1e-5) by v's sign; NaN and inf give -1.
ZB_FN long long zb_round_index(double v) {
  if (!(v == v) || v - v != 0.0) return -1;
  return zt_i64(v + (v >= 0.0 ? 1.0e-5 : -1.0e-5));
}
// A region of `span` cells from `base` inside one page and the heap.  On
// a reduced heap a region inside its page that leaves the heap marks the
// high water with its last cell (the golden grows its heap for it).
ZB_FN bool zb_region_ok(const ZB* S, long long base, long long span) {
  if (base < 0 || span <= 0) return false;
  if (base / ZB_PAGE != (base + span - 1) / ZB_PAGE) return false;
  if (base + span <= S->mem_size) return true;
  if (S->hiwater && *S->hiwater < (double)(base + span - 1))
    *S->hiwater = (double)(base + span - 1);
  return false;
}
ZB_FN long long zb_fft_base(double dest) {
  const long long b = zb_round_index(dest);
  return b < 0 ? 0 : b;
}
ZB_FN long long zb_bitrev(long long k, long long n) {
  long long r = 0;
  for (long long m = n >> 1; m > 0; m >>= 1, k >>= 1) r = (r << 1) | (k & 1);
  return r;
}
// x: n complex (re, im interleaved) in bit-reversed order -> the
// unnormalized DFT in natural order; `inverse` takes e^{+i}.
ZB_FN void zb_fft_core(double* x, long long n, const double* tw,
                       long long tw_n, bool inverse) {
  for (long long len = 2; len <= n; len <<= 1) {
    const long long half = len >> 1, step = tw_n / len;
    for (long long i = 0; i < n; i += len) {
      for (long long j = 0; j < half; ++j) {
        const double wr = ZB_LDG(tw + 2 * j * step);
        const double wi = inverse ? ZB_LDG(tw + 2 * j * step + 1)
                                  : -ZB_LDG(tw + 2 * j * step + 1);
        double* a = x + 2 * (i + j);
        double* b = x + 2 * (i + j + half);
        const double tr = b[0] * wr - b[1] * wi;
        const double ti = b[0] * wi + b[1] * wr;
        b[0] = a[0] - tr;
        b[1] = a[1] - ti;
        a[0] = a[0] + tr;
        a[1] = a[1] + ti;
      }
    }
  }
}

// fft: natural-order DFT of n complex, stored in WDL order.
ZB_FN double zb_fft(ZB* S, double dest, long long n, const int* perm) {
  const long long base = zb_fft_base(dest);
  if (!zb_region_ok(S, base, 2 * n)) return 0.0;
  double* x = S->M + base;
  double* w = S->scratch;
  for (long long k = 0; k < n; ++k) {
    const long long r = zb_bitrev(k, n);
    w[2 * r] = x[2 * k];
    w[2 * r + 1] = x[2 * k + 1];
  }
  zb_fft_core(w, n, S->tw, S->tw_n, false);
  for (long long k = 0; k < n; ++k) {
    x[2 * ZB_LDG(perm + k)] = w[2 * k];
    x[2 * ZB_LDG(perm + k) + 1] = w[2 * k + 1];
  }
  return 0.0;
}
// ifft: WDL order in, the unnormalized inverse in natural order out.
ZB_FN double zb_ifft(ZB* S, double dest, long long n, const int* perm) {
  const long long base = zb_fft_base(dest);
  if (!zb_region_ok(S, base, 2 * n)) return 0.0;
  double* x = S->M + base;
  double* w = S->scratch;
  for (long long k = 0; k < n; ++k) {
    const long long r = zb_bitrev(k, n);
    w[2 * r] = x[2 * ZB_LDG(perm + k)];
    w[2 * r + 1] = x[2 * ZB_LDG(perm + k) + 1];
  }
  zb_fft_core(w, n, S->tw, S->tw_n, true);
  for (long long k = 0; k < 2 * n; ++k) x[k] = w[k];
  return 0.0;
}
// fft_permute (ipermute = false): buf = buf[perm]; fft_ipermute:
// buf[perm] = buf.
ZB_FN double zb_fft_permute(ZB* S, double dest, long long n, const int* perm,
                            bool ipermute) {
  const long long base = zb_fft_base(dest);
  if (!zb_region_ok(S, base, 2 * n)) return 0.0;
  double* x = S->M + base;
  double* w = S->scratch;
  for (long long k = 0; k < n; ++k) {
    const long long from = ipermute ? k : ZB_LDG(perm + k);
    const long long to = ipermute ? ZB_LDG(perm + k) : k;
    w[2 * to] = x[2 * from];
    w[2 * to + 1] = x[2 * from + 1];
  }
  for (long long k = 0; k < 2 * n; ++k) x[k] = w[k];
  return 0.0;
}
// fft_real(N): N/2 bins of 2 * rfft(x), bin 0 packing (2 DC, 2 Nyquist),
// in WDL order of N/2 (`perm` is perm_table(N / 2)).
ZB_FN double zb_fft_real(ZB* S, double dest, long long n, const int* perm) {
  const long long base = zb_fft_base(dest);
  if (!zb_region_ok(S, base, n)) return 0.0;
  const long long half = n / 2;
  double* x = S->M + base;
  double* w = S->scratch;
  for (long long t = 0; t < n; ++t) {
    const long long r = zb_bitrev(t, n);
    w[2 * r] = x[t];
    w[2 * r + 1] = 0.0;
  }
  zb_fft_core(w, n, S->tw, S->tw_n, false);
  x[2 * ZB_LDG(perm)] = 2.0 * w[0];
  x[2 * ZB_LDG(perm) + 1] = 2.0 * w[2 * half];
  for (long long k = 1; k < half; ++k) {
    x[2 * ZB_LDG(perm + k)] = 2.0 * w[2 * k];
    x[2 * ZB_LDG(perm + k) + 1] = 2.0 * w[2 * k + 1];
  }
  return 0.0;
}
// ifft_real(N): the inverse of fft_real scaled by 2N (the caller applies
// 0.5 / N): x = 2 Re(the unnormalized inverse DFT of the hermitian
// spectrum whose bins are the WDL bins / 2).
ZB_FN double zb_ifft_real(ZB* S, double dest, long long n, const int* perm) {
  const long long base = zb_fft_base(dest);
  if (!zb_region_ok(S, base, n)) return 0.0;
  const long long half = n / 2;
  double* x = S->M + base;
  double* w = S->scratch;
  const long long r0 = zb_bitrev(0, n), rh = zb_bitrev(half, n);
  w[2 * r0] = x[2 * ZB_LDG(perm)] / 2.0;
  w[2 * r0 + 1] = 0.0;
  w[2 * rh] = x[2 * ZB_LDG(perm) + 1] / 2.0;
  w[2 * rh + 1] = 0.0;
  for (long long k = 1; k < half; ++k) {
    const long long pk = ZB_LDG(perm + k);
    const double re = x[2 * pk] / 2.0, im = x[2 * pk + 1] / 2.0;
    const long long rk = zb_bitrev(k, n), rn = zb_bitrev(n - k, n);
    w[2 * rk] = re;
    w[2 * rk + 1] = im;
    w[2 * rn] = re;
    w[2 * rn + 1] = 0.0 - im;
  }
  zb_fft_core(w, n, S->tw, S->tw_n, true);
  for (long long t = 0; t < n; ++t) x[t] = 2.0 * w[2 * t];
  return 0.0;
}
// convolve_c: dest[k] *= src[k] over n complex (the source read first,
// through the scratch row, so that overlapping regions read as before).
ZB_FN double zb_convolve_c(ZB* S, double dest, double src, long long n) {
  const long long d = zb_fft_base(dest), s = zb_fft_base(src);
  if (!zb_region_ok(S, d, 2 * n) || !zb_region_ok(S, s, 2 * n)) return 0.0;
  double* w = S->scratch;
  for (long long k = 0; k < 2 * n; ++k) w[k] = S->M[s + k];
  double* x = S->M + d;
  for (long long k = 0; k < n; ++k) {
    const double dr = x[2 * k], di = x[2 * k + 1];
    x[2 * k] = dr * w[2 * k] - di * w[2 * k + 1];
    x[2 * k + 1] = dr * w[2 * k + 1] + di * w[2 * k];
  }
  return 0.0;
}

// -- the FFT family in block form ----------------------------------------------
//
// The same transforms across a file's CUDA block: the loads, each stage's
// butterflies and the stores are thread-strided, with a barrier between
// steps.  A butterfly is the same four lines of arithmetic with the same
// twiddle as zb_fft_core's, and no stage is fused, so the result equals the
// one-thread form bit for bit.  `base` is the region's first cell, decided
// once by thread 0 (zb_fft_region) and shared: -1 is the WDL no-op, and
// every thread then returns alike.

// zb_fft_base and zb_region_ok of the one-thread forms: the region's base,
// or -1 where the call is a no-op.
ZB_FN long long zb_fft_region(const ZB* S, double dest, long long span) {
  const long long base = zb_fft_base(dest);
  return zb_region_ok(S, base, span) ? base : -1;
}
// zb_bitrev with the card's bit reversal (n a power of two >= 2)
ZB_FN long long zb_bitrev_n(long long k, long long n) {
#ifdef __CUDA_ARCH__
  return (long long)(__brevll((unsigned long long)k) >> (64 - (63 - __clzll(n))));
#else
  return zb_bitrev(k, n);
#endif
}
// one stage of zb_fft_core: butterfly b = t, t + nt, ... of n / 2
ZB_FN void zb_blk_stage(double* x, long long n, long long len, const double* tw,
                        long long tw_n, bool inverse, long long t,
                        long long nt) {
  const long long half = len >> 1, step = tw_n / len;
  for (long long b = t; b < (n >> 1); b += nt) {
    const long long j = b & (half - 1);
    const long long ij = 2 * b - j;            // i + j of zb_fft_core
    const double wr = ZB_LDG(tw + 2 * j * step);
    const double wi = inverse ? ZB_LDG(tw + 2 * j * step + 1)
                              : -ZB_LDG(tw + 2 * j * step + 1);
    double* a = x + 2 * ij;
    double* c = x + 2 * (ij + half);
    const double tr = c[0] * wr - c[1] * wi;
    const double ti = c[0] * wi + c[1] * wr;
    c[0] = a[0] - tr;
    c[1] = a[1] - ti;
    a[0] = a[0] + tr;
    a[1] = a[1] + ti;
  }
}
ZB_FN void zb_blk_fft_core(double* x, long long n, const double* tw,
                           long long tw_n, bool inverse, ZT team) {
  for (long long len = 2; len <= n; len <<= 1)
    ZB_STEPS(team, zb_blk_stage(x, n, len, tw, tw_n, inverse, t, nt));
}

ZB_FN void zb_blk_fft(ZB* S, long long base, long long n, const int* perm,
                      ZT team) {
  if (base < 0) return;
  double* x = S->M + base;
  double* w = S->scratch;
  ZB_STEPS(team, for (long long k = t; k < n; k += nt) {
    const long long r = zb_bitrev_n(k, n);
    w[2 * r] = x[2 * k];
    w[2 * r + 1] = x[2 * k + 1];
  });
  zb_blk_fft_core(w, n, S->tw, S->tw_n, false, team);
  ZB_STEPS(team, for (long long k = t; k < n; k += nt) {
    x[2 * ZB_LDG(perm + k)] = w[2 * k];
    x[2 * ZB_LDG(perm + k) + 1] = w[2 * k + 1];
  });
}
ZB_FN void zb_blk_ifft(ZB* S, long long base, long long n, const int* perm,
                       ZT team) {
  if (base < 0) return;
  double* x = S->M + base;
  double* w = S->scratch;
  ZB_STEPS(team, for (long long k = t; k < n; k += nt) {
    const long long r = zb_bitrev_n(k, n);
    w[2 * r] = x[2 * ZB_LDG(perm + k)];
    w[2 * r + 1] = x[2 * ZB_LDG(perm + k) + 1];
  });
  zb_blk_fft_core(w, n, S->tw, S->tw_n, true, team);
  ZB_STEPS(team, for (long long k = t; k < 2 * n; k += nt) x[k] = w[k]);
}
ZB_FN void zb_blk_fft_permute(ZB* S, long long base, long long n,
                              const int* perm, bool ipermute, ZT team) {
  if (base < 0) return;
  double* x = S->M + base;
  double* w = S->scratch;
  ZB_STEPS(team, for (long long k = t; k < n; k += nt) {
    const long long from = ipermute ? k : ZB_LDG(perm + k);
    const long long to = ipermute ? ZB_LDG(perm + k) : k;
    w[2 * to] = x[2 * from];
    w[2 * to + 1] = x[2 * from + 1];
  });
  ZB_STEPS(team, for (long long k = t; k < 2 * n; k += nt) x[k] = w[k]);
}
ZB_FN void zb_blk_fft_real(ZB* S, long long base, long long n, const int* perm,
                           ZT team) {
  if (base < 0) return;
  const long long half = n / 2;
  double* x = S->M + base;
  double* w = S->scratch;
  ZB_STEPS(team, for (long long k = t; k < n; k += nt) {
    const long long r = zb_bitrev_n(k, n);
    w[2 * r] = x[k];
    w[2 * r + 1] = 0.0;
  });
  zb_blk_fft_core(w, n, S->tw, S->tw_n, false, team);
  ZB_STEPS(team, for (long long k = t; k < half; k += nt) {
    x[2 * ZB_LDG(perm + k)] = 2.0 * w[2 * k];
    x[2 * ZB_LDG(perm + k) + 1] = 2.0 * w[k == 0 ? 2 * half : 2 * k + 1];
  });
}
ZB_FN void zb_blk_ifft_real(ZB* S, long long base, long long n,
                            const int* perm, ZT team) {
  if (base < 0) return;
  const long long half = n / 2;
  double* x = S->M + base;
  double* w = S->scratch;
  ZB_STEPS(team, for (long long k = t; k < half; k += nt) {
    const long long pk = ZB_LDG(perm + k);
    if (k == 0) {
      const long long r0 = zb_bitrev_n(0, n), rh = zb_bitrev_n(half, n);
      w[2 * r0] = x[2 * pk] / 2.0;
      w[2 * r0 + 1] = 0.0;
      w[2 * rh] = x[2 * pk + 1] / 2.0;
      w[2 * rh + 1] = 0.0;
    } else {
      const double re = x[2 * pk] / 2.0, im = x[2 * pk + 1] / 2.0;
      const long long rk = zb_bitrev_n(k, n), rn = zb_bitrev_n(n - k, n);
      w[2 * rk] = re;
      w[2 * rk + 1] = im;
      w[2 * rn] = re;
      w[2 * rn + 1] = 0.0 - im;
    }
  });
  zb_blk_fft_core(w, n, S->tw, S->tw_n, true, team);
  ZB_STEPS(team, for (long long k = t; k < n; k += nt) x[k] = 2.0 * w[2 * k]);
}
ZB_FN void zb_blk_convolve_c(ZB* S, long long d, long long s, long long n,
                             ZT team) {
  if (d < 0 || s < 0) return;
  double* w = S->scratch;
  double* x = S->M + d;
  ZB_STEPS(team, for (long long k = t; k < 2 * n; k += nt) w[k] = S->M[s + k]);
  ZB_STEPS(team, for (long long k = t; k < n; k += nt) {
    const double dr = x[2 * k], di = x[2 * k + 1];
    x[2 * k] = dr * w[2 * k] - di * w[2 * k + 1];
    x[2 * k + 1] = dr * w[2 * k + 1] + di * w[2 * k];
  });
}

// -- block loops: thread 0's run-time decision ----------------------------------
//
// A loop that devgen.py prints for the whole block runs there only if its
// iterations provably touch no common heap cell; thread 0 checks that on
// the values of this run and otherwise runs the loop itself, counted here.

ZB_FN void zb_count_serial(ZB* S) {
  if (!S->serial_runs) return;
#ifdef __CUDA_ARCH__
  atomicAdd(S->serial_runs, 1ull);
#else
  *S->serial_runs += 1;
#endif
}
#define ZB_EXACT 9007199254740992.0   // 2^53: integers in doubles stay exact
// start + k equals k increments of the induction from an integer start.
ZB_FN bool zb_trip_ok(double start, long long n) {
  return n <= 0 || (start == floor(start)
                    && fabs(start) + (double)n < ZB_EXACT);
}
// base[iv + c] over the trip: the cells b + start + c + k, k < n, all
// inside [0, mem_size - 1], so that the clamp folds no two of them (an
// integer base keeps the address exact).
ZB_FN bool zb_unit_span(const ZB* S, double b, double start, double c,
                        long long n, long long* lo, long long* hi) {
  if (!(b == floor(b) && fabs(b) < ZB_EXACT
        && fabs(start) + fabs(c) + (double)n < ZB_EXACT)) return false;
  const double first = b + (start + c);
  if (!(first >= 0.0 && first + (double)(n - 1) <= (double)(S->mem_size - 1)))
    return false;
  *lo = (long long)first;
  *hi = *lo + n - 1;
  return true;
}
// The cells zb_addr(S, b, i) can reach for i in [i_lo, i_hi]: zb_addr is
// non-decreasing in i where b + i stays finite.
ZB_FN bool zb_read_span(const ZB* S, double b, double i_lo, double i_hi,
                        long long* lo, long long* hi) {
  if (!(fabs(b) < ZB_EXACT)) return false;
  *lo = zb_addr(S, b, i_lo);
  *hi = zb_addr(S, b, i_hi);
  return true;
}
ZB_FN bool zb_apart(long long lo0, long long hi0, long long lo1, long long hi1) {
  return hi0 < lo1 || hi1 < lo0;
}
