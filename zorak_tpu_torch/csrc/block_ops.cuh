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
// `_mem_addr`, `_mem_get`, `_mem_set` under reduced_heap), over a view of
// their own (ZX, at the end of this file, compiled where ZX_PAGE is
// defined): a dynamic address is raised to at least 0 and not clamped
// above, a read at or past mem_size gives 0, and a write there is
// dropped; every dynamic write and every FFT region that leaves the heap
// inside its page raise the high-water mark to its address, so that the
// executor can see that the render needs a larger heap.

#pragma once

#include "scan_ops.cuh"

// K11 defines ZB_FORCE_INLINE: its one kernel inlines every helper, so
// that the view stays in registers.
#if defined(__CUDACC__) && defined(ZB_FORCE_INLINE)
#define ZB_FN static __host__ __device__ __forceinline__
#elif defined(__CUDACC__)
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

// The tables a section's host-service calls read (lowering/devgen.py
// HostTables): the loaded sample pool's generation, the file table that
// file_mem copies from, the string literals.  Built with the program,
// staged on the device once a render, read-only and shared by the files of
// a launch; a table no printed call reads is null.  A pool row a sample id
// (row 0: no entry, all zeros).
struct ZH {
  const float* pool_data;         // every entry's [frames, channels] f32
  const long long* pool_offs;     // an entry's first cell in pool_data
  const long long* pool_frm;      // its frames
  const long long* pool_nch;      // its channels
  const long long* pool_pv_off;   // its first cell in pool_pv
  const long long* pool_pv_bins;  // its preview bins
  const long long* pool_order;    // the sample ids in load order
  const double* pool_meta;        // [row][3]: srate, peak, rms
  const double* pool_pv;          // [bin][3]: min, max, rms
  long long pool_maxsid;          // the largest sample id
  long long pool_n_order;
  const double* files;            // file_mem's chunks, one after another
  const long long* str_h;         // the literals' handles
  const double* str_len;          // their lengths
  const double* str_chars;        // [literal][str_w] their characters
  long long str_n, str_w;
};

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
  // set where a section uses gmem or the message bus (zero-initialised
  // where the generated text leaves them out)
  double* G;               // gmem: a graph's shared segment, or the heap's window
  long long gmem_cells;
  long long msg_out;       // the msg OUT table in M: [count | CAP rows of 8]
  long long msg_in;        // the msg IN region in M: [drop cell | queues]
  ZH H;                    // the host-service tables (zero where unused)
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
// the host form counts the barriers the card would pass: a run of
// thread 0's code or a block step each (zb_host_barrier_count)
#ifdef __CUDACC__
#define ZB_BARRIER_COUNTED() ((void)0)
#else
static long long zb_host_barriers = 0;
extern "C" long long zb_host_barrier_count(void) { return zb_host_barriers; }
#define ZB_BARRIER_COUNTED() ((void)++zb_host_barriers)
#endif
#define ZB_SOLO(team, ...) do { __VA_ARGS__; ZB_BARRIER_COUNTED(); } while (0)
#define ZB_STEPS(team, ...) \
  do { for (long long zb_k = 0; zb_k < (team).nt; ++zb_k) { \
    const long long nt = (team).nt; \
    const long long t = (team).desc ? nt - 1 - zb_k : zb_k; \
    (void)t; __VA_ARGS__; } ZB_BARRIER_COUNTED(); } while (0)
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

// memset/memcpy's run: n = max(0, trunc(len)) cells (at most the heap)
// from blob_address(dest), the start clamped so that the run stays inside
// (either view: K10's ZB, K11's ZX).
template <class View>
ZB_FN long long zb_run_len(const View* S, double len) {
  long long n = zt_i64(len);
  if (n < 0) n = 0;
  return n > S->mem_size ? S->mem_size : n;
}
template <class View>
ZB_FN long long zb_run_start(const View* S, double x, long long n) {
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
template <class View>
ZB_FN const double* zb_midirecv(View* S, double* pos) {
  const double p = *pos;
  if (!(p < S->midi_n)) return nullptr;
  *pos = p + 1.0;
  return S->midi_ev + 4 * zt_i64(p);
}

// Append (offset, b1, b2, b3) to the block's OUT table, bytes masked as
// the golden masks them; past ZB_MIDI_OUT_CAP sends drop.  Returns b1.
template <class View>
ZB_FN double zb_midisend(View* S, double ofs, double b1, double b2, double b3) {
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
template <class View>
ZB_FN double zb_midisend3(View* S, double ofs, double b1, double m23) {
  const long long m = zt_i64(m23);
  return zb_midisend(S, ofs, b1, (double)(m & 255), (double)((m >> 8) & 255));
}

// -- gmem (shadow/state.py's HostServices.gmem_*) -------------------------------
//
// An index is max(0, trunc(x + 1e-5)) (0 for NaN and inf); a read past the
// segment gives 0 and a write there is dropped; a bulk operation's count is
// cut at the segment's end.  Counts come static from the printer, so the
// heap side of gmem_get and gmem_put was checked to lie inside the heap.
// The segment side is the same in either view (K10's ZB, K11's ZX: G and
// gmem_cells); the heap side of gmem_get and gmem_put is the view's own
// (zb_gmem_bulk, zx_gmem_bulk).

ZB_FN long long zb_gidx(double x) {
  const long long i = zt_i64(x + 1.0e-5);
  return i > 0 ? i : 0;
}
template <class View>
ZB_FN double zb_gmem_get(const View* S, double idx) {
  const long long i = zb_gidx(idx);
  return i < S->gmem_cells ? S->G[i] : 0.0;
}
template <class View>
ZB_FN double zb_gmem_set(View* S, double idx, double v) {
  const long long i = zb_gidx(idx);
  if (i < S->gmem_cells) S->G[i] = v;
  return v;
}
// gmem_get (to_mem) and gmem_put: n <= count cells between the heap at m
// and the segment at g; returns n.
ZB_FN double zb_gmem_bulk(ZB* S, long long m, double g, long long count,
                          int to_mem) {
  const long long gi = zb_gidx(g);
  if (gi >= S->gmem_cells) return 0.0;
  const long long n = count < S->gmem_cells - gi ? count : S->gmem_cells - gi;
  if (n <= 0) return 0.0;
  for (long long k = 0; k < n; ++k) {
    if (to_mem) S->M[m + k] = S->G[gi + k];
    else S->G[gi + k] = S->M[m + k];
  }
  return (double)n;
}
template <class View>
ZB_FN double zb_gmem_fill(View* S, double dst, double v, long long count) {
  const long long i = zb_gidx(dst);
  if (i >= S->gmem_cells) return 0.0;
  const long long n = count < S->gmem_cells - i ? count : S->gmem_cells - i;
  for (long long k = 0; k < n; ++k) S->G[i + k] = v;
  return (double)(n > 0 ? n : 0);
}
// overlap-safe; d, s and n (> 0) checked when printed
template <class View>
ZB_FN double zb_gmem_copy(View* S, long long d, long long s, long long n) {
  if (d < s) {
    for (long long k = 0; k < n; ++k) S->G[d + k] = S->G[s + k];
  } else if (d > s) {
    for (long long k = n - 1; k >= 0; --k) S->G[d + k] = S->G[s + k];
  }
  return (double)n;
}

// -- the message bus of a graph's lockstep member (comm/bus.py) -----------------
//
// Sends append [bc, dest, chan, tag, a, b, c, d] to the heap's OUT table
// (past ZB_MSG_OUT_CAP they count into the drop cell, the IN region's first
// cell); K10's epilogue publishes the table to the graph's ring window.
// K10's prologue routes the window's matched entries into the queues,
// [head, count, ZB_MSG_QUEUE_CAP rows of 6: sender, tag, a, b, c, d], which
// the receives pop.

#define ZB_MSG_OUT_CAP 32
#define ZB_MSG_QUEUE_CAP 64
#define ZB_MSG_ENT 8
#define ZB_MSG_QENT 6

ZB_FN void zb_msg_out(ZB* S, double bc, double dest, double chan, double tag,
                      double a, double b, double c, double d) {
  double* T = S->M + S->msg_out;
  const long long n = zt_i64(T[0]);
  if (n < ZB_MSG_OUT_CAP) {
    double* r = T + 1 + ZB_MSG_ENT * n;
    r[0] = bc; r[1] = dest; r[2] = chan; r[3] = tag;
    r[4] = a; r[5] = b; r[6] = c; r[7] = d;
    T[0] = (double)(n + 1);
  } else {
    S->M[S->msg_in] += 1.0;
  }
}
ZB_FN double zb_msg_send(ZB* S, double chan, double tag, double a, double b,
                         double c, double d) {
  zb_msg_out(S, 1.0, 0.0, chan, tag, a, b, c, d);
  return 1.0;
}
// a direct send: int(dest) fails on NaN and inf, and then nothing is sent
ZB_FN double zb_msg_sendto(ZB* S, double dest, double chan, double tag,
                           double a, double b, double c, double d) {
  if (!(dest == dest) || dest - dest != 0.0) return 0.0;
  zb_msg_out(S, 0.0, trunc(dest), chan, tag, a, b, c, d);
  return 1.0;
}
// The queue at q's next row, popped, or nullptr where it is empty.
ZB_FN const double* zb_msg_pop(ZB* S, long long q) {
  double* Q = S->M + q;
  const double cnt = Q[1];
  if (!(cnt > 0.0)) return nullptr;
  const long long h = zt_i64(Q[0]);
  const double nh = Q[0] + 1.0;
  Q[0] = nh >= ZB_MSG_QUEUE_CAP ? 0.0 : nh;
  Q[1] = cnt - 1.0;
  return Q + 2 + ZB_MSG_QENT * h;
}
ZB_FN double zb_msg_clear(ZB* S, long long q) {
  double* Q = S->M + q;
  const double cnt = Q[1];
  Q[0] = fmod(Q[0] + cnt, (double)ZB_MSG_QUEUE_CAP);
  Q[1] = 0.0;
  return cnt;
}
// int(x) of a finite x (saturated), else `bad`
ZB_FN long long zb_int_or(double x, long long bad) {
  return (x == x && x - x == 0.0) ? zt_i64(x) : bad;
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
// A region of `span` cells from `base` inside one page and the heap.
ZB_FN bool zb_region_ok(const ZB* S, long long base, long long span) {
  if (base < 0 || span <= 0) return false;
  if (base / ZB_PAGE != (base + span - 1) / ZB_PAGE) return false;
  return base + span <= S->mem_size;
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

// The transforms on a region x that passed its checks, through the
// workspace w: what zb_fft ... zb_convolve_c (K10's view) and zx_fft ...
// zx_convolve_c (K11's) run.

// fft: natural-order DFT of n complex, stored in WDL order.
ZB_FN void zb_fft_on(double* x, double* w, long long n, const int* perm,
                     const double* tw, long long tw_n) {
  for (long long k = 0; k < n; ++k) {
    const long long r = zb_bitrev(k, n);
    w[2 * r] = x[2 * k];
    w[2 * r + 1] = x[2 * k + 1];
  }
  zb_fft_core(w, n, tw, tw_n, false);
  for (long long k = 0; k < n; ++k) {
    x[2 * ZB_LDG(perm + k)] = w[2 * k];
    x[2 * ZB_LDG(perm + k) + 1] = w[2 * k + 1];
  }
}
// ifft: WDL order in, the unnormalized inverse in natural order out.
ZB_FN void zb_ifft_on(double* x, double* w, long long n, const int* perm,
                      const double* tw, long long tw_n) {
  for (long long k = 0; k < n; ++k) {
    const long long r = zb_bitrev(k, n);
    w[2 * r] = x[2 * ZB_LDG(perm + k)];
    w[2 * r + 1] = x[2 * ZB_LDG(perm + k) + 1];
  }
  zb_fft_core(w, n, tw, tw_n, true);
  for (long long k = 0; k < 2 * n; ++k) x[k] = w[k];
}
// fft_permute (ipermute = false): buf = buf[perm]; fft_ipermute:
// buf[perm] = buf.
ZB_FN void zb_fft_permute_on(double* x, double* w, long long n,
                             const int* perm, bool ipermute) {
  for (long long k = 0; k < n; ++k) {
    const long long from = ipermute ? k : ZB_LDG(perm + k);
    const long long to = ipermute ? ZB_LDG(perm + k) : k;
    w[2 * to] = x[2 * from];
    w[2 * to + 1] = x[2 * from + 1];
  }
  for (long long k = 0; k < 2 * n; ++k) x[k] = w[k];
}
// fft_real(N): N/2 bins of 2 * rfft(x), bin 0 packing (2 DC, 2 Nyquist),
// in WDL order of N/2 (`perm` is perm_table(N / 2)).
ZB_FN void zb_fft_real_on(double* x, double* w, long long n, const int* perm,
                          const double* tw, long long tw_n) {
  const long long half = n / 2;
  for (long long t = 0; t < n; ++t) {
    const long long r = zb_bitrev(t, n);
    w[2 * r] = x[t];
    w[2 * r + 1] = 0.0;
  }
  zb_fft_core(w, n, tw, tw_n, false);
  x[2 * ZB_LDG(perm)] = 2.0 * w[0];
  x[2 * ZB_LDG(perm) + 1] = 2.0 * w[2 * half];
  for (long long k = 1; k < half; ++k) {
    x[2 * ZB_LDG(perm + k)] = 2.0 * w[2 * k];
    x[2 * ZB_LDG(perm + k) + 1] = 2.0 * w[2 * k + 1];
  }
}
// ifft_real(N): the inverse of fft_real scaled by 2N (the caller applies
// 0.5 / N): x = 2 Re(the unnormalized inverse DFT of the hermitian
// spectrum whose bins are the WDL bins / 2).
ZB_FN void zb_ifft_real_on(double* x, double* w, long long n, const int* perm,
                           const double* tw, long long tw_n) {
  const long long half = n / 2;
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
  zb_fft_core(w, n, tw, tw_n, true);
  for (long long t = 0; t < n; ++t) x[t] = 2.0 * w[2 * t];
}
// convolve_c: x[k] *= src[k] over n complex (the source read first, into
// the workspace, so that overlapping regions read as before).
ZB_FN void zb_convolve_c_on(double* x, const double* src, double* w,
                            long long n) {
  for (long long k = 0; k < 2 * n; ++k) w[k] = src[k];
  for (long long k = 0; k < n; ++k) {
    const double dr = x[2 * k], di = x[2 * k + 1];
    x[2 * k] = dr * w[2 * k] - di * w[2 * k + 1];
    x[2 * k + 1] = dr * w[2 * k + 1] + di * w[2 * k];
  }
}

ZB_FN double zb_fft(ZB* S, double dest, long long n, const int* perm) {
  const long long base = zb_fft_base(dest);
  if (zb_region_ok(S, base, 2 * n))
    zb_fft_on(S->M + base, S->scratch, n, perm, S->tw, S->tw_n);
  return 0.0;
}
ZB_FN double zb_ifft(ZB* S, double dest, long long n, const int* perm) {
  const long long base = zb_fft_base(dest);
  if (zb_region_ok(S, base, 2 * n))
    zb_ifft_on(S->M + base, S->scratch, n, perm, S->tw, S->tw_n);
  return 0.0;
}
ZB_FN double zb_fft_permute(ZB* S, double dest, long long n, const int* perm,
                            bool ipermute) {
  const long long base = zb_fft_base(dest);
  if (zb_region_ok(S, base, 2 * n))
    zb_fft_permute_on(S->M + base, S->scratch, n, perm, ipermute);
  return 0.0;
}
ZB_FN double zb_fft_real(ZB* S, double dest, long long n, const int* perm) {
  const long long base = zb_fft_base(dest);
  if (zb_region_ok(S, base, n))
    zb_fft_real_on(S->M + base, S->scratch, n, perm, S->tw, S->tw_n);
  return 0.0;
}
ZB_FN double zb_ifft_real(ZB* S, double dest, long long n, const int* perm) {
  const long long base = zb_fft_base(dest);
  if (zb_region_ok(S, base, n))
    zb_ifft_real_on(S->M + base, S->scratch, n, perm, S->tw, S->tw_n);
  return 0.0;
}
ZB_FN double zb_convolve_c(ZB* S, double dest, double src, long long n) {
  const long long d = zb_fft_base(dest), s = zb_fft_base(src);
  if (zb_region_ok(S, d, 2 * n) && zb_region_ok(S, s, 2 * n))
    zb_convolve_c_on(S->M + d, S->M + s, S->scratch, n);
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
// The trips of a counted `while (iv < e)` (`<=` where le) from iv =
// start, each trip iv += 1, by the golden's compare of iv + k with e: 0
// where the first compare fails (NaN too); -1 where thread 0 must run
// the loop itself (a start that is not an integer, or values iv + k that
// leave the exact integers, or a bound past them).
ZB_FN long long zb_while_trips(double start, double e, int le) {
  if (!(le ? start <= e : start < e)) return 0;
  if (!(start == floor(start) && fabs(start) < ZB_EXACT)) return -1;
  const double d = e - start;
  if (!(d < ZB_EXACT)) return -1;
  long long n = le ? (long long)floor(d) + 1 : (long long)ceil(d);
  if (n < 1) n = 1;
  if (!zb_trip_ok(start, n + 1)) return -1;
  // e - start may round: settle n on the compare itself (start + k is
  // exact here)
  while (n > 1 && !(le ? start + (double)(n - 1) <= e
                       : start + (double)(n - 1) < e)) --n;
  while (le ? start + (double)n <= e : start + (double)n < e) {
    ++n;
    if (!zb_trip_ok(start, n + 1)) return -1;
  }
  return n;
}

// -- block copies: thread 0 resolves the runs, every thread copies ---------
//
// zb_memset's and zb_memcpy's clamping, resolved once by thread 0 and
// published (q[0] the first cell, then the source's, then the length);
// every thread then copies the cells t, t + nt, ...  A copy reads each
// source cell once and writes each destination cell once, so any split
// gives the bits of the one-thread form where the runs do not overlap;
// where they do, thread 0 copies them itself (memmove's order, counted)
// and publishes the length 0.
ZB_FN double zb_set_region(const ZB* S, double dest, double val, double len,
                           long long* q, double* v) {
  const long long n = zb_run_len(S, len);
  q[0] = zb_run_start(S, dest, n);
  q[1] = n;
  *v = val;
  return dest;
}
ZB_FN double zb_copy_region(ZB* S, double dest, double src, double len,
                            long long* q) {
  const long long n = zb_run_len(S, len);
  const long long d = zb_run_start(S, dest, n), s = zb_run_start(S, src, n);
  q[0] = d;
  q[1] = s;
  q[2] = d == s ? 0 : n;            // a copy onto itself changes nothing
  if (d != s && (d < s ? s - d : d - s) < n) {
    zb_count_serial(S);
    zb_memcpy(S, dest, src, len);
    q[2] = 0;
  }
  return dest;
}
ZB_FN void zb_blk_set(ZB* S, long long d, long long n, double v, long long t,
                      long long nt) {
  for (long long k = t; k < n; k += nt) S->M[d + k] = v;
}
ZB_FN void zb_blk_copy(ZB* S, long long d, long long s, long long n,
                       long long t, long long nt) {
  for (long long k = t; k < n; k += nt) S->M[d + k] = S->M[s + k];
}

// -- host services: the sample pool, file_mem, the string literals -------------
//
// The pool's reads repeat runtime/services.py's `SamplePoolService.read`,
// `read_interp` and `read2` on the loaded generation: int() of a sample id
// or a bin (NaN, +-inf: no entry), Python's round() of a frame (rint in
// the default rounding mode: half to even), a non-finite frame 0, the
// channel truncated and clamped (NaN, +-inf: 0), anything out of range
// 0.0, the f32 cell widened, the interpolation two roundings.  Both views
// call them with their tables (&S->H).  The pool's data is a plain load:
// the read-only data cache (__ldg) measured no different on the card.

ZB_FN bool zb_finite(double x) { return x - x == 0.0; }
// Python's int(x) where it fits a long long; *ok false for NaN, +-inf and
// beyond (where every lookup below misses as Python's does)
ZB_FN long long zb_pyint(double x, bool* ok) {
  *ok = x > -9.2e18 && x < 9.2e18;
  return *ok ? (long long)x : 0;
}
// the pool row of a sample id, 0 where no loaded entry has it
ZB_FN long long zb_pool_row(const ZH* H, double sid) {
  bool ok;
  const long long s = zb_pyint(sid, &ok);
  return ok && s >= 1 && s <= H->pool_maxsid ? s : 0;
}
ZB_FN double zb_pool_read(const ZH* H, double sid, double ch, double frame) {
  const long long s = zb_pool_row(H, sid);
  const long long nf = H->pool_frm[s], nc = H->pool_nch[s];
  if (nf == 0 || nc == 0) return 0.0;
  if (!zb_finite(frame)) frame = 0.0;
  const double r = rint(frame);
  if (!(r >= 0.0) || r >= (double)nf) return 0.0;
  long long c = 0;
  if (zb_finite(ch) && ch >= 1.0) c = ch >= (double)nc ? nc - 1 : (long long)ch;
  return (double)H->pool_data[H->pool_offs[s] + (long long)r * nc + c];
}
ZB_FN double zb_pool_read_interp(const ZH* H, double sid, double ch,
                                 double phase) {
  if (!zb_finite(phase)) phase = 0.0;
  const double base = floor(phase);
  const double frac = phase - base;
  const double x0 = zb_pool_read(H, sid, ch, base);
  const double x1 = zb_pool_read(H, sid, ch, base + 1.0);
  return x0 + (x1 - x0) * frac;
}
// sample_read2{,_interp}: 1.0 and (l, r) where the entry holds the phase
// (the hard boundary: finite, 0 <= phase <= frames - 1; r = l for a mono
// entry), else 0.0 and zeros
ZB_FN double zb_pool_read2(const ZH* H, double sid, double phase, int interp,
                           double* l, double* r) {
  const long long s = zb_pool_row(H, sid);
  const long long nf = H->pool_frm[s], nc = H->pool_nch[s];
  *l = 0.0;
  *r = 0.0;
  if (nf == 0 || nc == 0 || !zb_finite(phase) || phase < 0.0
      || phase > (double)(nf - 1))
    return 0.0;
  *l = interp ? zb_pool_read_interp(H, sid, 0.0, phase)
              : zb_pool_read(H, sid, 0.0, phase);
  *r = nc < 2 ? *l
              : (interp ? zb_pool_read_interp(H, sid, 1.0, phase)
                        : zb_pool_read(H, sid, 1.0, phase));
  return 1.0;
}
// sample_preview_read: the bin's (min, max, rms), or nullptr (the golden
// then leaves the out-params as they were)
ZB_FN const double* zb_pool_preview(const ZH* H, double sid, double bin) {
  const long long s = zb_pool_row(H, sid);
  bool ok;
  const long long b = zb_pyint(bin, &ok);
  if (!ok || b < 0 || b >= H->pool_pv_bins[s]) return nullptr;
  return H->pool_pv + H->pool_pv_off[s] + 3 * b;
}
ZB_FN double zb_pool_get(const ZH* H, double index) {
  bool ok;
  const long long i = zb_pyint(index, &ok);
  return ok && i >= 0 && i < H->pool_n_order ? (double)H->pool_order[i] : 0.0;
}
ZB_FN double zb_pool_len(const ZH* H, double sid) {
  return (double)H->pool_frm[zb_pool_row(H, sid)];
}
ZB_FN double zb_pool_channels(const ZH* H, double sid) {
  return (double)H->pool_nch[zb_pool_row(H, sid)];
}
ZB_FN double zb_pool_bins(const ZH* H, double sid) {
  return (double)H->pool_pv_bins[zb_pool_row(H, sid)];
}
// k: 0 srate, 1 peak, 2 rms
ZB_FN double zb_pool_meta(const ZH* H, double sid, int k) {
  return H->pool_meta[3 * zb_pool_row(H, sid) + k];
}

// strlen / str_getchar of a literal handle (shadow/state.py: int(handle);
// an unknown handle, an index out of range, NaN or +-inf give 0)
ZB_FN long long zb_str_row(const ZH* H, double handle) {
  bool ok;
  const long long h = zb_pyint(handle, &ok);
  if (!ok) return -1;
  for (long long i = 0; i < H->str_n; ++i)
    if (H->str_h[i] == h) return i;
  return -1;
}
ZB_FN double zb_strlen(const ZH* H, double handle) {
  const long long r = zb_str_row(H, handle);
  return r < 0 ? 0.0 : H->str_len[r];
}
ZB_FN double zb_str_getchar(const ZH* H, double handle, double index) {
  const long long r = zb_str_row(H, handle);
  bool ok;
  const long long i = zb_pyint(index, &ok);
  if (r < 0 || !ok || i < 0 || (double)i >= H->str_len[r]) return 0.0;
  return H->str_chars[r * H->str_w + i];
}

// file_mem's copy: n cells of the file table from off into the heap at
// dst (the printer checked that [dst, dst + n) lies in the heap)
ZB_FN double zb_file_copy(ZB* S, long long dst, long long off, long long n) {
  for (long long i = 0; i < n; ++i) S->M[dst + i] = S->H.files[off + i];
  return (double)n;
}

// -- K11's view: the reduced heap, its first page on chip -----------------------
//
// K11 (kernels/device_exec.py) runs a file's whole render on lane 0 of the
// file's warp.  Its hot state stays on chip: the var row and the heap's
// first ZX_PAGE cells (a plugin's tables, records and counters lie low)
// are the warp's copies in shared memory (arrays of the render in the host
// form), staged at the file's start and written back at its end, and the
// high-water mark is a register, stored to its slot where the executor's
// overflow check reads it.  The rest of the heap (rings, buffers), the
// gmem window, the MIDI out table and the draw pool stay in device
// memory.  Every helper is inlined into the kernel, so the view itself
// lives in registers.

#ifdef ZX_PAGE

struct ZX {
  double* P;               // the heap's first ZX_PAGE cells, on chip
  double* M;               // the heap row: [plugin heap | gmem window | MIDI out table]
  long long mem_size;      // plugin heap cells
  long long page_n;        // the page's cells that are heap: min(ZX_PAGE, mem_size)
  long long mo_base;       // the MIDI out table: [count | CAP rows of 4]
  double samplesblock;
  const double* midi_ev;   // this block's staged host events [k][4]
  double midi_n;           // how many there are
  double* scratch;         // FFT workspace of this file
  const double* tw;        // cos, sin of 2 pi k / tw_n, k < tw_n / 2
  long long tw_n;
  const double* pool;      // the staged MT19937 draws (u32 values), shared
  long long pool_n;        // how many
  long long hw;            // the high-water mark of dynamic writes: its
                           // slot holds it as a double (max and the
                           // rounding to double commute)
  double* G;               // gmem: the heap row's window after the heap
  long long gmem_cells;    // its cells (0 where no section uses gmem)
  ZH H;                    // the host-service tables (zero where unused)
};

// A dynamic access is on the chain of every heap read.  Its address is
// trunc(base + idx + 1e-5) raised to 0 and not clamped above (zt_i64:
// NaN and +-inf give 0, past 2^62 saturates).  Where s = base + idx (the
// golden's first addition) is a whole number in [0, 2^31), as a plugin's
// indices are, that is s itself: adding 2^52 + 2^51 puts s's integer in
// the low word of the sum, exactly, and subtracting it again gives s back
// only where s is whole.  Two adds and a compare, and no conversion.
#define ZX_MAGIC 6755399441055744.0   // 2^52 + 2^51
ZB_FN int zx_low(double t) {
#ifdef __CUDA_ARCH__
  return __double2loint(t);
#else
  unsigned long long b;
  memcpy(&b, &t, 8);
  return (int)(unsigned)(b & 0xffffffffull);
#endif
}
ZB_FN bool zx_small(double s, double t) {
  return t - ZX_MAGIC == s && s >= 0.0 && s < 2147483648.0;
}
ZB_FN long long zx_raddr(double base, double idx) {
  const double s = base + idx;
  const double t = s + ZX_MAGIC;
  if (zx_small(s, t)) return zx_low(t);
  const double x = s + 1.0e-5;
  const double top = 4.611686018427387904e18;   // 2^62
  return (long long)(x >= 0.0 && x <= top ? x
                     : (x > top && x < INFINITY ? top : 0.0));
}
// The same address where idx is a whole constant k, |k| < 2^31 (a record's
// field, a table's base): where base is whole in [0, 2^31), base's integer
// (from base + ZX_MAGIC, which the accesses of one base share) plus k.
ZB_FN long long zx_raddr_k(double base, long long k) {
  const double tb = base + ZX_MAGIC;
  const long long a = (long long)zx_low(tb) + k;
  if (zx_small(base, tb) && a >= 0 && a < 2147483648LL) return a;
  return zx_raddr(base, (double)k);
}
// Cell a >= 0: the page's below ZX_PAGE (a page cell past a small heap
// stays 0), the row's below the heap, else 0.
ZB_FN double zx_rat(const ZX* S, long long a) {
  return a < ZX_PAGE ? S->P[a] : (a < S->mem_size ? S->M[a] : 0.0);
}
// A read: the page's cell at a small whole address is read ahead, while
// the address is checked; any other address takes the general way.
ZB_FN double zx_rmget(const ZX* S, double base, double idx) {
  const double s = base + idx;
  const double t = s + ZX_MAGIC;
  const int a = zx_low(t);
  const double ahead = S->P[a & (ZX_PAGE - 1)];
  if (zx_small(s, t) && a < ZX_PAGE) return ahead;
  return zx_rat(S, zx_raddr(base, idx));
}
ZB_FN double zx_rmget_k(const ZX* S, double base, long long k) {
  const double tb = base + ZX_MAGIC;
  const long long a = (long long)zx_low(tb) + k;
  const double ahead = S->P[a & (ZX_PAGE - 1)];
  if (zx_small(base, tb) && a >= 0 && a < ZX_PAGE) return ahead;
  return zx_rat(S, zx_raddr(base, (double)k));
}
// A dynamic write: it raises the high water to its address (as the
// reference's does) and drops past the heap.
ZB_FN void zx_rmset(ZX* S, long long a, double v) {
  S->hw = S->hw < a ? a : S->hw;
  if (a < S->mem_size) {
    if (a < ZX_PAGE) S->P[a] = v;
    else S->M[a] = v;
  }
}

// rand(limit) = u32 * (1/4294967295) * max(floor(limit), 1), the u32 the
// pool's cell at the cursor (*pos, a var slot).  The cursor counts past the
// pool's end and the read clamps; the executor refuses a render that used
// more draws than the pool held.
ZB_FN double zx_rand(const ZX* S, double* pos, double limit) {
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

// file_mem's copy on the reduced heap: the page's cells below ZX_PAGE
ZB_FN double zx_file_copy(ZX* S, long long dst, long long off, long long n) {
  for (long long i = 0; i < n; ++i) {
    const long long a = dst + i;
    if (a < ZX_PAGE) S->P[a] = S->H.files[off + i];
    else S->M[a] = S->H.files[off + i];
  }
  return (double)n;
}

// -- bulk operations: runs of cells in the page or in the row --

// The page's cells back into the row, and from it.
ZB_FN void zx_page_out(ZX* S) {
  for (long long i = 0; i < S->page_n; ++i) S->M[i] = S->P[i];
}
ZB_FN void zx_page_in(ZX* S) {
  for (long long i = 0; i < S->page_n; ++i) S->P[i] = S->M[i];
}
ZB_FN bool zx_across(long long a, long long n) {
  return a < ZX_PAGE && a + n > ZX_PAGE;
}
// Before an operation on the runs [a, a + n) and [b, b + m): where a run
// crosses cell ZX_PAGE (rare), the page is written back and every run is
// worked in the row (returns true; zx_close loads the page again).
ZB_FN bool zx_open(ZX* S, long long a, long long n, long long b, long long m) {
  const bool across = zx_across(a, n) || zx_across(b, m);
  if (across) zx_page_out(S);
  return across;
}
// Where run [a, a + n) is worked: the page's cells where it lies inside
// the page, else the row's.
ZB_FN double* zx_cells(const ZX* S, bool across, long long a, long long n) {
  return !across && a + n <= ZX_PAGE ? S->P + a : S->M + a;
}
ZB_FN void zx_close(ZX* S, bool across) {
  if (across) zx_page_in(S);
}

ZB_FN double zx_memset(ZX* S, double dest, double val, double len) {
  const long long n = zb_run_len(S, len);
  const long long d = zb_run_start(S, dest, n);
  const bool across = zx_open(S, d, n, d, n);
  double* x = zx_cells(S, across, d, n);
  for (long long i = 0; i < n; ++i) x[i] = val;
  zx_close(S, across);
  return dest;
}
// overlap-safe, as memmove (runs in the page and in the row never overlap)
ZB_FN double zx_memcpy(ZX* S, double dest, double src, double len) {
  const long long n = zb_run_len(S, len);
  const long long d = zb_run_start(S, dest, n);
  const long long s = zb_run_start(S, src, n);
  const bool across = zx_open(S, d, n, s, n);
  double* x = zx_cells(S, across, d, n);
  const double* y = zx_cells(S, across, s, n);
  if (d < s) {
    for (long long i = 0; i < n; ++i) x[i] = y[i];
  } else if (d > s) {
    for (long long i = n - 1; i >= 0; --i) x[i] = y[i];
  }
  zx_close(S, across);
  return dest;
}

// gmem_get (to_mem) and gmem_put on the reduced heap.  The window lies in
// the row past the heap, so the page never holds it and no gmem write
// moves the high water; the heap side is a static run inside the heap
// (checked when printed), worked in the page, in the row, or across cell
// ZX_PAGE as the bulk operations above.
ZB_FN double zx_gmem_bulk(ZX* S, long long m, double g, long long count,
                          int to_mem) {
  const long long gi = zb_gidx(g);
  if (gi >= S->gmem_cells) return 0.0;
  const long long n = count < S->gmem_cells - gi ? count : S->gmem_cells - gi;
  if (n <= 0) return 0.0;
  const bool across = zx_open(S, m, n, m, n);
  double* h = zx_cells(S, across, m, n);
  for (long long k = 0; k < n; ++k) {
    if (to_mem) h[k] = S->G[gi + k];
    else S->G[gi + k] = h[k];
  }
  zx_close(S, across);
  return (double)n;
}

// zb_region_ok on the reduced heap: a region inside its WDL page that
// leaves the heap marks the high water with its last cell (the golden
// grows its heap for it).
ZB_FN bool zx_region_ok(ZX* S, long long base, long long span) {
  if (base < 0 || span <= 0) return false;
  if (base / ZB_PAGE != (base + span - 1) / ZB_PAGE) return false;
  if (base + span <= S->mem_size) return true;
  if (S->hw < base + span - 1) S->hw = base + span - 1;
  return false;
}
ZB_FN double zx_fft(ZX* S, double dest, long long n, const int* perm) {
  const long long a = zb_fft_base(dest);
  if (!zx_region_ok(S, a, 2 * n)) return 0.0;
  const bool across = zx_open(S, a, 2 * n, a, 2 * n);
  zb_fft_on(zx_cells(S, across, a, 2 * n), S->scratch, n, perm, S->tw,
            S->tw_n);
  zx_close(S, across);
  return 0.0;
}
ZB_FN double zx_ifft(ZX* S, double dest, long long n, const int* perm) {
  const long long a = zb_fft_base(dest);
  if (!zx_region_ok(S, a, 2 * n)) return 0.0;
  const bool across = zx_open(S, a, 2 * n, a, 2 * n);
  zb_ifft_on(zx_cells(S, across, a, 2 * n), S->scratch, n, perm, S->tw,
             S->tw_n);
  zx_close(S, across);
  return 0.0;
}
ZB_FN double zx_fft_permute(ZX* S, double dest, long long n, const int* perm,
                            bool ipermute) {
  const long long a = zb_fft_base(dest);
  if (!zx_region_ok(S, a, 2 * n)) return 0.0;
  const bool across = zx_open(S, a, 2 * n, a, 2 * n);
  zb_fft_permute_on(zx_cells(S, across, a, 2 * n), S->scratch, n, perm,
                    ipermute);
  zx_close(S, across);
  return 0.0;
}
ZB_FN double zx_fft_real(ZX* S, double dest, long long n, const int* perm) {
  const long long a = zb_fft_base(dest);
  if (!zx_region_ok(S, a, n)) return 0.0;
  const bool across = zx_open(S, a, n, a, n);
  zb_fft_real_on(zx_cells(S, across, a, n), S->scratch, n, perm, S->tw,
                 S->tw_n);
  zx_close(S, across);
  return 0.0;
}
ZB_FN double zx_ifft_real(ZX* S, double dest, long long n, const int* perm) {
  const long long a = zb_fft_base(dest);
  if (!zx_region_ok(S, a, n)) return 0.0;
  const bool across = zx_open(S, a, n, a, n);
  zb_ifft_real_on(zx_cells(S, across, a, n), S->scratch, n, perm, S->tw,
                  S->tw_n);
  zx_close(S, across);
  return 0.0;
}
ZB_FN double zx_convolve_c(ZX* S, double dest, double src, long long n) {
  const long long d = zb_fft_base(dest), s = zb_fft_base(src);
  if (!zx_region_ok(S, d, 2 * n) || !zx_region_ok(S, s, 2 * n)) return 0.0;
  const bool across = zx_open(S, d, 2 * n, s, 2 * n);
  zb_convolve_c_on(zx_cells(S, across, d, 2 * n),
                   zx_cells(S, across, s, 2 * n), S->scratch, n);
  zx_close(S, across);
  return 0.0;
}

#endif  // ZX_PAGE
