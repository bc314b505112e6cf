// EEL2 scalar operations for the generated sequential-scan-group kernels.
//
// Each function gives, bit for bit, what zorak_tpu_torch/semantics/scalar.py
// gives for the same f64 operands (a NaN's sign and payload aside: no EEL2
// operation reads them).  The generated sources of
// zorak_tpu_torch/lowering/scan_codegen.py include this header; it holds
// everything of a scan-group kernel that does not depend on the group.
//
// The header compiles as CUDA C++ (nvcc, device and host) and as plain
// C++17 (g++), so that the generated body can run on a CPU against the
// Python loop.  Build with two roundings a multiply-add (nvcc --fmad=false,
// g++ -ffp-contract=off) and without fast-math: `/` and sqrt must round as
// IEEE says.  The transcendental calls (sin ... pow) go to the platform's
// libm: glibc on a host, CUDA's device library on the card, which may
// differ from glibc by 1 to 2 ulp.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define ZT_FN static __host__ __device__ __forceinline__
#else
#define ZT_FN static inline
#endif

// A double from its bit pattern (NaN and the infinities as constants).
ZT_FN double zt_from_bits(uint64_t bits) {
  double v;
  memcpy(&v, &bits, 8);
  return v;
}

// fptosi f64 -> i64 as scalar.trunc_i64: toward zero, NaN and +-inf give 0,
// saturating at +-2^62.
ZT_FN int64_t zt_i64(double x) {
  if (!(x == x) || x - x != 0.0) return 0;   // NaN, +inf, -inf
  if (x > 4.611686018427387904e18) return (int64_t)1 << 62;
  if (x < -4.611686018427387904e18) return -((int64_t)1 << 62);
  return (int64_t)x;
}
// ... then wrapped mod 2^32 into a signed int32 (scalar.to_i32).
ZT_FN int32_t zt_i32(double x) {
  return (int32_t)(uint32_t)(uint64_t)zt_i64(x);
}

ZT_FN double z_or(double a, double b) { return (double)(zt_i32(a) | zt_i32(b)); }
ZT_FN double z_and(double a, double b) { return (double)(zt_i32(a) & zt_i32(b)); }
ZT_FN double z_xor(double a, double b) { return (double)(zt_i32(a) ^ zt_i32(b)); }
ZT_FN double z_shl(double a, double b) {
  return (double)(int32_t)((uint32_t)zt_i32(a) << (zt_i32(b) & 31));
}
ZT_FN double z_shr(double a, double b) {   // arithmetic shift
  const int32_t v = zt_i32(a);
  const int s = zt_i32(b) & 31;
  return (double)(v < 0 ? ~(~v >> s) : v >> s);
}
// C srem on int32 operands; |INT32_MIN| needs 64 bits, as Python's abs has.
ZT_FN double z_mod(double a, double b) {
  const int64_t li = zt_i32(a), ri = zt_i32(b);
  if (ri == 0) return 0.0;
  const int64_t r = (li < 0 ? -li : li) % (ri < 0 ? -ri : ri);
  return (double)(li < 0 ? -r : r);
}

// ordered comparisons -> 1.0 / 0.0 (a NaN operand gives 0.0, `!=` too)
ZT_FN double z_lt(double a, double b) { return a < b ? 1.0 : 0.0; }
ZT_FN double z_le(double a, double b) { return a <= b ? 1.0 : 0.0; }
ZT_FN double z_gt(double a, double b) { return a > b ? 1.0 : 0.0; }
ZT_FN double z_ge(double a, double b) { return a >= b ? 1.0 : 0.0; }
ZT_FN double z_eq(double a, double b) { return a == b ? 1.0 : 0.0; }
ZT_FN double z_ne(double a, double b) {
  return (a == a && b == b && a != b) ? 1.0 : 0.0;
}
ZT_FN bool z_true(double x) { return x < 0.0 || x > 0.0; }
ZT_FN double z_not(double x) { return x == 0.0 ? 1.0 : 0.0; }

ZT_FN double z_min(double a, double b) { return a < b ? a : b; }
ZT_FN double z_max(double a, double b) { return a > b ? a : b; }
ZT_FN double z_sign(double a) {
  return a > 0.0 ? 1.0 : (a < 0.0 ? -1.0 : 0.0);
}
ZT_FN double z_abs(double x) { return fabs(x); }
ZT_FN double z_div(double a, double b) { return a / b; }
ZT_FN double z_pow(double a, double b) { return pow(a, b); }

// float(math.floor(x)) goes through a Python int, which has no -0: a zero
// result is +0.0 where C's floor(-0.0) and ceil(-0.5) are -0.0.
ZT_FN double z_floor(double x) {
  const double r = floor(x);
  return r == 0.0 ? 0.0 : r;
}
ZT_FN double z_ceil(double x) {
  const double r = ceil(x);
  return r == 0.0 ? 0.0 : r;
}

// The f32 bit-trick inverse square root, one Newton step in f64.
ZT_FN double z_invsqrt(double x) {
  const float xf = (float)x;
  int32_t bits;
  memcpy(&bits, &xf, 4);
  const int32_t half = bits < 0 ? ~(~bits >> 1) : bits >> 1;
  const int32_t ap = (int32_t)(0x5f3759dfu - (uint32_t)half);
  float y0f;
  memcpy(&y0f, &ap, 4);
  const double y0 = (double)y0f;
  return y0 * (1.5 - 0.5 * x * y0 * y0);
}
