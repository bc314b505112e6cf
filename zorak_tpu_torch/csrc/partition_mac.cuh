// The walk of K8 (partition_mac.cu), the frequency-domain MAC of uniform
// partitioned convolution, complex64:
//
//   Y[l][f][b] = sum over p = 0 .. parts-1, ascending,
//                of X[l][f-p][b] * H[p][b]
//
// with X[l][g] = 0 for g < 0 and each complex product written out as
// (xr*hr - xi*hi, xr*hi + xi*hr), every multiply and add rounded on its own.
//
// A block takes kPmBins = 32 bins (a warp's lanes) and W warps; warp w
// owns the R output frames f0 = f_blk + w*R .. f0 + R - 1 of its lane's
// bin.  The partitions are walked in groups of PG; for each group the
// block stages, in shared memory, the X rows the group reads and the
// group's rows of H (a "stage": kRows rows of X, then PG rows of H, each
// row kPmBins complex values).  A thread keeps its R sums and a window of
// R input frames in registers and walks p upwards: step p loads the one
// new frame X[f0 - p] into window slot (-p) mod R, where it replaces
// X[f0 - p + R], then adds X[f0 + j - p] * H[p] (slot (j - p) mod R) into
// every sum j.  Each sum meets its partitions in ascending order, the
// reference's order; the zero history rows are multiplied and added as
// the reference does (0 x inf is NaN there too).  Steps run in chunks of
// R, unrolled, so every slot index is a constant and the window stays in
// registers; PG is a multiple of R, so every chunk starts at slot 0; a
// last chunk shorter than R takes the same steps in the same order.
//
// The header compiles as CUDA C++ (nvcc, host and device) and as plain
// C++17 (g++), so that the walk runs on a CPU against the plain PyTorch
// version (partition_mac.cu's host form).  Build with two roundings a
// multiply-add: nvcc --fmad=false, g++ -ffp-contract=off.

#pragma once

#ifdef __CUDACC__
#define PM_FN static __host__ __device__ __forceinline__
#define PM_UNROLL _Pragma("unroll")
#else
#define PM_FN static inline
#define PM_UNROLL
#endif

// complex64 as stored: real, imaginary
struct alignas(8) PmC {
  float re, im;
};

constexpr int kPmBins = 32;  // bins a block: one warp's lanes

PM_FN float pm_mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
PM_FN float pm_add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
PM_FN float pm_sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

// A block's geometry: W warps of R output frames, partitions in groups
// of PG.
template <int R, int W, int PG>
struct PmTile {
  static_assert(PG % R == 0, "a group is whole chunks of R steps");
  static constexpr int kFrames = W * R;        // output frames a block
  static constexpr int kRows = W * R + PG - 1; // X rows a stage holds
  // complex values a stage holds: X rows, then PG rows of H
  static constexpr int kStage = (kRows + PG) * kPmBins;

  // The frame that stage row r holds for the group that starts at
  // partition p0 (its H rows are partitions p0 .. p0 + PG - 1).  A row
  // outside 0 .. n_frames - 1 (a history row, a frame past the last of a
  // ragged tile) is staged as zeros, as is a bin past the last.
  PM_FN int row_frame(int f_blk, int p0, int r) {
    return f_blk - p0 - (PG - 1) + r;
  }
};

// A thread's registers: the window, X[f0 + j - p] in slot (j - p) mod R,
// and the sums Y[f0 + j].
template <int R>
struct PmThread {
  float wr[R], wi[R];
  float ar[R], ai[R];
};

// Zero the sums; fill window slots 1 .. R-1 with frames f0 + 1 ..
// f0 + R - 1 from the first group's stage (step 0 loads slot 0).
template <int R, int PG>
PM_FN void pm_begin(PmThread<R>& t, const PmC* xs, int w, int bl) {
  t.wr[0] = t.wi[0] = 0.0f;
  PM_UNROLL
  for (int j = 0; j < R; ++j) {
    t.ar[j] = t.ai[j] = 0.0f;
    if (j > 0) {
      const PmC v = xs[(w * R + PG - 1 + j) * kPmBins + bl];
      t.wr[j] = v.re;
      t.wi[j] = v.im;
    }
  }
}

// Steps p0 + c .. p0 + c + n - 1 of the group whose stage is xs / hs (c a
// multiple of R; n == R unless kPartial).  The frame f0 - p sits in stage
// row w*R + PG - 1 - (p - p0).
template <int R, int PG, bool kPartial>
PM_FN void pm_steps(PmThread<R>& t, const PmC* xs, const PmC* hs, int w,
                    int bl, int c, int n) {
  const PmC* xrow = xs + (w * R + PG - 1 - c) * kPmBins + bl;
  const PmC* hrow = hs + c * kPmBins + bl;
  PM_UNROLL
  for (int u = 0; u < R; ++u) {
    if (!kPartial || u < n) {
      const PmC xv = xrow[-u * kPmBins];
      t.wr[(R - u) % R] = xv.re;
      t.wi[(R - u) % R] = xv.im;
      const PmC hv = hrow[u * kPmBins];
      PM_UNROLL
      for (int j = 0; j < R; ++j) {
        const int k = (j - u + R) % R;
        const float pr =
            pm_sub(pm_mul(t.wr[k], hv.re), pm_mul(t.wi[k], hv.im));
        const float pi =
            pm_add(pm_mul(t.wr[k], hv.im), pm_mul(t.wi[k], hv.re));
        t.ar[j] = pm_add(t.ar[j], pr);
        t.ai[j] = pm_add(t.ai[j], pi);
      }
    }
  }
}

// One group of np partitions (np <= PG): whole chunks of R, then the rest.
template <int R, int PG>
PM_FN void pm_group(PmThread<R>& t, const PmC* xs, const PmC* hs, int w,
                    int bl, int np) {
  int c = 0;
  for (; c + R <= np; c += R) pm_steps<R, PG, false>(t, xs, hs, w, bl, c, R);
  if (c < np) pm_steps<R, PG, true>(t, xs, hs, w, bl, c, np - c);
}

// Sum j times the power-of-two scale (irfft's 1/N folded in; exact).
template <int R>
PM_FN PmC pm_result(const PmThread<R>& t, int j, float scale) {
  return PmC{pm_mul(t.ar[j], scale), pm_mul(t.ai[j], scale)};
}
