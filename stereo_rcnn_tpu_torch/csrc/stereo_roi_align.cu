// Fused stereo RoIAlign forward for Hopper (sm_90a).
//
// Replaces stereo_rcnn_tpu/ops/roi_align_pallas.py::_stereo_kernel with
// packed_out="raw", in the five sampling-weight modes of _sample_grid: the
// three of _HAT_MODES (rcnn.roi_align_hat), "f32", "kron_bf16" and
// "kron_hilo", and the two that the JAX package reaches only through
// stereo_roi_align_pallas(hat_dtype=...) (its tools/bench_roialign.py):
// "bf16" (hat_dtype=jnp.bfloat16) and "hilo".  For one (image, roi) it
// writes one packed block of 294 rows x C float32:
//   rows   0..195  left 14x14 bilinear samples at the bin centres (kpt rows)
//   rows 196..244  left 7x7 pool: the 2x2 mean of those samples
//   rows 245..293  right 7x7 pool at sampling ratio 2 on the right features
// Samples are clamped to the roi's window, not to its level: the window is
// _STEREO_WIN clamped to the level, its origin (y0, x0) and the roi geometry
// in window coordinates come from the shared metadata that
// ops/stereo_roi_align.py::roi_window_meta computes on the device, so the
// kernel and its plain PyTorch version never disagree on a level or window.
// A zero-area roi writes zeros.
//
// "f32": a sample at window position p reads the two cells floor(p) and
// min(floor(p) + 1, win - 1) with weights 1 - frac and frac (the TPU
// kernel's hat weights max(0, 1 - |cell - p|)); the right 7x7 is the 2x2
// mean of the 14x14 grid taken on the right features.
//
// Kron modes (_sample_grid's kron branch): the TPU kernel builds one
// combined weight per (sample, window cell),
//   W = (sum_a hat_y,a) * (sum_a hat_x,a) * (1 / avg^2),
// and rounds it to bf16 once ("kron_bf16") or splits it into bf16 hi + lo
// ("kron_hilo"; hi + lo is exact in float32, so one weight stands for the
// TPU kernel's two products).  Only the cells a sample touches have W != 0,
// so the kernel reads just those: on the left (avg = 1) the 2x2 cells of
// each of the 196 samples; on the right (avg = 2, folding the 2x2 bin mean
// into the weights) the up to 4 distinct rows and 4 distinct columns of
// each 7x7 bin's two samples per axis, whose hats are summed per distinct
// row and column before the product and the rounding (rounding the 16 tap
// products one by one would give another result), so the right 7x7 is not
// the mean of four kron samples.  The hats are computed with explicit
// roundings in the JAX order, 1 - |cell - p| with __fsub_rn, so no
// contraction the compiler chooses moves a weight by an ulp and flips its
// bf16 rounding: the weights equal the plain version's bit for bit.
//
// Two-matmul modes (_sample_grid's other branch, roi_align_pallas.py
// :311-356): the hat rows wy [n, wh] and wx [n, ww] are contracted one after
// the other, y first, with a rounding in between.  On the right (avg = 2)
// a bin's hat per distinct row (column) is the MEAN of its two samples'
// hats, (h0 + h1) * 0.5 in float32, as jnp.mean takes it, before any
// rounding.  "bf16": the hats are rounded to bf16; for each column x that
// an x-hat touches, t_x = sum over the touched rows of wy * window[row, x]
// in float32 (ascending rows, fused multiply-adds), rounded to bf16; then
// out = sum over those columns of wx * t_x in float32.  "hilo": the y-hats
// are split into bf16 hi + lo and the two y-passes summed in float32 (t_x =
// hi-pass + lo-pass); t_x and the x-hats are split too, and the products
// hi x hi, hi x lo and lo x hi are three separate float32 sums added in
// that order (lo x lo dropped), as the JAX code adds its three dots.  A hat
// is zero away from its taps, so each contraction runs over the touched
// cells only: 2 rows and 2 columns per left sample, the up to 4 distinct
// rows and columns per right bin (a repeated cell carries weight 0).  With
// bf16 levels every product is exact (bf16 x bf16 fits float32), so the
// left side equals any implementation's sums bit for bit; the right side's
// 4-term sums can round differently in another order, and a bf16
// intermediate one float32 rounding from a bf16 boundary then moves by a
// bf16 step.
//
// In every mode a sample's position y1 + (k + 0.5) * bin is rounded once
// (__fmaf_rn), as XLA fuses it into one multiply-add where the JAX kernel is
// checked, on the CPU, and as the plain versions compute it.
//
// What bounds it on an H100: memory traffic, mostly the output.  Each roi
// writes 294 x 256 x 4 B = 301 KB of float32, so one batch-16 call
// (16 x 300 rois) stores 1.45 GB, about 0.43 ms at 3.35 TB/s.  Its reads
// are 4 taps x 392 samples x 512 B = 0.8 MB per roi, but they touch at most
// 28 x 28 distinct cells per side, the rois of one image overlap, and
// consecutive blocks belong to one image, so most taps should hit in the
// 50 MB L2: the bf16 pyramids of both sides are 0.67 GB at batch 16, read
// about once from device memory.
// The first port (one block of at most 128 threads per roi, two
// channels per thread, 4-byte tap loads, each thread walking all 98 bins,
// plain 8-byte stores) took 1.102-1.108 ms in f32, 1.120-1.124 kron_bf16,
// 1.122-1.135 kron_hilo, 1.113-1.117 bf16 and 1.312-1.320 hilo at batch
// 16 x 300 rois, C = 256, bf16 levels ("NVIDIA H100 80GB HBM3, 700.00 W"),
// against a 0.631 ms bound; its plain stores evicted from L2 the pyramid
// the taps re-read.  The design now, K4's (csrc/stereo_roi_align_atlas.cu):
// - one block per (image, roi); the taps of each side (and the mode's
//   weights) computed once per block into shared memory;
// - each lane owns kVec = 8 neighbouring channels (vec.cuh): one 16-byte
//   load per bf16 tap, two float4 loads per float32 tap; a C that is not a
//   multiple of 8 (or a level that is not 16-byte aligned) takes 2-channel
//   lanes, the same kernel with kVec = 2, and an odd C 1-channel lanes
//   (kVec = 1), chosen by the C entry;
// - the block's ~256 threads are (C / kVec) lanes x groups; group g takes
//   the 7x7 bins g, g + groups, ...: a bin's 2x2 left samples, their mean
//   and the right bin's pool;
// - all 294 rows are stored as float4 with __stcs, so the 1.45 GB of output
//   streams past L2.
// Each channel's arithmetic is the first port's, term for term, so the
// outputs are the same bits in every mode.
// Timed by chip_smoke.py (phase 3) at batch 16 x 300 rois, C = 256, bf16
// levels, in turns with the first port in one call ("NVIDIA H100 80GB
// HBM3, 700.00 W"): f32 0.881-0.883 ms (first port 1.107-1.110), kron_bf16
// 0.899-0.908 (1.131), kron_hilo 0.907-0.920 (1.110-1.132), bf16
// 0.855-0.864 (1.097-1.125), hilo 0.954-0.955 (1.314-1.320), against the
// 0.631 ms bound and 0.439 ms for the store side alone (the output
// zeroed).  The outputs of all five modes were the same bits as the first
// port's (chip_smoke.py --digests).  What still holds it above the bound:
// the taps' re-reads of the pyramid from L2 and L1 (16 loads per bin on
// each side) and, in hilo, a second y-pass and three x-products per
// column; not measured without a profiler of the card's counters.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec.cuh"

namespace {

constexpr int kLevels = 4;
constexpr int kPk = 14;                      // samples per axis
constexpr int kP = 7;                        // pooled bins per axis
constexpr int kKpt = kPk * kPk;              // 196
constexpr int kRows = kKpt + 2 * kP * kP;    // 294

constexpr int kF32 = 0;                      // _HAT_MODES order
constexpr int kKronBf16 = 1;
constexpr int kKronHilo = 2;
constexpr int kBf16 = 3;                     // the two-matmul modes
constexpr int kHilo = 4;

struct Pyramids {
  const void* left[kLevels];
  const void* right[kLevels];
  int h[kLevels];        // level height
  int w[kLevels];        // level width
  int win_h[kLevels];    // sampling window, clamped to the level
  int win_w[kLevels];
};

// Bilinear taps of one axis of one side: absolute level cells and weights
// (f32: 1 - frac and frac; kron modes: the two literal hats; two-matmul
// modes: the two hats rounded to bf16, or their bf16 hi parts with the lo
// parts in wlo2 / whi2).
struct Taps {
  int lo[kPk];
  int hi[kPk];
  float wlo[kPk];
  float whi[kPk];
  float wlo2[kPk];
  float whi2[kPk];
};

// Right side, one axis, all modes but f32: per 7x7 bin the 4 candidate
// cells of its two samples (absolute, clamped into the window) and their
// hats, zero for a cell that repeats an earlier one.  Kron modes: the hats
// summed; two-matmul modes: their mean, rounded to bf16 (or its hi part,
// with the lo part in w2).
struct BinTaps {
  int cell[kP][4];
  float w[kP][4];
  float w2[kP][4];
};

constexpr int kBlockThreads = 256;

// Sample position y1 + (k + 0.5) * bin, rounded once, clamped to
// [0, win - 1] (k is the sample's index on the 14-sample grid).
__device__ __forceinline__ float position(float start, float bin, int k,
                                          int win) {
  const float p = __fmaf_rn(static_cast<float>(k) + 0.5f, bin, start);
  return fminf(fmaxf(p, 0.0f), static_cast<float>(win - 1));
}

// The TPU kernel's hat weight max(0, 1 - |cell - p|), cell in window
// coordinates.
__device__ __forceinline__ float hat(int cell, float p) {
  return fmaxf(0.0f, __fsub_rn(1.0f,
                               fabsf(__fsub_rn(static_cast<float>(cell), p))));
}

__device__ __forceinline__ float round_bf16(float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

// The bf16 hi and lo parts of w (roi_align_pallas.py::_hi_lo).
__device__ __forceinline__ float2 hi_lo(float w) {
  const float hi = round_bf16(w);
  return make_float2(hi, round_bf16(__fsub_rn(w, hi)));
}

// A combined weight as the kron modes feed it to the matrix unit.
template <int kMode>
__device__ __forceinline__ float quantize(float w) {
  const float2 h = hi_lo(w);
  return kMode == kKronBf16 ? h.x : __fadd_rn(h.x, h.y);
}

// A two-matmul mode's hat as it reaches the matrix unit: rounded to bf16
// ("bf16", *w2 unused) or split into hi (returned) and lo (*w2) ("hilo").
template <int kMode>
__device__ __forceinline__ float split_hat(float w, float* w2) {
  if (kMode == kBf16) return round_bf16(w);
  const float2 h = hi_lo(w);
  *w2 = h.y;
  return h.x;
}

// One f32 sample: y first, then x (the order of the TPU kernel's two hat
// contractions).
template <int kVec, typename T>
__device__ __forceinline__ Vec<kVec> sample(const T* img, int w, int c,
                                            int ch, const Taps& ty,
                                            const Taps& tx, int i, int j) {
  const size_t r0 = static_cast<size_t>(ty.lo[i]) * w;
  const size_t r1 = static_cast<size_t>(ty.hi[i]) * w;
  const int x0 = tx.lo[j], x1 = tx.hi[j];
  const Vec<kVec> v00 = load_vec<kVec>(img + (r0 + x0) * c + ch);
  const Vec<kVec> v01 = load_vec<kVec>(img + (r0 + x1) * c + ch);
  const Vec<kVec> v10 = load_vec<kVec>(img + (r1 + x0) * c + ch);
  const Vec<kVec> v11 = load_vec<kVec>(img + (r1 + x1) * c + ch);
  const float wyl = ty.wlo[i], wyh = ty.whi[i];
  const float wxl = tx.wlo[j], wxh = tx.whi[j];
  Vec<kVec> s;
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const float t0 = wyl * v00.v[v] + wyh * v10.v[v];
    const float t1 = wyl * v01.v[v] + wyh * v11.v[v];
    s.v[v] = wxl * t0 + wxh * t1;
  }
  return s;
}

// One kron sample of the left side: its 2x2 cells with their rounded
// weights wk = (lo,lo), (lo,hi), (hi,lo), (hi,hi).
template <int kVec, typename T>
__device__ __forceinline__ Vec<kVec> sample_kron(const T* img, int w, int c,
                                                 int ch, const Taps& ty,
                                                 const Taps& tx, int i, int j,
                                                 const float* wk) {
  const size_t r0 = static_cast<size_t>(ty.lo[i]) * w;
  const size_t r1 = static_cast<size_t>(ty.hi[i]) * w;
  const int x0 = tx.lo[j], x1 = tx.hi[j];
  const Vec<kVec> v00 = load_vec<kVec>(img + (r0 + x0) * c + ch);
  const Vec<kVec> v01 = load_vec<kVec>(img + (r0 + x1) * c + ch);
  const Vec<kVec> v10 = load_vec<kVec>(img + (r1 + x0) * c + ch);
  const Vec<kVec> v11 = load_vec<kVec>(img + (r1 + x1) * c + ch);
  Vec<kVec> s;
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    s.v[v] = wk[0] * v00.v[v] + wk[1] * v01.v[v] + wk[2] * v10.v[v] +
             wk[3] * v11.v[v];
  }
  return s;
}

template <int kVec>
__device__ __forceinline__ void fma_vec(float w, const Vec<kVec>& x,
                                        Vec<kVec>& acc) {
#pragma unroll
  for (int v = 0; v < kVec; ++v) acc.v[v] = __fmaf_rn(w, x.v[v], acc.v[v]);
}

// One output of a two-matmul mode from kN touched rows and columns (2 per
// left sample, 4 per right bin): for each column the y-pass over the rows,
// rounded to bf16 ("bf16") or split into hi + lo ("hilo"), then the x-pass.
// wy / wx are the rounded hats (hilo: hi parts; wy2 / wx2 the lo parts).
template <int kMode, int kN, int kVec, typename T>
__device__ __forceinline__ Vec<kVec> sample_2mm(
    const T* img, int w, int c, int ch, const int (&rows)[kN],
    const float (&wy)[kN], const float (&wy2)[kN], const int (&cols)[kN],
    const float (&wx)[kN], const float (&wx2)[kN]) {
  // hilo: the three x-passes
  Vec<kVec> hh = zero_vec<kVec>(), hl = zero_vec<kVec>(),
            lh = zero_vec<kVec>();
#pragma unroll
  for (int l = 0; l < kN; ++l) {
    // y-passes (hilo: hi and lo)
    Vec<kVec> a = zero_vec<kVec>(), b = zero_vec<kVec>();
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const Vec<kVec> x = load_vec<kVec>(
          img + (static_cast<size_t>(rows[k]) * w + cols[l]) * c + ch);
      fma_vec(wy[k], x, a);
      if (kMode == kHilo) fma_vec(wy2[k], x, b);
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      if (kMode == kBf16) {
        hh.v[v] = __fmaf_rn(wx[l], round_bf16(a.v[v]), hh.v[v]);
      } else {
        const float t = __fadd_rn(a.v[v], b.v[v]);
        const float t_hi = round_bf16(t);
        const float t_lo = round_bf16(__fsub_rn(t, t_hi));
        hh.v[v] = __fmaf_rn(wx[l], t_hi, hh.v[v]);
        hl.v[v] = __fmaf_rn(wx[l], t_lo, hl.v[v]);
        lh.v[v] = __fmaf_rn(wx2[l], t_hi, lh.v[v]);
      }
    }
  }
  if (kMode == kHilo) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      hh.v[v] = __fadd_rn(__fadd_rn(hh.v[v], hl.v[v]), lh.v[v]);
    }
  }
  return hh;
}

template <typename T, int kMode, int kVec>
__global__ void __launch_bounds__(kBlockThreads)
    stereo_roi_align_kernel(Pyramids pyr, const int* __restrict__ meta_l,
                            const float* __restrict__ geom_l,
                            const int* __restrict__ meta_r,
                            const float* __restrict__ geom_r,
                            float* __restrict__ out, int n_rois, int c) {
  constexpr bool kKron = kMode == kKronBf16 || kMode == kKronHilo;
  constexpr bool kTwoMM = kMode == kBf16 || kMode == kHilo;
  const int roi = blockIdx.x;                // b * n_rois + r
  const int b = roi / n_rois;
  __shared__ Taps taps[2][2];                // [side][y, x]
  __shared__ BinTaps bins[2];                // right side but f32, [y, x]
  __shared__ float w_left[kKron ? kKpt : 1][4];
  __shared__ float w_right[kKron ? kP * kP : 1][16];
  __shared__ int s_level[2];
  __shared__ int s_valid[2];

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  // 2 sides x 2 axes x 14 positions; in all modes but f32 the right side's
  // entries are its 7 bins per axis instead.
  for (int t = tid; t < 2 * 2 * kPk; t += n_threads) {
    const int side = t / (2 * kPk);
    const int axis = (t / kPk) % 2;          // 0: y, 1: x
    const int i = t % kPk;
    const int* meta = (side == 0 ? meta_l : meta_r) + roi * 4;
    const float* geom = (side == 0 ? geom_l : geom_r) + roi * 4;
    const int level = meta[0];
    const int win = axis == 0 ? pyr.win_h[level] : pyr.win_w[level];
    const int origin = meta[1 + axis];
    if (axis == 0 && i == 0) {
      s_level[side] = level;
      s_valid[side] = meta[3];
    }
    if (kMode != kF32 && side == 1) {
      if (i >= kP) continue;
      const float p0 = position(geom[axis], geom[2 + axis], 2 * i, win);
      const float p1 =
          position(geom[axis], geom[2 + axis], 2 * i + 1, win);
      const int lo0 = static_cast<int>(floorf(p0));
      const int lo1 = static_cast<int>(floorf(p1));
      const int cells[4] = {lo0, lo0 + 1, lo1, lo1 + 1};
      // lo1 >= lo0: cell 2 repeats cell 0 or 1 when lo1 <= lo0 + 1, and
      // cell 3 repeats cell 1 when lo1 == lo0.
      const bool repeat[4] = {false, false, lo1 <= lo0 + 1, lo1 == lo0};
      BinTaps& bt = bins[axis];
      for (int k = 0; k < 4; ++k) {
        bt.cell[i][k] = origin + min(cells[k], win - 1);
        const float sum = repeat[k] ? 0.0f
                                    : __fadd_rn(hat(cells[k], p0),
                                                hat(cells[k], p1));
        // Two-matmul modes: the mean of the two hats (jnp.mean), rounded.
        bt.w[i][k] = kTwoMM ? split_hat<kMode>(__fmul_rn(sum, 0.5f),
                                               &bt.w2[i][k])
                            : sum;
      }
      continue;
    }
    const float pos = position(geom[axis], geom[2 + axis], i, win);
    const float fl = floorf(pos);
    const int lo = static_cast<int>(fl);
    Taps& tp = taps[side][axis];
    tp.lo[i] = origin + lo;
    tp.hi[i] = origin + min(lo + 1, win - 1);
    if (kKron) {
      tp.wlo[i] = hat(lo, pos);
      tp.whi[i] = hat(lo + 1, pos);
    } else if (kTwoMM) {
      tp.wlo[i] = split_hat<kMode>(hat(lo, pos), &tp.wlo2[i]);
      tp.whi[i] = split_hat<kMode>(hat(lo + 1, pos), &tp.whi2[i]);
    } else {
      tp.whi[i] = pos - fl;
      tp.wlo[i] = 1.0f - (pos - fl);
    }
  }
  __syncthreads();
  if (kKron) {
    // Rounded combined weights: left (avg 1) per sample and tap; right
    // (avg 2) per bin and (row, column) pair, scaled by 1 / avg^2.
    for (int t = tid; t < kKpt * 4 + kP * kP * 16; t += n_threads) {
      if (t < kKpt * 4) {
        const int s = t / 4, k = t % 4;
        const int i = s / kPk, j = s % kPk;
        const float wy = (k / 2) ? taps[0][0].whi[i] : taps[0][0].wlo[i];
        const float wx = (k % 2) ? taps[0][1].whi[j] : taps[0][1].wlo[j];
        w_left[s][k] = quantize<kMode>(__fmul_rn(wy, wx));
      } else {
        const int u = t - kKpt * 4;
        const int bin = u / 16, k = (u % 16) / 4, l = u % 4;
        const float wy = bins[0].w[bin / kP][k];
        const float wx = bins[1].w[bin % kP][l];
        w_right[bin][k * 4 + l] =
            quantize<kMode>(__fmul_rn(__fmul_rn(wy, wx), 0.25f));
      }
    }
    __syncthreads();
  }

  float* blk = out + static_cast<size_t>(roi) * kRows * c;
  const int lvl_l = s_level[0], lvl_r = s_level[1];
  const T* img_l = static_cast<const T*>(pyr.left[lvl_l]) +
                   static_cast<size_t>(b) * pyr.h[lvl_l] * pyr.w[lvl_l] * c;
  const T* img_r = static_cast<const T*>(pyr.right[lvl_r]) +
                   static_cast<size_t>(b) * pyr.h[lvl_r] * pyr.w[lvl_r] * c;
  const int w_l = pyr.w[lvl_l], w_r = pyr.w[lvl_r];
  const bool valid_l = s_valid[0] != 0, valid_r = s_valid[1] != 0;

  for (int ch = threadIdx.x * kVec; ch < c; ch += blockDim.x * kVec) {
    for (int bin = threadIdx.y; bin < kP * kP; bin += blockDim.y) {
      const int py = bin / kP, px = bin % kP;
      // Left: the bin's 2x2 samples (kpt rows), then their mean.
      Vec<kVec> acc = zero_vec<kVec>();
      for (int dy = 0; dy < 2; ++dy) {
        for (int dx = 0; dx < 2; ++dx) {
          const int i = 2 * py + dy, j = 2 * px + dx;
          Vec<kVec> s = zero_vec<kVec>();
          if (valid_l && kTwoMM) {
            const Taps& ty = taps[0][0];
            const Taps& tx = taps[0][1];
            s = sample_2mm<kMode, 2, kVec>(
                img_l, w_l, c, ch, {ty.lo[i], ty.hi[i]},
                {ty.wlo[i], ty.whi[i]}, {ty.wlo2[i], ty.whi2[i]},
                {tx.lo[j], tx.hi[j]}, {tx.wlo[j], tx.whi[j]},
                {tx.wlo2[j], tx.whi2[j]});
          } else if (valid_l) {
            s = kKron ? sample_kron<kVec>(img_l, w_l, c, ch, taps[0][0],
                                          taps[0][1], i, j,
                                          w_left[i * kPk + j])
                      : sample<kVec>(img_l, w_l, c, ch, taps[0][0],
                                     taps[0][1], i, j);
          }
          store_vec(blk + static_cast<size_t>(i * kPk + j) * c + ch, s);
#pragma unroll
          for (int v = 0; v < kVec; ++v) acc.v[v] += s.v[v];
        }
      }
#pragma unroll
      for (int v = 0; v < kVec; ++v) acc.v[v] = acc.v[v] * 0.25f;
      store_vec(blk + static_cast<size_t>(kKpt + bin) * c + ch, acc);
      // Right: the 7x7 pool only.
      acc = zero_vec<kVec>();
      if (valid_r && kKron) {
        const float* wk = w_right[bin];
        for (int k = 0; k < 4; ++k) {
          const T* row = img_r + static_cast<size_t>(bins[0].cell[py][k]) *
                                     w_r * c + ch;
          for (int l = 0; l < 4; ++l) {
            const Vec<kVec> x = load_vec<kVec>(
                row + static_cast<size_t>(bins[1].cell[px][l]) * c);
#pragma unroll
            for (int v = 0; v < kVec; ++v) {
              acc.v[v] += wk[k * 4 + l] * x.v[v];
            }
          }
        }
      } else if (valid_r && kTwoMM) {
        const BinTaps& by = bins[0];
        const BinTaps& bx = bins[1];
        acc = sample_2mm<kMode, 4, kVec>(
            img_r, w_r, c, ch,
            {by.cell[py][0], by.cell[py][1], by.cell[py][2], by.cell[py][3]},
            {by.w[py][0], by.w[py][1], by.w[py][2], by.w[py][3]},
            {by.w2[py][0], by.w2[py][1], by.w2[py][2], by.w2[py][3]},
            {bx.cell[px][0], bx.cell[px][1], bx.cell[px][2], bx.cell[px][3]},
            {bx.w[px][0], bx.w[px][1], bx.w[px][2], bx.w[px][3]},
            {bx.w2[px][0], bx.w2[px][1], bx.w2[px][2], bx.w2[px][3]});
      } else if (valid_r) {
        for (int dy = 0; dy < 2; ++dy) {
          for (int dx = 0; dx < 2; ++dx) {
            const Vec<kVec> s = sample<kVec>(img_r, w_r, c, ch, taps[1][0],
                                             taps[1][1], 2 * py + dy,
                                             2 * px + dx);
#pragma unroll
            for (int v = 0; v < kVec; ++v) acc.v[v] += s.v[v];
          }
        }
#pragma unroll
        for (int v = 0; v < kVec; ++v) acc.v[v] = acc.v[v] * 0.25f;
      }
      store_vec(blk + static_cast<size_t>(kKpt + kP * kP + bin) * c + ch,
                acc);
    }
  }
}

// Groups of lanes over the 7x7 bins.
template <typename T, int kVec>
void launch(int mode, int blocks, cudaStream_t s, const Pyramids& pyr,
            const int* meta_l, const float* geom_l, const int* meta_r,
            const float* geom_r, float* out, int n_rois, int c) {
  const dim3 threads = lane_groups(c, kVec, kBlockThreads, kP * kP);
  if (mode == kKronBf16) {
    stereo_roi_align_kernel<T, kKronBf16, kVec><<<blocks, threads, 0, s>>>(
        pyr, meta_l, geom_l, meta_r, geom_r, out, n_rois, c);
  } else if (mode == kKronHilo) {
    stereo_roi_align_kernel<T, kKronHilo, kVec><<<blocks, threads, 0, s>>>(
        pyr, meta_l, geom_l, meta_r, geom_r, out, n_rois, c);
  } else if (mode == kBf16) {
    stereo_roi_align_kernel<T, kBf16, kVec><<<blocks, threads, 0, s>>>(
        pyr, meta_l, geom_l, meta_r, geom_r, out, n_rois, c);
  } else if (mode == kHilo) {
    stereo_roi_align_kernel<T, kHilo, kVec><<<blocks, threads, 0, s>>>(
        pyr, meta_l, geom_l, meta_r, geom_r, out, n_rois, c);
  } else {
    stereo_roi_align_kernel<T, kF32, kVec><<<blocks, threads, 0, s>>>(
        pyr, meta_l, geom_l, meta_r, geom_r, out, n_rois, c);
  }
}

}  // namespace

// C entry, bound with ctypes.  feats_l / feats_r: host arrays of 4 device
// pointers to NHWC levels [B, h, w, C]; level_hw / win_hw: host arrays
// (h0, w0, h1, w1, ...); meta_*: int32 [B, R, 4] (level, y0, x0, valid) and
// geom_*: float32 [B, R, 4] (y1, x1, bin_h, bin_w) on the device; out:
// float32 [B, R, 294, C]; mode: 0 f32, 1 kron_bf16, 2 kron_hilo, 3 bf16,
// 4 hilo.  Any C: 8-channel lanes where C is a multiple of 8 and every
// level and the output are 16-byte aligned, else 2-channel lanes for an
// even C, else 1-channel lanes (vec.cuh lane_width).  Returns
// cudaGetLastError().
extern "C" int stereo_roi_align_fwd(const void* const* feats_l,
                                    const void* const* feats_r,
                                    const int* level_hw, const int* win_hw,
                                    const int* meta_l, const float* geom_l,
                                    const int* meta_r, const float* geom_r,
                                    float* out, int batch, int n_rois, int c,
                                    int is_bf16, int mode, void* stream) {
  Pyramids pyr;
  bool wide = aligned16(out);
  for (int l = 0; l < kLevels; ++l) {
    pyr.left[l] = feats_l[l];
    pyr.right[l] = feats_r[l];
    pyr.h[l] = level_hw[2 * l];
    pyr.w[l] = level_hw[2 * l + 1];
    pyr.win_h[l] = win_hw[2 * l];
    pyr.win_w[l] = win_hw[2 * l + 1];
    wide = wide && aligned16(feats_l[l]) && aligned16(feats_r[l]);
  }
  const int blocks = batch * n_rois;
  if (blocks == 0 || c == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = lane_width(c, wide);
  if (is_bf16 && vec == 8) {
    launch<__nv_bfloat16, 8>(mode, blocks, s, pyr, meta_l, geom_l, meta_r,
                             geom_r, out, n_rois, c);
  } else if (is_bf16 && vec == 2) {
    launch<__nv_bfloat16, 2>(mode, blocks, s, pyr, meta_l, geom_l, meta_r,
                             geom_r, out, n_rois, c);
  } else if (is_bf16) {
    launch<__nv_bfloat16, 1>(mode, blocks, s, pyr, meta_l, geom_l, meta_r,
                             geom_r, out, n_rois, c);
  } else if (vec == 8) {
    launch<float, 8>(mode, blocks, s, pyr, meta_l, geom_l, meta_r, geom_r,
                     out, n_rois, c);
  } else if (vec == 2) {
    launch<float, 2>(mode, blocks, s, pyr, meta_l, geom_l, meta_r, geom_r,
                     out, n_rois, c);
  } else {
    launch<float, 1>(mode, blocks, s, pyr, meta_l, geom_l, meta_r, geom_r,
                     out, n_rois, c);
  }
  return static_cast<int>(cudaGetLastError());
}
