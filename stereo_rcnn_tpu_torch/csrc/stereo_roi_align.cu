// Fused stereo RoIAlign forward for Hopper (sm_90a).
//
// Replaces stereo_rcnn_tpu/ops/roi_align_pallas.py::_stereo_kernel with
// packed_out="raw", in the three sampling-weight modes of _HAT_MODES
// (rcnn.roi_align_hat): "f32", "kron_bf16" and "kron_hilo".  For one
// (image, roi) it writes one packed block of 294 rows x C float32:
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
// The design follows from that: one block per (image, roi); each thread owns
// two neighbouring channels, so a warp reads 128 contiguous bytes of a bf16
// NHWC row per tap and stores 256 contiguous bytes of float32 per output
// row; the taps of each side (and, in the kron modes, the rounded weights)
// are computed once per block into shared memory; the 2x2 means are formed
// in registers, so the right side's samples are never stored.  No wgmma,
// TMA or tuning yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 4;
constexpr int kPk = 14;                      // samples per axis
constexpr int kP = 7;                        // pooled bins per axis
constexpr int kKpt = kPk * kPk;              // 196
constexpr int kRows = kKpt + 2 * kP * kP;    // 294

constexpr int kF32 = 0;                      // _HAT_MODES order
constexpr int kKronBf16 = 1;
constexpr int kKronHilo = 2;

struct Pyramids {
  const void* left[kLevels];
  const void* right[kLevels];
  int h[kLevels];        // level height
  int w[kLevels];        // level width
  int win_h[kLevels];    // sampling window, clamped to the level
  int win_w[kLevels];
};

// Bilinear taps of one axis of one side: absolute level cells and weights
// (f32: 1 - frac and frac; kron modes: the two literal hats).
struct Taps {
  int lo[kPk];
  int hi[kPk];
  float wlo[kPk];
  float whi[kPk];
};

// Kron modes, right side, one axis: per 7x7 bin the 4 candidate cells of
// its two samples (absolute, clamped into the window) and their summed hats,
// zero for a cell that repeats an earlier one.
struct BinTaps {
  int cell[kP][4];
  float w[kP][4];
};

__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

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

// A combined weight as the kron modes feed it to the matrix unit.
template <int kMode>
__device__ __forceinline__ float quantize(float w) {
  const float hi = __bfloat162float(__float2bfloat16_rn(w));
  if (kMode == kKronBf16) return hi;
  const float lo = __bfloat162float(__float2bfloat16_rn(__fsub_rn(w, hi)));
  return __fadd_rn(hi, lo);
}

// One f32 sample: y first, then x (the order of the TPU kernel's two hat
// contractions).
template <typename T>
__device__ __forceinline__ float2 sample(const T* img, int w, int c,
                                         int ch, const Taps& ty,
                                         const Taps& tx, int i, int j) {
  const size_t r0 = static_cast<size_t>(ty.lo[i]) * w;
  const size_t r1 = static_cast<size_t>(ty.hi[i]) * w;
  const int x0 = tx.lo[j], x1 = tx.hi[j];
  const float2 v00 = load2(img + (r0 + x0) * c + ch);
  const float2 v01 = load2(img + (r0 + x1) * c + ch);
  const float2 v10 = load2(img + (r1 + x0) * c + ch);
  const float2 v11 = load2(img + (r1 + x1) * c + ch);
  const float wyl = ty.wlo[i], wyh = ty.whi[i];
  const float wxl = tx.wlo[j], wxh = tx.whi[j];
  const float t0x = wyl * v00.x + wyh * v10.x;
  const float t0y = wyl * v00.y + wyh * v10.y;
  const float t1x = wyl * v01.x + wyh * v11.x;
  const float t1y = wyl * v01.y + wyh * v11.y;
  return make_float2(wxl * t0x + wxh * t1x, wxl * t0y + wxh * t1y);
}

// One kron sample of the left side: its 2x2 cells with their rounded
// weights wk = (lo,lo), (lo,hi), (hi,lo), (hi,hi).
template <typename T>
__device__ __forceinline__ float2 sample_kron(const T* img, int w, int c,
                                              int ch, const Taps& ty,
                                              const Taps& tx, int i, int j,
                                              const float* wk) {
  const size_t r0 = static_cast<size_t>(ty.lo[i]) * w;
  const size_t r1 = static_cast<size_t>(ty.hi[i]) * w;
  const int x0 = tx.lo[j], x1 = tx.hi[j];
  const float2 v00 = load2(img + (r0 + x0) * c + ch);
  const float2 v01 = load2(img + (r0 + x1) * c + ch);
  const float2 v10 = load2(img + (r1 + x0) * c + ch);
  const float2 v11 = load2(img + (r1 + x1) * c + ch);
  return make_float2(
      wk[0] * v00.x + wk[1] * v01.x + wk[2] * v10.x + wk[3] * v11.x,
      wk[0] * v00.y + wk[1] * v01.y + wk[2] * v10.y + wk[3] * v11.y);
}

template <typename T, int kMode>
__global__ void stereo_roi_align_kernel(Pyramids pyr,
                                        const int* __restrict__ meta_l,
                                        const float* __restrict__ geom_l,
                                        const int* __restrict__ meta_r,
                                        const float* __restrict__ geom_r,
                                        float* __restrict__ out, int n_rois,
                                        int c) {
  constexpr bool kKron = kMode != kF32;
  const int roi = blockIdx.x;                // b * n_rois + r
  const int b = roi / n_rois;
  __shared__ Taps taps[2][2];                // [side][y, x]
  __shared__ BinTaps bins[2];                // kron right side, [y, x]
  __shared__ float w_left[kKron ? kKpt : 1][4];
  __shared__ float w_right[kKron ? kP * kP : 1][16];
  __shared__ int s_level[2];
  __shared__ int s_valid[2];

  // 2 sides x 2 axes x 14 positions; in the kron modes the right side's
  // entries are its 7 bins per axis instead.
  for (int t = threadIdx.x; t < 2 * 2 * kPk; t += blockDim.x) {
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
    if (kKron && side == 1) {
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
        bt.w[i][k] = repeat[k] ? 0.0f
                               : __fadd_rn(hat(cells[k], p0),
                                           hat(cells[k], p1));
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
    } else {
      tp.whi[i] = pos - fl;
      tp.wlo[i] = 1.0f - (pos - fl);
    }
  }
  __syncthreads();
  if (kKron) {
    // Rounded combined weights: left (avg 1) per sample and tap; right
    // (avg 2) per bin and (row, column) pair, scaled by 1 / avg^2.
    for (int t = threadIdx.x; t < kKpt * 4 + kP * kP * 16; t += blockDim.x) {
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
  const float2 zero = make_float2(0.0f, 0.0f);

  for (int ch = 2 * threadIdx.x; ch < c; ch += 2 * blockDim.x) {
    // Left: 196 samples, then their 2x2 means.
    for (int py = 0; py < kP; ++py) {
      for (int px = 0; px < kP; ++px) {
        float2 acc = zero;
        for (int dy = 0; dy < 2; ++dy) {
          for (int dx = 0; dx < 2; ++dx) {
            const int i = 2 * py + dy, j = 2 * px + dx;
            float2 s = zero;
            if (s_valid[0]) {
              s = kKron ? sample_kron(img_l, w_l, c, ch, taps[0][0],
                                      taps[0][1], i, j, w_left[i * kPk + j])
                        : sample(img_l, w_l, c, ch, taps[0][0], taps[0][1],
                                 i, j);
            }
            store2(blk + static_cast<size_t>(i * kPk + j) * c + ch, s);
            acc.x += s.x;
            acc.y += s.y;
          }
        }
        store2(blk + static_cast<size_t>(kKpt + py * kP + px) * c + ch,
               make_float2(acc.x * 0.25f, acc.y * 0.25f));
      }
    }
    // Right: the 7x7 pool only.
    for (int py = 0; py < kP; ++py) {
      for (int px = 0; px < kP; ++px) {
        float2 acc = zero;
        if (s_valid[1] && kKron) {
          const float* wk = w_right[py * kP + px];
          for (int k = 0; k < 4; ++k) {
            const T* row = img_r + static_cast<size_t>(bins[0].cell[py][k]) *
                                       w_r * c + ch;
            for (int l = 0; l < 4; ++l) {
              const float2 v = load2(row + static_cast<size_t>(
                                               bins[1].cell[px][l]) * c);
              acc.x += wk[k * 4 + l] * v.x;
              acc.y += wk[k * 4 + l] * v.y;
            }
          }
        } else if (s_valid[1]) {
          for (int dy = 0; dy < 2; ++dy) {
            for (int dx = 0; dx < 2; ++dx) {
              const float2 s = sample(img_r, w_r, c, ch, taps[1][0],
                                      taps[1][1], 2 * py + dy, 2 * px + dx);
              acc.x += s.x;
              acc.y += s.y;
            }
          }
          acc = make_float2(acc.x * 0.25f, acc.y * 0.25f);
        }
        store2(blk + static_cast<size_t>(kKpt + kP * kP + py * kP + px) * c +
                   ch,
               acc);
      }
    }
  }
}

template <typename T>
void launch(int mode, int blocks, int threads, cudaStream_t s,
            const Pyramids& pyr, const int* meta_l, const float* geom_l,
            const int* meta_r, const float* geom_r, float* out, int n_rois,
            int c) {
  if (mode == kKronBf16) {
    stereo_roi_align_kernel<T, kKronBf16><<<blocks, threads, 0, s>>>(
        pyr, meta_l, geom_l, meta_r, geom_r, out, n_rois, c);
  } else if (mode == kKronHilo) {
    stereo_roi_align_kernel<T, kKronHilo><<<blocks, threads, 0, s>>>(
        pyr, meta_l, geom_l, meta_r, geom_r, out, n_rois, c);
  } else {
    stereo_roi_align_kernel<T, kF32><<<blocks, threads, 0, s>>>(
        pyr, meta_l, geom_l, meta_r, geom_r, out, n_rois, c);
  }
}

}  // namespace

// C entry, bound with ctypes.  feats_l / feats_r: host arrays of 4 device
// pointers to NHWC levels [B, h, w, C]; level_hw / win_hw: host arrays
// (h0, w0, h1, w1, ...); meta_*: int32 [B, R, 4] (level, y0, x0, valid) and
// geom_*: float32 [B, R, 4] (y1, x1, bin_h, bin_w) on the device; out:
// float32 [B, R, 294, C]; mode: 0 f32, 1 kron_bf16, 2 kron_hilo.  C must be
// even.  Returns cudaGetLastError().
extern "C" int stereo_roi_align_fwd(const void* const* feats_l,
                                    const void* const* feats_r,
                                    const int* level_hw, const int* win_hw,
                                    const int* meta_l, const float* geom_l,
                                    const int* meta_r, const float* geom_r,
                                    float* out, int batch, int n_rois, int c,
                                    int is_bf16, int mode, void* stream) {
  Pyramids pyr;
  for (int l = 0; l < kLevels; ++l) {
    pyr.left[l] = feats_l[l];
    pyr.right[l] = feats_r[l];
    pyr.h[l] = level_hw[2 * l];
    pyr.w[l] = level_hw[2 * l + 1];
    pyr.win_h[l] = win_hw[2 * l];
    pyr.win_w[l] = win_hw[2 * l + 1];
  }
  const int blocks = batch * n_rois;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  int threads = ((c / 2 + 31) / 32) * 32;
  threads = threads > 128 ? 128 : threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch<__nv_bfloat16>(mode, blocks, threads, s, pyr, meta_l, geom_l,
                          meta_r, geom_r, out, n_rois, c);
  } else {
    launch<float>(mode, blocks, threads, s, pyr, meta_l, geom_l, meta_r,
                  geom_r, out, n_rois, c);
  }
  return static_cast<int>(cudaGetLastError());
}
