// One-sided multilevel RoIAlign over a per-roi window, for Hopper (sm_90a).
//
// Replaces stereo_rcnn_tpu/ops/roi_align_pallas.py::_kernel (entries
// roi_align_pallas_single and multilevel_roi_align_pallas).  For one
// (image, roi) it writes P x P float32 bins, each the mean of s x s bilinear
// samples.  What it reproduces of the TPU kernel, rather than fixes:
//   * the window is (48, 96) clamped to the roi's level, its origin centred
//     on the roi, clamped into the level, then x0 aligned down to 8
//     (ops/roi_align_window.py::roi_align_window_meta, on the device);
//   * sample k of an axis sits at y1 + ((k + 0.5) / s) * bin with
//     bin = roi / P: the quotient rounded (__fdiv_rn), then one fused
//     multiply-add (__fmaf_rn, as in K1) -- another rounding order than
//     K1's (k + 0.5) * bin -- and clamped to [0, win - 1] of the window;
//   * the valid flag is computed after the roi's width and height were
//     clamped to >= 1, so it is always 1: a zero-area roi gives the samples
//     of a 1-cell roi, not zeros.
// A sample reads floor(p) and min(floor(p) + 1, win - 1) with weights
// 1 - frac and frac (the TPU kernel's hat weights max(0, 1 - |cell - p|)),
// y first, then x.  Any P and s with P * s <= 64, up to 5 levels, any C.
//
// What bounds it on an H100: memory traffic.  It writes P * P * C float32
// per roi (50 KB at P = 7, C = 256) and reads the levels of one side; the
// taps of a roi touch at most (P * s + 1)^2 distinct cells, and the rois of
// one image overlap, so the reads should mostly hit in the 50 MB L2.  At
// (P, s) = (7, 2) it stores only 241 MB for 16 x 300 rois but issues 16 tap
// loads per bin, about 1.9 GB of loads, most of them hits in L2 or L1.
// The first port (one block of at most 128 threads per roi, two
// channels per thread, 4-byte tap loads, each thread walking all P * P
// bins, plain 8-byte stores) took 0.542-0.548 ms at (7, 2) and 0.857-0.878
// ms at (14, 1), batch 16 x 300 rois, C = 256, bf16 levels ("NVIDIA H100
// 80GB HBM3, 700.00 W"), against bounds of 0.172 and 0.387 ms.  The design
// now, K1's and K4's:
// - one block per (image, roi), the taps computed once per block into
//   shared memory;
// - each lane owns kVec = 8 neighbouring channels (vec.cuh): one 16-byte
//   load per bf16 tap, two float4 loads per float32 tap; a C that is not a
//   multiple of 8 (or a level that is not 16-byte aligned) takes 2-channel
//   lanes, the same kernel with kVec = 2, and an odd C 1-channel lanes
//   (kVec = 1), chosen by the C entry;
// - the block's ~256 threads are (C / kVec) lanes x groups; group g takes
//   the bins g, g + groups, ... of the P x P;
// - each bin is stored as float4 with __stcs, streaming past L2.
// Each channel's arithmetic is the first port's, term for term (y first,
// then x, the samples summed in (dy, dx) order, then divided by s * s), so
// the outputs are the same bits.
// Timed by chip_smoke.py (phase 5) at batch 16 x 300 rois, C = 256, in
// turns with the first port in one call ("NVIDIA H100 80GB HBM3, 700.00 W"):
// bf16 levels (7, 2) 0.261 ms (first port 0.540) and (14, 1) 0.516-0.518 ms
// (0.881-0.887), against bounds of 0.172 and 0.387 ms and 0.077 and
// 0.294-0.296 ms for the store side alone (the output zeroed); float32
// levels (7, 2) 0.372 (0.608-0.609) and (14, 1) 0.646-0.649 (1.036-1.040)
// against 0.271 and 0.487 ms.  The outputs were the same bits as the first
// port's (chip_smoke.py --digests).  Both cases met the aim of half the
// bound (0.344 and 0.774 ms), so merging a bin's taps per distinct cell
// (K4's right pool, another float32 order) was not tried.  What still
// holds (7, 2) above its bound: 16 tap loads per bin, about 1.9 GB from L2
// and L1 against 241 MB of output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec.cuh"

namespace {

constexpr int kMaxLevels = 5;
constexpr int kMaxSamples = 64;              // P * s per axis
constexpr int kBlockThreads = 256;

struct Levels {
  const void* feat[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int win_h[kMaxLevels];
  int win_w[kMaxLevels];
};

struct Taps {
  int lo[kMaxSamples];
  int hi[kMaxSamples];
  float wlo[kMaxSamples];
  float whi[kMaxSamples];
};

template <typename T, int kVec>
__global__ void __launch_bounds__(kBlockThreads)
    roi_align_window_kernel(Levels lv, const int* __restrict__ meta,
                            const float* __restrict__ geom,
                            float* __restrict__ out, int n_rois, int c,
                            int p, int s) {
  const int roi = blockIdx.x;                // b * n_rois + r
  const int b = roi / n_rois;
  const int n = p * s;
  __shared__ Taps taps[2];                   // [y, x]

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  const int level = meta[roi * 4];
  for (int t = tid; t < 2 * n; t += n_threads) {
    const int axis = t / n;                  // 0: y, 1: x
    const int k = t % n;
    const int win = axis == 0 ? lv.win_h[level] : lv.win_w[level];
    const int origin = meta[roi * 4 + 1 + axis];
    const float* g = geom + roi * 4;
    const float grid = __fdiv_rn(static_cast<float>(k) + 0.5f,
                                 static_cast<float>(s));
    float pos = __fmaf_rn(grid, g[2 + axis], g[axis]);
    pos = fminf(fmaxf(pos, 0.0f), static_cast<float>(win - 1));
    const float fl = floorf(pos);
    const int lo = static_cast<int>(fl);
    taps[axis].lo[k] = origin + lo;
    taps[axis].hi[k] = origin + min(lo + 1, win - 1);
    taps[axis].whi[k] = pos - fl;
    taps[axis].wlo[k] = 1.0f - (pos - fl);
  }
  __syncthreads();

  const bool valid = meta[roi * 4 + 3] != 0;
  const int w = lv.w[level];
  const T* img = static_cast<const T*>(lv.feat[level]) +
                 static_cast<size_t>(b) * lv.h[level] * w * c;
  float* blk = out + static_cast<size_t>(roi) * p * p * c;
  const float count = static_cast<float>(s * s);
  const Taps& ty = taps[0];
  const Taps& tx = taps[1];

  for (int ch = threadIdx.x * kVec; ch < c; ch += blockDim.x * kVec) {
    for (int bin = threadIdx.y; bin < p * p; bin += blockDim.y) {
      const int py = bin / p, px = bin % p;
      Vec<kVec> acc = zero_vec<kVec>();
      if (valid) {
        for (int dy = 0; dy < s; ++dy) {
          const int i = py * s + dy;
          const size_t r0 = static_cast<size_t>(ty.lo[i]) * w;
          const size_t r1 = static_cast<size_t>(ty.hi[i]) * w;
          const float wyl = ty.wlo[i], wyh = ty.whi[i];
          for (int dx = 0; dx < s; ++dx) {
            const int j = px * s + dx;
            const int x0 = tx.lo[j], x1 = tx.hi[j];
            const Vec<kVec> v00 = load_vec<kVec>(img + (r0 + x0) * c + ch);
            const Vec<kVec> v01 = load_vec<kVec>(img + (r0 + x1) * c + ch);
            const Vec<kVec> v10 = load_vec<kVec>(img + (r1 + x0) * c + ch);
            const Vec<kVec> v11 = load_vec<kVec>(img + (r1 + x1) * c + ch);
            // y first, then x: the order of the TPU kernel's two hat
            // contractions.
            const float wxl = tx.wlo[j], wxh = tx.whi[j];
#pragma unroll
            for (int v = 0; v < kVec; ++v) {
              acc.v[v] += wxl * (wyl * v00.v[v] + wyh * v10.v[v]) +
                          wxh * (wyl * v01.v[v] + wyh * v11.v[v]);
            }
          }
        }
#pragma unroll
        for (int v = 0; v < kVec; ++v) acc.v[v] = __fdiv_rn(acc.v[v], count);
      }
      store_vec(blk + static_cast<size_t>(bin) * c + ch, acc);
    }
  }
}

// Groups of lanes over the P x P bins.
template <typename T, int kVec>
void launch(int blocks, int c, int p, int s, cudaStream_t st,
            const Levels& lv, const int* meta, const float* geom,
            float* out, int n_rois) {
  roi_align_window_kernel<T, kVec>
      <<<blocks, lane_groups(c, kVec, kBlockThreads, p * p), 0, st>>>(
          lv, meta, geom, out, n_rois, c, p, s);
}

}  // namespace

// C entry, bound with ctypes.  feats: host array of n_levels device pointers
// to NHWC levels [B, h, w, C]; level_hw / win_hw: host arrays (h0, w0, h1,
// w1, ...); meta: int32 [B, R, 4] (level, y0, x0, valid) and geom: float32
// [B, R, 4] (y1, x1, bin_h, bin_w) on the device; out: float32
// [B, R, P, P, C].  n_levels <= 5, P * s <= 64, any C: 8-channel lanes
// where C is a multiple of 8 and every level and the output are 16-byte
// aligned, else 2-channel lanes for an even C, else 1-channel lanes
// (vec.cuh lane_width).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for sizes it does not take.
extern "C" int roi_align_window_fwd(const void* const* feats,
                                    const int* level_hw, const int* win_hw,
                                    int n_levels, const int* meta,
                                    const float* geom, float* out, int batch,
                                    int n_rois, int c, int p, int s,
                                    int is_bf16, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || p * s > kMaxSamples ||
      p < 1 || s < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv;
  bool wide = aligned16(out);
  for (int l = 0; l < kMaxLevels; ++l) {
    const int k = l < n_levels ? l : 0;
    lv.feat[l] = feats[k];
    lv.h[l] = level_hw[2 * k];
    lv.w[l] = level_hw[2 * k + 1];
    lv.win_h[l] = win_hw[2 * k];
    lv.win_w[l] = win_hw[2 * k + 1];
    wide = wide && aligned16(feats[k]);
  }
  const int blocks = batch * n_rois;
  if (blocks == 0 || c == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = lane_width(c, wide);
  if (is_bf16 && vec == 8) {
    launch<__nv_bfloat16, 8>(blocks, c, p, s, st, lv, meta, geom, out,
                             n_rois);
  } else if (is_bf16 && vec == 2) {
    launch<__nv_bfloat16, 2>(blocks, c, p, s, st, lv, meta, geom, out,
                             n_rois);
  } else if (is_bf16) {
    launch<__nv_bfloat16, 1>(blocks, c, p, s, st, lv, meta, geom, out,
                             n_rois);
  } else if (vec == 8) {
    launch<float, 8>(blocks, c, p, s, st, lv, meta, geom, out, n_rois);
  } else if (vec == 2) {
    launch<float, 2>(blocks, c, p, s, st, lv, meta, geom, out, n_rois);
  } else {
    launch<float, 1>(blocks, c, p, s, st, lv, meta, geom, out, n_rois);
  }
  return static_cast<int>(cudaGetLastError());
}
