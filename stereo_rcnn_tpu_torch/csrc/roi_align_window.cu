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
// y first, then x.  Any P and s with P * s <= 64, up to 5 levels, C even.
//
// What bounds it on an H100: memory traffic.  It writes P * P * C float32
// per roi (50 KB at P = 7, C = 256) and reads the levels of one side; the
// taps of a roi touch at most (P * s + 1)^2 distinct cells, and the rois of
// one image overlap, so the reads should mostly hit in the 50 MB L2.
// Design as K1's (csrc/stereo_roi_align.cu): one block per (image, roi);
// each thread owns two neighbouring channels; the taps are computed once per
// block into shared memory.  No wgmma, TMA or tuning yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kMaxSamples = 64;              // P * s per axis

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

__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

template <typename T>
__global__ void roi_align_window_kernel(Levels lv,
                                        const int* __restrict__ meta,
                                        const float* __restrict__ geom,
                                        float* __restrict__ out, int n_rois,
                                        int c, int p, int s) {
  const int roi = blockIdx.x;                // b * n_rois + r
  const int b = roi / n_rois;
  const int n = p * s;
  __shared__ Taps taps[2];                   // [y, x]

  const int level = meta[roi * 4];
  for (int t = threadIdx.x; t < 2 * n; t += blockDim.x) {
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

  for (int ch = 2 * threadIdx.x; ch < c; ch += 2 * blockDim.x) {
    for (int py = 0; py < p; ++py) {
      for (int px = 0; px < p; ++px) {
        float ax = 0.0f, ay = 0.0f;
        if (valid) {
          for (int dy = 0; dy < s; ++dy) {
            const int i = py * s + dy;
            const size_t r0 = static_cast<size_t>(ty.lo[i]) * w;
            const size_t r1 = static_cast<size_t>(ty.hi[i]) * w;
            const float wyl = ty.wlo[i], wyh = ty.whi[i];
            for (int dx = 0; dx < s; ++dx) {
              const int j = px * s + dx;
              const int x0 = tx.lo[j], x1 = tx.hi[j];
              const float2 v00 = load2(img + (r0 + x0) * c + ch);
              const float2 v01 = load2(img + (r0 + x1) * c + ch);
              const float2 v10 = load2(img + (r1 + x0) * c + ch);
              const float2 v11 = load2(img + (r1 + x1) * c + ch);
              // y first, then x: the order of the TPU kernel's two hat
              // contractions.
              const float wxl = tx.wlo[j], wxh = tx.whi[j];
              ax += wxl * (wyl * v00.x + wyh * v10.x) +
                    wxh * (wyl * v01.x + wyh * v11.x);
              ay += wxl * (wyl * v00.y + wyh * v10.y) +
                    wxh * (wyl * v01.y + wyh * v11.y);
            }
          }
          ax = __fdiv_rn(ax, count);
          ay = __fdiv_rn(ay, count);
        }
        *reinterpret_cast<float2*>(
            blk + static_cast<size_t>(py * p + px) * c + ch) =
            make_float2(ax, ay);
      }
    }
  }
}

}  // namespace

// C entry, bound with ctypes.  feats: host array of n_levels device pointers
// to NHWC levels [B, h, w, C]; level_hw / win_hw: host arrays (h0, w0, h1,
// w1, ...); meta: int32 [B, R, 4] (level, y0, x0, valid) and geom: float32
// [B, R, 4] (y1, x1, bin_h, bin_w) on the device; out: float32
// [B, R, P, P, C].  n_levels <= 5, P * s <= 64, C even.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for sizes it does not take.
extern "C" int roi_align_window_fwd(const void* const* feats,
                                    const int* level_hw, const int* win_hw,
                                    int n_levels, const int* meta,
                                    const float* geom, float* out, int batch,
                                    int n_rois, int c, int p, int s,
                                    int is_bf16, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || p * s > kMaxSamples ||
      p < 1 || s < 1 || c % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv;
  for (int l = 0; l < kMaxLevels; ++l) {
    const int k = l < n_levels ? l : 0;
    lv.feat[l] = feats[k];
    lv.h[l] = level_hw[2 * k];
    lv.w[l] = level_hw[2 * k + 1];
    lv.win_h[l] = win_hw[2 * k];
    lv.win_w[l] = win_hw[2 * k + 1];
  }
  const int blocks = batch * n_rois;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  int threads = ((c / 2 + 31) / 32) * 32;
  threads = threads > 128 ? 128 : threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    roi_align_window_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        lv, meta, geom, out, n_rois, c, p, s);
  } else {
    roi_align_window_kernel<float><<<blocks, threads, 0, st>>>(
        lv, meta, geom, out, n_rois, c, p, s);
  }
  return static_cast<int>(cudaGetLastError());
}
