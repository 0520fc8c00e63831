// Fused stereo RoIAlign over a row-packed level atlas, for Hopper (sm_90a).
//
// Replaces stereo_rcnn_tpu/ops/roi_align_pallas.py::_stereo_kernel_atlas
// (entry stereo_roi_align_pallas_atlas).  The levels of each side are packed
// by rows into one atlas per image, [sum H_l + 48, W_max, C], widths
// zero-padded to the widest level (ops/stereo_roi_align.py::pack_atlas, a
// torch op outside the kernel, as the TPU's is outside its pallas_call).
// For one (image, roi) the kernel takes 14x14 samples per side at the bin
// centres y1 + (i + 0.5) * bin, clamped to [0, clamp] with the roi's own
// clamp bounds (its level window's last row and column, from
// ops/stereo_roi_align.py::atlas_meta), and reads the taps floor(p) and
// min(floor(p) + 1, clamp) at atlas row y0_atlas + row (y0_atlas = the
// window origin plus the level's row offset) and column x0 + col.  So a tap
// never leaves the roi's level window: the cells past the clamp, which the
// TPU kernel's 48x64 window covers with exactly zero hat weight, are never
// read.  It writes three float32 outputs: the left 14x14 samples, their 2x2
// means (left 7x7) and the 2x2 means of the right samples (right 7x7; no
// folding of the mean into the weights).  A zero-area roi (valid bit from
// the raw rois) writes zeros.  The arithmetic is K1's "f32" mode
// (csrc/stereo_roi_align.cu); only the addressing differs.
//
// What bounds it on an H100: memory traffic, mostly the output (294 x C
// float32 rows per roi, 1.45 GB for 16 x 300 rois at C = 256) and the two
// atlases read once (0.67 GB of bf16 at batch 16).  Design as K1's: one
// block per (image, roi), threads own channel pairs, taps once per block in
// shared memory, 2x2 means in registers.  One launch covers all images.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPk = 14;                      // samples per axis
constexpr int kP = 7;                        // pooled bins per axis
constexpr int kKpt = kPk * kPk;              // 196

struct Taps {
  int lo[kPk];
  int hi[kPk];
  float wlo[kPk];
  float whi[kPk];
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

// y first, then x, as K1 and the TPU kernel's two hat contractions.
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

template <typename T>
__global__ void stereo_roi_align_atlas_kernel(
    const T* __restrict__ atlas_l, const T* __restrict__ atlas_r,
    int atlas_h, int atlas_w, const int* __restrict__ meta_l,
    const float* __restrict__ geom_l, const int* __restrict__ meta_r,
    const float* __restrict__ geom_r, float* __restrict__ out14l,
    float* __restrict__ out7l, float* __restrict__ out7r, int n_rois, int c) {
  const int roi = blockIdx.x;                // b * n_rois + r
  const int b = roi / n_rois;
  __shared__ Taps taps[2][2];                // [side][y, x]
  __shared__ int s_valid[2];

  for (int t = threadIdx.x; t < 2 * 2 * kPk; t += blockDim.x) {
    const int side = t / (2 * kPk);
    const int axis = (t / kPk) % 2;          // 0: y, 1: x
    const int i = t % kPk;
    const int* meta = (side == 0 ? meta_l : meta_r) + roi * 4;
    const float* geom = (side == 0 ? geom_l : geom_r) + roi * 6;
    const float bound = geom[4 + axis];      // clamp_y or clamp_x
    const int origin = meta[axis];           // y0_atlas or x0
    float pos = __fmaf_rn(static_cast<float>(i) + 0.5f, geom[2 + axis],
                          geom[axis]);
    pos = fminf(fmaxf(pos, 0.0f), bound);
    const float fl = floorf(pos);
    Taps& tp = taps[side][axis];
    tp.lo[i] = origin + static_cast<int>(fl);
    tp.hi[i] = origin + static_cast<int>(fminf(fl + 1.0f, bound));
    tp.whi[i] = pos - fl;
    tp.wlo[i] = 1.0f - (pos - fl);
    if (axis == 0 && i == 0) s_valid[side] = meta[2];
  }
  __syncthreads();

  const size_t img_off = static_cast<size_t>(b) * atlas_h * atlas_w * c;
  const T* img_l = atlas_l + img_off;
  const T* img_r = atlas_r + img_off;
  float* o14 = out14l + static_cast<size_t>(roi) * kKpt * c;
  float* o7l = out7l + static_cast<size_t>(roi) * kP * kP * c;
  float* o7r = out7r + static_cast<size_t>(roi) * kP * kP * c;
  const float2 zero = make_float2(0.0f, 0.0f);

  for (int ch = 2 * threadIdx.x; ch < c; ch += 2 * blockDim.x) {
    for (int py = 0; py < kP; ++py) {
      for (int px = 0; px < kP; ++px) {
        float2 acc_l = zero, acc_r = zero;
        for (int dy = 0; dy < 2; ++dy) {
          for (int dx = 0; dx < 2; ++dx) {
            const int i = 2 * py + dy, j = 2 * px + dx;
            float2 s = zero;
            if (s_valid[0]) {
              s = sample(img_l, atlas_w, c, ch, taps[0][0], taps[0][1], i, j);
            }
            store2(o14 + static_cast<size_t>(i * kPk + j) * c + ch, s);
            acc_l.x += s.x;
            acc_l.y += s.y;
            if (s_valid[1]) {
              const float2 r = sample(img_r, atlas_w, c, ch, taps[1][0],
                                      taps[1][1], i, j);
              acc_r.x += r.x;
              acc_r.y += r.y;
            }
          }
        }
        const size_t row = static_cast<size_t>(py * kP + px) * c + ch;
        store2(o7l + row, make_float2(acc_l.x * 0.25f, acc_l.y * 0.25f));
        store2(o7r + row, make_float2(acc_r.x * 0.25f, acc_r.y * 0.25f));
      }
    }
  }
}

}  // namespace

// C entry, bound with ctypes.  atlas_l / atlas_r: device pointers to the
// packed atlases [B, atlas_h, atlas_w, C]; meta_*: int32 [B, R, 4]
// (y0_atlas, x0, valid, 0) and geom_*: float32 [B, R, 6] (y1, x1, bin_h,
// bin_w, clamp_y, clamp_x) on the device; out14l: float32 [B, R, 14, 14, C],
// out7l / out7r: float32 [B, R, 7, 7, C].  C must be even.  Returns
// cudaGetLastError().
extern "C" int stereo_roi_align_atlas_fwd(
    const void* atlas_l, const void* atlas_r, const int* meta_l,
    const float* geom_l, const int* meta_r, const float* geom_r,
    float* out14l, float* out7l, float* out7r, int batch, int n_rois,
    int atlas_h, int atlas_w, int c, int is_bf16, void* stream) {
  const int blocks = batch * n_rois;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  int threads = ((c / 2 + 31) / 32) * 32;
  threads = threads > 128 ? 128 : threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    stereo_roi_align_atlas_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(atlas_l),
        static_cast<const __nv_bfloat16*>(atlas_r), atlas_h, atlas_w, meta_l,
        geom_l, meta_r, geom_r, out14l, out7l, out7r, n_rois, c);
  } else {
    stereo_roi_align_atlas_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(atlas_l), static_cast<const float*>(atlas_r),
        atlas_h, atlas_w, meta_l, geom_l, meta_r, geom_r, out14l, out7l,
        out7r, n_rois, c);
  }
  return static_cast<int>(cudaGetLastError());
}
