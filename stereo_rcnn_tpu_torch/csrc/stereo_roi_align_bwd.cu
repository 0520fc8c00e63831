// Backward of the fused stereo RoIAlign for Hopper (sm_90a).
//
// Replaces stereo_rcnn_tpu/ops/roi_align_pallas.py::_stereo_bwd_kernel (the
// custom-VJP backward of stereo_roi_align_batched_packed; its transpose is
// _grad_window).  Input: the cotangent of the forward's packed block, one
// 294 x C float32 block per (image, roi) in the forward's row layout
// (14x14 left samples, left 7x7 pool, right 7x7 pool).  Output: float32
// gradients of the four left and four right levels, zero-filled by the
// caller.  Per sample of the 14x14 grid the cotangent is
//   left:  d14[y, x] + d7l[y / 2, x / 2] / 4
//   right:             d7r[y / 2, x / 2] / 4
// (each 7x7 bin is the mean of its 2x2 samples), and a roi whose valid bit
// is 0 (zero-area) contributes nothing.  Each sample's cotangent goes back
// through the forward's four bilinear taps: cells floor(p) and
// min(floor(p) + 1, win - 1) of the roi's clamped window, weights
// (1 - fy)(1 - fx), (1 - fy) fx, fy (1 - fx), fy fx.  For a sample position
// p in [0, win - 1] those are exactly the TPU kernel's hat weights
// max(0, 1 - |cell - p|), also at p = win - 1, where fy = 0.  The level,
// window and geometry come from the same metadata the forward reads
// (ops/stereo_roi_align.py::roi_window_meta), recomputed from the rois.
//
// What bounds it on an H100: memory traffic.  One training step at batch 8
// x 128 rois x C = 256 reads a 308 MB cotangent and writes 668 MB of level
// gradients (2 sides x 8 images x 40,800 cells x 1 KB), about 0.29 ms at
// 3.35 TB/s.  Rois overlap, so different blocks add into the same cells:
// the TPU kernel's sequential read-modify-write has no race there, but
// blocks on Hopper run in parallel, so every tap is a float32 atomicAdd
// into device memory (411 M of them per step), resolved in the 50 MB L2.
// The order of those adds varies from run to run, so the sums differ in
// the last bits between runs.
// The design is the simple one: one block per (image, roi, side); the 2 x
// 14 taps of the roi's axes are computed once into shared memory; each
// thread owns one channel, so a warp's 32 atomics of one tap hit 128
// contiguous bytes of an NHWC row.  No shared-memory window tiles or
// sorted deterministic reduction yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 4;
constexpr int kPk = 14;                      // samples per axis
constexpr int kP = 7;                        // pooled bins per axis
constexpr int kKpt = kPk * kPk;              // 196
constexpr int kRows = kKpt + 2 * kP * kP;    // 294

struct Grads {
  float* left[kLevels];
  float* right[kLevels];
  int h[kLevels];        // level height
  int w[kLevels];        // level width
  int win_h[kLevels];    // sampling window, clamped to the level
  int win_w[kLevels];
};

// Bilinear taps of one axis: absolute level cells and weights.
struct Taps {
  int lo[kPk];
  int hi[kPk];
  float wlo[kPk];
  float whi[kPk];
};

__global__ void stereo_roi_align_bwd_kernel(Grads grads,
                                            const int* __restrict__ meta_l,
                                            const float* __restrict__ geom_l,
                                            const int* __restrict__ meta_r,
                                            const float* __restrict__ geom_r,
                                            const float* __restrict__ g,
                                            int n_rois, int c) {
  const int roi = blockIdx.x;                // b * n_rois + r
  const int side = blockIdx.y;               // 0: left, 1: right
  const int b = roi / n_rois;
  const int* meta = (side == 0 ? meta_l : meta_r) + roi * 4;
  const float* geom = (side == 0 ? geom_l : geom_r) + roi * 4;
  if (meta[3] == 0) return;                  // the whole block: no sync yet
  const int level = meta[0];

  __shared__ Taps taps[2];                   // [y, x]
  for (int t = threadIdx.x; t < 2 * kPk; t += blockDim.x) {
    const int axis = t / kPk;                // 0: y, 1: x
    const int i = t % kPk;
    const int win = axis == 0 ? grads.win_h[level] : grads.win_w[level];
    const int origin = meta[1 + axis];
    float pos = geom[axis] + (static_cast<float>(i) + 0.5f) * geom[2 + axis];
    pos = fminf(fmaxf(pos, 0.0f), static_cast<float>(win - 1));
    const float fl = floorf(pos);
    const int lo = static_cast<int>(fl);
    Taps& tp = taps[axis];
    tp.lo[i] = origin + lo;
    tp.hi[i] = origin + min(lo + 1, win - 1);
    tp.whi[i] = pos - fl;
    tp.wlo[i] = 1.0f - (pos - fl);
  }
  __syncthreads();

  const Taps& ty = taps[0];
  const Taps& tx = taps[1];
  const int w = grads.w[level];
  float* dst = (side == 0 ? grads.left[level] : grads.right[level]) +
               static_cast<size_t>(b) * grads.h[level] * w * c;
  const float* blk = g + static_cast<size_t>(roi) * kRows * c;
  const float* pool = blk + static_cast<size_t>(kKpt + side * kP * kP) * c;

  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    for (int i = 0; i < kPk; ++i) {
      const size_t r0 = static_cast<size_t>(ty.lo[i]) * w;
      const size_t r1 = static_cast<size_t>(ty.hi[i]) * w;
      const float wyl = ty.wlo[i], wyh = ty.whi[i];
      for (int j = 0; j < kPk; ++j) {
        float cot =
            pool[static_cast<size_t>((i / 2) * kP + j / 2) * c + ch] * 0.25f;
        if (side == 0) cot += blk[static_cast<size_t>(i * kPk + j) * c + ch];
        const float wxl = tx.wlo[j], wxh = tx.whi[j];
        const int x0 = tx.lo[j], x1 = tx.hi[j];
        atomicAdd(dst + (r0 + x0) * c + ch, wyl * wxl * cot);
        atomicAdd(dst + (r0 + x1) * c + ch, wyl * wxh * cot);
        atomicAdd(dst + (r1 + x0) * c + ch, wyh * wxl * cot);
        atomicAdd(dst + (r1 + x1) * c + ch, wyh * wxh * cot);
      }
    }
  }
}

}  // namespace

// C entry, bound with ctypes.  grad_l / grad_r: host arrays of 4 device
// pointers to zero-filled float32 NHWC level gradients [B, h, w, C];
// level_hw / win_hw: host arrays (h0, w0, h1, w1, ...); meta_*: int32
// [B, R, 4] (level, y0, x0, valid) and geom_*: float32 [B, R, 4] (y1, x1,
// bin_h, bin_w) on the device; g: float32 [B, R, 294, C].  Returns
// cudaGetLastError().
extern "C" int stereo_roi_align_bwd(float* const* grad_l,
                                    float* const* grad_r,
                                    const int* level_hw, const int* win_hw,
                                    const int* meta_l, const float* geom_l,
                                    const int* meta_r, const float* geom_r,
                                    const float* g, int batch, int n_rois,
                                    int c, void* stream) {
  Grads grads;
  for (int l = 0; l < kLevels; ++l) {
    grads.left[l] = grad_l[l];
    grads.right[l] = grad_r[l];
    grads.h[l] = level_hw[2 * l];
    grads.w[l] = level_hw[2 * l + 1];
    grads.win_h[l] = win_hw[2 * l];
    grads.win_w[l] = win_hw[2 * l + 1];
  }
  if (batch * n_rois == 0 || c == 0) return static_cast<int>(cudaSuccess);
  int threads = ((c + 31) / 32) * 32;
  threads = threads > 256 ? 256 : threads;
  const dim3 blocks(batch * n_rois, 2);
  stereo_roi_align_bwd_kernel<<<blocks, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      grads, meta_l, geom_l, meta_r, geom_r, g, n_rois, c);
  return static_cast<int>(cudaGetLastError());
}
