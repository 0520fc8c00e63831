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
// means (left 7x7) and the right 7x7 pool at sampling ratio 2.  A zero-area
// roi (valid bit from the raw rois) writes zeros.  The left side's
// arithmetic is K1's "f32" mode (csrc/stereo_roi_align.cu), bit for bit.
//
// The right 7x7 pool: a bin's two samples per axis have 4 candidate taps
// (floor and floor + 1 of each); their weights (1 - frac, frac) are summed
// per distinct row and column, as K1's kron modes sum their hats, and the
// pool is sum over those rows k and columns l of (Wy_k * Wx_l / 4) *
// cell[k, l]: 9 to 16 loads per bin where the mean of four samples takes
// 16 (samples under two cells apart share rows and columns).  That sums in
// another float32 order than the mean of four bilinear samples, so the
// right pool is held to K1 f32 and the plain version within a tolerance
// (1e-4 absolute on unit-scale features), not bit for bit.
//
// What bounds it on an H100: memory traffic, mostly the output (294 x C
// float32 rows per roi, 1.45 GB for 16 x 300 rois at C = 256) and the levels
// read once (0.67 GB of bf16 at batch 16): 0.631 ms at 3.35 TB/s.  The
// taps re-read the pyramid from L2 (about 0.8 MB of tap reads per roi,
// 3.85 GB per call), so the output must not evict it.  The first port (K1's
// design: two channels per thread, 4-byte tap loads, plain 8-byte stores)
// took 1.409 ms ("NVIDIA H100 80GB HBM3, 700.00 W") where K1 f32 took
// 1.106 ms for the same bytes.  The design now:
// - one block per (image, roi), the taps and the right pool's merged
//   weights computed once per block in shared memory (as K1);
// - each thread owns kVec = 8 neighbouring channels (vec.cuh, shared with
//   K1 and K3): one 16-byte load of bf16 per tap, 16-byte float4 stores;
// - the three outputs are stored with __stcs (cache-streaming), so they
//   pass through L2 without evicting the pyramid the taps re-read;
// - the block's threads are (C / kVec) x groups, about 256; group g takes
//   the 7x7 bins g, g + groups, ...: the left 2x2 samples and their mean,
//   and the right pool of each bin.
// kVec was chosen by timing it in chip_smoke.py (phase 6) at batch 16 x
// 300 rois, bf16 ("NVIDIA H100 80GB HBM3, 700.00 W"): 8 channels per
// thread 0.861 ms, 4 channels 0.922 ms, against 1.399 ms for the first
// port in the same call, a 0.631 ms bound and a 0.444 ms floor for the
// store side alone (the three outputs zeroed).  What still
// holds it above the bound: the taps' re-reads of the pyramid from L2
// (not measured without a profiler of the card's counters).  Staging the
// roi's tap rectangle in shared memory is not done: it reaches 48x64
// cells, 1.5 MB of bf16 at C = 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec.cuh"

namespace {

constexpr int kPk = 14;                      // samples per axis
constexpr int kP = 7;                        // pooled bins per axis
constexpr int kKpt = kPk * kPk;              // 196
constexpr int kBlockThreads = 256;
constexpr int kVec = 8;                      // channels per thread

struct Taps {
  int lo[kPk];
  int hi[kPk];
  float wlo[kPk];
  float whi[kPk];
};

// The right pool, one axis: per 7x7 bin the distinct tap cells of its two
// samples (absolute atlas rows or columns) and their summed weights.
struct BinTaps {
  int cell[kP][4];
  float w[kP][4];
  int n[kP];
};

// y first, then x, as K1 and the TPU kernel's two hat contractions.
template <typename T>
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

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    stereo_roi_align_atlas_kernel(
        const T* __restrict__ atlas_l, const T* __restrict__ atlas_r,
        int atlas_h, int atlas_w, const int* __restrict__ meta_l,
        const float* __restrict__ geom_l, const int* __restrict__ meta_r,
        const float* __restrict__ geom_r, float* __restrict__ out14l,
        float* __restrict__ out7l, float* __restrict__ out7r, int n_rois,
        int c) {
  const int roi = blockIdx.x;                // b * n_rois + r
  const int b = roi / n_rois;
  __shared__ Taps taps[2];                   // left [y, x]
  __shared__ BinTaps bins[2];                // right [y, x]
  __shared__ float w_right[kP * kP][16];     // (Wy_k * Wx_l) / 4
  __shared__ int s_valid[2];

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  // Left: 2 axes x 14 samples; right: 2 axes x 7 bins.
  for (int t = tid; t < 2 * kPk + 2 * kP; t += n_threads) {
    const bool right = t >= 2 * kPk;
    const int u = right ? t - 2 * kPk : t;
    const int n = right ? kP : kPk;
    const int axis = u / n, i = u % n;       // axis 0: y, 1: x
    const int* meta = (right ? meta_r : meta_l) + roi * 4;
    const float* geom = (right ? geom_r : geom_l) + roi * 6;
    const float bound = geom[4 + axis];      // clamp_y or clamp_x
    const int origin = meta[axis];           // y0_atlas or x0
    if (axis == 0 && i == 0) s_valid[right] = meta[2];
    int cells[4];
    float wts[4];
    for (int a = 0; a < (right ? 2 : 1); ++a) {
      const int k = right ? 2 * i + a : i;
      float pos = __fmaf_rn(static_cast<float>(k) + 0.5f, geom[2 + axis],
                            geom[axis]);
      pos = fminf(fmaxf(pos, 0.0f), bound);
      const float fl = floorf(pos);
      cells[2 * a] = origin + static_cast<int>(fl);
      cells[2 * a + 1] = origin + static_cast<int>(fminf(fl + 1.0f, bound));
      wts[2 * a] = 1.0f - (pos - fl);
      wts[2 * a + 1] = pos - fl;
    }
    if (!right) {
      Taps& tp = taps[axis];
      tp.lo[i] = cells[0];
      tp.hi[i] = cells[1];
      tp.wlo[i] = wts[0];
      tp.whi[i] = wts[1];
      continue;
    }
    // Merge the 4 candidates into distinct cells, in candidate order.
    BinTaps& bt = bins[axis];
    int m = 0;
    for (int k = 0; k < 4; ++k) {
      int at = m;
      for (int q = 0; q < m; ++q) {
        if (bt.cell[i][q] == cells[k]) at = q;
      }
      if (at == m) {
        bt.cell[i][m] = cells[k];
        bt.w[i][m++] = wts[k];
      } else {
        bt.w[i][at] = __fadd_rn(bt.w[i][at], wts[k]);
      }
    }
    bt.n[i] = m;
  }
  __syncthreads();
  for (int t = tid; t < kP * kP * 16; t += n_threads) {
    const int bin = t / 16, k = (t % 16) / 4, l = t % 4;
    const int py = bin / kP, px = bin % kP;
    w_right[bin][k * 4 + l] =
        k < bins[0].n[py] && l < bins[1].n[px]
            ? __fmul_rn(__fmul_rn(bins[0].w[py][k], bins[1].w[px][l]), 0.25f)
            : 0.0f;
  }
  __syncthreads();

  const int ch = threadIdx.x * kVec;
  if (ch >= c) return;                       // no barrier follows
  const size_t img_off = static_cast<size_t>(b) * atlas_h * atlas_w * c;
  const T* img_l = atlas_l + img_off;
  const T* img_r = atlas_r + img_off;
  float* o14 = out14l + static_cast<size_t>(roi) * kKpt * c + ch;
  float* o7l = out7l + static_cast<size_t>(roi) * kP * kP * c + ch;
  float* o7r = out7r + static_cast<size_t>(roi) * kP * kP * c + ch;
  const bool valid_l = s_valid[0] != 0, valid_r = s_valid[1] != 0;

  for (int bin = threadIdx.y; bin < kP * kP; bin += blockDim.y) {
    const int py = bin / kP, px = bin % kP;
    Vec<kVec> acc_l, acc_r;
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc_l.v[v] = acc_r.v[v] = 0.0f;
    for (int dy = 0; dy < 2; ++dy) {
      for (int dx = 0; dx < 2; ++dx) {
        const int i = 2 * py + dy, j = 2 * px + dx;
        Vec<kVec> s;
        if (valid_l) {
          s = sample(img_l, atlas_w, c, ch, taps[0], taps[1], i, j);
        } else {
#pragma unroll
          for (int v = 0; v < kVec; ++v) s.v[v] = 0.0f;
        }
        store_vec(o14 + static_cast<size_t>(i * kPk + j) * c, s);
#pragma unroll
        for (int v = 0; v < kVec; ++v) acc_l.v[v] += s.v[v];
      }
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc_l.v[v] *= 0.25f;
    store_vec(o7l + static_cast<size_t>(bin) * c, acc_l);
    if (valid_r) {
      const float* wk = w_right[bin];
      const int ny = bins[0].n[py], nx = bins[1].n[px];
      for (int k = 0; k < ny; ++k) {
        const T* row =
            img_r + static_cast<size_t>(bins[0].cell[py][k]) * atlas_w * c +
            ch;
        for (int l = 0; l < nx; ++l) {
          const Vec<kVec> x = load_vec<kVec>(
              row + static_cast<size_t>(bins[1].cell[px][l]) * c);
          const float wt = wk[k * 4 + l];
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            acc_r.v[v] = __fmaf_rn(wt, x.v[v], acc_r.v[v]);
          }
        }
      }
    }
    store_vec(o7r + static_cast<size_t>(bin) * c, acc_r);
  }
}

template <typename T>
int launch(int blocks, int c, cudaStream_t s, const void* atlas_l,
           const void* atlas_r, int atlas_h, int atlas_w, const int* meta_l,
           const float* geom_l, const int* meta_r, const float* geom_r,
           float* out14l, float* out7l, float* out7r, int n_rois) {
  const dim3 threads = lane_groups(c, kVec, kBlockThreads, kP * kP);
  stereo_roi_align_atlas_kernel<T><<<blocks, threads, 0, s>>>(
      static_cast<const T*>(atlas_l), static_cast<const T*>(atlas_r),
      atlas_h, atlas_w, meta_l, geom_l, meta_r, geom_r, out14l, out7l, out7r,
      n_rois, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes.  atlas_l / atlas_r: device pointers to the
// packed atlases [B, atlas_h, atlas_w, C]; meta_*: int32 [B, R, 4]
// (y0_atlas, x0, valid, 0) and geom_*: float32 [B, R, 6] (y1, x1, bin_h,
// bin_w, clamp_y, clamp_x) on the device; out14l: float32 [B, R, 14, 14, C],
// out7l / out7r: float32 [B, R, 7, 7, C]; C a multiple of 8, at most 2048.
// Returns a CUDA error code (0 on success).
extern "C" int stereo_roi_align_atlas_fwd(
    const void* atlas_l, const void* atlas_r, const int* meta_l,
    const float* geom_l, const int* meta_r, const float* geom_r,
    float* out14l, float* out7l, float* out7r, int batch, int n_rois,
    int atlas_h, int atlas_w, int c, int is_bf16, void* stream) {
  const int blocks = batch * n_rois;
  if (blocks == 0 || c == 0) return static_cast<int>(cudaSuccess);
  if (c % kVec || c / kVec > kBlockThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(blocks, c, s, atlas_l, atlas_r, atlas_h,
                                 atlas_w, meta_l, geom_l, meta_r, geom_r,
                                 out14l, out7l, out7r, n_rois);
  }
  return launch<float>(blocks, c, s, atlas_l, atlas_r, atlas_h, atlas_w,
                       meta_l, geom_l, meta_r, geom_r, out14l, out7l, out7r,
                       n_rois);
}
