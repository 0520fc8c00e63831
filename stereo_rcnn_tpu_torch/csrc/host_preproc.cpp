// Host-side image preprocessing for the TPU input pipeline.
//
// Role parallel to the reference's native layer (lib/model/csrc/): where the
// reference spends its C++/CUDA budget on device kernels (NMS/RoIAlign —
// which on TPU become Pallas/XLA ops), the TPU framework's native budget
// goes to keeping the chips FED: decode-adjacent preprocessing (bilinear
// resize + BGR mean subtraction + letterbox padding) runs multi-threaded on
// the host CPU so the input pipeline never throttles the accelerator
// (SURVEY.md §7 step 7: "host decode/resize/normalize pipeline").
//
// Built as a plain shared library, loaded via ctypes (no pybind11 in this
// environment). Exposes a C ABI.

#include <cstdint>
#include <cstring>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Bilinearly resize an HxWx3 uint8 image by `scale`, subtract per-channel
// means, and write into a pre-zeroed dst of shape [dst_h, dst_w, 3] float32
// (top-left anchored letterbox; the caller computes scale so the scaled
// image fits).  src is assumed BGR (KITTI/cv2 order; means likewise).
void resize_subtract_pad(const uint8_t* src, int src_h, int src_w,
                         float* dst, int dst_h, int dst_w,
                         float scale, const float* means) {
    const int out_h = std::min(dst_h, (int)(src_h * scale + 0.5f));
    const int out_w = std::min(dst_w, (int)(src_w * scale + 0.5f));
    const float inv = 1.0f / scale;

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int y = 0; y < out_h; ++y) {
        const float sy = (y + 0.5f) * inv - 0.5f;
        const int y0 = std::max(0, std::min(src_h - 1, (int)sy));
        const int y1 = std::min(src_h - 1, y0 + 1);
        const float fy = std::max(0.0f, std::min(1.0f, sy - y0));
        float* drow = dst + (size_t)y * dst_w * 3;
        for (int x = 0; x < out_w; ++x) {
            const float sx = (x + 0.5f) * inv - 0.5f;
            const int x0 = std::max(0, std::min(src_w - 1, (int)sx));
            const int x1 = std::min(src_w - 1, x0 + 1);
            const float fx = std::max(0.0f, std::min(1.0f, sx - x0));
            const uint8_t* p00 = src + ((size_t)y0 * src_w + x0) * 3;
            const uint8_t* p01 = src + ((size_t)y0 * src_w + x1) * 3;
            const uint8_t* p10 = src + ((size_t)y1 * src_w + x0) * 3;
            const uint8_t* p11 = src + ((size_t)y1 * src_w + x1) * 3;
            for (int c = 0; c < 3; ++c) {
                const float top = p00[c] + fx * (p01[c] - p00[c]);
                const float bot = p10[c] + fx * (p11[c] - p10[c]);
                drow[x * 3 + c] = top + fy * (bot - top) - means[c];
            }
        }
    }
}

// Batched variant: processes `n` images with identical geometry in one call
// (one thread pool launch for the whole batch).
void resize_subtract_pad_batch(const uint8_t* const* srcs, int src_h,
                               int src_w, float* dst, int n, int dst_h,
                               int dst_w, float scale, const float* means) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int i = 0; i < n; ++i) {
        // Serial inner call: parallelism is over batch elements here.
        const uint8_t* src = srcs[i];
        float* d = dst + (size_t)i * dst_h * dst_w * 3;
        const int out_h = std::min(dst_h, (int)(src_h * scale + 0.5f));
        const int out_w = std::min(dst_w, (int)(src_w * scale + 0.5f));
        const float inv = 1.0f / scale;
        for (int y = 0; y < out_h; ++y) {
            const float sy = (y + 0.5f) * inv - 0.5f;
            const int y0 = std::max(0, std::min(src_h - 1, (int)sy));
            const int y1 = std::min(src_h - 1, y0 + 1);
            const float fy = std::max(0.0f, std::min(1.0f, sy - y0));
            float* drow = d + (size_t)y * dst_w * 3;
            for (int x = 0; x < out_w; ++x) {
                const float sx = (x + 0.5f) * inv - 0.5f;
                const int x0 = std::max(0, std::min(src_w - 1, (int)sx));
                const int x1 = std::min(src_w - 1, x0 + 1);
                const float fx = std::max(0.0f, std::min(1.0f, sx - x0));
                const uint8_t* p00 = src + ((size_t)y0 * src_w + x0) * 3;
                const uint8_t* p01 = src + ((size_t)y0 * src_w + x1) * 3;
                const uint8_t* p10 = src + ((size_t)y1 * src_w + x0) * 3;
                const uint8_t* p11 = src + ((size_t)y1 * src_w + x1) * 3;
                for (int c = 0; c < 3; ++c) {
                    const float top = p00[c] + fx * (p01[c] - p00[c]);
                    const float bot = p10[c] + fx * (p11[c] - p10[c]);
                    drow[x * 3 + c] = top + fy * (bot - top) - means[c];
                }
            }
        }
    }
}

}  // extern "C"
