// Channel vectors shared by the RoIAlign kernels of this directory
// (stereo_roi_align.cu, roi_align_window.cu, stereo_roi_align_atlas.cu).
//
// A lane owns N neighbouring channels of an NHWC row.  A tap loads them in
// one access where it can: N = 8 bf16 channels are one 16-byte load, N = 2
// one 4-byte load; float32 channels are N / 4 float4 loads (N = 2: one
// float2).  Every load goes through the read-only path (__ldg).  Outputs
// are float32, stored with __stcs (cache-streaming): a kernel writes each
// output row once, so the stores pass through L2 without evicting the
// feature levels that the taps read again and again.  A bf16 value
// converts to float32 exactly, so the width of a lane changes how many
// channels a thread handles, never what a channel computes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int N>
struct Vec {
  static_assert(N == 2 || N % 4 == 0, "2 channels or a multiple of 4");
  float v[N];
};

template <int N>
__device__ __forceinline__ Vec<N> zero_vec() {
  Vec<N> r;
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = 0.0f;
  return r;
}

// Two bf16 (the first in the low half) to float32: a bf16 is the top half
// of its float32.
__device__ __forceinline__ void unpack2(uint32_t bits, float* v) {
  v[0] = __uint_as_float(bits << 16);
  v[1] = __uint_as_float(bits & 0xffff0000u);
}

template <int N>
__device__ __forceinline__ Vec<N> load_vec(const __nv_bfloat16* p) {
  static_assert(N == 2 || N == 8, "one 4-byte or one 16-byte load");
  Vec<N> r;
  if constexpr (N == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    unpack2(u.x, r.v);
    unpack2(u.y, r.v + 2);
    unpack2(u.z, r.v + 4);
    unpack2(u.w, r.v + 6);
  } else {
    unpack2(__ldg(reinterpret_cast<const unsigned int*>(p)), r.v);
  }
  return r;
}

template <int N>
__device__ __forceinline__ Vec<N> load_vec(const float* p) {
  Vec<N> r;
  if constexpr (N == 2) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(p));
    r.v[0] = f.x;
    r.v[1] = f.y;
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p) + q);
      r.v[4 * q] = f.x;
      r.v[4 * q + 1] = f.y;
      r.v[4 * q + 2] = f.z;
      r.v[4 * q + 3] = f.w;
    }
  }
  return r;
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const Vec<N>& r) {
  if constexpr (N == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(r.v[0], r.v[1]));
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      __stcs(reinterpret_cast<float4*>(p) + q,
             make_float4(r.v[4 * q], r.v[4 * q + 1], r.v[4 * q + 2],
                         r.v[4 * q + 3]));
    }
  }
}

// The block of a kernel whose lanes own `vec` channels each: (C / vec)
// lanes rounded up to whole warps, at most `threads`, times as many groups
// of lanes as fill `threads`, at most `units` (the work items the groups
// take in turn).  C > 0.
inline dim3 lane_groups(int c, int vec, int threads, int units) {
  int lanes = ((c / vec + 31) / 32) * 32;
  lanes = lanes > threads ? threads : lanes;
  int groups = threads / lanes;
  groups = groups > units ? units : groups;
  return dim3(lanes, groups);
}

// Whether a lane of 8 channels may read and write at these addresses:
// every 16-byte access of an 8-channel lane starts at a multiple of 16
// bytes when the channel count is a multiple of 8 and the base pointers
// are 16-byte aligned.
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace
