// The epilogue of a backbone convolution, for Hopper (sm_90a): K6.
//
//   out[r, c] = T(relu(float(y[r, c]) + bias[c] + float(res[r, c])))
//
// over a convolution's output y (contiguous NHWC: rows of C channels, as
// a channels_last tensor lies in memory), a float32 bias [C], an optional
// residual of y's shape and an optional ReLU, in that order of additions,
// each rounded on its own (__fadd_rn) and the result rounded once to T
// (bfloat16 or float32; round to nearest even, as ATen's cast).  out may
// be y (in place).
//
// Replaces no Pallas kernel: on the TPU, XLA fuses this epilogue into the
// convolution.  It replaces, on the card, the port's per-call broadcast
// passes around each convolution of the backbone when no gradient is
// taken: frozen BN's `x * scale` and `+ bias`, the ReLUs and the residual
// add (models/resnet_fpn.py; the scale is folded into the convolution's
// weights once, so what is left is this one pass).  Its plain version is
// ops/conv_epilogue.py::conv_epilogue_ref, the same additions in the same
// order, which K6 matches bit for bit.
//
// What bounds it on an H100: bytes.  It reads y (and the residual) once
// and writes out once, 2 bytes an element each in bfloat16, at 3.35 TB/s;
// it does one or two additions an element.  So each thread moves 16
// bytes an access (8 bfloat16 or 4 float32 channels: a lane), neighbouring
// threads on neighbouring addresses, and walks the tensor with a stride of
// the whole grid.  The grid is a multiple of C / lane-width lanes, so a
// thread's lane, and so its channels, is the same at every step: their
// bias is loaded into registers once.  A C that is not a multiple of the
// lane width, or a base pointer that is not 16-byte aligned, takes
// 1-channel lanes (any C); a lane's width changes how many channels a
// thread handles, never what a channel computes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2,048 threads: a full SM

// N elements at p, as float32, in one access where N * sizeof(T) is 16
// bytes, else one element.  Cache-streaming loads: each is read once.  A
// bfloat16 is the top half of its float32.
template <int N>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* f) {
  static_assert(N == 1 || N == 8, "one element or 16 bytes");
  if constexpr (N == 1) {
    const unsigned short u = __ldcs(reinterpret_cast<const unsigned short*>(p));
    f[0] = __uint_as_float(static_cast<uint32_t>(u) << 16);
  } else {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      f[2 * q] = __uint_as_float(w[q] << 16);
      f[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  }
}

template <int N>
__device__ __forceinline__ void load(const float* p, float* f) {
  static_assert(N == 1 || N == 4, "one element or 16 bytes");
  if constexpr (N == 1) {
    f[0] = __ldcs(p);
  } else {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// N float32 values stored at p as T, rounded to nearest even.
template <int N>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
  if constexpr (N == 1) {
    *reinterpret_cast<unsigned short*>(p) =
        static_cast<unsigned short>(bf16_bits(f[0]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = bf16_bits(f[2 * q]) | (bf16_bits(f[2 * q + 1]) << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int N>
__device__ __forceinline__ void store(float* p, const float* f) {
  if constexpr (N == 1) {
    p[0] = f[0];
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_kernel(const T* y, const float* __restrict__ bias,
                         const T* res, T* out, long long n_lanes, int lanes,
                         int relu) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // stride is a multiple of `lanes`: this thread's channels never change.
  const int c0 = static_cast<int>(t % lanes) * N;
  float b[N];
#pragma unroll
  for (int k = 0; k < N; ++k) b[k] = __ldg(bias + c0 + k);
  for (long long v = t; v < n_lanes; v += stride) {
    float s[N];
    load<N>(y + v * N, s);
#pragma unroll
    for (int k = 0; k < N; ++k) s[k] = __fadd_rn(s[k], b[k]);
    if (res != nullptr) {
      float r[N];
      load<N>(res + v * N, r);
#pragma unroll
      for (int k = 0; k < N; ++k) s[k] = __fadd_rn(s[k], r[k]);
    }
    if (relu) {
      // ATen's relu: max(s, 0) that keeps a NaN.
#pragma unroll
      for (int k = 0; k < N; ++k) s[k] = s[k] < 0.0f ? 0.0f : s[k];
    }
    store<N>(out + v * N, s);
  }
}

int gcd_int(int a, int b) {
  while (b != 0) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch(const void* y, const float* bias, const void* res, void* out,
           long long rows, int c, int relu, int sms, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
  const bool wide = c % kWide == 0 && aligned16(y) && aligned16(out) &&
                    (res == nullptr || aligned16(res));
  const int n = wide ? kWide : 1;
  const int lanes = c / n;
  const long long n_lanes = rows * lanes;
  // Enough blocks to fill every SM (fewer for a small tensor), rounded up
  // to a multiple of lanes / gcd_int(lanes, kThreads) blocks, so that the
  // grid's thread count is a multiple of `lanes`.
  long long blocks = (n_lanes + kThreads - 1) / kThreads;
  const long long full = static_cast<long long>(sms) * kBlocksPerSm;
  blocks = blocks < full ? blocks : full;
  const long long m = lanes / gcd_int(lanes, kThreads);
  blocks = (blocks + m - 1) / m * m;
  const unsigned int grid = static_cast<unsigned int>(blocks);
  const T* yt = static_cast<const T*>(y);
  const T* rt = static_cast<const T*>(res);
  T* ot = static_cast<T*>(out);
  if (wide) {
    conv_epilogue_kernel<T, kWide><<<grid, kThreads, 0, stream>>>(
        yt, bias, rt, ot, n_lanes, lanes, relu);
  } else {
    conv_epilogue_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        yt, bias, rt, ot, n_lanes, lanes, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The epilogue of `rows` rows of `c` channels on `stream`; `bf16` selects
// bfloat16 tensors (else float32).  res may be null (no residual); out may
// be y.  Returns the launch's CUDA error (0 on success).  rows, c >= 1;
// sms is the card's SM count.
extern "C" int conv_epilogue(const void* y, const float* bias,
                             const void* res, void* out, long long rows,
                             int c, int relu, int bf16, int sms,
                             cudaStream_t stream) {
  if (bf16) {
    return launch<__nv_bfloat16>(y, bias, res, out, rows, c, relu, sms,
                                 stream);
  }
  return launch<float>(y, bias, res, out, rows, c, relu, sms, stream);
}
