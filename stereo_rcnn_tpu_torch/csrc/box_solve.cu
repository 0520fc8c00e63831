// The damped Gauss-Newton 3D box solve, one thread per detection, for
// Hopper (sm_90a): K5.
//
// Replaces no Pallas kernel: the JAX package's solve,
// stereo_rcnn_tpu/solve/box_estimator.py::solve_batch, is XLA-compiled jnp.
// It replaces, on the card, the port's plain loop
// (solve/box_estimator.py::solve_batch_ref), whose iterations are ~270
// small ATen launches each: ~8,000 launches a solve, whose issue on the
// host, not the card, set the pipeline's time.  Here the whole solve is one
// launch.
//
// Per detection it fits the state (x, y, z, theta) to the 7 observations
// [ul, vt, ur, vb, ul', ur', up]: the closed-form init from the box-centre
// disparity (z replaced by fixed_z where given, which also freezes z); then
// `iters` damped Gauss-Newton steps, each projecting the box's 8 corners
// into both images with the written-out Jacobian (the depth floor at 1e-3
// gates dz: 1 above, 1/2 at a tie, 0 below), taking min/max over the corners
// with the derivative shared evenly among corners that tie exactly, the
// keypoint column by kpt_idx, weighting rows by obs_weights, solving
// (JtJ + damping (1 + diag) + identity on a frozen z) delta = Jtr by an
// unrolled Cholesky (pivots clamped to 1e-12), clipping the step to
// (3, 1.5, 5, 0.5) and flooring z at 0.5; last, the RMS of the weighted
// residuals.  A kpt_idx outside 0..7 gives NaN (the plain loop's gather
// raises).
//
// The arithmetic is the plain loop's, in float32, operation for
// operation, since each of its ATen launches rounds once: every product,
// sum, quotient and square root is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn), so that nvcc does not contract a * b + c
// into one fused multiply-add; sinf, cosf and atan2f are libdevice's, as
// ATen's.  The plain loop's sums over the 7 observations are taken in the
// orders that cuBLAS and ATen take them on the card (found by matching their
// bits on an H100 for N from 1 to 1024): JtJ one chain of fused
// multiply-adds in observation order, Jtr two (observations 0-3 and 4-6)
// then their sum, and the mean of the squared residuals four interleaved
// partial sums combined pairwise, times 1/7.
//
// What bounds it on an H100: neither bytes (~100 B a detection in and out)
// nor FLOPs (~15 MFLOP at N = 512) but the serial chain of `iters`
// dependent iterations of one detection, each a chain of divisions and
// square roots (projection, Cholesky) that a thread cannot split.  So the
// block is one warp (kBlock = 32): N = 512 detections spread over 16 SMs, one
// warp each, and no warp waits behind another for its SM's schedulers; a
// larger block would put more warps on fewer SMs and shorten nothing.  The
// state, the 8 corners, the 7 weighted residuals, the 10 distinct entries of
// JtJ and the 4 of Jtr stay in registers: nothing goes to device memory
// between iterations.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 32;
constexpr int kObs = 7;
constexpr int kCorners = 8;
constexpr float kProjZMin = 1e-3f;   // geometry/projection.py::project
constexpr float kStateZMin = 0.5f;   // z floor after each step
constexpr float kPivotMin = 1e-12f;  // Cholesky pivot clamp
// Trust region: the per-iteration bound on the step (m, m, m, rad).
__constant__ float kMaxStep[4] = {3.0f, 1.5f, 5.0f, 0.5f};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float quo(float a, float b) {
  return __fdiv_rn(a, b);
}
// ATen's clamps: a NaN passes through.
__device__ __forceinline__ float at_least(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float at_most(float x, float hi) {
  return x > hi ? hi : x;
}

// What one detection's projection needs besides its state.
struct Det {
  float h, w, l;          // dims_hwl
  float f, cu, cv, tx2;   // calibration
  float off_r;            // tx2 - baseline: the right camera's x offset
  int k;                  // keypoint corner
};

// The running min (kLargest false) or max over the corners, in corner order,
// and the sum of the derivatives of the corners that tie it exactly.
template <bool kLargest>
struct Extreme {
  float val, d[4], count;
  bool nan;

  __device__ __forceinline__ void first(float v, const float dv[4]) {
    val = v;
    count = 1.0f;
    nan = isnan(v);
#pragma unroll
    for (int q = 0; q < 4; ++q) d[q] = dv[q];
  }
  __device__ __forceinline__ void take(float v, const float dv[4]) {
    const bool any_nan = nan || isnan(v);
    if (kLargest ? v > val : v < val) {
      first(v, dv);
    } else if (v == val) {
      count += 1.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) d[q] = add(d[q], dv[q]);
    }
    nan = any_nan;
  }
  // amax/amin and the tie-shared derivative; a NaN corner makes both NaN.
  __device__ __forceinline__ void result(float& v, float dv[4]) const {
    v = nan ? NAN : val;
#pragma unroll
    for (int q = 0; q < 4; ++q) dv[q] = nan ? NAN : quo(d[q], count);
  }
};

// Predicted observations pred [7] at state s and their Jacobian jac [7][4]:
// solve/box_estimator.py::_observe_jac, op for op.
__device__ __forceinline__ void observe(const float s[4], const Det& g,
                                        float pred[kObs],
                                        float jac[kObs][4]) {
  const float c = cosf(s[3]);
  const float sn = sinf(s[3]);
  Extreme<false> ul_min, vl_min, ur_min;
  Extreme<true> ul_max, vl_max, ur_max;
  float kpt_u = NAN;
  float kpt_d[4] = {NAN, NAN, NAN, NAN};
#pragma unroll
  for (int i = 0; i < kCorners; ++i) {
    const int b = i & 3;
    // The template scaled: geometry/projection.py's _CORNERS_X, _Y, _Z.
    const float xo = mul(b < 2 ? 0.5f : -0.5f, g.l);
    const float yo = mul(i < 4 ? 0.0f : -1.0f, g.h);
    const float zo = mul(b == 0 || b == 3 ? 0.5f : -0.5f, g.w);
    const float x = add(add(s[0], mul(c, xo)), mul(sn, zo));
    const float y = add(s[1], yo);
    const float z = add(sub(s[2], mul(sn, xo)), mul(c, zo));
    // d corner / d (x, y, z, theta).
    const float dx[4] = {1.0f, 0.0f, 0.0f, add(mul(-sn, xo), mul(c, zo))};
    const float dy[4] = {0.0f, 1.0f, 0.0f, 0.0f};
    const float dz[4] = {0.0f, 0.0f, 1.0f, sub(mul(-c, xo), mul(sn, zo))};
    // _project_jac, both cameras.
    const float zc = at_least(z, kProjZMin);
    const float gate = z > kProjZMin ? 1.0f : (z == kProjZMin ? 0.5f : 0.0f);
    const float gz = quo(g.f, zc);
    const float xl = add(x, g.tx2);
    const float xr = add(x, g.off_r);
    const float u_l = add(g.cu, quo(mul(g.f, xl), zc));
    const float v_l = add(g.cv, quo(mul(g.f, y), zc));
    const float u_r = add(g.cu, quo(mul(g.f, xr), zc));
    const float ql = quo(xl, zc);
    const float qy = quo(y, zc);
    const float qr = quo(xr, zc);
    float du_l[4], dv_l[4], du_r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float dzc = mul(dz[q], gate);
      du_l[q] = mul(gz, sub(dx[q], mul(ql, dzc)));
      dv_l[q] = mul(gz, sub(dy[q], mul(qy, dzc)));
      du_r[q] = mul(gz, sub(dx[q], mul(qr, dzc)));
    }
    if (i == 0) {
      ul_min.first(u_l, du_l);
      vl_min.first(v_l, dv_l);
      ul_max.first(u_l, du_l);
      vl_max.first(v_l, dv_l);
      ur_min.first(u_r, du_r);
      ur_max.first(u_r, du_r);
    } else {
      ul_min.take(u_l, du_l);
      vl_min.take(v_l, dv_l);
      ul_max.take(u_l, du_l);
      vl_max.take(v_l, dv_l);
      ur_min.take(u_r, du_r);
      ur_max.take(u_r, du_r);
    }
    if (i == g.k) {
      kpt_u = u_l;
#pragma unroll
      for (int q = 0; q < 4; ++q) kpt_d[q] = du_l[q];
    }
  }
  ul_min.result(pred[0], jac[0]);
  vl_min.result(pred[1], jac[1]);
  ul_max.result(pred[2], jac[2]);
  vl_max.result(pred[3], jac[3]);
  ur_min.result(pred[4], jac[4]);
  ur_max.result(pred[5], jac[5]);
  pred[6] = kpt_u;
#pragma unroll
  for (int q = 0; q < 4; ++q) jac[6][q] = kpt_d[q];
}

// (JtJ)[p][q]: fused multiply-adds in observation order, as cuBLAS sums
// the einsum's batched product.
__device__ __forceinline__ float dot(const float j[kObs][4], int p, int q) {
  float acc = 0.0f;
#pragma unroll
  for (int o = 0; o < kObs; ++o) acc = __fmaf_rn(j[o][p], j[o][q], acc);
  return acc;
}

// (Jtr)[p]: as cuBLAS sums the einsum's batched matrix-vector product, two
// chains of fused multiply-adds, observations 0-3 and 4-6, then their sum.
__device__ __forceinline__ float dot(const float j[kObs][4], int p,
                                     const float r[kObs]) {
  float lo = 0.0f, hi = 0.0f;
#pragma unroll
  for (int o = 0; o < 4; ++o) lo = __fmaf_rn(j[o][p], r[o], lo);
#pragma unroll
  for (int o = 4; o < kObs; ++o) hi = __fmaf_rn(j[o][p], r[o], hi);
  return add(lo, hi);
}

__global__ void __launch_bounds__(kBlock) gauss_newton_solve_kernel(
    const float* __restrict__ obs, const float* __restrict__ obs_weights,
    const float* __restrict__ dims_hwl, const float* __restrict__ alpha,
    const int* __restrict__ kpt_idx, const float* __restrict__ f,
    const float* __restrict__ cu, const float* __restrict__ cv,
    const float* __restrict__ baseline, const float* __restrict__ tx2,
    const float* __restrict__ fixed_z, float* __restrict__ position,
    float* __restrict__ theta, float* __restrict__ residual, int n, int iters,
    float damping) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float ob[kObs], wt[kObs];
#pragma unroll
  for (int o = 0; o < kObs; ++o) {
    ob[o] = obs[i * kObs + o];
    wt[o] = obs_weights[i * kObs + o];
  }
  const Det g = {dims_hwl[i * 3], dims_hwl[i * 3 + 1], dims_hwl[i * 3 + 2],
                 f[i], cu[i], cv[i], tx2[i], sub(tx2[i], baseline[i]),
                 kpt_idx[i]};

  // _init_state: the closed-form init from box-centre disparity.
  const float uc_l = mul(0.5f, add(ob[0], ob[2]));
  const float uc_r = mul(0.5f, add(ob[4], ob[5]));
  const float disp = at_least(sub(uc_l, uc_r), 1.0f);
  const float z0 = quo(mul(g.f, baseline[i]), disp);
  const float x0 = sub(quo(mul(sub(uc_l, g.cu), z0), g.f), g.tx2);
  const float y0 = quo(mul(sub(ob[3], g.cv), z0), g.f);
  float s[4] = {x0, y0, fixed_z ? fixed_z[i] : z0,
                add(alpha[i], atan2f(x0, z0))};
  const float mask[4] = {1.0f, 1.0f, fixed_z ? 0.0f : 1.0f, 1.0f};

  float pred[kObs], jac[kObs][4], r[kObs];
  for (int it = 0; it < iters; ++it) {
    observe(s, g, pred, jac);
    float j[kObs][4];
#pragma unroll
    for (int o = 0; o < kObs; ++o) {
      r[o] = mul(sub(pred[o], ob[o]), wt[o]);
#pragma unroll
      for (int q = 0; q < 4; ++q) j[o][q] = mul(mul(jac[o][q], wt[o]), mask[q]);
    }
    // The damped normal equations, lower triangle, and their unrolled
    // Cholesky solve (_solve_spd4).
    float a[4][4], l[4][4], y[4], x[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int q = 0; q < p; ++q) a[p][q] = dot(j, p, q);
      const float diag = dot(j, p, p);
      a[p][p] = add(add(diag, mul(damping, add(1.0f, diag))),
                    sub(1.0f, mask[p]));
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int q = 0; q <= p; ++q) {
        float t = a[p][q];
#pragma unroll
        for (int k = 0; k < q; ++k) t = sub(t, mul(l[p][k], l[q][k]));
        l[p][q] = p == q ? __fsqrt_rn(at_least(t, kPivotMin)) : quo(t, l[q][q]);
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float t = dot(j, p, r);
#pragma unroll
      for (int k = 0; k < p; ++k) t = sub(t, mul(l[p][k], y[k]));
      y[p] = quo(t, l[p][p]);
    }
#pragma unroll
    for (int p = 3; p >= 0; --p) {
      float t = y[p];
#pragma unroll
      for (int k = p + 1; k < 4; ++k) t = sub(t, mul(l[k][p], x[k]));
      x[p] = quo(t, l[p][p]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float delta = at_most(at_least(x[p], -kMaxStep[p]), kMaxStep[p]);
      s[p] = sub(s[p], mul(delta, mask[p]));
    }
    s[2] = at_least(s[2], kStateZMin);
  }

  observe(s, g, pred, jac);
  float sq[kObs];
#pragma unroll
  for (int o = 0; o < kObs; ++o) {
    r[o] = mul(sub(pred[o], ob[o]), wt[o]);
    sq[o] = mul(r[o], r[o]);
  }
  // ATen's mean of 7 on the card: four interleaved partial sums, halved
  // twice, times 1/7.
  const float ss = add(add(add(sq[0], sq[4]), add(sq[2], sq[6])),
                       add(add(sq[1], sq[5]), sq[3]));
  position[i * 3] = s[0];
  position[i * 3 + 1] = s[1];
  position[i * 3 + 2] = s[2];
  theta[i] = s[3];
  residual[i] = __fsqrt_rn(mul(ss, 1.0f / kObs));
}

}  // namespace

// Solves the n detections on `stream`; returns the launch's CUDA error
// (0 on success).  fixed_z may be null (z free).  n must be >= 1.
extern "C" int gauss_newton_solve(
    const float* obs, const float* obs_weights, const float* dims_hwl,
    const float* alpha, const int* kpt_idx, const float* f, const float* cu,
    const float* cv, const float* baseline, const float* tx2,
    const float* fixed_z, float* position, float* theta, float* residual,
    int n, int iters, float damping, cudaStream_t stream) {
  gauss_newton_solve_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                              stream>>>(obs, obs_weights, dims_hwl, alpha,
                                        kpt_idx, f, cu, cv, baseline, tx2,
                                        fixed_z, position, theta, residual,
                                        n, iters, damping);
  return static_cast<int>(cudaGetLastError());
}
