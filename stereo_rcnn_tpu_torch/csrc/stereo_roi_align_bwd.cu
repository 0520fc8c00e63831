// Backward of the fused stereo RoIAlign for Hopper (sm_90a).
//
// Replaces stereo_rcnn_tpu/ops/roi_align_pallas.py::_stereo_bwd_kernel (the
// custom-VJP backward of stereo_roi_align_batched_packed; its transpose is
// _grad_window).  Input: the cotangent of the forward's packed block, one
// 294 x C float32 block per (image, roi) in the forward's row layout
// (14x14 left samples, left 7x7 pool, right 7x7 pool).  Output: float32
// gradients of the four left and four right levels, every cell written by
// the kernel (the caller allocates them uninitialised).  Per sample of the
// 14x14 grid the cotangent is
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
// Each term is one fused multiply-add, sum += (wy * wx) * cotangent, with
// the weight product rounded first as in the plain version; the plain
// version rounds the term before adding it, so the two agree to float32
// rounding, not bit for bit.
//
// What bounds it on an H100: by bytes, the valid rois' cotangent rows read
// once (left 245, right 49 of the 294) and 668 MB of level gradients
// written once (2 sides x 8 images x 40,800 cells x 1 KB at batch 8 x 128
// rois x C = 256): 974 MB, 0.291 ms at 3.35 TB/s.  Rois overlap, so many
// samples add into one cell.  The TPU kernel has no race there: its grid
// runs in order and read-modify-writes each roi's window.  Blocks on Hopper
// run in parallel; the first port (one block per roi and side) made every
// tap a float32 atomicAdd into device memory, 411 M per step, after a
// 668 MB zero-fill, and its sums changed in the last bits from run to run.
//
// The design: every gradient cell, with its channel, is owned by one lane,
// summed in one fixed order and written once, with no atomics.
// - One warp per (image, side, level, strip of kRowsW x kTileW cells,
//   channel chunk).  Lane l owns kVec channels of every cell of the strip,
//   in registers.  Where C % 4 == 0, kVec = 8: two quads, quad q at
//   channel 128 q + 4 l, so that each warp-wide load or store of a quad
//   covers 512 contiguous bytes.  Any other even C takes kVec = 2: one
//   pair at channel 2 l, 8-byte accesses.  The width is a template
//   parameter of the same kernel, chosen by the C entry (as K1's in
//   stereo_roi_align.cu); it changes how many channels a lane carries,
//   never the order in which a channel's terms are summed, so both widths
//   give the same bits for the same channel.
// - The warp lists the strip's hits once, in ascending roi order (4 x 32
//   rois' loads in flight, a ballot per 32): the rois of its level, valid,
//   whose tap rectangle meets the strip, with their window origin and
//   geometry, kept in shared memory.  The rectangle comes from the roi's
//   metadata in the scan (axis_meets): positions grow with the sample
//   index, so the taps run from sample 0's low tap to sample 13's high
//   one; it is widened by one cell against a position rounded an ulp
//   apart.
// - Per hit, lanes 0..13 compute the y-taps of its sample rows and lanes
//   16..29 the x-taps of its sample columns (the forward's positions,
//   __fmaf_rn); ballots keep the rows and columns with a tap in the strip.
//   Each kept sample row is a unit: the cotangent vectors of its kept
//   columns (left) and of the 7x7 pool bins they fall in go to a ring of
//   kRing vectors in shared memory by cp.async, several units ahead of
//   the one being added, so the warp waits on memory about once per ring.
// - Adding a unit: for each kept column, each of the sample's up to four
//   taps in the strip adds into its cell's registers through a switch on
//   the cell (an indexed register array would go to local memory).  A
//   clamped high tap (the low tap's cell, weight exactly 0) is skipped.
// - At the end the warp writes its strip, zeros included, with 16-byte
//   streaming stores (__stcs): every gradient cell is written exactly once,
//   so the caller allocates the gradients uninitialised (no zero-fill).
//   The hit order and the order within a hit are fixed: two launches give
//   the same bits.
// - Blocks go out coarsest level first (few strips, each hit by many
//   rois), and the channel chunks of a strip next to each other.
// The mapping (kRowsW x kTileW cells, kVec channels per lane, a kRing
// ring) was chosen by timing it at the training shapes in chip_smoke.py
// (phase 4), batch 8 x 128 edge-case rois, C = 256 ("NVIDIA H100 80GB
// HBM3, 700.00 W"): 2 x 4 cells, 8 channels per lane, a 12-vector ring
// 0.773 ms; the same with a 10-vector ring 0.796; 1 x 8 cells, ring 10
// 0.807; the atomic kernel 0.977 ms in the same call; every roi zero-area
// (scan and store only) 0.204 ms; all 128 rois of each image one box
// 0.956 ms.
// What holds it above its 0.291 ms bound is not bytes: a warp adds its
// units one after another, each a chain of dependent shared-memory reads,
// switches and multiply-adds, and shared memory (ring plus hit list, about
// 18 KB a warp) keeps about 12 warps on an SM to hide those chains.  Over
// the strip designs that came first (shared-memory sums, 2 x 8 cells and
// 4 channels per lane, loads issued when needed), the sums in registers,
// the cp.async ring, one chunk of all 256 channels and 512-byte quads
// (lane-strided 32-byte stores had slowed the store side) each took a
// share of the time.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 4;
constexpr int kPk = 14;                      // samples per axis
constexpr int kP = 7;                        // pooled bins per axis
constexpr int kKpt = kPk * kPk;              // 196
constexpr int kRows = kKpt + 2 * kP * kP;    // 294
constexpr int kHitQ = 4;                     // hits in flight per warp
constexpr int kUnitQ = 8;                    // units (cp.async groups)
constexpr int kRowsW = 2;                    // cell rows per strip
constexpr int kTileW = 4;                    // strip width in cells
constexpr int kRing = 12;                    // cotangent vectors in the ring
constexpr int kCells = kRowsW * kTileW;

struct Grads {
  float* left[kLevels];
  float* right[kLevels];
  int h[kLevels];        // level height
  int w[kLevels];        // level width
  int win_h[kLevels];    // sampling window, clamped to the level
  int win_w[kLevels];
  int tiles_x[kLevels];  // strips per level row
  int first_tile[kLevels];  // the level's first strip, coarsest level first
};

// A lane's channels: kVec = 8 as two quads (4 channels, one 16-byte
// access each), kVec = 2 as one pair (one 8-byte access).
template <int kVec>
struct Lane {
  static_assert(kVec == 2 || kVec == 8, "a pair or two quads");
  static constexpr int kElem = kVec == 2 ? 2 : 4;  // channels per access
  static constexpr int kQ = kVec / kElem;          // accesses per lane
  static constexpr int kChunk = 32 * kVec;         // channels per warp
  // A unit takes at most kMaxCols sample columns, so that its vectors
  // (kept columns plus the pool bins they fall in) fit the ring.
  static constexpr int kMaxCols =
      2 * (kRing - 1) / 3 < kPk ? 2 * (kRing - 1) / 3 : kPk;
  static_assert(kMaxCols >= 2, "ring too small");
  // The lane's access q of a row of channels: for quads 128 q + 4 lane
  // (each warp-wide access covers 512 contiguous bytes), for a pair
  // 2 lane.
  static __device__ __forceinline__ int at(int q, int lane) {
    return 32 * kElem * q + kElem * lane;
  }
};

template <int kVec>
struct Vec {
  float v[kVec];
};

template <int kVec>
__device__ __forceinline__ Vec<kVec> load_lane(const float* row, int lane) {
  using L = Lane<kVec>;
  Vec<kVec> r;
#pragma unroll
  for (int q = 0; q < L::kQ; ++q) {
    if constexpr (L::kElem == 4) {
      const float4 t = *reinterpret_cast<const float4*>(row + L::at(q, lane));
      r.v[4 * q] = t.x;
      r.v[4 * q + 1] = t.y;
      r.v[4 * q + 2] = t.z;
      r.v[4 * q + 3] = t.w;
    } else {
      const float2 t = *reinterpret_cast<const float2*>(row + L::at(q, lane));
      r.v[2 * q] = t.x;
      r.v[2 * q + 1] = t.y;
    }
  }
  return r;
}

// acc[k] += w * d for a cell index k known only at run time: a switch, so
// that the sums stay in registers.
template <int kVec>
__device__ __forceinline__ void add_cell(float (&acc)[kCells][kVec], int k,
                                         float w, const Vec<kVec>& d) {
  static_assert(kCells == 8, "one case per cell");
#define K2_CELL(q)                                                  \
  case q:                                                           \
    _Pragma("unroll") for (int v = 0; v < kVec; ++v) {              \
      acc[q][v] = __fmaf_rn(w, d.v[v], acc[q][v]);                  \
    }                                                               \
    break;
  switch (k) {
    K2_CELL(0) K2_CELL(1) K2_CELL(2) K2_CELL(3) K2_CELL(4) K2_CELL(5)
    K2_CELL(6) K2_CELL(7)
    default: break;
  }
#undef K2_CELL
}

// Waits until at most n of this thread's cp.async groups are pending (the
// instruction takes an immediate).
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: __pipeline_wait_prior(0); break;
    case 1: __pipeline_wait_prior(1); break;
    case 2: __pipeline_wait_prior(2); break;
    case 3: __pipeline_wait_prior(3); break;
    case 4: __pipeline_wait_prior(4); break;
    case 5: __pipeline_wait_prior(5); break;
    case 6: __pipeline_wait_prior(6); break;
    default: __pipeline_wait_prior(7); break;
  }
}

// Whether one axis of a roi's taps meets the n cells from first on, widened
// by one cell on each side: p1 the roi's start and bin its bin size in
// window coordinates, origin and win its window's first cell and size.
// The forward's positions (__fmaf_rn) grow with the sample index, so the
// taps run from sample 0's low tap to sample 13's high one.
__device__ __forceinline__ bool axis_meets(float p1, float bin, int origin,
                                           int win, int first, int n) {
  const float last = static_cast<float>(win - 1);
  const float p0 = fminf(fmaxf(__fmaf_rn(0.5f, bin, p1), 0.0f), last);
  const float pn =
      fminf(fmaxf(__fmaf_rn(kPk - 0.5f, bin, p1), 0.0f), last);
  const int lo = origin + static_cast<int>(floorf(p0));
  const int hi = origin + min(static_cast<int>(floorf(pn)) + 1, win - 1);
  return lo <= first + n && hi >= first - 1;
}

template <int kVec>
__global__ void __launch_bounds__(32)
    stereo_roi_align_bwd_kernel(Grads grads, const int* __restrict__ meta_l,
                                const float* __restrict__ geom_l,
                                const int* __restrict__ meta_r,
                                const float* __restrict__ geom_r,
                                const float* __restrict__ g, int n_rois,
                                int c) {
  using L = Lane<kVec>;
  constexpr int kChunk = L::kChunk, kQ = L::kQ, kElem = L::kElem;
  constexpr int kMaxCols = L::kMaxCols;
  extern __shared__ float4 smem4[];  // ring [kRing][kChunk], hit meta, geom
  __shared__ int4 taps_q[kHitQ][2 * kPk];    // y-taps, then x-taps
  __shared__ int4 units[kUnitQ];

  // The warp's strip and channel chunk; the chunks of a strip neighbours.
  const int n_chunks = (c + kChunk - 1) / kChunk;
  const int tile_id = blockIdx.x / n_chunks;
  const int ch0 = (blockIdx.x % n_chunks) * kChunk;
  int level = kLevels - 1;
  while (level > 0 && tile_id >= grads.first_tile[level - 1]) --level;
  const int tile = tile_id - grads.first_tile[level];
  const int tx0 = (tile % grads.tiles_x[level]) * kTileW;
  const int y_first = (tile / grads.tiles_x[level]) * kRowsW;
  const int side = blockIdx.z & 1;
  const int b = blockIdx.z >> 1;
  const int lane = threadIdx.x;
  const int4* meta = reinterpret_cast<const int4*>(side == 0 ? meta_l
                                                             : meta_r);
  const float4* geom = reinterpret_cast<const float4*>(side == 0 ? geom_l
                                                                 : geom_r);

  float* ring = reinterpret_cast<float*>(smem4);
  int4* hit_meta = reinterpret_cast<int4*>(ring + kRing * kChunk);
  float4* hit_geom = reinterpret_cast<float4*>(hit_meta + n_rois);
  bool live[kQ];                             // the lane's quads below C
#pragma unroll
  for (int q = 0; q < kQ; ++q) live[q] = ch0 + L::at(q, lane) < c;
  float acc[kCells][kVec];
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[k][v] = 0.0f;
  }

  // The strip's hits, in ascending roi order.
  const int win_h = grads.win_h[level], win_w = grads.win_w[level];
  int n_hit = 0;
  for (int r0 = 0; r0 < n_rois; r0 += 128) {
    bool hit[4];
    int4 mq[4];
    float4 gq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + 32 * q + lane;
      mq[q] = make_int4(-1, 0, 0, 0);
      gq[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < n_rois) {
        mq[q] = __ldg(meta + b * n_rois + r);
        gq[q] = __ldg(geom + b * n_rois + r);
      }
      hit[q] = mq[q].x == level && mq[q].w != 0 &&
               axis_meets(gq[q].x, gq[q].z, mq[q].y, win_h, y_first,
                          kRowsW) &&
               axis_meets(gq[q].y, gq[q].w, mq[q].z, win_w, tx0, kTileW);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned bal = __ballot_sync(~0u, hit[q]);
      if (hit[q]) {
        const int k = n_hit + __popc(bal & ((1u << lane) - 1u));
        hit_meta[k] = make_int4(r0 + 32 * q + lane, mq[q].y, mq[q].z, 0);
        hit_geom[k] = gq[q];
      }
      n_hit += __popc(bal);
    }
  }
  __syncwarp();                              // the hit list written

  const int axis = lane / 16, k_tap = lane % 16;
  const int win = axis ? win_w : win_h;
  const int base = axis ? tx0 : y_first;
  const int span = axis ? kTileW : kRowsW;
  const float* g_chunk = g + ch0;
  const int pool_row = kKpt + side * kP * kP;

  // Producer: the next hit, the current hit's rows still to issue, its
  // columns, the current row's columns still to issue, its tap slot.
  int hp = 0;
  unsigned p_rows = 0u, p_cols = 0u, p_left = 0u;
  int p_slot = 0, p_roi = 0;
  int hits_in = 0, hits_out = 0;             // tap slots taken / freed
  int u_in = 0, u_out = 0;                   // units issued / added
  int ring_head = 0, ring_used = 0;          // vectors

  for (;;) {
    // Issue units while the queues and the ring have room.
    for (;;) {
      if (p_rows == 0u) {
        if (hp >= n_hit || hits_in - hits_out >= kHitQ) break;
        const int4 m = hit_meta[hp];
        const float4 gm = hit_geom[hp];
        ++hp;
        const int slot = hits_in % kHitQ;
        bool touch = false;
        if (k_tap < kPk) {
          // Rounded once, as the forward's positions.
          float pos = __fmaf_rn(static_cast<float>(k_tap) + 0.5f,
                                axis ? gm.w : gm.z, axis ? gm.y : gm.x);
          pos = fminf(fmaxf(pos, 0.0f), static_cast<float>(win - 1));
          const float fl = floorf(pos);
          const int cell = static_cast<int>(fl);
          const int origin = axis ? m.z : m.y;
          const int lo = origin + cell - base;
          const int hi = origin + min(cell + 1, win - 1) - base;
          touch = (lo >= 0 && lo < span) || (hi >= 0 && hi < span);
          // A clamped high tap (the low one's cell) has weight exactly 0:
          // marked -1 so it is skipped.
          taps_q[slot][axis * kPk + k_tap] =
              make_int4(lo, hi == lo ? -1 : hi,
                        __float_as_int(1.0f - (pos - fl)),
                        __float_as_int(pos - fl));
        }
        __syncwarp();                        // the slot's taps written
        const unsigned mask = __ballot_sync(~0u, touch);
        const unsigned cols = (mask >> 16) & 0x3fffu;
        if (cols == 0u || (mask & 0x3fffu) == 0u) continue;
        p_rows = mask & 0x3fffu;
        p_cols = p_left = cols;
        p_slot = slot;
        p_roi = b * n_rois + m.x;
        ++hits_in;
      }
      // The next unit: one sample row of the current hit, up to kMaxCols
      // of its kept columns, their d14 vectors (left) and the pool bins
      // they fall in.
      const int i = __ffs(p_rows) - 1;
      unsigned u_cols = p_left;
      if (kMaxCols < kPk) {
        u_cols = 0u;
        unsigned rem = p_left;
        for (int n = 0; n < kMaxCols && rem; ++n) {
          u_cols |= rem & (0u - rem);
          rem &= rem - 1u;
        }
      }
      unsigned bins = 0u;
#pragma unroll
      for (int m = 0; m < kP; ++m) {
        if ((u_cols >> (2 * m)) & 3u) bins |= 1u << m;
      }
      const int n_d14 = side == 0 ? __popc(u_cols) : 0;
      const int nv = n_d14 + __popc(bins);
      if (u_in - u_out >= kUnitQ || ring_used + nv > kRing) break;
      const float* blk = g_chunk + static_cast<size_t>(p_roi) * kRows * c;
      int pos = ring_head;
      if (side == 0) {
        for (unsigned cs = u_cols; cs; cs &= cs - 1u) {
          const float* src = blk + static_cast<size_t>(i * kPk + __ffs(cs) -
                                                       1) * c;
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            if (live[q]) {
              __pipeline_memcpy_async(ring + pos * kChunk + L::at(q, lane),
                                      src + L::at(q, lane), 4 * kElem);
            }
          }
          pos = pos + 1 == kRing ? 0 : pos + 1;
        }
      }
      for (unsigned bs = bins; bs; bs &= bs - 1u) {
        const float* src = blk + static_cast<size_t>(
                                     pool_row + (i / 2) * kP + __ffs(bs) - 1) *
                                     c;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          if (live[q]) {
            __pipeline_memcpy_async(ring + pos * kChunk + L::at(q, lane),
                                    src + L::at(q, lane), 4 * kElem);
          }
        }
        pos = pos + 1 == kRing ? 0 : pos + 1;
      }
      __pipeline_commit();
      p_left &= ~u_cols;
      if (p_left == 0u) {                    // the row done: the next one
        p_rows &= p_rows - 1u;
        p_left = p_cols;
      }
      if (lane == 0) {
        units[u_in % kUnitQ] = make_int4(
            p_slot | (i << 8) | ((p_rows == 0u) << 16),
            static_cast<int>(u_cols), static_cast<int>(bins), ring_head);
      }
      ring_head = (ring_head + nv) % kRing;
      ring_used += nv;
      ++u_in;
    }
    if (u_in == u_out) break;                // nothing left to add
    // Add the oldest unit once its copies have landed.
    wait_pending(u_in - u_out - 1);
    __syncwarp();                            // its record written
    const int4 rec = units[u_out % kUnitQ];
    const int4* tq = taps_q[rec.x & 0xff];
    const int4 yt = tq[(rec.x >> 8) & 0xff];
    const unsigned cols = static_cast<unsigned>(rec.y);
    const unsigned bins = static_cast<unsigned>(rec.z);
    const int start = rec.w;
    const int n_d14 = side == 0 ? __popc(cols) : 0;
    const float wyl = __int_as_float(yt.z), wyh = __int_as_float(yt.w);
    const bool own_lo = yt.x >= 0 && yt.x < kRowsW;
    const bool own_hi = yt.y >= 0 && yt.y < kRowsW;
    int k = 0;
    for (unsigned cs = cols; cs; cs &= cs - 1u, ++k) {
      const int j = __ffs(cs) - 1;
      int pv_pos = start + n_d14 + __popc(bins & ((1u << (j / 2)) - 1u));
      pv_pos -= pv_pos >= kRing ? kRing : 0;
      const Vec<kVec> pv = load_lane<kVec>(ring + pv_pos * kChunk, lane);
      // d14 + pool / 4 (left) or pool / 4 (right): the quarter is exact, so
      // one fused multiply-add rounds as the plain version's two steps.
      Vec<kVec> d;
      if (side == 0) {
        int d_pos = start + k;
        d_pos -= d_pos >= kRing ? kRing : 0;
        const Vec<kVec> d14 = load_lane<kVec>(ring + d_pos * kChunk, lane);
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          d.v[v] = __fmaf_rn(pv.v[v], 0.25f, d14.v[v]);
        }
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v) d.v[v] = __fmul_rn(pv.v[v], 0.25f);
      }
      const int4 x = tq[kPk + j];
      const float wxl = __int_as_float(x.z), wxh = __int_as_float(x.w);
      const bool own_xlo = x.x >= 0 && x.x < kTileW;
      const bool own_xhi = x.y >= 0 && x.y < kTileW;
      // The four taps in the plain version's order.
      if (own_lo && own_xlo) {
        add_cell(acc, yt.x * kTileW + x.x, __fmul_rn(wyl, wxl), d);
      }
      if (own_lo && own_xhi) {
        add_cell(acc, yt.x * kTileW + x.y, __fmul_rn(wyl, wxh), d);
      }
      if (own_hi && own_xlo) {
        add_cell(acc, yt.y * kTileW + x.x, __fmul_rn(wyh, wxl), d);
      }
      if (own_hi && own_xhi) {
        add_cell(acc, yt.y * kTileW + x.y, __fmul_rn(wyh, wxh), d);
      }
    }
    ring_used -= n_d14 + __popc(bins);
    hits_out += (rec.x >> 16) & 1;
    ++u_out;
    __syncwarp();                            // the record read
  }

  // Write the strip once, zeros included.
  const int h = grads.h[level], w = grads.w[level];
  float* dst = (side == 0 ? grads.left[level] : grads.right[level]) +
               static_cast<size_t>(b) * h * w * c + ch0;
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int y = y_first + k / kTileW, x = tx0 + k % kTileW;
    if (y >= h || x >= w) continue;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      if (!live[q]) continue;
      float* cell = dst + (static_cast<size_t>(y) * w + x) * c + L::at(q, lane);
      if constexpr (kElem == 4) {
        __stcs(reinterpret_cast<float4*>(cell),
               make_float4(acc[k][4 * q], acc[k][4 * q + 1],
                           acc[k][4 * q + 2], acc[k][4 * q + 3]));
      } else {
        __stcs(reinterpret_cast<float2*>(cell),
               make_float2(acc[k][2 * q], acc[k][2 * q + 1]));
      }
    }
  }
}

template <int kVec>
cudaError_t launch(const Grads& grads, const int* meta_l, const float* geom_l,
                   const int* meta_r, const float* geom_r, const float* g,
                   int batch, int n_rois, int c, int n_tiles,
                   cudaStream_t stream) {
  constexpr int kChunk = Lane<kVec>::kChunk;
  const int smem = (kRing * kChunk + 8 * n_rois) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stereo_roi_align_bwd_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 blocks(n_tiles * ((c + kChunk - 1) / kChunk), 1, 2 * batch);
  stereo_roi_align_bwd_kernel<kVec><<<blocks, 32, smem, stream>>>(
      grads, meta_l, geom_l, meta_r, geom_r, g, n_rois, c);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes.  grad_l / grad_r: host arrays of 4 device
// pointers to float32 NHWC level gradients [B, h, w, C], written in full;
// level_hw / win_hw: host arrays (h0, w0, h1, w1, ...); meta_*: int32
// [B, R, 4] (level, y0, x0, valid) and geom_*: float32 [B, R, 4] (y1, x1,
// bin_h, bin_w) on the device; g: float32 [B, R, 294, C], C even, 16-byte
// aligned.  Returns a CUDA error code (0 on success).
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
  if (batch == 0 || c == 0) return static_cast<int>(cudaSuccess);
  if (c % 2) return static_cast<int>(cudaErrorInvalidValue);
  int n_tiles = 0;
  for (int l = kLevels - 1; l >= 0; --l) {
    grads.tiles_x[l] = (grads.w[l] + kTileW - 1) / kTileW;
    grads.first_tile[l] = n_tiles;
    n_tiles += grads.tiles_x[l] * ((grads.h[l] + kRowsW - 1) / kRowsW);
  }
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      c % 4 == 0 ? launch<8>(grads, meta_l, geom_l, meta_r, geom_r, g, batch,
                             n_rois, c, n_tiles, s)
                 : launch<2>(grads, meta_l, geom_l, meta_r, geom_r, g, batch,
                             n_rois, c, n_tiles, s));
}
