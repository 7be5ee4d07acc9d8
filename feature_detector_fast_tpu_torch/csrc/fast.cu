// FAST corner detection for Hopper (sm_90a): arc test, MaxThreshold or
// SumAbsolute score, 3x3 strict-max nonmax and the interior mask, in one
// pass over the frame, with two entry points:
//
//   fdf_fast_words  keypoint mask packed 32 px per int32 word, (B, H, ceil(W/32))
//   fdf_fast_dense  u16 keypoint mask and u16 kp-masked score, (B, H, W)
//
// Replaces the TPU kernels feature_detector_fast_tpu/ops/fast_pallas.py
// _kernel_words (:949, entry detect_words_padded) and _kernel (:621, entry
// detect_dense_padded).  It computes what their shared body _tile_keep
// (:567) computes; the plain PyTorch version is ops/fast.py, and
// ops/fast_cuda.py is the wrapper that checks arguments and launches.
//
// Design.  One thread per pixel; a block is 32 x 8 pixels and gridDim.z is
// the frame index.  A warp covers 32 consecutive, 32-aligned columns of one
// row, so one __ballot_sync of the keep flags IS a packed word (bit b =
// column 32*j + b), which lane 0 stores: no pack pass, and the dense mask
// never reaches device memory on the words path.  The block stages its u8
// tile with a 4-px halo (circle radius 3 + the nonmax ring) in shared
// memory, computes the kp-masked score of the tile plus a 1-px ring into
// shared memory, and runs the nonmax from there.  The TPU kernel's SWAR
// pixel pairs, MXU pack matmul, tile-height tables and VMEM chunking
// answered TPU limits and have no counterpart here.
//
// Bound.  Per pixel the kernel reads one byte and writes 1/8 byte (words)
// or 4 bytes (dense), but runs 32 compares for the arc test and, where a
// pixel is a corner, up to 480 min/max (MaxThreshold) or 64 adds
// (SumAbsolute) for the score, on the tile plus its ring (1.33x the tile).
// It is bound by integer instruction throughput, not by memory; the
// prefilter and tile skip the TPU kernel uses are left for later work.
//
// Border rules are evaluated in global rows: row r of the buffer is global
// row row_offset + r of a frame of `height` rows (0 and H for a whole
// frame), so a row shard with its halo rows gives the same result as the
// whole frame.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 32;  // one warp per tile row: one ballot, one word
constexpr int TILE_H = 8;
constexpr int THREADS = TILE_W * TILE_H;
constexpr int RADIUS = 3;
constexpr int HALO = RADIUS + 1;        // circle radius + nonmax ring
constexpr int SW = TILE_W + 2 * HALO;   // staged u8 tile pitch
constexpr int SH = TILE_H + 2 * HALO;
constexpr int CW = TILE_W + 2;          // score tile: tile + 1-px ring
constexpr int CH = TILE_H + 2;

enum Mode { OFF = 0, MAX_THRESHOLD = 1, SUM_ABSOLUTE = 2 };

// The 16 circle taps, clockwise from twelve o'clock (geometry.CIRCLE):
// (0,-3) (1,-3) (2,-2) (3,-1) (3,0) (3,1) (2,2) (1,3)
// (0,3) (-1,3) (-2,2) (-3,1) (-3,0) (-3,-1) (-2,-2) (-1,-3), as (dx, dy).
__device__ __forceinline__ void load_taps(const uint8_t* s, int p[16]) {
  p[0] = s[-3 * SW];
  p[1] = s[-3 * SW + 1];
  p[2] = s[-2 * SW + 2];
  p[3] = s[-1 * SW + 3];
  p[4] = s[3];
  p[5] = s[SW + 3];
  p[6] = s[2 * SW + 2];
  p[7] = s[3 * SW + 1];
  p[8] = s[3 * SW];
  p[9] = s[3 * SW - 1];
  p[10] = s[2 * SW - 2];
  p[11] = s[SW - 3];
  p[12] = s[-3];
  p[13] = s[-SW - 3];
  p[14] = s[-2 * SW - 2];
  p[15] = s[-3 * SW - 1];
}

// Does some wraparound window of N consecutive bits of the 16-bit ring m
// have all bits set?  Bit s of r is the AND of ring bits s..s+N-1 (mod 16).
template <int N>
__device__ __forceinline__ bool any_run(unsigned m) {
  const unsigned m32 = m | (m << 16);
  unsigned r = m32;
#pragma unroll
  for (int k = 1; k < N; ++k) r &= m32 >> k;
  return (r & 0xFFFFu) != 0;
}

// Arc test at the staged pixel s: bright p - c > t, dark c - p > t, both
// strict, in int32.
template <int N>
__device__ __forceinline__ bool is_corner(const uint8_t* s, const int p[16], int t) {
  const int c = s[0];
  unsigned bright = 0, dark = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    bright |= static_cast<unsigned>(p[i] - c > t) << i;
    dark |= static_cast<unsigned>(c - p[i] > t) << i;
  }
  return any_run<N>(bright) || any_run<N>(dark);
}

// MaxThreshold score, d = c - p: min(|max_s min_window d|, |min_s max_window d|).
template <int N>
__device__ __forceinline__ int score_max_threshold(int c, const int p[16]) {
  int d[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = c - p[i];
  int eh = -256, el = 256;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    int mn = d[s], mx = d[s];
#pragma unroll
    for (int k = 1; k < N; ++k) {
      mn = min(mn, d[(s + k) & 15]);
      mx = max(mx, d[(s + k) & 15]);
    }
    eh = max(eh, mn);
    el = min(el, mx);
  }
  return min(abs(eh), abs(el));
}

// SumAbsolute score, d = p - c (the opposite sign to MaxThreshold's):
// max(sum over d > t of (d - t), sum over -d > t of (-d - t)).
__device__ __forceinline__ int score_sum_abs(int c, const int p[16], int t) {
  int light = 0, dark = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int d = p[i] - c;
    light += d > t ? d - t : 0;
    dark += -d > t ? -d - t : 0;
  }
  return max(light, dark);
}

// Buffer pixel (y, x) may be a keypoint: x in [3, W-4], the global row in
// [3, height-4], and the whole circle inside the buffer.
__device__ __forceinline__ bool detectable(int y, int x, int H, int W,
                                           int row_offset, int height) {
  const int gy = row_offset + y;
  return x >= RADIUS && x < W - RADIUS && y >= RADIUS && y < H - RADIUS &&
         gy >= RADIUS && gy < height - RADIUS;
}

template <int N, bool WORDS>
__global__ void __launch_bounds__(THREADS)
fast_kernel(const uint8_t* __restrict__ img, int H, int W, int row_offset,
            int height, int t, int mode, int n_words,
            int32_t* __restrict__ words, uint16_t* __restrict__ mask_out,
            uint16_t* __restrict__ score_out) {
  __shared__ uint8_t tile[SH * SW];
  __shared__ int scores[CH * CW];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TILE_W + tx;
  const int x0 = blockIdx.x * TILE_W, y0 = blockIdx.y * TILE_H;
  const size_t frame = blockIdx.z;
  const uint8_t* im = img + frame * H * W;

  // Stage the tile and its halo; pixels outside the buffer read 0 (they
  // can only feed pixels that are not detectable).
  for (int i = tid; i < SH * SW; i += THREADS) {
    const int y = y0 - HALO + i / SW, x = x0 - HALO + i % SW;
    tile[i] = (y >= 0 && y < H && x >= 0 && x < W) ? im[(size_t)y * W + x] : 0;
  }
  __syncthreads();

  const int y = y0 + ty, x = x0 + tx;
  bool keep;
  int score = 0;
  if (mode == OFF) {
    keep = false;
    if (detectable(y, x, H, W, row_offset, height)) {
      const uint8_t* s = &tile[(ty + HALO) * SW + tx + HALO];
      int p[16];
      load_taps(s, p);
      keep = is_corner<N>(s, p, t);
    }
  } else {
    // kp-masked score of the tile plus its 1-px ring: 0 for non-keypoints.
    for (int i = tid; i < CH * CW; i += THREADS) {
      const int ly = i / CW, lx = i % CW;
      int v = 0;
      if (detectable(y0 - 1 + ly, x0 - 1 + lx, H, W, row_offset, height)) {
        const uint8_t* s = &tile[(ly + HALO - 1) * SW + lx + HALO - 1];
        int p[16];
        load_taps(s, p);
        if (is_corner<N>(s, p, t)) {
          v = mode == MAX_THRESHOLD ? score_max_threshold<N>(s[0], p)
                                    : score_sum_abs(s[0], p, t);
        }
      }
      scores[i] = v;
    }
    __syncthreads();
    // Strict max over the 8 neighbours.  Every neighbour score is >= 0, so
    // score > neigh implies score > 0, which implies a keypoint.
    const int* sc = &scores[(ty + 1) * CW + tx + 1];
    score = sc[0];
    const int neigh = max(max(max(sc[-CW - 1], sc[-CW]), max(sc[-CW + 1], sc[-1])),
                          max(max(sc[1], sc[CW - 1]), max(sc[CW], sc[CW + 1])));
    const int gy = row_offset + y;
    keep = score > neigh && gy != RADIUS && gy != height - RADIUS - 1;
  }

  if (WORDS) {
    const unsigned word = __ballot_sync(0xFFFFFFFFu, keep);
    if (tx == 0 && y < H) words[(frame * H + y) * n_words + blockIdx.x] = static_cast<int32_t>(word);
  } else if (y < H && x < W) {
    const size_t o = (frame * H + y) * W + x;
    mask_out[o] = keep;
    score_out[o] = static_cast<uint16_t>(score);
  }
}

template <bool WORDS>
int launch(const void* img, void* words, void* mask, void* score, int B, int H,
           int W, int row_offset, int height, int threshold, int count,
           int mode, int device, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || threshold < 0 || threshold > 255 ||
      mode < OFF || mode > SUM_ABSOLUTE)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 block(TILE_W, TILE_H);
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  const int n_words = grid.x;
  auto* in = static_cast<const uint8_t*>(img);
  auto* w = static_cast<int32_t*>(words);
  auto* m = static_cast<uint16_t*>(mask);
  auto* s = static_cast<uint16_t*>(score);
  auto st = static_cast<cudaStream_t>(stream);
  switch (count) {
#define FDF_COUNT_CASE(N)                                                     \
  case N:                                                                     \
    fast_kernel<N, WORDS><<<grid, block, 0, st>>>(in, H, W, row_offset,       \
                                                  height, threshold, mode,    \
                                                  n_words, w, m, s);          \
    break;
    FDF_COUNT_CASE(9)
    FDF_COUNT_CASE(10)
    FDF_COUNT_CASE(11)
    FDF_COUNT_CASE(12)
    FDF_COUNT_CASE(13)
    FDF_COUNT_CASE(14)
    FDF_COUNT_CASE(15)
    FDF_COUNT_CASE(16)
#undef FDF_COUNT_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Both entry points launch on `stream`, do not synchronise, and return
// cudaGetLastError() after the launch (0 on success).
int fdf_fast_words(const void* img, void* words, int B, int H, int W,
                   int row_offset, int height, int threshold, int count,
                   int mode, int device, void* stream) {
  return launch<true>(img, words, nullptr, nullptr, B, H, W, row_offset,
                      height, threshold, count, mode, device, stream);
}

int fdf_fast_dense(const void* img, void* mask, void* score, int B, int H,
                   int W, int row_offset, int height, int threshold, int count,
                   int mode, int device, void* stream) {
  return launch<false>(img, nullptr, mask, score, B, H, W, row_offset, height,
                       threshold, count, mode, device, stream);
}

const char* fdf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
