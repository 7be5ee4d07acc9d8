// FAST corner detection for Hopper (sm_90a): arc test, MaxThreshold or
// SumAbsolute score, 3x3 strict-max nonmax and the interior mask, in one
// pass over the frame, with four entry points:
//
//   fdf_fast_words        keypoint mask packed 32 px per int32 word, (B, H, ceil(W/32))
//   fdf_fast_dense        u16 keypoint mask and u16 kp-masked score, (B, H, W)
//   fdf_fast_words_tiles  the words of each row shard's own rows, (S, rows, ceil(W/32))
//   fdf_fast_dense_tiles  the mask and score of each shard's own rows, (S, rows, W)
//
// Replaces the TPU kernels feature_detector_fast_tpu/ops/fast_pallas.py
// _kernel_words (:949, entry detect_words_padded), _kernel (:621, entry
// detect_dense_padded), and their row-shard forms _kernel_words_tiles
// (:1029, entry detect_words_tiles) and _kernel_tiles (:647, entry
// detect_dense_tiles).  It computes what their shared body _tile_keep
// (:567) computes; the plain PyTorch version is ops/fast.py, and
// ops/fast_cuda.py is the wrapper that checks arguments and launches.
// One kernel body serves all four: a template flag picks the tiles form
// (see fast_kernel and Layout).
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
// whole frame.  In the tiles form the buffer is a shard's slab, its global
// offset comes per shard from a device array, and only the shard's own
// rows are written; halo rows at the global top and bottom may hold any
// filler, since every pixel they can reach lies outside [3, height-4].

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

// Where one launch reads and writes.  The whole-frame form reads a (B, H,
// W) batch and writes every row; the tiles form reads an (S, rows +
// 2*halo, pitch) stack of row-shard slabs and writes each shard's own
// rows only, (S, rows, W).
struct Layout {
  int in_h;        // rows of each input buffer: the frame, or a shard's slab
  int out_h;       // rows written per buffer: the frame's, or the shard's own
  int skip;        // buffer row of written row 0: 0, or the halo
  int w;           // frame width; columns [3, w-4] are detectable
  int pitch;       // bytes between input rows, >= w
  int height;      // global frame height
  int row_offset;  // whole-frame form: global row of buffer row 0
  const int32_t* row0;  // tiles form: per shard, in device memory, the
                        // global row of its first own row
};

// Buffer pixel (y, x) may be a keypoint: x in [3, W-4], the global row in
// [3, height-4], and the whole circle inside the buffer.
__device__ __forceinline__ bool detectable(int y, int x, int H, int W,
                                           int row_offset, int height) {
  const int gy = row_offset + y;
  return x >= RADIUS && x < W - RADIUS && y >= RADIUS && y < H - RADIUS &&
         gy >= RADIUS && gy < height - RADIUS;
}

// TILES selects the row-shard form: blockIdx.z is the shard, whose global
// first row the block reads from g.row0 (the counterpart of the TPU
// kernel's SMEM tile offset: per-shard data, so one launch serves every
// shard on a device), and the grid covers the shard's own rows, which lie
// g.skip rows into its slab.
template <int N, bool WORDS, bool TILES>
__global__ void __launch_bounds__(THREADS)
fast_kernel(const uint8_t* __restrict__ img, const Layout g, int t, int mode,
            int n_words, int32_t* __restrict__ words,
            uint16_t* __restrict__ mask_out, uint16_t* __restrict__ score_out) {
  __shared__ uint8_t tile[SH * SW];
  __shared__ int scores[CH * CW];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TILE_W + tx;
  const int x0 = blockIdx.x * TILE_W, y0 = blockIdx.y * TILE_H;
  const int b0 = y0 + g.skip;  // buffer row of the block's first row
  const int H = g.in_h, W = g.w;
  const size_t frame = blockIdx.z;
  const uint8_t* im = img + frame * H * g.pitch;
  const int row_offset = TILES ? g.row0[frame] - g.skip : g.row_offset;
  const int height = g.height;

  // Stage the tile and its halo; pixels outside the buffer read 0 (they
  // can only feed pixels that are not detectable).
  for (int i = tid; i < SH * SW; i += THREADS) {
    const int y = b0 - HALO + i / SW, x = x0 - HALO + i % SW;
    tile[i] = (y >= 0 && y < H && x >= 0 && x < W) ? im[(size_t)y * g.pitch + x] : 0;
  }
  __syncthreads();

  const int y = y0 + ty, x = x0 + tx;  // written row and column
  const int by = b0 + ty;              // buffer row
  bool keep;
  int score = 0;
  if (mode == OFF) {
    keep = false;
    if (detectable(by, x, H, W, row_offset, height)) {
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
      if (detectable(b0 - 1 + ly, x0 - 1 + lx, H, W, row_offset, height)) {
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
    const int gy = row_offset + by;
    keep = score > neigh && gy != RADIUS && gy != height - RADIUS - 1;
  }

  const int out_h = g.out_h;
  if (WORDS) {
    const unsigned word = __ballot_sync(0xFFFFFFFFu, keep);
    if (tx == 0 && y < out_h)
      words[(frame * out_h + y) * n_words + blockIdx.x] = static_cast<int32_t>(word);
  } else if (y < out_h && x < W) {
    const size_t o = (frame * out_h + y) * W + x;
    mask_out[o] = keep;
    score_out[o] = static_cast<uint16_t>(score);
  }
}

template <bool WORDS, bool TILES>
int launch(const void* img, void* words, void* mask, void* score, int B,
           const Layout& g, int threshold, int count, int mode, int device,
           void* stream) {
  if (B <= 0 || g.in_h <= 0 || g.out_h <= 0 || g.w <= 0 || g.pitch < g.w ||
      threshold < 0 || threshold > 255 || mode < OFF || mode > SUM_ABSOLUTE ||
      (TILES && (g.row0 == nullptr || g.skip < HALO ||
                 g.in_h != g.out_h + 2 * g.skip)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 block(TILE_W, TILE_H);
  const dim3 grid((g.w + TILE_W - 1) / TILE_W, (g.out_h + TILE_H - 1) / TILE_H, B);
  const int n_words = grid.x;
  auto* in = static_cast<const uint8_t*>(img);
  auto* w = static_cast<int32_t*>(words);
  auto* m = static_cast<uint16_t*>(mask);
  auto* s = static_cast<uint16_t*>(score);
  auto st = static_cast<cudaStream_t>(stream);
  switch (count) {
#define FDF_COUNT_CASE(N)                                                     \
  case N:                                                                     \
    fast_kernel<N, WORDS, TILES><<<grid, block, 0, st>>>(in, g, threshold,    \
                                                         mode, n_words, w, m, \
                                                         s);                  \
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

// Every entry point launches on `stream`, does not synchronise, and
// returns cudaGetLastError() after the launch (0 on success).
int fdf_fast_words(const void* img, void* words, int B, int H, int W,
                   int row_offset, int height, int threshold, int count,
                   int mode, int device, void* stream) {
  const Layout g{H, H, 0, W, W, height, row_offset, nullptr};
  return launch<true, false>(img, words, nullptr, nullptr, B, g, threshold,
                             count, mode, device, stream);
}

int fdf_fast_dense(const void* img, void* mask, void* score, int B, int H,
                   int W, int row_offset, int height, int threshold, int count,
                   int mode, int device, void* stream) {
  const Layout g{H, H, 0, W, W, height, row_offset, nullptr};
  return launch<false, false>(img, nullptr, mask, score, B, g, threshold,
                              count, mode, device, stream);
}

// The row-shard forms.  `ext` is an (S, rows + 2*halo, pitch) u8 stack of
// shard slabs, `row0` an (S,) int32 device array; outputs hold each
// shard's own rows: words (S, rows, ceil(W/32)), mask and score (S, rows,
// W).  halo >= 4 (circle radius + the nonmax ring).
int fdf_fast_words_tiles(const void* ext, const void* row0, void* words, int S,
                         int rows, int halo, int W, int pitch, int height,
                         int threshold, int count, int mode, int device,
                         void* stream) {
  const Layout g{rows + 2 * halo, rows, halo, W, pitch, height, 0,
                 static_cast<const int32_t*>(row0)};
  return launch<true, true>(ext, words, nullptr, nullptr, S, g, threshold,
                            count, mode, device, stream);
}

int fdf_fast_dense_tiles(const void* ext, const void* row0, void* mask,
                         void* score, int S, int rows, int halo, int W,
                         int pitch, int height, int threshold, int count,
                         int mode, int device, void* stream) {
  const Layout g{rows + 2 * halo, rows, halo, W, pitch, height, 0,
                 static_cast<const int32_t*>(row0)};
  return launch<false, true>(ext, nullptr, mask, score, S, g, threshold, count,
                             mode, device, stream);
}

const char* fdf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
