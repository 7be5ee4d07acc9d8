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
// One kernel body serves all four: template flags pick the nonmax mode,
// the output form and the tiles form (see fast_kernel and Layout).
//
// Bound.  Per pixel the kernel reads one byte and writes 1/8 byte (words)
// or 4 bytes (dense).  The work the data needs is 17 integer operations
// for the cardinal prefilter at every pixel, 40 more for the arc test
// where it passes (8% of the 1080p benchmark frame's pixels at t=16, n=9),
// and at arc-test corners only (1.2%) 9 for the nonmax and 99-131
// (MaxThreshold) or 65 (SumAbsolute) for the score.  At (16, 1080, 1920)
// that is 0.67-0.71 G operations, 0.040-0.043 ms at 16.7 T int32
// lane-operations/s, against 0.011 (words) or 0.050 ms (dense) for the
// bytes at 3.35 TB/s: words are bound by operations, dense by bytes
// (tools/_common.py fast_work and fast_bound).
//
// Design, and what it does about that bound:
//   * Every mode, count, form and strip height is its own instantiation
//     (count x mode x words x tiles x 32 or 8 rows), so OFF carries no
//     score state: its instantiations are held to 32 registers, full
//     occupancy at 2048 threads per SM.  A runtime strip height would halve
//     the 192 instantiations and this source's build (43 s to 22 s on the
//     H100 machine) but cost MaxThreshold and SumAbsolute 2.5-5.6%; the
//     build is cached by source hash, the kernel runs on every call.
//   * A block is a column strip: 4 warps, one column per lane, 128 columns
//     wide and 32 rows tall, or 8 where 32 would give a launch fewer blocks
//     than fill the card once (one frame, a few row shards: shorter strips
//     trade halo for SMs).  A warp is 32 aligned columns of one row
//     at every step, so one __ballot_sync of the keep flags IS a packed word
//     (bit b = column 32*j + b), which lane 0 stores; dense stores are 2
//     bytes per lane per row, 64 B a warp per plane.
//   * The strip and its 4-px halo (circle radius 3 + the nonmax ring),
//     (rows + 8) x 136 B, are staged once with aligned 4-byte loads (byte
//     loads only where a word crosses the frame's edge, so any pitch and
//     any frame base work), one barrier per strip: 1.33x halo
//     amplification at 32 rows.  Blocks are small (4.3 KB of u8 tile, 8.8 KB more of
//     scores for MaxThreshold and SumAbsolute), so enough of them are
//     resident for one block's loads to hide under another's compares; no
//     cp.async double buffer is needed for that.
//   * A cardinal prefilter (>= 2 of taps 0/4/8/12 bright or dark for counts
//     <= 11, >= 3 for >= 12, as fast_pallas.py:385; a necessary condition,
//     tests/test_torch_fast.py proves it on all 2^16 rings) and
//     __any_sync let a warp skip the 16-tap test of a row where no lane
//     passes.  Each tap test is a subtraction whose sign bit one funnel
//     shift pushes into a register, bright and dark interleaved, so the
//     16-tap ring fills 32 bits and one run test serves both polarities:
//     AND-rotations by 1, 2, 4 taps give runs of 8, and a run of N is two
//     overlapping runs of 8 at s and s + N - 8 (8 instructions).
//   * MaxThreshold and SumAbsolute compute each score once.  Each lane
//     writes the kp-masked scores of its column for the strip's rows and the
//     1-px rows above and below into shared memory; warps 0-2 compute the
//     two ring columns beside the strip (2 * (rows + 2) scores, the only
//     arc tests run twice); after one barrier each lane takes the
//     nonmax down its column from shared memory, keeping the row above in
//     registers (3 shared loads a pixel).  Shared memory rather than
//     __shfl_*_sync across lanes: the columns at warp edges need it anyway,
//     and one path serves every lane.
//   * The scores use Hopper's DPX instructions.  MaxThreshold takes the
//     window min/max exactly from shared pieces: windows of 3 by 3-input
//     min/max, of 9 as three windows of 3, of N as two overlapping windows
//     of 9, then the max/min over the 16 starts, 3 inputs at a time: ~130
//     operations for N > 9 and ~100 for N = 9, against 2 x 16 x (N-1) for
//     the direct form.  SumAbsolute adds each tap's excess with one
//     add-then-max.
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

constexpr int STRIP_W = 128;            // 4 warps, one column per lane
constexpr int STRIP_H = 32;             // rows a block walks down ...
constexpr int SHORT_H = 8;              // ... or where 32 leaves the card short of blocks
constexpr int THREADS = STRIP_W;
constexpr int RADIUS = 3;
constexpr int HALO = RADIUS + 1;        // circle radius + nonmax ring
constexpr int SW = STRIP_W + 2 * HALO;  // staged u8 strip pitch: 136
constexpr int WPR = SW / 4 + 1;         // aligned words that cover a staged row
constexpr int CW = STRIP_W + 2;         // score tile: strip + 1-px ring
constexpr unsigned FULL = 0xFFFFFFFFu;
static_assert(2 * (STRIP_H + 2) <= THREADS, "the ring columns' scores must fit the block");
static_assert(SW % 4 == 0, "staged rows start 4-byte aligned");
// Blocks that fill the H100 once: 132 SMs x 16 resident blocks of 128
// threads.  Fewer leave SMs idle and the rest latency-bound.
constexpr long long MIN_BLOCKS = 132 * 16;

enum Mode { OFF = 0, MAX_THRESHOLD = 1, SUM_ABSOLUTE = 2 };

// The 16 circle taps, clockwise from twelve o'clock (geometry.CIRCLE):
// (0,-3) (1,-3) (2,-2) (3,-1) (3,0) (3,1) (2,2) (1,3)
// (0,3) (-1,3) (-2,2) (-3,1) (-3,0) (-3,-1) (-2,-2) (-1,-3), as (dx, dy).
// The cardinal taps 0, 4, 8 and 12 are loaded by the caller.
__device__ __forceinline__ void load_taps(const uint8_t* s, int p[16]) {
  p[1] = s[-3 * SW + 1];
  p[2] = s[-2 * SW + 2];
  p[3] = s[-1 * SW + 3];
  p[5] = s[SW + 3];
  p[6] = s[2 * SW + 2];
  p[7] = s[3 * SW + 1];
  p[9] = s[3 * SW - 1];
  p[10] = s[2 * SW - 2];
  p[11] = s[SW - 3];
  p[13] = s[-SW - 3];
  p[14] = s[-2 * SW - 2];
  p[15] = s[-3 * SW - 1];
}

// The tap tests as sign bits, pushed into a register: push(acc, d) is
// (acc << 1) | (d >>> 31), one funnel shift.  With d = hi - p (negative iff
// p is bright) and d = p - lo (negative iff p is dark) pushed for taps 15
// down to 0, tap i's bright bit lands at 2i + 1 and its dark bit at 2i: the
// 16-tap ring fills 32 bits, so a 32-bit rotation by 2k rotates the ring by
// k taps for both polarities at once.
__device__ __forceinline__ unsigned push(unsigned acc, int d) {
  return __funnelshift_l(static_cast<unsigned>(d), acc, 1);
}

// Nonzero iff some wraparound window of N consecutive taps of the
// interleaved ring m is all bright or all dark.  Bit 2s (+1) of r8 is the
// AND over taps s..s+7, and a window of N (9..16) is the windows of 8 at s
// and at s + N - 8.
template <int N>
__device__ __forceinline__ unsigned runs(unsigned m) {
  const unsigned r2 = m & __funnelshift_r(m, m, 2);
  const unsigned r4 = r2 & __funnelshift_r(r2, r2, 4);
  const unsigned r8 = r4 & __funnelshift_r(r4, r4, 8);
  return r8 & __funnelshift_r(r8, r8, 2 * (N - 8));
}

// At least K (2 or 3) bits of m set.
template <int K>
__device__ __forceinline__ bool at_least(unsigned m) {
  const unsigned two = m & (m - 1);
  return (K == 2 ? two : two & (two - 1)) != 0;
}

// Max and min over w[0..15], by Hopper's 3-input DPX min/max.
__device__ __forceinline__ int max16(const int w[16]) {
  int m = __vimax3_s32(w[0], w[1], w[2]);
#pragma unroll
  for (int i = 3; i < 15; i += 2) m = __vimax3_s32(m, w[i], w[i + 1]);
  return max(m, w[15]);
}

__device__ __forceinline__ int min16(const int w[16]) {
  int m = __vimin3_s32(w[0], w[1], w[2]);
#pragma unroll
  for (int i = 3; i < 15; i += 2) m = __vimin3_s32(m, w[i], w[i + 1]);
  return min(m, w[15]);
}

// MaxThreshold score, d = c - p: min(|max_s min_window d|, |min_s max_window
// d|).  The window minima and maxima are exact and shared: windows of 3 by
// 3-input min/max, of 9 as three windows of 3, and of N (9..16) as the two
// windows of 9 at s and s + N - 9.
template <int N>
__device__ __forceinline__ int score_max_threshold(int c, const int p[16]) {
  int d[16], mn3[16], mx3[16], mn[16], mx[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = c - p[i];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    mn3[i] = __vimin3_s32(d[i], d[(i + 1) & 15], d[(i + 2) & 15]);
    mx3[i] = __vimax3_s32(d[i], d[(i + 1) & 15], d[(i + 2) & 15]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    mn[i] = __vimin3_s32(mn3[i], mn3[(i + 3) & 15], mn3[(i + 6) & 15]);
    mx[i] = __vimax3_s32(mx3[i], mx3[(i + 3) & 15], mx3[(i + 6) & 15]);
  }
  if (N > 9) {
    int a[16], b[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      a[i] = min(mn[i], mn[(i + N - 9) & 15]);
      b[i] = max(mx[i], mx[(i + N - 9) & 15]);
    }
    return min(abs(max16(a)), abs(min16(b)));
  }
  return min(abs(max16(mn)), abs(min16(mx)));
}

// SumAbsolute score, d = p - c (the opposite sign to MaxThreshold's):
// max(sum over d > t of (d - t), sum over -d > t of (-d - t)); d - t is
// p - hi and -d - t is lo - p, and each term is one DPX add-then-max.
__device__ __forceinline__ int score_sum_abs(const int p[16], int hi, int lo) {
  int light = 0, dark = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    light = __viaddmax_s32(light, p[i] - hi, light);
    dark = __viaddmax_s32(dark, lo - p[i], dark);
  }
  return max(light, dark);
}

// FAST at the staged pixel s, which the caller has found detectable (det):
// OFF gives 1 at an arc-test corner, MaxThreshold and SumAbsolute the
// corner's score; 0 elsewhere.  Bright p - c > t and dark c - p > t, both
// strict, in int32.  Every lane of the warp calls it (__any_sync).
template <int N, int MODE>
__device__ __forceinline__ int fast_at(const uint8_t* s, int t, bool det) {
  constexpr int NEED = N >= 12 ? 3 : 2;  // cardinal taps any run of N covers
  const int c = s[0], hi = c + t, lo = c - t;
  int p[16];
  p[0] = s[-3 * SW];
  p[4] = s[3];
  p[8] = s[3 * SW];
  p[12] = s[-3];
  const unsigned cb = push(push(push(push(0u, hi - p[0]), hi - p[4]), hi - p[8]), hi - p[12]);
  const unsigned cd = push(push(push(push(0u, p[0] - lo), p[4] - lo), p[8] - lo), p[12] - lo);
  const bool cand = det && (at_least<NEED>(cb) || at_least<NEED>(cd));
  if (!__any_sync(FULL, cand) || !cand) return 0;
  load_taps(s, p);
  unsigned ring = 0;
#pragma unroll
  for (int i = 15; i >= 0; --i) ring = push(push(ring, hi - p[i]), p[i] - lo);
  if (runs<N>(ring) == 0) return 0;
  if (MODE == OFF) return 1;
  if (MODE == MAX_THRESHOLD) return score_max_threshold<N>(c, p);
  return score_sum_abs(p, hi, lo);
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

// Stage buffer rows [b0 - HALO, b0 + rows + HALO) x columns [x0 - HALO,
// x0 + STRIP_W + HALO) of the frame `im` into `tile`, 0 outside the buffer
// (such pixels only feed pixels that are not detectable).  A thread loads
// one 4-byte-aligned word of a row at a time, whole where all its bytes lie
// in the row's columns [0, W), else byte by byte.
__device__ __forceinline__ void stage(uint8_t* tile, const uint8_t* im, int b0, int x0,
                                      int rows, int H, int W, int pitch) {
  for (int i = threadIdx.x; i < (rows + 2 * HALO) * WPR; i += THREADS) {
    const int ly = i / WPR, k = i - ly * WPR;
    const int y = b0 - HALO + ly;
    // Address of the staged row's column 0 (frame column x0 - HALO), which
    // may lie outside the buffer; only checked bytes are read.
    const intptr_t start = reinterpret_cast<intptr_t>(im) + static_cast<intptr_t>(y) * pitch +
                           (x0 - HALO);
    const intptr_t wa = (start & ~static_cast<intptr_t>(3)) + 4 * k;
    const int c0 = static_cast<int>(wa - start);  // staged column of the word's byte 0
    const int xw = x0 - HALO + c0;                // its frame column
    const bool row_in = y >= 0 && y < H;
    uint8_t* dst = tile + ly * SW;
    if (row_in && xw >= 0 && xw + 3 < W) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(wa);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j >= 0 && c0 + j < SW) dst[c0 + j] = static_cast<uint8_t>(v >> (8 * j));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c0 + j < 0 || c0 + j >= SW) continue;
        const bool in = row_in && xw + j >= 0 && xw + j < W;
        dst[c0 + j] = in ? *reinterpret_cast<const uint8_t*>(wa + j) : 0;
      }
    }
  }
}

// TILES selects the row-shard form: blockIdx.z is the shard, whose global
// first row the block reads from g.row0 (the counterpart of the TPU
// kernel's SMEM tile offset: per-shard data, so one launch serves every
// shard on a device), and the grid covers the shard's own rows, which lie
// g.skip rows into its slab.  Otherwise blockIdx.z is the frame.  A block
// walks ROWS (STRIP_H or SHORT_H, see launch) rows.
template <int N, int MODE, bool WORDS, bool TILES, int ROWS>
__global__ void __launch_bounds__(THREADS, MODE == OFF ? 16 : 8)
fast_kernel(const uint8_t* __restrict__ img, const Layout g, int t, int n_words,
            int32_t* __restrict__ words, uint16_t* __restrict__ mask_out,
            uint16_t* __restrict__ score_out) {
  __shared__ __align__(16) uint8_t tile[(ROWS + 2 * HALO) * SW];
  __shared__ uint16_t scores[MODE == OFF ? 1 : (ROWS + 2) * CW];

  const int tid = threadIdx.x, lane = tid & 31;
  const int x0 = blockIdx.x * STRIP_W, y0 = blockIdx.y * ROWS;
  const int b0 = y0 + g.skip;  // buffer row of the strip's first row
  const int H = g.in_h, W = g.w, out_h = g.out_h, height = g.height;
  const size_t frame = blockIdx.z;
  const uint8_t* im = img + frame * H * g.pitch;
  const int row_offset = TILES ? g.row0[frame] - g.skip : g.row_offset;
  const int x = x0 + tid;
  const int word = (x0 >> 5) + (tid >> 5);

  stage(tile, im, b0, x0, ROWS, H, W, g.pitch);
  __syncthreads();

  // Buffer row `by` may hold keypoints: the circle inside the buffer and
  // the global row in [3, height-4].
  auto row_ok = [&](int by) {
    const int gy = row_offset + by;
    return by >= RADIUS && by < H - RADIUS && gy >= RADIUS && gy < height - RADIUS;
  };
  const bool col_ok = x >= RADIUS && x < W - RADIUS;
  auto emit = [&](int r, bool keep, int score) {
    const size_t y = frame * out_h + y0 + r;
    if (WORDS) {
      const unsigned bits = __ballot_sync(FULL, keep);
      if (lane == 0 && word < n_words) words[y * n_words + word] = static_cast<int32_t>(bits);
    } else if (x < W) {
      mask_out[y * W + x] = keep;
      score_out[y * W + x] = static_cast<uint16_t>(score);
    }
  };
  const int rows = min(ROWS, out_h - y0);  // the same for the whole block

  if (MODE == OFF) {
    for (int r = 0; r < rows; ++r) {
      const bool det = col_ok && row_ok(b0 + r);
      emit(r, fast_at<N, OFF>(&tile[(r + HALO) * SW + tid + HALO], t, det) != 0, 0);
    }
    return;
  }

  // kp-masked scores of the strip plus its 1-px ring (score row i is strip
  // row i - 1, score column j is strip column j - 1): each lane its column,
  // rows -1..ROWS ...
  for (int r = -1; r <= ROWS; ++r) {
    const bool det = col_ok && row_ok(b0 + r);
    scores[(r + 1) * CW + tid + 1] = fast_at<N, MODE>(&tile[(r + HALO) * SW + tid + HALO], t, det);
  }
  // ... and the first whole warps the ring columns -1 and STRIP_W.
  const int ch = ROWS + 2, ring = 2 * ch;
  if (tid < ((ring + 31) & ~31)) {
    const int i = tid < ring ? tid : 0;
    const int lx = i < ch ? -1 : STRIP_W;
    const int r = (i < ch ? i : i - ch) - 1;
    const int xr = x0 + lx;
    const bool det = tid < ring && xr >= RADIUS && xr < W - RADIUS && row_ok(b0 + r);
    const int v = fast_at<N, MODE>(&tile[(r + HALO) * SW + lx + HALO], t, det);
    if (tid < ring) scores[(r + 1) * CW + lx + 1] = v;
  }
  __syncthreads();

  // Strict max over the 8 neighbours, down the column.  Every neighbour
  // score is >= 0, so score > neigh implies score > 0, which implies a
  // keypoint.
  const uint16_t* col = &scores[tid + 1];
  const int ul = col[-1], uc = col[0], ur = col[1];
  int up = max(max(ul, uc), ur);  // row -1, across
  int left = col[CW - 1], centre = col[CW], right = col[CW + 1];
  for (int r = 0; r < rows; ++r) {
    const uint16_t* next = col + (r + 2) * CW;
    const int nl = next[-1], nc = next[0], nr = next[1];
    const int neigh = max(max(up, max(max(nl, nc), nr)), max(left, right));
    const int gy = row_offset + b0 + r;
    emit(r, centre > neigh && gy != RADIUS && gy != height - RADIUS - 1, centre);
    up = max(max(left, centre), right);
    left = nl;
    centre = nc;
    right = nr;
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
  // Strips of 32 rows, or of 8 where 32 would leave the card short of
  // blocks (one frame, or a few shards).
  const int strips_x = (g.w + STRIP_W - 1) / STRIP_W;
  const bool tall = static_cast<long long>(strips_x) * ((g.out_h + STRIP_H - 1) / STRIP_H) * B >=
                    MIN_BLOCKS;
  const int sh = tall ? STRIP_H : SHORT_H;
  const dim3 grid(strips_x, (g.out_h + sh - 1) / sh, B);
  const int n_words = (g.w + 31) / 32;
  auto* in = static_cast<const uint8_t*>(img);
  auto* w = static_cast<int32_t*>(words);
  auto* m = static_cast<uint16_t*>(mask);
  auto* s = static_cast<uint16_t*>(score);
  auto st = static_cast<cudaStream_t>(stream);
  switch (count * 4 + mode) {
#define FDF_CASE(N, MODE)                                                      \
  case (N) * 4 + (MODE):                                                       \
    if (tall)                                                                  \
      fast_kernel<N, MODE, WORDS, TILES, STRIP_H><<<grid, THREADS, 0, st>>>(   \
          in, g, threshold, n_words, w, m, s);                                 \
    else                                                                       \
      fast_kernel<N, MODE, WORDS, TILES, SHORT_H><<<grid, THREADS, 0, st>>>(   \
          in, g, threshold, n_words, w, m, s);                                 \
    break;
#define FDF_COUNT_CASES(N) \
  FDF_CASE(N, OFF)         \
  FDF_CASE(N, MAX_THRESHOLD) \
  FDF_CASE(N, SUM_ABSOLUTE)
    FDF_COUNT_CASES(9)
    FDF_COUNT_CASES(10)
    FDF_COUNT_CASES(11)
    FDF_COUNT_CASES(12)
    FDF_COUNT_CASES(13)
    FDF_COUNT_CASES(14)
    FDF_COUNT_CASES(15)
    FDF_COUNT_CASES(16)
#undef FDF_COUNT_CASES
#undef FDF_CASE
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
