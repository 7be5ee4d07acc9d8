// The OFF-floor experiment kernels for Hopper (sm_90a): micro-benchmarks
// of the OFF words kernel fdf_fast_words (csrc/fast.cu), with six entry
// points:
//
//   fdf_off_floor_load        the floor stages of the OFF kernel, each
//   fdf_off_floor_triple      (B, H, ceil(W/32)) words
//   fdf_off_floor_prefilter
//   fdf_fast_words_prepacked  OFF words from a prepacked dual-row plane
//   fdf_swar_pred16           the 16-bit-field SWAR predicate sequence
//   fdf_swar_pred8            the 8-bit-field SWAR predicate sequence
//
// Replaces the Pallas kernels of the JAX package's TPU experiment tools:
// tools/exp_off_floor.py pallas-1in (:87, body k1 :81), pallas-3in (:105,
// body k3 :97) and pallas-win (:128, body kwin :119); tools/exp_off_prepack.py
// (:126, body kernel :73); tools/exp_off_byteswar.py (:107, bodies k16 :60
// and k8 :84).  The plain PyTorch versions are ops/exp_off.py;
// ops/exp_off_cuda.py checks arguments and launches.
//
// Design.  The floors and the prepacked kernel keep the grid and store
// fdf_fast_words had when they were written: a 32 x 8 block, the frame in
// gridDim.z, one thread per pixel, and a warp's __ballot_sync of the keep
// flags as the packed word, which lane 0 stores.  So each floor is that
// 32 x 8 kernel with stages taken away (fast.cu has since moved to
// 128-column strips, so the floors no longer split its time into stages):
//
//   LOAD       stages the block's own 32 x 8 u8 tile (no halo); keep = px & 1
//   TRIPLE     stages three 32 x 8 tiles, the block's and the ones `span`
//              rows above and below (block index clamped to the frame, rows
//              past the frame read 0); keep = (prev ^ cur ^ next) & 1
//   PREFILTER  stages the tile with fast.cu's 4-px halo and runs the
//              cardinal prefilter alone: keep = (>= need of the 4 cardinal
//              taps bright) or (>= need dark), strict int32 compares, 0
//              outside x in [3, W-4], y in [3, H-4]
//
// and the 32 x 8 kernel's OFF time minus PREFILTER is its arc test.  The TPU
// pallas-win kernel cannot run as written (one input for three in_specs, a
// (64, 128) value stored into a (128, 128) block, and an output that is 0
// everywhere); PREFILTER measures what it was meant to: the window build
// plus _swar_window_prefilter's cardinal test (fast_pallas.py:381-396).
//
// The prepacked kernel reads the TPU tool's plane, built outside the kernel
// (ops/exp_off.py prepack): per 128-row tile, 72 packed int32 rows whose
// low / high 16-bit fields hold frame rows 128 i + j - 3 and that + 64.  A
// block's 8 rows lie in one tile and one field, so it stages that field's
// bytes (14 rows and a 4-px halo) and runs the OFF arc test and the
// interior mask as fdf_fast_words does; the words equal fdf_fast_words OFF.
// The TPU kernel's MXU pack matmul and SWAR pixel pairs are not carried
// over: the ballot packs, and one thread tests one pixel.
//
// The predicate sequences are elementwise: one thread per int32 element,
// the op sequence kept exactly, since the sequence is what is measured.
// JAX's int32 adds wrap and its >> is arithmetic; signed overflow is
// undefined in C++, so the adds, subtractions and ~ run in uint32_t and
// each right shift is an arithmetic shift of the int32_t bit pattern.
//
// Bound.  LOAD and TRIPLE read 1 and 3 bytes a pixel and write 1/8: device
// memory bound (the floor of any kernel over the batch).  PREFILTER adds
// the halo staging (640 bytes a block instead of 256) and 8 compares a
// pixel.  The prepacked kernel reads 4 bytes a pixel pair (72/64 of it for
// the tile's halo rows) and runs fdf_fast_words' 32 compares a pixel, so it
// is integer-throughput bound as fdf_fast_words is.  The predicate
// sequences are integer-throughput bound: ~100 (16-bit) and ~330 (8-bit)
// 32-bit operations per element, against 16 bytes of traffic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 32;  // one warp per tile row: one ballot, one word
constexpr int TILE_H = 8;
constexpr int THREADS = TILE_W * TILE_H;
constexpr int RADIUS = 3;
constexpr int HALO = RADIUS + 1;  // fast.cu's halo: circle radius + nonmax ring
constexpr int SW = TILE_W + 2 * HALO;
constexpr int SH = TILE_H + 2 * HALO;

// The prepacked plane: rows per 128-row tile, and a field's centre rows.
constexpr int PACK_TILE = 128;
constexpr int PACK_HALF = PACK_TILE / 2;
constexpr int PACKED_ROWS = PACK_HALF + 2 * RADIUS + 2;

// ---- copied from fast.cu (no shared header: cuda_build keys a library by
// the hash of its one source) ------------------------------------------

// The 16 circle taps, clockwise from twelve o'clock (geometry.CIRCLE), at
// the staged pixel s of a tile with row pitch SW.
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
// have all bits set?
template <int N>
__device__ __forceinline__ bool any_run(unsigned m) {
  const unsigned m32 = m | (m << 16);
  unsigned r = m32;
#pragma unroll
  for (int k = 1; k < N; ++k) r &= m32 >> k;
  return (r & 0xFFFFu) != 0;
}

// Arc test at the staged pixel s: bright p - c > t, dark c - p > t.
template <int N>
__device__ __forceinline__ bool is_corner(const uint8_t* s, int t) {
  int p[16];
  load_taps(s, p);
  const int c = s[0];
  unsigned bright = 0, dark = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    bright |= static_cast<unsigned>(p[i] - c > t) << i;
    dark |= static_cast<unsigned>(c - p[i] > t) << i;
  }
  return any_run<N>(bright) || any_run<N>(dark);
}

// ---- the floors ----------------------------------------------------------

// The warp's ballot of the keep flags is the word of its 32 columns; lane 0
// stores it.
__device__ __forceinline__ void store_word(bool keep, int y, int H, int n_words,
                                           int32_t* __restrict__ words) {
  const unsigned word = __ballot_sync(0xFFFFFFFFu, keep);
  if (threadIdx.x == 0 && y < H)
    words[((size_t)blockIdx.z * H + y) * n_words + blockIdx.x] = static_cast<int32_t>(word);
}

__global__ void __launch_bounds__(THREADS)
floor_load_kernel(const uint8_t* __restrict__ img, int H, int W, int n_words,
                  int32_t* __restrict__ words) {
  __shared__ uint8_t tile[THREADS];
  const int tid = threadIdx.y * TILE_W + threadIdx.x;
  const int x = blockIdx.x * TILE_W + threadIdx.x, y = blockIdx.y * TILE_H + threadIdx.y;
  const uint8_t* im = img + (size_t)blockIdx.z * H * W;
  tile[tid] = (y < H && x < W) ? im[(size_t)y * W + x] : 0;
  __syncthreads();
  store_word(tile[tid] & 1, y, H, n_words, words);
}

// Row `span` rows from y in the direction d (-1 or +1): the same row of the
// neighbouring span-row block, the block index clamped to [0, n_blk).
__device__ __forceinline__ int triple_row(int y, int span, int n_blk, int d) {
  const int blk = min(max(y / span + d, 0), n_blk - 1);
  return blk * span + y % span;
}

__global__ void __launch_bounds__(THREADS)
floor_triple_kernel(const uint8_t* __restrict__ img, int H, int W, int n_words, int span,
                    int32_t* __restrict__ words) {
  __shared__ uint8_t tile[3 * THREADS];
  const int tid = threadIdx.y * TILE_W + threadIdx.x;
  const int x = blockIdx.x * TILE_W + threadIdx.x, y = blockIdx.y * TILE_H + threadIdx.y;
  const uint8_t* im = img + (size_t)blockIdx.z * H * W;
  const int n_blk = (H + span - 1) / span;
  const int rows[3] = {triple_row(y, span, n_blk, -1), y, triple_row(y, span, n_blk, 1)};
#pragma unroll
  for (int k = 0; k < 3; ++k)
    tile[k * THREADS + tid] = (rows[k] < H && x < W) ? im[(size_t)rows[k] * W + x] : 0;
  __syncthreads();
  store_word((tile[tid] ^ tile[THREADS + tid] ^ tile[2 * THREADS + tid]) & 1, y, H, n_words,
             words);
}

__global__ void __launch_bounds__(THREADS)
floor_prefilter_kernel(const uint8_t* __restrict__ img, int H, int W, int n_words, int t,
                       int need, int32_t* __restrict__ words) {
  __shared__ uint8_t tile[SH * SW];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TILE_W + tx;
  const int x0 = blockIdx.x * TILE_W, y0 = blockIdx.y * TILE_H;
  const int x = x0 + tx, y = y0 + ty;
  const uint8_t* im = img + (size_t)blockIdx.z * H * W;
  // fast.cu's staging loop: the tile and its 4-px halo, 0 outside.
  for (int i = tid; i < SH * SW; i += THREADS) {
    const int sy = y0 - HALO + i / SW, sx = x0 - HALO + i % SW;
    tile[i] = (sy >= 0 && sy < H && sx >= 0 && sx < W) ? im[(size_t)sy * W + sx] : 0;
  }
  __syncthreads();
  bool keep = false;
  if (x >= RADIUS && x < W - RADIUS && y >= RADIUS && y < H - RADIUS) {
    const uint8_t* s = &tile[(ty + HALO) * SW + tx + HALO];
    const int c = s[0];
    const int card[4] = {s[-3 * SW], s[3], s[3 * SW], s[-3]};  // N, E, S, W
    int nb = 0, nd = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      nb += card[k] - c > t;
      nd += c - card[k] > t;
    }
    keep = nb >= need || nd >= need;
  }
  store_word(keep, y, H, n_words, words);
}

// ---- OFF words from the prepacked plane ----------------------------------

template <int N>
__global__ void __launch_bounds__(THREADS)
prepacked_kernel(const int32_t* __restrict__ plane, int n_rows, int pitch, int H,
                 int W, int n_words, int t, int32_t* __restrict__ words) {
  __shared__ uint8_t tile[SH * SW];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TILE_W + tx;
  const int x0 = blockIdx.x * TILE_W, y0 = blockIdx.y * TILE_H;
  const size_t frame = blockIdx.z;
  // The block's 8 rows share a tile and a field (8 divides 64): packed row
  // j0 of that field holds row y0 as a circle centre.
  const int ti = y0 / PACK_TILE, shift = 16 * ((y0 % PACK_TILE) / PACK_HALF);
  const int j0 = y0 % PACK_HALF + RADIUS;
  const int32_t* pl = plane + (frame * n_rows + (size_t)ti * PACKED_ROWS) * pitch;

  for (int i = tid; i < SH * SW; i += THREADS) {
    const int j = j0 - HALO + i / SW, sx = x0 - HALO + i % SW;
    tile[i] = (j >= 0 && j < PACKED_ROWS && sx >= 0 && sx < pitch)
                  ? static_cast<uint8_t>(pl[(size_t)j * pitch + sx] >> shift)
                  : 0;
  }
  __syncthreads();

  const int x = x0 + tx, y = y0 + ty;
  bool keep = false;
  if (x >= RADIUS && x < W - RADIUS && y >= RADIUS && y < H - RADIUS)
    keep = is_corner<N>(&tile[(ty + HALO) * SW + tx + HALO], t);
  store_word(keep, y, H, n_words, words);
}

// ---- the SWAR predicate sequences ------------------------------------------

constexpr uint32_t FF = 0x00010001u;
constexpr uint32_t M9 = 0x200u * FF;
constexpr uint32_t H8 = 0x80808080u;
constexpr uint32_t L7 = 0x7F7F7F7Fu;
constexpr int TAPS = 16;

// JAX's >> on int32: an arithmetic shift of the bit pattern.
__device__ __forceinline__ uint32_t sar(uint32_t v, int s) {
  return static_cast<uint32_t>(static_cast<int32_t>(v) >> s);
}

__global__ void pred16_kernel(const int32_t* __restrict__ xs, const int32_t* __restrict__ hbs,
                              const int32_t* __restrict__ cws, int32_t* __restrict__ out,
                              long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t p = xs[i];
  const uint32_t hb = hbs[i], cw = cws[i];
  uint32_t bright = 0, dark = 0;
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
    const uint32_t q = p + hb, r = cw - p;
    const int s = 9 - k;
    uint32_t b, d;
    if (s > 0) {
      b = sar(q, s) & (FF << k);
      d = sar(r, s) & (FF << k);
    } else if (s == 0) {
      b = q & M9;
      d = r & M9;
    } else {
      b = (q << -s) & (FF << k);
      d = (r << -s) & (FF << k);
    }
    bright |= b;
    dark |= d;
    p += 1u;
  }
  out[i] = static_cast<int32_t>(bright ^ dark);
}

__global__ void pred8_kernel(const int32_t* __restrict__ xs, const int32_t* __restrict__ his,
                             const int32_t* __restrict__ los, int32_t* __restrict__ out,
                             long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t p = xs[i];
  const uint32_t hi = his[i], lo = los[i];
  uint32_t planes[2] = {0, 0};
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      // bright: hi < p; dark: p < lo (bytewise, unsigned)
      const uint32_t a = which == 0 ? hi : p, b = which == 0 ? p : lo;
      const uint32_t w = ((a & L7) | H8) - (b & L7);
      const uint32_t r = ((~a & b) | (~(a ^ b) & ~w)) & H8;
      const int s = 7 - (k % 8);
      const uint32_t bit = s ? sar(r, s) & (0x01010101u << (k % 8)) : r;
      planes[k / 8] |= bit;
    }
    p += 0x01010101u;
  }
  out[i] = static_cast<int32_t>(planes[0] ^ planes[1]);
}

constexpr int ELEMENTWISE_THREADS = 256;

// The 8-bit (BYTES) or 16-bit predicate kernel over n elements.
template <bool BYTES>
int elementwise(const void* a, const void* b, const void* c, void* out, long long n,
                int device, void* stream) {
  if (n <= 0 || (n + ELEMENTWISE_THREADS - 1) / ELEMENTWISE_THREADS > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>((n + ELEMENTWISE_THREADS - 1) / ELEMENTWISE_THREADS);
  auto* pa = static_cast<const int32_t*>(a);
  auto* pb = static_cast<const int32_t*>(b);
  auto* pc = static_cast<const int32_t*>(c);
  auto* po = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if constexpr (BYTES)
    pred8_kernel<<<blocks, ELEMENTWISE_THREADS, 0, st>>>(pa, pb, pc, po, n);
  else
    pred16_kernel<<<blocks, ELEMENTWISE_THREADS, 0, st>>>(pa, pb, pc, po, n);
  return cudaGetLastError();
}

// A floor kernel over the (B, H, W) batch: one 32 x 8 block per tile.
template <typename Launch>
int launch_floor(int B, int H, int W, int device, Launch launch) {
  if (B <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  launch(grid, dim3(TILE_W, TILE_H));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point launches on `stream`, does not synchronise, and
// returns cudaGetLastError() after the launch (0 on success).

// The floors: img (B, H, W) u8 -> words (B, H, ceil(W/32)) int32.
int fdf_off_floor_load(const void* img, void* words, int B, int H, int W, int device,
                       void* stream) {
  return launch_floor(B, H, W, device, [&](dim3 grid, dim3 block) {
    floor_load_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(img), H, W, grid.x, static_cast<int32_t*>(words));
  });
}

int fdf_off_floor_triple(const void* img, void* words, int B, int H, int W, int span,
                         int device, void* stream) {
  if (span <= 0) return cudaErrorInvalidValue;
  return launch_floor(B, H, W, device, [&](dim3 grid, dim3 block) {
    floor_triple_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(img), H, W, grid.x, span, static_cast<int32_t*>(words));
  });
}

// `need` (2 or 3): cardinal taps one polarity must pass.
int fdf_off_floor_prefilter(const void* img, void* words, int B, int H, int W, int threshold,
                            int need, int device, void* stream) {
  if (threshold < 0 || threshold > 255 || need < 0 || need > 4) return cudaErrorInvalidValue;
  return launch_floor(B, H, W, device, [&](dim3 grid, dim3 block) {
    floor_prefilter_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(img), H, W, grid.x, threshold, need,
        static_cast<int32_t*>(words));
  });
}

// plane (B, n_rows, pitch) int32, n_rows = n_tiles * 72, of frames H x W
// with H <= n_tiles * 128 and W <= pitch -> words (B, H, ceil(W/32)).
int fdf_fast_words_prepacked(const void* plane, void* words, int B, int n_rows, int pitch,
                             int H, int W, int threshold, int count, int device,
                             void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || n_rows <= 0 || n_rows % PACKED_ROWS != 0 ||
      H > n_rows / PACKED_ROWS * PACK_TILE || W > pitch || threshold < 0 || threshold > 255)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 block(TILE_W, TILE_H);
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  auto* in = static_cast<const int32_t*>(plane);
  auto* out = static_cast<int32_t*>(words);
  auto st = static_cast<cudaStream_t>(stream);
  switch (count) {
#define FDF_COUNT_CASE(N)                                                                 \
  case N:                                                                                 \
    prepacked_kernel<N><<<grid, block, 0, st>>>(in, n_rows, pitch, H, W, grid.x, threshold, \
                                                out);                                     \
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

// x, hb, cw: n int32 each -> out: n int32.
int fdf_swar_pred16(const void* x, const void* hb, const void* cw, void* out, long long n,
                    int device, void* stream) {
  return elementwise<false>(x, hb, cw, out, n, device, stream);
}

// x, hi, lo: n int32 each -> out: n int32.
int fdf_swar_pred8(const void* x, const void* hi, const void* lo, void* out, long long n,
                   int device, void* stream) {
  return elementwise<true>(x, hi, lo, out, n, device, stream);
}

const char* fdf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
