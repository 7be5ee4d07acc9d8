// Dense BRIEF-256 for Hopper (sm_90a): the 5x5 box sum and the 256 pattern
// compares of every pixel, packed into 8 int32 word planes, in one pass:
//
//   fdf_brief_words  (B, H, W) u8 -> (B, WORDS, H, W) int32
//
// Replaces the TPU kernel feature_detector_fast_tpu/ops/brief_pallas.py
// _kernel (:47, entry describe_words_padded :88).  Bit b of plane j at pixel
// p is blur(p + o1) < blur(p + o2) for PATTERN[32j + b] = (o1, o2), where
// blur(y, x) = S5x5(clamp(y, 2, H-3), clamp(x, 2, W-3)): models/brief.py's
// box_blur5, extended past the frame by the same clamp.  The plain PyTorch
// version is ops/brief_cuda.py describe_words_plain, and the two agree on
// every pixel; the JAX planes agree with both at least BORDER (18) from
// every edge, where the JAX package defines them.
//
// Design.  One thread per pixel; a block is 32 x 8 pixels and gridDim.z is
// the frame.  The block stages its u8 tile with a 17-px halo (pattern reach
// 15 + blur radius 2; 42 x 66 B, reads clamped into the frame) in shared
// memory, takes the vertical 5-sums at the clamped row centres (38 x 66
// int32), then the horizontal 5-sums at the clamped column centres: the
// blurred (8 + 30) x (32 + 30) region the tile's patterns reach (9.4 KB).
// The 256 pattern pairs sit in __constant__ memory as offsets into that
// region; every thread of a warp reads the same pair at the same time, so
// the constant cache broadcasts it.  A warp's 32 lanes then read 32
// consecutive shared words per sample (no bank conflicts) and store 32
// consecutive words per plane (one coalesced 128 B store).  The TPU
// kernel's lane rolls, shared-shift cache and 32-row tiles with clamped
// neighbour tiles answered VMEM layout and have no counterpart here.
//
// Bound.  Per pixel the kernel reads ~1.3 B of frame, writes 32 B of planes
// and does 512 shared-memory loads and 256 compares.  At (16, 1080, 1920)
// that is 1.06 GB written (~0.32 ms at 3.35 TB/s) against ~17 G shared
// loads (~2.4 ms at 32 loads per SM per clock on 132 SMs): it is bound by
// shared-memory load throughput, then by the plane stores.  Loading two
// samples per 64-bit load, or keeping a thread's column of the region in
// registers, is left for later work.

#include <cstdint>
#include <cstdlib>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 8;
constexpr int THREADS = TILE_W * TILE_H;
constexpr int BITS = 256;
constexpr int WORDS = BITS / 32;
constexpr int REACH = 15;            // pattern offsets lie in [-15, 15]
constexpr int HALO = REACH + 2;      // + the blur radius
constexpr int SW = TILE_W + 2 * HALO;   // staged u8 tile: 66 x 42
constexpr int SH = TILE_H + 2 * HALO;
constexpr int BW = TILE_W + 2 * REACH;  // blurred region: 62 x 38
constexpr int BH = TILE_H + 2 * REACH;

// Pair i: (offset of endpoint 1, offset of endpoint 2) in the blurred
// region, relative to the pixel's own cell: dy * BW + dx.
__constant__ int2 c_pairs[BITS];

__global__ void __launch_bounds__(THREADS)
brief_words_kernel(const uint8_t* __restrict__ img, int H, int W,
                   int32_t* __restrict__ planes) {
  __shared__ uint8_t tile[SH * SW];
  __shared__ int vsum[BH * SW];
  __shared__ int blur[BH * BW];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TILE_W + tx;
  const int x0 = blockIdx.x * TILE_W, y0 = blockIdx.y * TILE_H;
  const size_t frame = blockIdx.z;
  const uint8_t* im = img + frame * H * W;

  // tile[i][c] = frame pixel (y0 - HALO + i, x0 - HALO + c), clamped.
  for (int i = tid; i < SH * SW; i += THREADS) {
    const int y = min(max(y0 - HALO + i / SW, 0), H - 1);
    const int x = min(max(x0 - HALO + i % SW, 0), W - 1);
    tile[i] = im[(size_t)y * W + x];
  }
  __syncthreads();

  // vsum[r][c]: vertical 5-sum of tile column c centred at frame row
  // clamp(y0 - REACH + r, 2, H-3).  With H >= 5 every row it reads is a
  // frame row inside the staged tile.
  for (int i = tid; i < BH * SW; i += THREADS) {
    const int r = i / SW, c = i % SW;
    const int ly = min(max(y0 - REACH + r, 2), H - 3) - (y0 - HALO);
    const uint8_t* t = &tile[(ly - 2) * SW + c];
    vsum[i] = t[0] + t[SW] + t[2 * SW] + t[3 * SW] + t[4 * SW];
  }
  __syncthreads();

  // blur[r][c] = S5x5 centred at (clamp(y0 - REACH + r), clamp(x0 - REACH + c)).
  for (int i = tid; i < BH * BW; i += THREADS) {
    const int r = i / BW, c = i % BW;
    const int lx = min(max(x0 - REACH + c, 2), W - 3) - (x0 - HALO);
    const int* v = &vsum[r * SW + lx - 2];
    blur[i] = v[0] + v[1] + v[2] + v[3] + v[4];
  }
  __syncthreads();

  const int y = y0 + ty, x = x0 + tx;
  if (y >= H || x >= W) return;
  const int* centre = &blur[(ty + REACH) * BW + tx + REACH];
  const size_t plane = (size_t)H * W;
  int32_t* out = planes + frame * WORDS * plane + (size_t)y * W + x;
#pragma unroll
  for (int j = 0; j < WORDS; ++j) {
    unsigned word = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const int2 p = c_pairs[32 * j + b];
      word |= static_cast<unsigned>(centre[p.x] < centre[p.y]) << b;
    }
    out[j * plane] = static_cast<int32_t>(word);
  }
}

}  // namespace

extern "C" {

// Copies the (BITS, 2, 2) int32 (dx, dy) pattern into constant memory on
// `device`; synchronous.  Call once per device before fdf_brief_words.
int fdf_brief_set_pattern(const void* pattern, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int32_t* p = static_cast<const int32_t*>(pattern);
  int2 pairs[BITS];
  for (int i = 0; i < BITS; ++i) {
    const int x1 = p[4 * i], y1 = p[4 * i + 1], x2 = p[4 * i + 2], y2 = p[4 * i + 3];
    if (abs(x1) > REACH || abs(y1) > REACH || abs(x2) > REACH || abs(y2) > REACH)
      return cudaErrorInvalidValue;
    pairs[i] = make_int2(y1 * BW + x1, y2 * BW + x2);
  }
  return cudaMemcpyToSymbol(c_pairs, pairs, sizeof(pairs));
}

// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// after the launch (0 on success).
int fdf_brief_words(const void* img, void* planes, int B, int H, int W,
                    int device, void* stream) {
  if (B <= 0 || H < 5 || W < 5) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 block(TILE_W, TILE_H);
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  brief_words_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), H, W, static_cast<int32_t*>(planes));
  return cudaGetLastError();
}

const char* fdf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
