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
// Two designs.  LOAD and TRIPLE are streaming kernels (namespace stream
// below): no shared memory and no ballot.  A thread makes one output word
// at a time, a warp 32 consecutive words (128 contiguous bytes of output),
// and each word is packed from its 32 bytes in registers: for each 4 bytes
// v, ((v & 0x01010101) * 0x01020408) >> 24 is their 4 low bits in column
// order.  Where W % 16 == 0 and the batch starts 16-byte aligned, a warp's
// words are one contiguous run of at most 64 16-byte chunks: lane i loads
// chunks i and i + 32 (512 contiguous bytes a load), packs each to 16 bits,
// and the words gather their halves by warp shuffles.  Any other width or
// base takes element loads, the ragged last word zero-filled.
//
//   LOAD       keep = px & 1: the batch as one run of words, warps striding
//              over it
//   TRIPLE     keep = (prev ^ cur ^ next) & 1, prev / next the same row of
//              the neighbouring span-row block (block index clamped to the
//              frame, rows past the frame read 0).  A warp holds 32 words of
//              the rows [0, min(span, H)) and walks them down the frame, one
//              span-row block a step, keeping the packed words of the
//              previous, current and next block in registers and the next
//              two blocks' loads in flight: each input byte is read from
//              device memory once.  Where the chains would leave the card
//              short of warps (small spans, few frames), each is cut into
//              segments that re-read one block at each end.
//
// PREFILTER and the prepacked kernel share fdf_fast_words' skeleton as it
// stands (namespace strip below): a block of 4 warps walks a 128-column
// strip of 32 rows (8 where 32 would leave the card short of blocks), one
// column per lane, staged once with the strip's 4-px halo; a warp's ballot
// is the packed word.  Their device functions are fast.cu's, copied
// verbatim (cuda_build keys a library by the hash of its one source, so an
// #include would leave a stale build; tests/test_torch_exp_off.py holds the
// copies to fast.cu's text):
//
//   PREFILTER  fdf_fast_words OFF with the arc test taken out: the cardinal
//              prefilter alone, keep = (>= need of the 4 cardinal taps
//              bright) or (>= need dark), strict int32 compares, 0 outside
//              x in [3, W-4], y in [3, H-4].  So fdf_fast_words OFF minus
//              PREFILTER is its arc test with the warp's row skip.
//   PREPACKED  fdf_fast_words OFF (prefilter, row skip, arc test) on the
//              TPU tool's plane, built outside the kernel (ops/exp_off.py
//              prepack): per 128-row tile, 72 packed int32 rows whose low /
//              high 16-bit fields hold frame rows 128 i + j - 3 and that +
//              64.  A block covers one strip of both fields of a tile: it
//              stages the strip's packed rows once (16-byte loads where the
//              pitch and base allow) and splits the low byte of each field
//              into two u8 tiles, so each plane byte is read once, plus the
//              halo.  The words equal fdf_fast_words OFF.
//
// The TPU pallas-win kernel cannot run as written (one input for three
// in_specs, a (64, 128) value stored into a (128, 128) block, and an output
// that is 0 everywhere); PREFILTER measures what it was meant to: the
// window build plus _swar_window_prefilter's cardinal test
// (fast_pallas.py:381-396).  The TPU prepacked kernel's MXU pack matmul and
// SWAR pixel pairs are not carried over: the ballot packs, and one lane
// tests one pixel.
//
// The predicate sequences are elementwise: one thread per int32 element,
// the op sequence kept exactly, since the sequence is what is measured.
// JAX's int32 adds wrap and its >> is arithmetic; signed overflow is
// undefined in C++, so the adds, subtractions and ~ run in uint32_t and
// each right shift is an arithmetic shift of the int32_t bit pattern.
//
// Bound.  LOAD and TRIPLE read each byte of the batch once and write 1/8 of
// a byte a pixel: device-memory bound, the floor of any kernel over the
// batch (0.0111 ms at (16, 1080, 1920)); their few operations a byte (the
// multiply pack, the shuffles) stay under it.  PREFILTER does
// the cardinal prefilter's 17 operations at every pixel: integer-throughput
// bound (0.034 ms at (16, 1080, 1920)).  The prepacked kernel does the work
// of fdf_fast_words OFF on the same frames (the prefilter at every pixel,
// the arc test where it passes) and reads the 2.4x larger plane: still
// bound by its operations (tools/_common.py words_prepacked_bound).  The
// predicate sequences are integer-throughput bound: ~100 (16-bit) and ~330
// (8-bit) 32-bit operations per element, against 16 bytes of traffic.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RADIUS = 3;
constexpr int HALO = RADIUS + 1;  // fast.cu's halo: circle radius + nonmax ring

// The prepacked plane: rows per 128-row tile, and a field's centre rows.
constexpr int PACK_TILE = 128;
constexpr int PACK_HALF = PACK_TILE / 2;
constexpr int PACKED_ROWS = PACK_HALF + 2 * RADIUS + 2;

// ---- the streaming floors: LOAD and TRIPLE ---------------------------------

namespace stream {

constexpr int BLOCK = 256;  // threads a block
constexpr int WARPS = BLOCK / 32;
constexpr int LOAD_RESIDENT = 8;    // blocks an SM: 2048 threads
constexpr int TRIPLE_RESIDENT = 4;  // 1024 threads, for the walk's registers
// TRIPLE's chains are cut into segments, none shorter than MIN_STEPS
// blocks, where they would give the H100 fewer than 512 threads an SM
// (span 128 over 16 frames of 1080p gives ~930, and runs uncut: cutting it
// re-reads 2 of 9 blocks).
constexpr long long FILL_WARPS = 132LL * 512 / 32;
constexpr int MIN_STEPS = 4;
constexpr unsigned ALL = 0xFFFFFFFFu;

// The low bits of 4 bytes, byte j to bit j: the multiply moves bit 8j of
// v & 0x01010101 to bit 24 + j, and its other partial products land on
// distinct bits below 24, so nothing carries.
__device__ __forceinline__ uint32_t low_bits4(uint32_t v) {
  return ((v & 0x01010101u) * 0x01020408u) >> 24;
}

// The low bits of a 16-byte chunk, byte j to bit j.
__device__ __forceinline__ uint32_t low_bits16(uint4 q) {
  return low_bits4(q.x) | low_bits4(q.y) << 4 | low_bits4(q.z) << 8 | low_bits4(q.w) << 12;
}

// A run of whole rows of W bytes from `base`, its words numbered row by row
// from 0: word t is columns [32 c, 32 c + 32) of row t / nw, c = t % nw,
// zero past the row's end.  A warp takes n (1..32) consecutive words t0 ..
// t0 + n - 1 at a time, lane i word t0 + i; lanes i >= n make 0.  span(t0)
// places the warp's words (the same for every run of the same rows),
// fetch() issues their loads and word() packs what the loads brought; each
// is called by the whole warp.

// Element loads, for any width and base: word() loads the lane's bytes.
struct ByteWords {
  int W, nw;
  struct Span { long long t0; };
  struct Raw {};

  __device__ __forceinline__ Span span(long long t0) const { return {t0}; }
  __device__ __forceinline__ Raw fetch(const uint8_t*, const Span&, int) const { return {}; }
  __device__ __forceinline__ uint32_t word(const uint8_t* base, const Span& sp, int n,
                                           const Raw&) const {
    const int lane = threadIdx.x & 31;
    if (lane >= n) return 0;
    const long long t = sp.t0 + lane, r = t / nw;
    const int c = static_cast<int>(t - r * nw), m = min(32, W - 32 * c);
    const uint8_t* p = base + r * W + 32 * c;
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (i < m) w |= static_cast<uint32_t>(p[i] & 1) << i;
    return w;
  }
};

// 16-byte loads, where W % 16 == 0 and the run starts 16-byte aligned: a
// row is cw = W / 16 whole chunks, so a warp's words are the chunks
// [first, first + e] of the run, e < 64.  Lane i loads chunks first + i and
// first + 32 + i (each load instruction 512 contiguous bytes) and packs them
// to the low and high halves of one register; a word gathers its two
// halves (one where a row of odd cw ends) from the lanes that hold them.
struct ChunkWords {
  int nw, cw;
  // The chunk of the warp's first word (first); this lane's word's first
  // chunk, counted from there (s); whether the word has a second chunk.
  struct Span { long long first; int s; bool two; };
  struct Raw { uint4 a, b; };

  __device__ __forceinline__ Span span(long long t0) const {
    const int lane = threadIdx.x & 31;
    if ((cw & 1) == 0) return {2 * t0, 2 * lane, true};
    const long long t = t0 + lane, r = t / nw;
    const int c = static_cast<int>(t - r * nw);
    const long long f = r * cw + 2 * c;
    const long long first = __shfl_sync(ALL, f, 0);
    return {first, static_cast<int>(f - first), 2 * c + 1 < cw};
  }
  __device__ __forceinline__ Raw fetch(const uint8_t* base, const Span& sp, int n) const {
    const int lane = threadIdx.x & 31;
    const int e = __shfl_sync(ALL, sp.s + sp.two, n - 1);  // the last word's last chunk
    const uint4* p = reinterpret_cast<const uint4*>(base) + sp.first + lane;
    Raw q = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
    if (lane <= e) q.a = __ldg(p);
    if (lane + 32 <= e) q.b = __ldg(p + 32);
    return q;
  }
  __device__ __forceinline__ uint32_t word(const uint8_t*, const Span& sp, int n,
                                           const Raw& q) const {
    // Chunk j (0..63 from first) sits in lane j % 32, in the low half for j < 32.
    const uint32_t v = low_bits16(q.a) | low_bits16(q.b) << 16;
    const int s = sp.s;
    const uint32_t a = __shfl_sync(ALL, v, s & 31), b = __shfl_sync(ALL, v, (s + 1) & 31);
    const uint32_t lo = s < 32 ? a & 0xFFFFu : a >> 16;
    const uint32_t hi = !sp.two ? 0u : s + 1 < 32 ? b << 16 : b & 0xFFFF0000u;
    return (threadIdx.x & 31) < n ? lo | hi : 0u;
  }
};

// LOAD: the batch is one run of n_words words; warps stride over it, 32
// words at a time.
template <class Words>
__global__ void __launch_bounds__(BLOCK, LOAD_RESIDENT)
load_kernel(const uint8_t* __restrict__ img, long long n_words, Words of,
            int32_t* __restrict__ words) {
  const int lane = threadIdx.x & 31;
  const long long stride = 32LL * WARPS * gridDim.x;
  for (long long t0 = 32 * (static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32);
       t0 < n_words; t0 += stride) {
    const int n = static_cast<int>(min(32LL, n_words - t0));
    const typename Words::Span sp = of.span(t0);
    const uint32_t w = of.word(img, sp, n, of.fetch(img, sp, n));
    if (lane < n) words[t0 + lane] = static_cast<int32_t>(w);
  }
}

// TRIPLE: warp g holds words [t0, t0 + 32) of the rows [0, min(span, H)) of
// one frame, the same words of every span-row block k (rows k span + r),
// and walks blocks [k0, k1) of its segment of the chain.  Block k's word
// is prev ^ cur ^ next of the packed words of blocks k - 1, k and k + 1:
// block 0's prev and the last block's next are the block itself, and a row
// of block k + 1 past H packs to 0.  The loads run two blocks ahead.
template <class Words>
__global__ void __launch_bounds__(BLOCK, TRIPLE_RESIDENT)
triple_kernel(const uint8_t* __restrict__ img, int H, int W, int nw, int span, int n_blk,
              int frame_warps, int n_seg, int seg_steps, long long n_warps, Words of,
              int32_t* __restrict__ words) {
  using Raw = typename Words::Raw;
  const long long g = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (g >= n_warps) return;
  const int lane = threadIdx.x & 31;
  const int t0 = 32 * static_cast<int>(g % frame_warps);
  const long long chain = g / frame_warps, b = chain / n_seg;
  const int k0 = static_cast<int>(chain % n_seg) * seg_steps, k1 = min(k0 + seg_steps, n_blk);
  const int kn = min(k1, n_blk - 1);  // the last block the segment reads
  const uint8_t* frame = img + static_cast<size_t>(b) * H * W;
  int32_t* out = words + static_cast<size_t>(b) * H * nw + t0 + lane;
  const typename Words::Span sp = of.span(t0);

  // Words of block k this warp holds (<= 0 past the frame).
  auto held = [&](int k) { return min(32, min(span, H - k * span) * nw - t0); };
  auto base = [&](int k) { return frame + static_cast<size_t>(k) * span * W; };
  auto fetch = [&](int k) {
    const int n = held(k);
    return n > 0 ? of.fetch(base(k), sp, n) : Raw{};
  };
  auto word = [&](int k, const Raw& q) {
    const int n = held(k);
    return n > 0 ? of.word(base(k), sp, n, q) : 0u;
  };

  const Raw qp = k0 > 0 ? fetch(k0 - 1) : Raw{};
  const Raw qc = fetch(k0);
  Raw qn = k0 + 1 <= kn ? fetch(k0 + 1) : Raw{};
  uint32_t cur = word(k0, qc);
  uint32_t prev = k0 > 0 ? word(k0 - 1, qp) : cur;
  for (int k = k0; k < k1; ++k) {
    const Raw ahead = k + 2 <= kn ? fetch(k + 2) : Raw{};
    const uint32_t next = k + 1 < n_blk ? word(k + 1, qn) : cur;
    if (lane < held(k))
      out[static_cast<size_t>(k) * span * nw] = static_cast<int32_t>(prev ^ cur ^ next);
    prev = cur;
    cur = next;
    qn = ahead;
  }
}

// 16-byte loads where every row starts 16-byte aligned.
inline bool chunked(const uint8_t* img, int W) {
  return W % 16 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0;
}

int launch_load(const uint8_t* img, int32_t* words, int B, int H, int W, cudaStream_t st) {
  const int nw = (W + 31) / 32;
  const long long n_words = static_cast<long long>(B) * H * nw;
  const auto blocks = static_cast<unsigned>(
      std::min((n_words + 32 * WARPS - 1) / (32 * WARPS), 0x7FFFFFFFLL));
  auto go = [&](auto of) { load_kernel<<<blocks, BLOCK, 0, st>>>(img, n_words, of, words); };
  if (chunked(img, W))
    go(ChunkWords{nw, W / 16});
  else
    go(ByteWords{W, nw});
  return cudaGetLastError();
}

int launch_triple(const uint8_t* img, int32_t* words, int B, int H, int W, int span,
                  cudaStream_t st) {
  const int nw = (W + 31) / 32;
  const int n_blk = static_cast<int>((H + static_cast<long long>(span) - 1) / span);
  const int frame_warps = (std::min(span, H) * nw + 31) / 32;
  const long long chains = static_cast<long long>(B) * frame_warps;
  // Segments: enough chains to fill the card, none under MIN_STEPS blocks.
  const long long cuts = std::max(1LL, std::min((FILL_WARPS + chains - 1) / chains,
                                                (n_blk + MIN_STEPS - 1LL) / MIN_STEPS));
  const int seg_steps = static_cast<int>((n_blk + cuts - 1) / cuts);
  const int n_seg = (n_blk + seg_steps - 1) / seg_steps;
  const long long n_warps = chains * n_seg;
  const long long blocks = (n_warps + WARPS - 1) / WARPS;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  auto go = [&](auto of) {
    triple_kernel<<<static_cast<unsigned>(blocks), BLOCK, 0, st>>>(
        img, H, W, nw, span, n_blk, frame_warps, n_seg, seg_steps, n_warps, of, words);
  };
  if (chunked(img, W))
    go(ChunkWords{nw, W / 16});
  else
    go(ByteWords{W, nw});
  return cudaGetLastError();
}

}  // namespace stream

// ---- the strip kernels: fdf_fast_words' skeleton --------------------------

namespace strip {

constexpr int STRIP_W = 128;            // 4 warps, one column per lane
constexpr int STRIP_H = 32;             // rows a block walks down ...
constexpr int SHORT_H = 8;              // ... or where 32 leaves the card short of blocks
constexpr int THREADS = STRIP_W;
constexpr int SW = STRIP_W + 2 * HALO;  // staged u8 strip pitch: 136
constexpr int WPR = SW / 4 + 1;         // aligned words that cover a staged row
constexpr int CHUNKS = SW / 4;          // 16-byte int32 chunks of a staged packed row
constexpr unsigned FULL = 0xFFFFFFFFu;
static_assert(SW % 4 == 0, "staged rows start 4-byte aligned");
static_assert(PACK_HALF % STRIP_H == 0, "a field's rows are whole strips");
// Blocks that fill the H100 once: 132 SMs x 16 resident blocks of 128
// threads (fast.cu's rule).
constexpr long long MIN_BLOCKS = 132 * 16;

// ---- copied verbatim from fast.cu ----------------------------------------

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

// ---- fast.cu's fast_at<N, OFF>, in two halves ------------------------------

// The cardinal prefilter at the staged pixel s (fast_at's first half): taps
// 0, 4, 8 and 12 into p; at least NEED of them bright (p > hi) or NEED dark
// (p < lo), each test a sign bit pushed into a register.
template <int NEED>
__device__ __forceinline__ bool cardinal(const uint8_t* s, int hi, int lo, int p[16]) {
  p[0] = s[-3 * SW];
  p[4] = s[3];
  p[8] = s[3 * SW];
  p[12] = s[-3];
  const unsigned cb = push(push(push(push(0u, hi - p[0]), hi - p[4]), hi - p[8]), hi - p[12]);
  const unsigned cd = push(push(push(push(0u, p[0] - lo), p[4] - lo), p[8] - lo), p[12] - lo);
  return at_least<NEED>(cb) || at_least<NEED>(cd);
}

// An OFF keypoint at the staged pixel s, which the caller has found
// detectable (det): the cardinal prefilter, the warp's skip of a row where
// no lane passes it (every lane of the warp calls this), then the 16 taps'
// sign bits in one interleaved ring and the run test.
template <int N>
__device__ __forceinline__ bool corner_at(const uint8_t* s, int t, bool det) {
  constexpr int NEED = N >= 12 ? 3 : 2;  // cardinal taps any run of N covers
  const int c = s[0], hi = c + t, lo = c - t;
  int p[16];
  const bool cand = det && cardinal<NEED>(s, hi, lo, p);
  if (!__any_sync(FULL, cand) || !cand) return false;
  load_taps(s, p);
  unsigned ring = 0;
#pragma unroll
  for (int i = 15; i >= 0; --i) ring = push(push(ring, hi - p[i]), p[i] - lo);
  return runs<N>(ring) != 0;
}

// The warp's ballot of the keep flags is the word of its 32 columns in
// output row `row` (frame * H + y); lane 0 stores it.
__device__ __forceinline__ void emit(bool keep, size_t row, int word, int n_words,
                                     int32_t* __restrict__ words) {
  const unsigned bits = __ballot_sync(FULL, keep);
  if ((threadIdx.x & 31) == 0 && word < n_words)
    words[row * n_words + word] = static_cast<int32_t>(bits);
}

// PREFILTER: a block walks ROWS rows of a 128-column strip of frame
// blockIdx.z.
template <int NEED, int ROWS>
__global__ void __launch_bounds__(THREADS, 16)
prefilter_kernel(const uint8_t* __restrict__ img, int H, int W, int n_words, int t,
                 int32_t* __restrict__ words) {
  __shared__ __align__(16) uint8_t tile[(ROWS + 2 * HALO) * SW];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * STRIP_W, y0 = blockIdx.y * ROWS;
  const size_t frame = blockIdx.z;
  const int x = x0 + tid, word = (x0 >> 5) + (tid >> 5);

  stage(tile, img + frame * H * W, y0, x0, ROWS, H, W, W);
  __syncthreads();

  const bool col_ok = x >= RADIUS && x < W - RADIUS;
  const int rows = min(ROWS, H - y0);
  for (int r = 0; r < rows; ++r) {
    const int y = y0 + r;
    const uint8_t* s = &tile[(r + HALO) * SW + tid + HALO];
    const int c = s[0];
    int p[16];
    const bool det = col_ok && y >= RADIUS && y < H - RADIUS;
    emit(det && cardinal<NEED>(s, c + t, c - t, p), frame * H + y, word, n_words, words);
  }
}

// PREPACKED: a block covers centre rows [r0, r0 + ROWS) of both fields of
// one 128-row tile of the plane (frame rows 128 ti + r0 + r and that + 64),
// over a 128-column strip.  It stages packed rows [r0 + RADIUS - HALO,
// r0 + RADIUS + ROWS + HALO) of the tile, columns [x0 - HALO, x0 + STRIP_W
// + HALO), 0 outside the tile's rows and the plane's columns: as 16-byte
// chunks where `vec` (pitch a multiple of 4 and a 16-byte aligned base, so
// every chunk lies wholly inside or outside the columns), else element by
// element.  The low byte of each field goes to its u8 tile.
template <int N, int ROWS>
__global__ void __launch_bounds__(THREADS, 16)
prepacked_kernel(const int32_t* __restrict__ plane, int n_rows, int pitch, int H, int W,
                 int n_words, int t, bool vec, int32_t* __restrict__ words) {
  constexpr int SR = ROWS + 2 * HALO;        // staged packed rows
  constexpr int STRIPS = PACK_HALF / ROWS;   // strips in a field's 64 centre rows
  __shared__ __align__(16) uint8_t tile[2][SR * SW];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * STRIP_W;
  const int ti = blockIdx.y / STRIPS, r0 = blockIdx.y % STRIPS * ROWS;
  const int y0 = ti * PACK_TILE + r0;  // frame row of field 0's first centre row
  if (y0 >= H) return;                 // both fields lie past the frame
  const size_t frame = blockIdx.z;
  const int32_t* pl = plane + (frame * n_rows + static_cast<size_t>(ti) * PACKED_ROWS) * pitch;

  for (int i = tid; i < SR * CHUNKS; i += THREADS) {
    const int ly = i / CHUNKS, k = i - ly * CHUNKS;
    const int j = r0 + RADIUS - HALO + ly;  // packed row
    const int c = x0 - HALO + 4 * k;        // plane column of the chunk's first element
    const bool row_in = j >= 0 && j < PACKED_ROWS;
    const int32_t* src = pl + static_cast<ptrdiff_t>(j) * pitch;
    int4 q = make_int4(0, 0, 0, 0);
    if (vec) {
      if (row_in && c >= 0 && c < pitch) q = *reinterpret_cast<const int4*>(src + c);
    } else if (row_in) {
      q.x = c >= 0 && c < pitch ? src[c] : 0;
      q.y = c + 1 >= 0 && c + 1 < pitch ? src[c + 1] : 0;
      q.z = c + 2 >= 0 && c + 2 < pitch ? src[c + 2] : 0;
      q.w = c + 3 >= 0 && c + 3 < pitch ? src[c + 3] : 0;
    }
    // bytes 0 and 2 of each element: [x0 y0 x2 y2], [z0 w0 z2 w2]
    const unsigned a = __byte_perm(q.x, q.y, 0x6240), b = __byte_perm(q.z, q.w, 0x6240);
    *reinterpret_cast<uint32_t*>(&tile[0][ly * SW + 4 * k]) = __byte_perm(a, b, 0x5410);
    *reinterpret_cast<uint32_t*>(&tile[1][ly * SW + 4 * k]) = __byte_perm(a, b, 0x7632);
  }
  __syncthreads();

  const int x = x0 + tid, word = (x0 >> 5) + (tid >> 5);
  const bool col_ok = x >= RADIUS && x < W - RADIUS;
#pragma unroll 1
  for (int f = 0; f < 2; ++f) {
    const int yf = y0 + f * PACK_HALF;  // frame row of the field's first centre row
    const int rows = min(ROWS, H - yf);
    for (int r = 0; r < rows; ++r) {
      const int y = yf + r;
      const bool det = col_ok && y >= RADIUS && y < H - RADIUS;
      emit(corner_at<N>(&tile[f][(r + HALO) * SW + tid + HALO], t, det), frame * H + y, word,
           n_words, words);
    }
  }
}

int launch_prefilter(const uint8_t* img, int32_t* words, int B, int H, int W, int t, int need,
                     cudaStream_t st) {
  // Strips of 32 rows, or of 8 where 32 would leave the card short of
  // blocks (fast.cu's rule).
  const int strips_x = (W + STRIP_W - 1) / STRIP_W;
  const bool tall = static_cast<long long>(strips_x) * ((H + STRIP_H - 1) / STRIP_H) * B >=
                    MIN_BLOCKS;
  const int sh = tall ? STRIP_H : SHORT_H;
  const dim3 grid(strips_x, (H + sh - 1) / sh, B);
  const int n_words = (W + 31) / 32;
#define FDF_PREFILTER(NEED, ROWS) \
  prefilter_kernel<NEED, ROWS><<<grid, THREADS, 0, st>>>(img, H, W, n_words, t, words)
  if (need == 2) {
    if (tall) FDF_PREFILTER(2, STRIP_H); else FDF_PREFILTER(2, SHORT_H);
  } else {
    if (tall) FDF_PREFILTER(3, STRIP_H); else FDF_PREFILTER(3, SHORT_H);
  }
#undef FDF_PREFILTER
  return cudaGetLastError();
}

int launch_prepacked(const int32_t* plane, int32_t* words, int B, int n_rows, int pitch, int H,
                     int W, int t, int count, cudaStream_t st) {
  const int strips_x = (W + STRIP_W - 1) / STRIP_W;
  const int tiles = (H + PACK_TILE - 1) / PACK_TILE;
  // fast.cu's rule, counting a block at 32 rows of both fields
  const bool tall = static_cast<long long>(strips_x) * tiles * (PACK_HALF / STRIP_H) * B >=
                    MIN_BLOCKS;
  const int sh = tall ? STRIP_H : SHORT_H;
  const dim3 grid(strips_x, tiles * (PACK_HALF / sh), B);
  const int n_words = (W + 31) / 32;
  const bool vec = pitch % 4 == 0 && reinterpret_cast<uintptr_t>(plane) % 16 == 0;
  switch (count) {
#define FDF_COUNT_CASE(N)                                                                   \
  case N:                                                                                   \
    if (tall)                                                                               \
      prepacked_kernel<N, STRIP_H><<<grid, THREADS, 0, st>>>(plane, n_rows, pitch, H, W,    \
                                                             n_words, t, vec, words);       \
    else                                                                                    \
      prepacked_kernel<N, SHORT_H><<<grid, THREADS, 0, st>>>(plane, n_rows, pitch, H, W,    \
                                                             n_words, t, vec, words);       \
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

}  // namespace strip

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

}  // namespace

extern "C" {

// Every entry point launches on `stream`, does not synchronise, and
// returns cudaGetLastError() after the launch (0 on success).

// The floors: img (B, H, W) u8 -> words (B, H, ceil(W/32)) int32.
int fdf_off_floor_load(const void* img, void* words, int B, int H, int W, int device,
                       void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return stream::launch_load(static_cast<const uint8_t*>(img), static_cast<int32_t*>(words), B,
                             H, W, static_cast<cudaStream_t>(stream));
}

int fdf_off_floor_triple(const void* img, void* words, int B, int H, int W, int span,
                         int device, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || span <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return stream::launch_triple(static_cast<const uint8_t*>(img), static_cast<int32_t*>(words),
                               B, H, W, span, static_cast<cudaStream_t>(stream));
}

// `need` (2 or 3): cardinal taps one polarity must pass.
int fdf_off_floor_prefilter(const void* img, void* words, int B, int H, int W, int threshold,
                            int need, int device, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || threshold < 0 || threshold > 255 || need < 2 || need > 3)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return strip::launch_prefilter(static_cast<const uint8_t*>(img), static_cast<int32_t*>(words),
                                 B, H, W, threshold, need, static_cast<cudaStream_t>(stream));
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
  return strip::launch_prepacked(static_cast<const int32_t*>(plane), static_cast<int32_t*>(words),
                                 B, n_rows, pitch, H, W, threshold, count,
                                 static_cast<cudaStream_t>(stream));
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
