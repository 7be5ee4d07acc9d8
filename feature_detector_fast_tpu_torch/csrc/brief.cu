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
// Bound.  Per pixel 256 compares, 32 B of planes written and ~1 B of frame
// read.  What limits a direct kernel is neither: it is the shared-memory
// pipe, which retires 128 B a clock per SM.  One int32 sample per endpoint
// is 512 four-byte loads a pixel (2.0 ms at (16, 1080, 1920) on 132 SMs at
// 1.98 GHz before any compare; the previous design, one pixel a thread in
// a 32 x 8 block, ran at 3.65 ms).
//
// Design.
// * A blur sum is at most 25 * 255 = 6375 < 2^13, so the blurred region is
//   held as u16, and a thread computes two horizontally adjacent pixels
//   (x, x+1), x even: one 32-bit shared load fetches an endpoint's sample
//   for both.  An endpoint at an odd column offset would straddle two
//   words, so every region row is held twice: copy 0 pairs cells (2k,
//   2k+1), copy 1 pairs (2k+1, 2k+2).  The pair table gives each
//   endpoint's word offset with the copy folded in.  That halves the shared
//   bytes a pixel needs (1 KB: 8 clocks a pixel per SM, 1.02 ms).
// * The table is compiled in (BEGIN PAIRS below): every offset is an
//   immediate, and a warp covers 4 rows, so the 128 loads of a pair's two
//   endpoints over 4 rows read cells that other pairs of the plane read
//   too: pixel (x, y+1) at (dx, dy) reads pixel (x, y)'s cell at (dx,
//   dy+1).  The compiler loads each distinct cell of a plane once: 1709 of
//   the 2048 loads a lane makes for 4 rows (83.4%, counted by
//   tests/test_torch_brief.py), 214 a pixel.  Holding more rows saves more
//   (72.6% at 8) but needs ~126 registers and ran 2x slower.
// * One 32-bit add compares both pixels: with both halves below 2^13,
//   d = b - a + 0x7FFF7FFF keeps the halves apart, and bit 15 (bit 31) of d
//   is a < b for pixel x (x+1).  d >> (15 - g) & (0x00010001 << g) moves
//   both bits to bit g of the two halves of an accumulator; a plane's bits
//   0..15 and 16..31 collect in two accumulators, and two byte permutes
//   give the two pixels' words.  That is 3 ALU operations a compare for 2
//   pixels, 384 a pixel: 6 clocks at 64 a clock per SM, beside the 6.7 of
//   the shared loads.
// * A block is 64 x 32 pixels, 8 warps of 64 columns (two a lane) by 4
//   rows.  The blurred region is 94 x 62 cells for 2048 pixels (2.8 a
//   pixel; the previous 32 x 8 block computed 9.2).  48 registers, no
//   spill, under __launch_bounds__(256, 5): five blocks, 40 warps, an SM.
//   A 64 x 64 block of 16 warps wants 59 registers (two blocks, 32 warps)
//   and ran 3% slower; held to 40 (three blocks) it spilled.
// * Staging: the block's u8 tile with a 17-pixel halo, read with aligned
//   4-byte loads (byte loads only at frame edges, so any width and any
//   frame base work); vertical 5-sums at the clamped row centres (u16), a
//   thread sliding one down 16 rows of a column (two loads a row after the
//   first); horizontal 5-sums at the clamped column centres, a thread
//   sliding one along 16 cells of a row, into both copies.  The copies
//   reuse the tile's shared memory (36.2 KB a block, dynamic).
// * Stores: a lane's two words of a plane row go out as one 8-byte store
//   where the address is 8-byte aligned (always for even W), else as two
//   4-byte stores (odd W, or odd H * W); a warp writes 256 contiguous
//   bytes per plane row.
// The TPU kernel's lane rolls, shared-shift cache and 32-row tiles with
// clamped neighbour tiles answered VMEM layout and have no counterpart.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 64;               // pixels a block covers: 64 x 32
constexpr int TILE_H = 32;
constexpr int ROWS = 4;                  // rows a warp covers
constexpr int WARPS = TILE_H / ROWS;     // 8
constexpr int THREADS = 32 * WARPS;      // 256; a lane covers 2 columns
static_assert(TILE_W == 64, "a warp's 32 lanes cover 64 columns");
constexpr int BITS = 256;
constexpr int WORDS = BITS / 32;
constexpr int REACH = 15;                // pattern offsets lie in [-15, 15]
constexpr int HALO = REACH + 2;          // + the blur radius
constexpr int SW = TILE_W + 2 * HALO;    // staged u8 columns: 98
constexpr int SH = TILE_H + 2 * HALO;    // staged u8 rows: 66
constexpr int SP = 100;                  // staged row pitch (bytes)
constexpr int WPR = SW / 4 + 2;          // aligned words that cover a staged row
constexpr int BW = TILE_W + 2 * REACH;   // blurred region: 94 x 62 cells
constexpr int BH = TILE_H + 2 * REACH;
constexpr int COPY_WORDS = 48;           // one copy of a region row (94 u16 + pad)
constexpr int ROW_WORDS = 2 * COPY_WORDS + 1;  // copy 0, copy 1; odd, so a warp
                                               // over 32 rows hits 32 banks
constexpr int BAND = 16;                 // rows (columns) a thread slides a 5-sum over
constexpr int BLUR_BYTES = BH * ROW_WORDS * 4;  // 24056
constexpr int TILE_BYTES = SH * SP;             // 6600, aliased by the copies
constexpr int VSUM_BYTES = BH * SW * 2;         // 12152
constexpr int SMEM_BYTES = BLUR_BYTES + VSUM_BYTES;
static_assert(TILE_BYTES <= BLUR_BYTES, "the tile fits under the copies");
static_assert(BW <= 2 * COPY_WORDS, "a region row fits one copy");

// The pair table (ops/brief_cuda.py pair_table), compiled in: plane j's
// 32 pairs as X(bit, offset of endpoint 1, offset of endpoint 2), word
// offsets in the blurred region relative to the word of the lane's pixel
// pair in its own row, (dy + 15) * ROW_WORDS + ((dx + 15) & 1) *
// COPY_WORDS + ((dx + 15) >> 1).  Within a plane the pairs run by their
// leftmost endpoint's column, so the compiler loads a cell that several
// pairs (and rows) read once and keeps it in a register.  Generated by
// ops/brief_cuda.py pair_macros; tests/test_torch_brief.py holds it equal.
// BEGIN PAIRS
#define FDF_PAIRS_0(X) \
  X(4, 1018, 873) X(9, 1462, 873) X(26, 727, 2090) X(3, 1562, 1309) \
  X(23, 2571, 1412) X(24, 1942, 2089) X(21, 1893, 1564) X(6, 2044, 1699) \
  X(5, 2623, 826) X(19, 1264, 1226) X(11, 1564, 3) X(8, 1946, 1797) \
  X(14, 1750, 686) X(16, 1023, 1410) X(15, 1077, 2865) X(1, 2045, 1313) \
  X(27, 1367, 2042) X(28, 1073, 2923) X(7, 1655, 929) X(18, 2625, 1222) \
  X(20, 927, 927) X(2, 1365, 927) X(17, 1659, 395) X(31, 2238, 2820) \
  X(0, 2626, 1609) X(29, 443, 985) X(12, 1316, 1122) X(13, 1899, 928) \
  X(30, 2239, 2243) X(25, 2483, 2143) X(22, 1319, 883) X(10, 1416, 58)
#define FDF_PAIRS_1(X) \
  X(24, 245, 776) X(3, 1899, 1843) X(17, 2328, 345) X(2, 2435, 1067) \
  X(26, 398, 1406) X(27, 486, 1561) X(29, 1364, 2621) X(9, 1505, 1800) \
  X(10, 1608, 1652) X(22, 830, 924) X(7, 1894, 1948) X(23, 829, 2235) \
  X(28, 1459, 732) X(18, 1750, 296) X(11, 731, 1122) X(21, 983, 2186) \
  X(5, 1072, 1270) X(4, 1563, 1751) X(13, 1851, 2236) X(8, 2624, 1464) \
  X(20, 1858, 1364) X(0, 1900, 2285) X(15, 2044, 2826) X(25, 2383, 1761) \
  X(6, 396, 1223) X(16, 2433, 1273) X(31, 2433, 1076) X(30, 2918, 1511) \
  X(19, 153, 2340) X(1, 1857, 1996) X(14, 2288, 1561) X(12, 2726, 1222)
#define FDF_PAIRS_2(X) \
  X(15, 2134, 2777) X(20, 2231, 97) X(0, 981, 1018) X(3, 2182, 1988) \
  X(27, 1748, 294) X(31, 1893, 1218) X(12, 1990, 2042) X(30, 2634, 1214) \
  X(13, 589, 2137) X(6, 1652, 1514) X(11, 1898, 1603) X(5, 4, 1369) \
  X(1, 831, 2186) X(29, 931, 1216) X(22, 2189, 1410) X(7, 1121, 2139) \
  X(28, 2238, 1945) X(14, 1024, 1702) X(17, 1416, 538) X(4, 1567, 2237) \
  X(2, 1567, 2673) X(9, 2576, 1315) X(18, 783, 2537) X(19, 2192, 977) \
  X(21, 641, 1316) X(24, 1369, 55) X(16, 1172, 1125) X(25, 1610, 1075) \
  X(26, 979, 1999) X(10, 1952, 882) X(8, 1271, 495) X(23, 1516, 1950)
#define FDF_PAIRS_3(X) \
  X(7, 248, 2910) X(31, 971, 2910) X(12, 971, 346) X(25, 2474, 1073) \
  X(24, 1748, 784) X(3, 1020, 1315) X(5, 1699, 1607) X(9, 391, 1948) \
  X(15, 732, 1846) X(22, 693, 2040) X(19, 1652, 691) X(29, 633, 974) \
  X(11, 2043, 1894) X(23, 1952, 1313) X(4, 58, 2527) X(27, 393, 1267) \
  X(8, 57, 1702) X(28, 1217, 1224) X(0, 1365, 441) X(1, 2827, 685) \
  X(13, 301, 2285) X(17, 2774, 1606) X(30, 884, 2820) X(14, 1268, 788) \
  X(10, 1272, 1269) X(26, 250, 1660) X(2, 1221, 1220) X(16, 1273, 785) \
  X(6, 1804, 494) X(18, 108, 2048) X(20, 1272, 1563) X(21, 1806, 789)
#define FDF_PAIRS_4(X) \
  X(16, 538, 1843) X(27, 1455, 1368) X(2, 630, 639) X(17, 1459, 824) \
  X(20, 680, 979) X(24, 1650, 785) X(12, 1999, 2135) X(3, 1802, 1602) \
  X(23, 2099, 1796) X(4, 2137, 1076) X(6, 2428, 296) X(25, 2434, 1264) \
  X(29, 51, 249) X(14, 1797, 1708) X(10, 445, 1653) X(31, 834, 1362) \
  X(26, 974, 1847) X(11, 1851, 2623) X(9, 1557, 1022) X(28, 2430, 833) \
  X(5, 829, 1176) X(22, 1314, 2286) X(18, 1511, 1508) X(1, 1898, 1508) \
  X(7, 685, 2483) X(30, 1267, 2965) X(15, 2383, 6) X(21, 1024, 2440) \
  X(19, 1413, 2964) X(13, 1365, 2969) X(0, 2530, 690) X(8, 303, 1031)
#define FDF_PAIRS_5(X) \
  X(27, 2231, 2577) X(24, 2716, 1994) X(28, 1703, 2038) X(9, 831, 2959) \
  X(2, 1363, 2040) X(16, 1709, 488) X(10, 2185, 1361) X(26, 2331, 394) \
  X(30, 2529, 924) X(20, 2627, 1653) X(5, 976, 1895) X(11, 1997, 1216) \
  X(25, 2440, 925) X(12, 1852, 2042) X(21, 344, 637) X(18, 2575, 1948) \
  X(6, 1413, 2091) X(31, 1413, 2188) X(23, 2245, 2188) X(29, 1171, 1707) \
  X(8, 2386, 2917) X(19, 637, 1122) X(15, 1221, 2092) X(7, 1704, 1221) \
  X(0, 1898, 1276) X(14, 688, 2530) X(17, 2627, 2288) X(3, 1808, 2578) \
  X(1, 9, 882) X(22, 2632, 1853) X(4, 1806, 2679) X(13, 2680, 933)
#define FDF_PAIRS_6(X) \
  X(27, 539, 2522) X(30, 1843, 881) X(2, 1461, 1553) X(31, 1214, 979) \
  X(17, 2960, 1557) X(12, 2088, 2817) X(25, 877, 1800) X(16, 1653, 979) \
  X(5, 2138, 1850) X(14, 2332, 7) X(0, 925, 635) X(20, 1074, 1022) \
  X(15, 2386, 878) X(1, 829, 300) X(22, 2678, 1702) X(4, 1077, 2140) \
  X(6, 2043, 207) X(29, 498, 2091) X(13, 689, 442) X(10, 1121, 1951) \
  X(11, 2387, 1703) X(18, 1753, 1468) X(8, 1125, 540) X(26, 1369, 1851) \
  X(19, 1706, 1560) X(24, 2387, 2336) X(21, 838, 1367) X(9, 1610, 2531) \
  X(28, 398, 2678) X(23, 737, 1125) X(3, 1513, 693) X(7, 2194, 1179)
#define FDF_PAIRS_7(X) \
  X(15, 735, 2473) X(17, 1262, 1361) X(22, 1513, 875) X(30, 1457, 1699) \
  X(5, 2233, 151) X(20, 827, 248) X(24, 1021, 2140) X(29, 1700, 1177) \
  X(8, 739, 2332) X(31, 634, 1317) X(16, 1122, 1654) X(10, 1945, 2385) \
  X(2, 829, 1660) X(11, 829, 829) X(27, 1217, 1217) X(14, 2963, 1511) \
  X(0, 685, 977) X(19, 1025, 1752) X(23, 7, 1800) X(13, 1369, 1994) \
  X(25, 1997, 636) X(4, 2870, 1315) X(6, 1559, 1463) X(12, 443, 1320) \
  X(3, 2189, 2386) X(9, 2771, 1511) X(1, 784, 2289) X(26, 2046, 1269) \
  X(21, 1220, 1613) X(28, 2385, 2292) X(7, 2242, 1804) X(18, 2438, 1805)
// END PAIRS

// Stage frame rows [y0 - HALO, y0 + TILE_H + HALO) x columns [x0 - HALO,
// x0 + TILE_W + HALO) into `tile`, 0 outside the frame (such bytes are
// never summed: every blur centre is clamped into the frame).  A thread
// loads one 4-byte-aligned word of a row at a time, whole where all its
// bytes lie in the row's columns [0, W), else byte by byte.
__device__ __forceinline__ void stage(uint8_t* tile, const uint8_t* im, int x0, int y0,
                                      int H, int W) {
  for (int i = threadIdx.x; i < SH * WPR; i += THREADS) {
    const int ly = i / WPR, k = i - ly * WPR;
    const int y = y0 - HALO + ly;
    const intptr_t start = reinterpret_cast<intptr_t>(im) + static_cast<intptr_t>(y) * W +
                           (x0 - HALO);
    const intptr_t wa = (start & ~static_cast<intptr_t>(3)) + 4 * k;
    const int c0 = static_cast<int>(wa - start);  // staged column of the word's byte 0
    const int xw = x0 - HALO + c0;                // its frame column
    const bool row_in = y >= 0 && y < H;
    uint8_t* dst = tile + ly * SP;
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

// A lane's two words of one plane in rows_in rows: pixel x's word
// (bits 0..15 from the low half of lo, 16..31 from the low half of hi) and
// pixel x+1's (the high halves), as one 8-byte store where aligned.
__device__ __forceinline__ void store_words(int32_t* out, int W, int rows_in, bool pair_in,
                                            const uint32_t* lo, const uint32_t* hi) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= rows_in) break;
    const int32_t w0 = static_cast<int32_t>(__byte_perm(lo[r], hi[r], 0x5410));
    const int32_t w1 = static_cast<int32_t>(__byte_perm(lo[r], hi[r], 0x7632));
    int32_t* o = out + static_cast<size_t>(r) * W;
    if (pair_in && (reinterpret_cast<uintptr_t>(o) & 7) == 0) {
      *reinterpret_cast<int2*>(o) = make_int2(w0, w1);
    } else {
      o[0] = w0;
      if (pair_in) o[1] = w1;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 5)
brief_words_kernel(const uint8_t* __restrict__ img, int H, int W,
                   int32_t* __restrict__ planes) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* tile = smem;                                          // phase 1-2
  uint32_t* blur = reinterpret_cast<uint32_t*>(smem);            // phase 3-4
  uint16_t* vsum = reinterpret_cast<uint16_t*>(smem + BLUR_BYTES);

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TILE_W, y0 = blockIdx.y * TILE_H;
  const size_t frame = blockIdx.z;
  stage(tile, img + frame * H * W, x0, y0, H, W);
  __syncthreads();

  // vsum[r][c]: vertical 5-sum of staged column c centred at frame row
  // clamp(y0 - REACH + r, 2, H-3); every row it reads is staged.  A thread
  // slides the sum down BAND rows of one column: the centre moves by 0 or
  // 1 a row, so each row after the first costs two loads.
  for (int i = tid; i < SW * ((BH + BAND - 1) / BAND); i += THREADS) {
    const int c = i % SW, r0 = i / SW * BAND;
    int prev = -1, v = 0;
    for (int r = r0; r < min(r0 + BAND, BH); ++r) {
      const int ly = min(max(y0 - REACH + r, 2), H - 3) - 2 - (y0 - HALO);
      const uint8_t* t = &tile[ly * SP + c];
      if (prev < 0) v = t[0] + t[SP] + t[2 * SP] + t[3 * SP] + t[4 * SP];
      else if (ly != prev) v += t[4 * SP] - t[-SP];
      prev = ly;
      vsum[r * SW + c] = static_cast<uint16_t>(v);
    }
  }
  __syncthreads();

  // Cell (r, c) of the region = S5x5 at (clamp(y0 - REACH + r), clamp(x0 -
  // REACH + c)): u16 index c of copy 0 and c - 1 of copy 1 of row r.  A
  // thread slides the sum along BAND columns of one row; a warp covers 32
  // rows (vsum's pitch, 49 words, and ROW_WORDS are odd: no bank conflict).
  uint16_t* blur16 = reinterpret_cast<uint16_t*>(blur);
  for (int i = tid; i < BH * ((BW + BAND - 1) / BAND); i += THREADS) {
    const int r = i % BH, c0 = i / BH * BAND;
    const uint16_t* v = &vsum[r * SW];
    uint16_t* row = blur16 + 2 * r * ROW_WORDS;
    int prev = -1, s = 0;
    for (int c = c0; c < min(c0 + BAND, BW); ++c) {
      const int lx = min(max(x0 - REACH + c, 2), W - 3) - 2 - (x0 - HALO);
      if (prev < 0) s = v[lx] + v[lx + 1] + v[lx + 2] + v[lx + 3] + v[lx + 4];
      else if (lx != prev) s += v[lx + 4] - v[lx - 1];
      prev = lx;
      row[c] = static_cast<uint16_t>(s);
      if (c > 0) row[2 * COPY_WORDS + c - 1] = static_cast<uint16_t>(s);
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int lr0 = warp * ROWS;
  const uint32_t* base = blur + lr0 * ROW_WORDS + lane;
  const int x = x0 + 2 * lane, y = y0 + lr0;
  // The lane's words of plane 0 in its first row (each plane moves it on
  // by the plane stride), the rows it may store, and whether its second
  // pixel is in the frame.
  int32_t* out = planes + frame * WORDS * H * W + static_cast<size_t>(y) * W + x;
  const size_t plane = static_cast<size_t>(H) * W;
  const int rows_in = x < W ? min(ROWS, H - y) : 0;
  const bool pair_in = x + 1 < W;

#define FDF_PAIR(B, O1, O2)                                                            \
  _Pragma("unroll") for (int r = 0; r < ROWS; ++r) {                                  \
    const uint32_t d = base[(O2) + r * ROW_WORDS] - base[(O1) + r * ROW_WORDS] + 0x7FFF7FFFu; \
    const uint32_t bit = (d >> (15 - ((B) & 15))) & (0x00010001u << ((B) & 15));     \
    if ((B) < 16) lo[r] |= bit;                                                        \
    else hi[r] |= bit;                                                                 \
  }
  // One plane: its 32 pairs, then the store.  The empty asm keeps the
  // compiler from holding a cell from one plane to the next.
#define FDF_PLANE(J)                                                                   \
  {                                                                                    \
    uint32_t lo[ROWS], hi[ROWS];                                                       \
    _Pragma("unroll") for (int r = 0; r < ROWS; ++r) lo[r] = hi[r] = 0;               \
    FDF_PAIRS_##J(FDF_PAIR)                                                            \
    store_words(out, W, rows_in, pair_in, lo, hi);                                     \
    out += plane;                                                                      \
    asm volatile("" ::: "memory");                                                     \
  }
  FDF_PLANE(0) FDF_PLANE(1) FDF_PLANE(2) FDF_PLANE(3)
  FDF_PLANE(4) FDF_PLANE(5) FDF_PLANE(6) FDF_PLANE(7)
#undef FDF_PLANE
#undef FDF_PAIR
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// after the launch (0 on success).
int fdf_brief_words(const void* img, void* planes, int B, int H, int W,
                    int device, void* stream) {
  if (B <= 0 || B > 65535 || H < 5 || W < 5)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(brief_words_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  brief_words_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), H, W, static_cast<int32_t*>(planes));
  return cudaGetLastError();
}

const char* fdf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
