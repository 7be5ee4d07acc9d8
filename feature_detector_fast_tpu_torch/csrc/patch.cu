// Per-keypoint patch extraction for Hopper (sm_90a), two entry points:
//
//   fdf_extract_windows  (B, H, W) u8, (B, K, 2) xy -> (B, K, 31, 31) int32
//                        blur5 | raw << 13 around each keypoint
//   fdf_extract_patches  (B, H, W) int32, (B, K, 2) xy -> (B, K, 32, 128)
//                        int32 windows of any plane
//
// fdf_extract_windows replaces the TPU kernels
// feature_detector_fast_tpu/ops/patch_pallas.py _fused_kernel_resident
// (:147) and _fused_kernel (:123), with their shared tail _blur_pack (:99),
// entry extract_windows_fused (:187).  out[b, k, r, c] = S5x5(y-15+r,
// x-15+c) | raw(y-15+r, x-15+c) << 13, the coordinates clamped to
// [17, W-18] x [17, H-18] so the 35 x 35 blur halo lies in the frame.
// fdf_extract_patches replaces patch_pallas.py _kernel (:69, entry
// extract_patches :313): out[b, k, r, c] = plane[y-15+r, x-15+c], the
// coordinates clamped to [15, W-16] x [15, H-16], and 0 for cells outside
// the frame (the JAX kernel reads them from its zero-padded plane).  The
// plain PyTorch versions are in ops/patch_cuda.py.
//
// Windows.  The output is 3844 B a keypoint against a 1225 B halo read
// mostly from L2, so the kernel is bound by its stores and by what each
// keypoint costs besides them.  One warp serves one keypoint, 8 in a block,
// with no block-wide barrier (only __syncwarp): slot s is warp s % 8 of
// block s / 8 over the flattened (B * K) slots, and reads its own
// coordinates.  The warp stages the 35 x 35 halo with aligned 4-byte loads
// (10 words a row, kept whole in shared memory; byte loads only at the
// ends of the batch's buffer).  Lane c (< 31) owns output column c: for
// each halo row it takes its 5 bytes with two shared word loads and a
// funnel shift, sums 4 of them with one __dp4a and adds the fifth, and
// keeps the vertical 5-sum sliding down its column in a register (one add
// and one subtract a row).  The raw pixel is byte 2 of the same shifted
// word.  The packed window goes to the warp's shared staging at the
// slot's 16-byte phase (a slot starts at s * 3844 B, 16-byte aligned every
// 4 slots), and the warp writes it as 16-byte stores, masking the head and
// tail that belong to the neighbouring slots.  The TPU's two forms -- the
// frame resident in VMEM, or one strip DMA per keypoint when the frame did
// not fit -- and its sublane/lane rolls have no counterpart: every keypoint
// reads its window through L2, whatever the frame's size.  The 32nd row
// and column of the TPU window were sublane slack and are not written.
//
// Patches: one 256-thread block per (keypoint, frame) copies its (32, 128)
// window; it keeps the (32, 128) shape, since that is its contract.  A
// window reads and writes 16 KB and is bound by its stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PATCH = 31;
constexpr int REACH = PATCH / 2;   // 15
constexpr int HALO = REACH + 2;    // + the blur radius
constexpr int WIN = PATCH + 4;     // 35: the blur halo window
constexpr int RAW_SHIFT = 13;
constexpr int WIN_H = 32;
constexpr int LANES = 128;

constexpr int WARPS = THREADS / 32;         // keypoints a windows block serves
constexpr int HALO_WORDS = 10;              // aligned words that cover a 35-byte row
constexpr int CELLS = PATCH * PATCH;        // 961 int32 a window
constexpr int STAGE_INTS = 4 * ((CELLS + 3 + 3) / 4);  // a window at any 16 B phase
static_assert(CELLS % 4 == 1, "slot s starts at 16-byte phase s % 4");

__global__ void __launch_bounds__(THREADS)
windows_kernel(const uint8_t* __restrict__ img, const uint8_t* img_end,
               const int32_t* __restrict__ xy, int H, int W, int K, long long slots,
               int32_t* __restrict__ out) {
  __shared__ uint32_t halo_all[WARPS][WIN * HALO_WORDS];
  __shared__ __align__(16) int32_t stage_all[WARPS][STAGE_INTS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long slot = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (slot >= slots) return;
  uint32_t* halo = halo_all[warp];
  int32_t* stage = stage_all[warp];
  const int x = min(max(xy[2 * slot], HALO), W - HALO - 1);
  const int y = min(max(xy[2 * slot + 1], HALO), H - HALO - 1);
  const uint8_t* top = img + static_cast<size_t>(slot / K) * H * W +
                       static_cast<size_t>(y - HALO) * W + (x - HALO);

  // halo[r][k]: the k-th aligned word of halo row r, whose byte 0 lies
  // (row & 3) bytes before the row's first pixel.  Every load is issued
  // before the first shared store, so a warp waits on L2 once.
  constexpr int LOADS = (WIN * HALO_WORDS + 31) / 32;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(img), hi = reinterpret_cast<uintptr_t>(img_end);
  uint32_t v[LOADS];
#pragma unroll
  for (int n = 0; n < LOADS; ++n) {
    const int i = lane + 32 * n;
    const int r = i / HALO_WORDS, k = i - r * HALO_WORDS;
    const uintptr_t row = reinterpret_cast<uintptr_t>(top) + static_cast<uintptr_t>(r) * W;
    const uintptr_t wa = (row & ~static_cast<uintptr_t>(3)) + 4 * k;
    v[n] = 0;
    if (i >= WIN * HALO_WORDS) continue;
    if (wa >= lo && wa + 4 <= hi) {
      v[n] = *reinterpret_cast<const uint32_t*>(wa);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (wa + j >= lo && wa + j < hi)
          v[n] |= static_cast<uint32_t>(*reinterpret_cast<const uint8_t*>(wa + j)) << (8 * j);
    }
  }
#pragma unroll
  for (int n = 0; n < LOADS; ++n)
    if (lane + 32 * n < WIN * HALO_WORDS) halo[lane + 32 * n] = v[n];
  __syncwarp();

  // Lane c < 31: output column c.  h[q] is the 5-sum of halo row q,
  // columns c..c+4; out row r = q - 4 sums h[r..r+4], raw is halo (r+2,
  // c+2); only the last 5 sums and 3 raw pixels stay live.
  const int phase = static_cast<int>(slot & 3);  // slot * 961 = slot (mod 4)
  if (lane < PATCH) {
    uint32_t h[WIN], raw[WIN], sum = 0;
    const unsigned lead = static_cast<unsigned>(reinterpret_cast<uintptr_t>(top) & 3);
#pragma unroll
    for (int q = 0; q < WIN; ++q) {
      const unsigned off = ((lead + static_cast<unsigned>(q) * W) & 3) + lane;
      const uint32_t* w = &halo[q * HALO_WORDS + (off >> 2)];
      const unsigned sh = (off & 3) * 8;
      const uint32_t t = __funnelshift_r(w[0], w[1], sh);  // bytes c..c+3
      h[q] = __dp4a(t, 0x01010101u, (w[1] >> sh) & 0xFFu);
      raw[q] = (t >> 16) & 0xFFu;
      sum += h[q];
      if (q >= 4) {
        const int r = q - 4;
        stage[phase + r * PATCH + lane] = static_cast<int32_t>(sum | (raw[r + 2] << RAW_SHIFT));
        sum -= h[r];
      }
    }
  }
  __syncwarp();

  // Slot s's cells are out[s * 961 + i]; base is 16-byte aligned and
  // stage[phase + i] holds cell i, so chunk n is 16-byte aligned on both sides.
  int32_t* base = out + slot * CELLS - phase;
  for (int n = lane; n < (phase + CELLS + 3) / 4; n += 32) {
    const int i0 = 4 * n;
    if (i0 >= phase && i0 + 4 <= phase + CELLS) {
      *reinterpret_cast<int4*>(base + i0) = *reinterpret_cast<const int4*>(stage + i0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i0 + j >= phase && i0 + j < phase + CELLS) base[i0 + j] = stage[i0 + j];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
patches_kernel(const int32_t* __restrict__ plane, const int32_t* __restrict__ xy,
               int H, int W, int K, int32_t* __restrict__ out) {
  const size_t slot = (size_t)blockIdx.y * K + blockIdx.x;
  const int x = min(max(xy[2 * slot], REACH), W - REACH - 1);
  const int y = min(max(xy[2 * slot + 1], REACH), H - REACH - 1);
  const int32_t* pl = plane + (size_t)blockIdx.y * H * W;
  int32_t* o = out + slot * WIN_H * LANES;
  for (int i = threadIdx.x; i < WIN_H * LANES; i += THREADS) {
    const int gy = y - REACH + i / LANES, gx = x - REACH + i % LANES;
    o[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? pl[(size_t)gy * W + gx] : 0;
  }
}

}  // namespace

extern "C" {

// Both entry points launch on `stream`, do not synchronise, and return
// cudaGetLastError() after the launch (0 on success).
int fdf_extract_windows(const void* img, const void* xy, void* out, int B,
                        int H, int W, int K, int device, void* stream) {
  if (B <= 0 || K <= 0 || H < WIN || W < WIN) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) & 15) return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long slots = static_cast<long long>(B) * K;
  const uint8_t* im = static_cast<const uint8_t*>(img);
  windows_kernel<<<static_cast<unsigned>((slots + WARPS - 1) / WARPS), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      im, im + static_cast<size_t>(B) * H * W, static_cast<const int32_t*>(xy), H, W, K,
      slots, static_cast<int32_t*>(out));
  return cudaGetLastError();
}

int fdf_extract_patches(const void* plane, const void* xy, void* out, int B,
                        int H, int W, int K, int device, void* stream) {
  if (B <= 0 || K <= 0 || B > 65535 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  patches_kernel<<<dim3(K, B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(plane), static_cast<const int32_t*>(xy), H, W, K,
      static_cast<int32_t*>(out));
  return cudaGetLastError();
}

const char* fdf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
