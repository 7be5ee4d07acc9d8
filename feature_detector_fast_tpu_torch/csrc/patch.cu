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
// Design.  One block per (keypoint, frame): blockIdx.x is the slot,
// blockIdx.y the frame, and each block reads its own coordinates.  For the
// windows the block stages the 35 x 35 u8 halo window in shared memory,
// takes the vertical 5-sums (31 x 35 int32) and then the horizontal ones,
// and packs the raw pixel above the 13 bits of the sum (<= 6375).  The
// TPU's two forms -- the frame resident in VMEM, or one strip DMA per
// keypoint when the frame did not fit -- and its sublane/lane rolls have no
// counterpart: every keypoint reads its window through L2, whatever the
// frame's size.  The 32nd row and column of the TPU window were sublane
// slack and are not written; patches keep the (32, 128) shape, since it
// is their contract.
//
// Bound.  A window reads 1225 B (from L2 for clustered keypoints) and
// writes 3844 B; a patch reads and writes 16 KB.  Both are bound by the
// stores and by the per-block fixed cost (one small block per keypoint,
// ~2 of 8 warps busy in the last pass); batching several keypoints per
// block is left for later work.

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

__global__ void __launch_bounds__(THREADS)
windows_kernel(const uint8_t* __restrict__ img, const int32_t* __restrict__ xy,
               int H, int W, int K, int32_t* __restrict__ out) {
  __shared__ uint8_t win[WIN * WIN];
  __shared__ int vsum[PATCH * WIN];

  const size_t slot = (size_t)blockIdx.y * K + blockIdx.x;
  const int x = min(max(xy[2 * slot], HALO), W - HALO - 1);
  const int y = min(max(xy[2 * slot + 1], HALO), H - HALO - 1);
  const uint8_t* im = img + (size_t)blockIdx.y * H * W + (size_t)(y - HALO) * W + (x - HALO);

  for (int i = threadIdx.x; i < WIN * WIN; i += THREADS)
    win[i] = im[(size_t)(i / WIN) * W + i % WIN];
  __syncthreads();

  // vsum[r][c]: sum of win rows r..r+4 = frame rows centred at y-15+r.
  for (int i = threadIdx.x; i < PATCH * WIN; i += THREADS) {
    const uint8_t* t = &win[i];
    vsum[i] = t[0] + t[WIN] + t[2 * WIN] + t[3 * WIN] + t[4 * WIN];
  }
  __syncthreads();

  int32_t* o = out + slot * PATCH * PATCH;
  for (int i = threadIdx.x; i < PATCH * PATCH; i += THREADS) {
    const int r = i / PATCH, c = i % PATCH;
    const int* v = &vsum[r * WIN + c];
    const int blur = v[0] + v[1] + v[2] + v[3] + v[4];
    o[i] = blur | (static_cast<int>(win[(r + 2) * WIN + c + 2]) << RAW_SHIFT);
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
  if (B <= 0 || K <= 0 || B > 65535 || H < WIN || W < WIN) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  windows_kernel<<<dim3(K, B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<const int32_t*>(xy), H, W, K,
      static_cast<int32_t*>(out));
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
