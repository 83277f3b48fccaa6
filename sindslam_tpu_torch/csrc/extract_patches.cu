// K4: N square windows of an image at per-point top-left corners, alone
// (extract_patches) and fused with the BRIEF sampling that consumes them
// (brief_from_patches).
//
// Replaces extract_patches_pallas (sindslam_tpu/ops/pallas_kernels.py:
// 425-470, body _make_patch_kernel 387-421): the BRIEF patch gather on the
// blurred ORB atlas, exact f32. The Pallas aligned-superset load and
// register roll exist only because Mosaic needs (8, 128)-aligned dynamic
// slices; Hopper reads any address, so each window is a plain copy.
//
// Bound on the H100: memory traffic, and in practice launch latency. Alone,
// N = 1500 windows of 28x28 f32 are 4.7 MB out and at most as much in, all
// L2-resident. The windows have one consumer, the BRIEF test of 256 sample
// pairs per keypoint, so the fused entry never writes them: it moves the
// touched image pixels, the used rows of the 64 x 512 sample table (131 KB,
// L2-resident) and 32 bytes of descriptor per keypoint, in one launch.
// Design: one block per keypoint. load_window copies the window row by row,
// one warp per row and one lane per column (no division, neighbouring lanes
// on neighbouring addresses), to global memory for the standalone entry and
// to shared memory for the fused one. There thread j compares its two
// samples of the shared window and a warp ballot packs 32 bits into a word:
// only loads and one compare, so the descriptors are bit-exact. Corners are
// clamped to [0, dim - patch] as the Pallas kernel clamps its aligned start:
// an out-of-contract corner returns a shifted window, never an
// out-of-bounds read.
// Lanes: both entries take B images ((B, h, w), the batched front-end's B
// atlases) with (B, N) corners (and bins) in one launch: block (k, b) is
// keypoint k of lane b, and the kernel offsets the image, the corners and
// the output by the lane. An unbatched call is the one-lane case.

#include <cuda_runtime.h>

namespace {

constexpr int kBriefPatch = 28;    // the sample table addresses a 28x28 window
constexpr int kBriefBits = 256;    // one thread per descriptor bit
constexpr int kCopyThreads = 224;  // 7 warps: 28 rows in 4 passes

// dst[row * patch + col] = img[(y + row) * w + x + col] for the window whose
// clamped corner is (y, x); dst is global or shared memory.
__device__ __forceinline__ void load_window(const float* __restrict__ img,
                                            int w, int y, int x, int patch,
                                            float* dst) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int row = warp; row < patch; row += n_warps) {
    const float* src = img + static_cast<size_t>(y + row) * w + x;
    for (int col = lane; col < patch; col += 32) {
      dst[row * patch + col] = src[col];
    }
  }
}

__device__ __forceinline__ int clamp_corner(int v, int dim, int patch) {
  return min(max(v, 0), dim - patch);
}

__global__ void patches_kernel(const float* __restrict__ img,
                               const int* __restrict__ y0,
                               const int* __restrict__ x0,
                               float* __restrict__ out, int n, int h, int w,
                               int patch) {
  const size_t k = static_cast<size_t>(blockIdx.y) * n + blockIdx.x;
  load_window(img + static_cast<size_t>(blockIdx.y) * h * w, w,
              clamp_corner(y0[k], h, patch), clamp_corner(x0[k], w, patch),
              patch, out + k * patch * patch);
}

__global__ void __launch_bounds__(kBriefBits)
brief_kernel(const float* __restrict__ img, const int* __restrict__ y0,
             const int* __restrict__ x0, const int* __restrict__ bins,
             const int* __restrict__ table, int* __restrict__ out, int n,
             int h, int w) {
  __shared__ float win[kBriefPatch * kBriefPatch];
  const size_t k = static_cast<size_t>(blockIdx.y) * n + blockIdx.x;
  load_window(img + static_cast<size_t>(blockIdx.y) * h * w, w,
              clamp_corner(y0[k], h, kBriefPatch),
              clamp_corner(x0[k], w, kBriefPatch), kBriefPatch, win);
  __syncthreads();
  // bit j: sample j of the bin's row against sample 256 + j. Every lane
  // reaches the ballot: lane j of warp i is bit j of word i.
  const int j = threadIdx.x;
  const int* row = table + bins[k] * (2 * kBriefBits);
  constexpr int kLast = kBriefPatch * kBriefPatch - 1;  // clamp, as corners
  const float a = win[min(max(__ldg(row + j), 0), kLast)];
  const float b = win[min(max(__ldg(row + kBriefBits + j), 0), kLast)];
  const unsigned word = __ballot_sync(0xffffffffu, a < b);
  if ((j & 31) == 0) {
    out[k * (kBriefBits / 32) + (j >> 5)] = static_cast<int>(word);
  }
}

}  // namespace

// img: (B, h, w) float32; y0, x0: (B, n) int32; out: (B, n, patch, patch)
// float32; all contiguous.
extern "C" int extract_patches(const float* img, const int* y0, const int* x0,
                               float* out, int lanes, int n, int h, int w,
                               int patch, void* stream) {
  if (n == 0) return 0;
  if (lanes < 1 || lanes > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  patches_kernel<<<dim3(n, lanes), kCopyThreads, 0, s>>>(img, y0, x0, out, n,
                                                         h, w, patch);
  return static_cast<int>(cudaGetLastError());
}

// img: (B, h, w) float32 with h, w >= 28; y0, x0: (B, n) int32; bins: (B, n)
// int32 in [0, n_bins); table: (n_bins, 512) int32 in [0, 784); out:
// (B, n, 8) int32; all contiguous.
extern "C" int brief_from_patches(const float* img, const int* y0,
                                  const int* x0, const int* bins,
                                  const int* table, int* out, int lanes,
                                  int n, int h, int w, void* stream) {
  if (n == 0) return 0;
  if (lanes < 1 || lanes > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  brief_kernel<<<dim3(n, lanes), kBriefBits, 0, s>>>(img, y0, x0, bins, table,
                                                     out, n, h, w);
  return static_cast<int>(cudaGetLastError());
}
