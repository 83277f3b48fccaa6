// K3: FAST-9/16 max-margin score, priority mix and 3x3 NMS on one level.
//
// Replaces fast_nms_pallas (sindslam_tpu/ops/pallas_kernels.py:368-384, body
// _make_fast_kernel 317-363). Score = max over the 16 cyclic starts of the
// minimum bright (or dark) margin along 9 consecutive ring pixels;
// thresholded at min_th, +1000 above ini_th; then kept where it equals its
// 3x3 neighbourhood max (ties survive). An out-of-image ring sample reads
// the centre pixel; an out-of-image NMS neighbour reads 0.
//
// Bound on the H100: memory traffic at these sizes (a 480x640 level is
// 1.2 MB in and out; ~300 subtract/min/max per pixel is ~0.1 GOP, far under
// the FP32 rate). Design: one thread per pixel; the 16 ring samples sit in
// registers and the 144 run minima are recomputed from them, so nothing but
// the image is read. The NMS needs the neighbours' finished scores, so it is
// a second launch over the score buffer. Only subtract, min, max and one
// add, so the result is bit-exact against the plain version.

#include <cuda_runtime.h>

namespace {

__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                3,  3,  2,  1,  0, -1, -2, -3};
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                0, -1, -2, -3, -3, -3, -2, -1};

__global__ void score_kernel(const float* __restrict__ img,
                             float* __restrict__ score, int h, int w,
                             float min_th, float ini_th) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= h || c >= w) return;
  const float center = img[r * w + c];
  float ring[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int y = r + kRingDy[k], x = c + kRingDx[k];
    ring[k] = (y >= 0 && y < h && x >= 0 && x < w) ? img[y * w + x] : center;
  }
  float best_b = -1e9f, best_d = -1e9f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    float wb = ring[k] - center;
    float wd = center - ring[k];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      const float s = ring[(k + j) & 15];
      wb = fminf(wb, s - center);
      wd = fminf(wd, center - s);
    }
    best_b = fmaxf(best_b, wb);
    best_d = fmaxf(best_d, wd);
  }
  float sc = fmaxf(best_b, best_d);
  sc = sc > min_th ? sc : 0.0f;
  if (sc > ini_th) sc = sc + 1000.0f;
  score[r * w + c] = sc;
}

__global__ void nms_kernel(const float* __restrict__ score,
                           float* __restrict__ out, int h, int w) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= h || c >= w) return;
  const float s = score[r * w + c];
  float m = s;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const int y = r + dy, x = c + dx;
      const float n = (y >= 0 && y < h && x >= 0 && x < w) ? score[y * w + x]
                                                           : 0.0f;
      m = fmaxf(m, n);
    }
  }
  out[r * w + c] = s >= m ? s : 0.0f;
}

}  // namespace

// img, out: (h, w) float32; score: (h, w) float32 scratch.
extern "C" int fast_nms(const float* img, float* out, float* score, int h,
                        int w, float min_th, float ini_th, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  score_kernel<<<grid, block, 0, s>>>(img, score, h, w, min_th, ini_th);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_kernel<<<grid, block, 0, s>>>(score, out, h, w);
  return static_cast<int>(cudaGetLastError());
}
