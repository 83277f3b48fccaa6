// K4: N square windows of an image at per-point top-left corners.
//
// Replaces extract_patches_pallas (sindslam_tpu/ops/pallas_kernels.py:
// 425-470, body _make_patch_kernel 387-421): the BRIEF patch gather on the
// blurred ORB atlas, exact f32. The Pallas aligned-superset load and
// register roll exist only because Mosaic needs (8, 128)-aligned dynamic
// slices; Hopper reads any address, so each window is a plain copy.
//
// Bound on the H100: memory traffic (N = 1500 windows of 28x28 f32 is 4.7 MB
// out and at most as much in, all L2-resident), in practice launch latency.
// Design: one block per group of kGroup keypoints; its threads walk the
// group's windows row-major, so neighbouring threads read neighbouring
// addresses of one window row and write contiguous output. Corners are
// clamped to [0, dim - patch] as the Pallas kernel clamps its aligned start:
// an out-of-contract corner returns a shifted window, never an
// out-of-bounds read.

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 8;

__global__ void patches_kernel(const float* __restrict__ img,
                               const int* __restrict__ y0,
                               const int* __restrict__ x0,
                               float* __restrict__ out, int n, int h, int w,
                               int patch) {
  const int first = blockIdx.x * kGroup;
  const int per = patch * patch;
  const int count = min(kGroup, n - first) * per;
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int k = first + t / per;
    const int e = t % per;
    const int y = min(max(y0[k], 0), h - patch) + e / patch;
    const int x = min(max(x0[k], 0), w - patch) + e % patch;
    out[static_cast<size_t>(k) * per + e] = img[y * w + x];
  }
}

}  // namespace

// img: (h, w) float32; y0, x0: (n,) int32; out: (n, patch, patch) float32.
extern "C" int extract_patches(const float* img, const int* y0, const int* x0,
                               float* out, int n, int h, int w, int patch,
                               void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kGroup - 1) / kGroup;
  patches_kernel<<<blocks, 256, 0, s>>>(img, y0, x0, out, n, h, w, patch);
  return static_cast<int>(cudaGetLastError());
}
