// K2: connected components by exactly n_sweeps Jacobi min-label sweeps.
//
// Replaces cc_labels_pallas (sindslam_tpu/ops/pallas_kernels.py:262-289,
// body _make_cc_kernel 202-257). A pixel links to a 4-neighbour only where
// both lie in the mask and carry equal `labels`; each sweep replaces a label
// by the minimum over itself and its linked neighbours' positive labels.
// Reach is bounded by the sweep count, so the result must be Jacobi exactly:
// an in-place (Gauss-Seidel) update, union-find or pointer jumping would
// converge faster and disagree whenever the budget is the limit.
//
// Bound on the H100: launch latency, then memory traffic. One sweep moves
// ~0.7 MB at 240x320 (a label read per neighbour from L1/L2, one write),
// ~0.3 us of bandwidth against a few us of launch, and the sweeps are
// sequential. Design: the loop-invariant neighbour links are packed once
// into one byte per pixel; then one launch per sweep ping-pongs between two
// label buffers (the kernel boundary is the grid barrier a Jacobi sweep
// needs), and a last launch zeroes everything outside the mask.

#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr unsigned char kUp = 1, kDown = 2, kLeft = 4, kRight = 8, kIn = 16;

__global__ void links_kernel(const int* __restrict__ mask,
                             const int* __restrict__ labels,
                             unsigned char* __restrict__ links, int h, int w) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= h || c >= w) return;
  const int i = r * w + c;
  unsigned char bits = 0;
  if (mask[i] > 0) {
    const int lab = labels[i];
    bits = kIn;
    if (r > 0 && mask[i - w] > 0 && labels[i - w] == lab) bits |= kUp;
    if (r < h - 1 && mask[i + w] > 0 && labels[i + w] == lab) bits |= kDown;
    if (c > 0 && mask[i - 1] > 0 && labels[i - 1] == lab) bits |= kLeft;
    if (c < w - 1 && mask[i + 1] > 0 && labels[i + 1] == lab) bits |= kRight;
  }
  links[i] = bits;
}

__global__ void sweep_kernel(const int* __restrict__ comp_in,
                             int* __restrict__ comp_out,
                             const unsigned char* __restrict__ links, int h,
                             int w) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= h || c >= w) return;
  const int i = r * w + c;
  const unsigned char bits = links[i];
  const int self = comp_in[i];
  int best = self > 0 ? self : kBig;
  if (bits & kUp) { const int n = comp_in[i - w]; if (n > 0) best = min(best, n); }
  if (bits & kDown) { const int n = comp_in[i + w]; if (n > 0) best = min(best, n); }
  if (bits & kLeft) { const int n = comp_in[i - 1]; if (n > 0) best = min(best, n); }
  if (bits & kRight) { const int n = comp_in[i + 1]; if (n > 0) best = min(best, n); }
  comp_out[i] = ((bits & kIn) && best < kBig) ? best : self;
}

__global__ void finalize_kernel(const int* __restrict__ comp,
                                const unsigned char* __restrict__ links,
                                int* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = (links[i] & kIn) ? comp[i] : 0;
}

}  // namespace

// seed, mask, labels: (h, w) int32; out: (h, w) int32; ping, pong: (h, w)
// int32 scratch; links: (h, w) uint8 scratch.
extern "C" int cc_labels(const int* seed, const int* mask, const int* labels,
                         int* out, int* ping, int* pong, unsigned char* links,
                         int h, int w, int n_sweeps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  links_kernel<<<grid, block, 0, s>>>(mask, labels, links, h, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* cur = seed;
  int* bufs[2] = {ping, pong};
  for (int k = 0; k < n_sweeps; ++k) {
    int* nxt = bufs[k & 1];
    sweep_kernel<<<grid, block, 0, s>>>(cur, nxt, links, h, w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cur = nxt;
  }
  const int n = h * w;
  finalize_kernel<<<(n + 255) / 256, 256, 0, s>>>(cur, links, out, n);
  return static_cast<int>(cudaGetLastError());
}
