// K3: FAST-9/16 max-margin score, priority mix and 3x3 NMS, for every
// pyramid level of an atlas in one launch.
//
// Replaces fast_nms_pallas (sindslam_tpu/ops/pallas_kernels.py:368-384, body
// _make_fast_kernel 317-363), which takes one level a call. Score = max over
// the 16 cyclic starts of the minimum bright (or dark) margin along 9
// consecutive ring pixels; thresholded at min_th, +1000 above ini_th; then
// kept where it equals its 3x3 neighbourhood max (ties survive). A ring
// sample outside the LEVEL reads the centre pixel; an NMS neighbour outside
// the level reads 0. The image is an atlas: level l occupies rows
// [y0, y0 + h) and columns [0, w) of it; its bounds, not the atlas's, decide
// what is outside. Everything outside every level comes out 0, so the kernel
// writes the whole output.
//
// Bound on the H100: bytes and operations about level (~190 subtract, min
// and max a pixel against 8 bytes); a launch a level and a score image in
// device memory between two kernels would add launches that fill a fraction
// of the card at the small levels.
// Design: one launch for the atlas. A block owns a 32x32 output tile. It
// loads the image tile with a halo of 4 (3 for the ring, 1 for the
// neighbours' scores) into shared memory, computes the scores of the tile
// and one ring around it into shared memory, and takes the 3x3 maximum from
// there: the scores never reach device memory. A block with no pixel of any
// level writes zeros and returns.
// Lanes: a call scores a (B, H, W) stack of atlases that share one level
// layout (the batched front-end's B frames) in the same one launch: the lane
// is blockIdx.z, the grid of tiles times B. A block reads its own lane only,
// so a lane is exactly the same call on that atlas alone.
// Fewer operations, the same values: with d_k = ring_k - centre the bright
// margin of a run is the min of d over it, and the dark margin is the min of
// (centre - ring_k) = -d_k (IEEE subtraction is exactly antisymmetric), that
// is minus the max of d over the run. Minima and maxima over runs of 2, 4, 8
// and then 9 by doubling take 4 x 16 min and 4 x 16 max a pixel instead of
// 16 x 8 x 2 min with their subtractions. min and max are exact, associative
// and commutative, so the result equals the plain version's, which keeps
// the order of the Pallas body (the sign of a zero aside, which no
// comparison sees).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kTile = 32;             // output tile side
constexpr int kThreadsX = 32, kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kImg = kTile + 8;       // image tile side (halo 4)
constexpr int kSc = kTile + 2;        // score tile side (halo 1)

struct Levels {
  int n;
  int y0[kMaxLevels], h[kMaxLevels], w[kMaxLevels];
};

__global__ void __launch_bounds__(kThreads)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ out, int H,
                int W, Levels L, float min_th, float ini_th) {
  __shared__ float s_img[kImg * kImg];
  __shared__ float s_sc[kSc * kSc];
  __shared__ int s_lvl[kSc];  // level of atlas rows Y0 - 1 .. Y0 + kTile
  __shared__ int s_any;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int X0 = blockIdx.x * kTile, Y0 = blockIdx.y * kTile;
  const size_t lane_px = static_cast<size_t>(blockIdx.z) * H * W;
  img += lane_px;
  out += lane_px;

  if (tid == 0) s_any = 0;
  __syncthreads();
  if (tid < kSc) {
    const int y = Y0 - 1 + tid;
    int lvl = -1;
    for (int l = 0; l < L.n; ++l) {
      if (y >= L.y0[l] && y < L.y0[l] + L.h[l]) lvl = l;
    }
    s_lvl[tid] = lvl;
    if (lvl >= 0 && tid >= 1 && tid <= kTile && L.w[lvl] > X0) s_any = 1;
  }
  __syncthreads();
  if (!s_any) {
    for (int r = ty; r < kTile; r += kThreadsY) {
      const int y = Y0 + r, x = X0 + tx;
      if (y < H && x < W) out[y * W + x] = 0.0f;
    }
    return;
  }

  for (int i = tid; i < kImg * kImg; i += kThreads) {
    const int y = Y0 - 4 + i / kImg, x = X0 - 4 + i % kImg;
    s_img[i] = (y >= 0 && y < H && x >= 0 && x < W) ? img[y * W + x] : 0.0f;
  }
  __syncthreads();

  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  for (int i = tid; i < kSc * kSc; i += kThreads) {
    const int sy = i / kSc, sx = i % kSc;
    const int lvl = s_lvl[sy];
    const int x = X0 - 1 + sx;
    float sc = 0.0f;
    if (lvl >= 0 && x >= 0 && x < L.w[lvl]) {
      const int ly = Y0 - 1 + sy - L.y0[lvl], lh = L.h[lvl], lw = L.w[lvl];
      const float* p = s_img + (sy + 3) * kImg + sx + 3;
      const float c = *p;
      const bool inner = ly >= 3 && ly < lh - 3 && x >= 3 && x < lw - 3;
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const bool inb = inner || (ly + kDy[k] >= 0 && ly + kDy[k] < lh &&
                                   x + kDx[k] >= 0 && x + kDx[k] < lw);
        d[k] = (inb ? p[kDy[k] * kImg + kDx[k]] : c) - c;
      }
      float lo[16], hi[16], t_lo[16], t_hi[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {  // runs of 2
        lo[k] = fminf(d[k], d[(k + 1) & 15]);
        hi[k] = fmaxf(d[k], d[(k + 1) & 15]);
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {  // runs of 4
        t_lo[k] = fminf(lo[k], lo[(k + 2) & 15]);
        t_hi[k] = fmaxf(hi[k], hi[(k + 2) & 15]);
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {  // runs of 8
        lo[k] = fminf(t_lo[k], t_lo[(k + 4) & 15]);
        hi[k] = fmaxf(t_hi[k], t_hi[(k + 4) & 15]);
      }
      float best_b = -1e9f, worst_d = 1e9f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {  // runs of 9, and the best start
        best_b = fmaxf(best_b, fminf(lo[k], d[(k + 8) & 15]));
        worst_d = fminf(worst_d, fmaxf(hi[k], d[(k + 8) & 15]));
      }
      // the dark margins are minus the run maxima: their max is minus the
      // least run maximum, held at -1e9 from below as the bright one is
      sc = fmaxf(best_b, 0.0f - worst_d);
      sc = sc > min_th ? sc : 0.0f;
      if (sc > ini_th) sc = sc + 1000.0f;
    }
    s_sc[i] = sc;
  }
  __syncthreads();

  for (int r = ty; r < kTile; r += kThreadsY) {
    const int y = Y0 + r, x = X0 + tx;
    if (y >= H || x >= W) continue;
    const int lvl = s_lvl[r + 1];
    float val = 0.0f;
    if (lvl >= 0 && x < L.w[lvl]) {
      const int ly = y - L.y0[lvl], lh = L.h[lvl], lw = L.w[lvl];
      const float* p = s_sc + (r + 1) * kSc + tx + 1;
      const float s = *p;
      float m = s;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          if (dy == 0 && dx == 0) continue;
          const bool inb = ly + dy >= 0 && ly + dy < lh && x + dx >= 0 &&
                           x + dx < lw;
          m = fmaxf(m, inb ? p[dy * kSc + dx] : 0.0f);
        }
      }
      val = s >= m ? s : 0.0f;
    }
    out[y * W + x] = val;
  }
}

}  // namespace

// img, out: (B, H, W) float32, contiguous. levels: n_levels triples
// (y0, h, w) in host memory, rows [y0, y0 + h) of the levels disjoint and
// inside the image; every lane has this layout.
extern "C" int fast_nms(const float* img, float* out, int lanes, int H, int W,
                        const int* levels, int n_levels, float min_th,
                        float ini_th, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || lanes < 1 || lanes > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels L;
  L.n = n_levels;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool on = l < n_levels;
    L.y0[l] = on ? levels[3 * l] : 0;
    L.h[l] = on ? levels[3 * l + 1] : 0;
    L.w[l] = on ? levels[3 * l + 2] : 0;
    if (on && (L.y0[l] < 0 || L.h[l] < 1 || L.y0[l] + L.h[l] > H ||
               L.w[l] < 1 || L.w[l] > W)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, lanes);
  fast_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, H, W, L, min_th, ini_th);
  return static_cast<int>(cudaGetLastError());
}
