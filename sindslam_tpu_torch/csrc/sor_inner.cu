// K1: one variational-flow inner solve on a pyramid level, for Hopper.
//
// Replaces sor_inner_pallas (sindslam_tpu/ops/pallas_kernels.py:169-199,
// body _make_kernel 55-163). `inner` lagged re-weightings (robust data,
// gradient and smoothness weights, each 1 / sqrt(x^2 + 1e-6)), each followed by
// `sweeps` red-black SOR sweeps on (du, dv) with relaxation omega.
//
// Bound on the H100: launch latency and barriers, not bytes or operations.
// The whole 288x384 level is 5 MB of inputs against ~20 MFLOP per
// re-weighting (a few microseconds either way), but every colour half-sweep
// must see the whole previous one: a red pixel reads only black neighbours
// and the reverse, so a half-sweep is parallel and exact, and between two of
// them stands a barrier. With one launch per half-sweep a call costs
// inner * (1 + 2 * sweeps) = 85 launches of ~4 us each.
// Design: the state of a solve lives in shared memory (12 floats a pixel,
// each field with a ring of zeros around the tile:
// du, dv, u, v, the smoothness weight psi_s, and the 7 sweep-invariant terms
// cu, cv, a12, 1/diag_u, 1/diag_v and the two edge-weight fields), and the
// barrier between half-sweeps is __syncthreads(). One kernel, two regimes,
// chosen by sor_inner_launches from the level's size:
//  - a level that with its ring has at most kMaxPixels pixels is one
//    block's tile: one launch runs all `inner` re-weightings and every sweep;
//  - a larger level is cut into interiors of kTile - 2 * halo pixels a side.
//    A block loads its interior with a halo of 2 * sweeps + 1 pixels and
//    runs one re-weighting and all its sweeps on the tile: each half-sweep
//    spoils one more ring of the halo (its neighbours outside the tile were
//    not updated), so the block updates a region that shrinks by one ring per
//    half-sweep and ends exactly on its interior. The re-weighting costs the
//    extra ring: psi_s of a neighbour reads that neighbour's neighbours.
//    Halo pixels repeat the arithmetic of the block that owns them on the
//    same values, so interiors agree bit for bit with the stepwise order.
//    One launch per re-weighting: `inner` launches a call. Blocks read
//    (du, dv) of the previous re-weighting from one buffer and write their
//    interiors to the other, so no block reads what another is writing.
// The image border is not a tile border: a tile is clipped to the image,
// neighbour indices replicate-clamp and the edge weights across the border
// are zero, inside tiles too; a clipped side does not shrink.
// psi_s is computed once per pixel. The edge weights are symmetric
// (w_down(r, c) = w_up(r + 1, c), w_right(r, c) = w_left(r, c + 1), the sum
// of the same two floats), so two fields serve four directions.
// Lanes: a call solves B levels of one shape at once (the batched
// front-end's B frame pairs, (B, h, w) fields). The lane is blockIdx.z: the
// single-block regime is B blocks in one launch, the tiled regime the grid
// of tiles times B, and the (du, dv) ping-pong buffer is (B, 2, 2, h, w).
// No block reads another lane, so a lane is computed exactly as the same
// call on that lane alone; an unbatched call is the one-lane case.
// Arithmetic: the expression shapes of the plain version
// (cuda_kernels.sor_inner_plain), (alpha * w) * inv * neighbour summed left
// to right, built with --fmad=false (ops/_build.py), with IEEE sqrtf and
// division in place of rsqrtf: every operation rounds once, as each PyTorch
// op of the plain version does on the card and on the CPU, so the kernel
// gives the plain version's bits.

#include <cuda_runtime.h>

namespace {

constexpr float kEps2 = 1e-6f;
constexpr int kTile = 64;          // loaded tile side of the tiled regime
constexpr int kMinInterior = 14;   // smallest interior side worth tiling
constexpr int kBlockX = 32, kBlockY = 32;
constexpr int kFields = 12;        // shared-memory floats per pixel
constexpr int kMaxSmemBytes = 232448;  // 227 KB a block on sm_90
constexpr int kMaxPixels = kMaxSmemBytes / (kFields * 4);  // 4842

struct Level {
  const float* ix; const float* iy; const float* iz;
  const float* ixx; const float* ixy; const float* iyy;
  const float* ixz; const float* iyz;
  const float* u; const float* v;
  int h; int w;
};

// An even row pitch keeps the half-sweeps free of bank conflicts.
__host__ __device__ inline int padded_width(int w) { return (w + 1) & ~1; }

struct Params {
  float alpha; float gamma; float omega;
  int sweeps;
  int n_iter;    // re-weightings run inside one launch
  int interior;  // interior side per block
  int halo;      // rings loaded around the interior
};

// Lane blockIdx.z of the fields and of buf, the (B, 2, 2, h, w) ping-pong
// of (du, dv) pairs: pair `in` holds the increment before this launch (or
// there is none: zero), pair `out` receives each block's interior.
__global__ void __launch_bounds__(kBlockX* kBlockY, 1)
sor_tile_kernel(Level L, float* __restrict__ buf, int in, int out, Params P) {
  extern __shared__ float smem[];
  const int h = L.h, w = L.w;
  const int tx = threadIdx.x, ty = threadIdx.y;
  // offsets of this block's lane (the host keeps 4 B h w below 2^31): its
  // fields at f0, its du and dv before and after this launch in buf. Offsets
  // and not moved pointers keep the fields' addresses in the parameters
  // instead of registers.
  const int px = h * w;
  const int f0 = blockIdx.z * px;
  const int du_in = 4 * f0 + 2 * px * in, du_out = 4 * f0 + 2 * px * out;

  // interior [R0, R1) x [C0, C1); loaded tile [r_lo, r_hi) x [c_lo, c_hi),
  // clipped to the image
  const int R0 = blockIdx.y * P.interior, R1 = min(R0 + P.interior, h);
  const int C0 = blockIdx.x * P.interior, C1 = min(C0 + P.interior, w);
  const int r_lo = max(R0 - P.halo, 0), r_hi = min(R1 + P.halo, h);
  const int c_lo = max(C0 - P.halo, 0), c_hi = min(C1 + P.halo, w);
  const int th = r_hi - r_lo, tw = c_hi - c_lo;
  // every field carries a ring of one pixel around the tile, so that
  // index lr * pw + lc holds for -1 <= lr <= th and -1 <= lc <= tw
  const int pw = padded_width(tw + 2);  // shared-memory row pitch
  const int n = (th + 2) * pw;
  // a side is open where the tile ends inside the image: values beyond it
  // are unknown, so what is valid shrinks from that side
  const int top = r_lo > 0, bottom = r_hi < h;
  const int left = c_lo > 0, right = c_hi < w;

  float* s_du = smem + pw + 1;
  float* s_dv = s_du + n;
  float* s_u = s_dv + n;
  float* s_v = s_u + n;
  float* s_ps = s_v + n;
  float* s_cu = s_ps + n;
  float* s_cv = s_cu + n;
  float* s_a12 = s_cv + n;
  float* s_idu = s_a12 + n;
  float* s_idv = s_idu + n;
  float* s_wv = s_idv + n;  // alpha * weight of the edge to the pixel above
  float* s_wh = s_wv + n;   // alpha * weight of the edge to the left pixel

  // The ring holds zero flow under zero edge weights: a half-sweep reads
  // its four neighbours without clamping, and what it reads across the
  // image border counts for nothing, as the clamped neighbour does.
  for (int lr = ty - 1; lr <= th; lr += kBlockY) {
    for (int lc = tx - 1; lc <= tw; lc += kBlockX) {
      const bool inside = lr >= 0 && lr < th && lc >= 0 && lc < tw;
      const int g = (r_lo + lr) * w + c_lo + lc;
      const int i = lr * pw + lc;
      s_u[i] = inside ? L.u[f0 + g] : 0.0f;
      s_v[i] = inside ? L.v[f0 + g] : 0.0f;
      s_du[i] = inside && in >= 0 ? buf[du_in + g] : 0.0f;
      s_dv[i] = inside && in >= 0 ? buf[du_in + px + g] : 0.0f;
      s_wv[i] = 0.0f;
      s_wh[i] = 0.0f;
    }
  }
  __syncthreads();

  for (int it = 0; it < P.n_iter; ++it) {
    // psi_s: smoothness weight on the total flow (u + du, v + dv), replicate
    // borders; valid one ring inside an open side
    for (int lr = top + ty; lr < th - bottom; lr += kBlockY) {
      const int gr = r_lo + lr;
      const int ru = (gr > 0 ? lr - 1 : lr) * pw;
      const int rd = (gr < h - 1 ? lr + 1 : lr) * pw;
      for (int lc = left + tx; lc < tw - right; lc += kBlockX) {
        const int gc = c_lo + lc;
        const int cl = gc > 0 ? lc - 1 : lc;
        const int cr = gc < w - 1 ? lc + 1 : lc;
        const int rc = lr * pw;
        auto U = [&](int i) { return s_u[i] + s_du[i]; };
        auto V = [&](int i) { return s_v[i] + s_dv[i]; };
        const float ux = (U(rc + cr) - U(rc + cl)) * 0.5f;
        const float uy = (U(rd + lc) - U(ru + lc)) * 0.5f;
        const float vx = (V(rc + cr) - V(rc + cl)) * 0.5f;
        const float vy = (V(rd + lc) - V(ru + lc)) * 0.5f;
        s_ps[rc + lc] =
            1.0f / sqrtf(ux * ux + uy * uy + vx * vx + vy * vy + kEps2);
      }
    }
    __syncthreads();

    // edge weights wherever psi_s and its up / left neighbour are valid;
    // the sweep-invariant terms two rings inside an open side
    for (int lr = top + ty; lr < th - bottom; lr += kBlockY) {
      const int gr = r_lo + lr;
      const bool in_q_row = lr >= 2 * top && lr < th - 2 * bottom;
      for (int lc = left + tx; lc < tw - right; lc += kBlockX) {
        const int gc = c_lo + lc;
        const int i = lr * pw + lc;
        const float ps = s_ps[i];
        const float w_up =
            (gr > 0 && lr > top) ? 0.5f * (ps + s_ps[i - pw]) : 0.0f;
        const float w_left =
            (gc > 0 && lc > left) ? 0.5f * (ps + s_ps[i - 1]) : 0.0f;
        s_wv[i] = P.alpha * w_up;
        s_wh[i] = P.alpha * w_left;
        if (!in_q_row || lc < 2 * left || lc >= tw - 2 * right) continue;

        const float w_down =
            gr < h - 1 ? 0.5f * (ps + s_ps[i + pw]) : 0.0f;
        const float w_right =
            gc < w - 1 ? 0.5f * (ps + s_ps[i + 1]) : 0.0f;
        const float wsum = w_up + w_down + w_left + w_right;

        const int g = f0 + gr * w + gc;
        const float ix = L.ix[g], iy = L.iy[g], iz = L.iz[g];
        const float ixx = L.ixx[g], ixy = L.ixy[g], iyy = L.iyy[g];
        const float ixz = L.ixz[g], iyz = L.iyz[g];
        const float d_u = s_du[i], d_v = s_dv[i];

        const float r_data = iz + ix * d_u + iy * d_v;
        const float psi_d = 1.0f / sqrtf(r_data * r_data + kEps2);
        const float gx = ixz + ixx * d_u + ixy * d_v;
        const float gy = iyz + ixy * d_u + iyy * d_v;
        const float psi_g =
            1.0f / sqrtf(gx * gx + gy * gy + kEps2) * P.gamma;

        const float a11 = psi_d * ix * ix + psi_g * (ixx * ixx + ixy * ixy);
        const float a12 = psi_d * ix * iy + psi_g * (ixx * ixy + ixy * iyy);
        const float a22 = psi_d * iy * iy + psi_g * (ixy * ixy + iyy * iyy);
        const float b_u =
            -(psi_d * ix * iz + psi_g * (ixx * ixz + ixy * iyz));
        const float b_v =
            -(psi_d * iy * iz + psi_g * (ixy * ixz + iyy * iyz));
        const float inv_du = 1.0f / (a11 + P.alpha * wsum + 1e-12f);
        const float inv_dv = 1.0f / (a22 + P.alpha * wsum + 1e-12f);

        // the neighbour sum over the BASE flow is constant across sweeps;
        // a clamped neighbour is the pixel itself, under a zero weight
        const int iu = gr > 0 ? i - pw : i, id = gr < h - 1 ? i + pw : i;
        const int il = gc > 0 ? i - 1 : i, ir = gc < w - 1 ? i + 1 : i;
        const float su_base = w_up * s_u[iu] + w_down * s_u[id] +
                              w_left * s_u[il] + w_right * s_u[ir] -
                              wsum * s_u[i];
        const float sv_base = w_up * s_v[iu] + w_down * s_v[id] +
                              w_left * s_v[il] + w_right * s_v[ir] -
                              wsum * s_v[i];
        s_cu[i] = (b_u + P.alpha * su_base) * inv_du;
        s_cv[i] = (b_v + P.alpha * sv_base) * inv_dv;
        s_a12[i] = a12;
        s_idu[i] = inv_du;
        s_idv[i] = inv_dv;
      }
    }
    __syncthreads();

    // half-sweep k (1-based) updates one colour where its neighbours are
    // still valid: k + 1 rings inside an open side. A warp takes two rows,
    // 16 pixels of the colour in each: the colour sits on even columns in
    // one row and on odd ones in the next, so with an even pitch the warp's
    // 32 stride-2 addresses fall on 32 different banks. A thread relaxes two
    // pixels 32 columns apart and stores both afterwards, so that their
    // loads overlap.
    const int half = tx >> 4, lane16 = tx & 15;
    auto relax = [&](int lr, int lc, float& out_du, float& out_dv) {
      const int i = lr * pw + lc;
      const int iu = i - pw, id = i + pw, il = i - 1, ir = i + 1;
      const float awu = s_wv[i], awd = s_wv[id];
      const float awl = s_wh[i], awr = s_wh[ir];
      const float inv_du = s_idu[i], inv_dv = s_idv[i];
      const float a12 = s_a12[i];
      // neighbours are of the other colour: untouched by this half-sweep
      const float new_du =
          s_cu[i] - (a12 * inv_du) * s_dv[i] + awu * inv_du * s_du[iu] +
          awd * inv_du * s_du[id] + awl * inv_du * s_du[il] +
          awr * inv_du * s_du[ir];
      const float new_dv =
          s_cv[i] - (a12 * inv_dv) * new_du + awu * inv_dv * s_dv[iu] +
          awd * inv_dv * s_dv[id] + awl * inv_dv * s_dv[il] +
          awr * inv_dv * s_dv[ir];
      out_du = (1.0f - P.omega) * s_du[i] + P.omega * new_du;
      out_dv = (1.0f - P.omega) * s_dv[i] + P.omega * new_dv;
    };
    for (int k = 1; k <= 2 * P.sweeps; ++k) {
      const int color = (k - 1) & 1;  // red, (r + c) even, first
      const int ra = top ? k + 1 : 0, rb = bottom ? th - 1 - k : th;
      const int ca = left ? k + 1 : 0, cb = right ? tw - 1 - k : tw;
      for (int lr = ra + 2 * ty + half; lr < rb; lr += 2 * kBlockY) {
        const int first = ca + ((r_lo + lr + c_lo + ca + color) & 1);
        for (int lc = first + 2 * lane16; lc < cb; lc += 64) {
          const bool two = lc + 32 < cb;
          float du_a, dv_a, du_b = 0.0f, dv_b = 0.0f;
          relax(lr, lc, du_a, dv_a);
          if (two) relax(lr, lc + 32, du_b, dv_b);
          s_du[lr * pw + lc] = du_a;
          s_dv[lr * pw + lc] = dv_a;
          if (two) {
            s_du[lr * pw + lc + 32] = du_b;
            s_dv[lr * pw + lc + 32] = dv_b;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int gr = R0 + ty; gr < R1; gr += kBlockY) {
    for (int gc = C0 + tx; gc < C1; gc += kBlockX) {
      const int i = (gr - r_lo) * pw + gc - c_lo;
      buf[du_out + gr * w + gc] = s_du[i];
      buf[du_out + px + gr * w + gc] = s_dv[i];
    }
  }
}

// shared-memory pixels of a tile of h x w with its ring
long long tile_pixels(int h, int w) {
  return static_cast<long long>(h + 2) * padded_width(w + 2);
}

bool fits_one_block(int h, int w) { return tile_pixels(h, w) <= kMaxPixels; }

}  // namespace

// CUDA launches one call of sor_inner makes at this size, or -1 where the
// level needs tiles and 2 * sweeps + 1 rings of halo leave a tile of kTile
// pixels a side no interior worth computing.
extern "C" int sor_inner_launches(int h, int w, int inner, int sweeps) {
  if (fits_one_block(h, w)) return 1;
  if (kTile - 2 * (2 * sweeps + 1) < kMinInterior) return -1;
  return inner;
}

// The 10 fields are (B, h, w) float32, contiguous. buf is (B, 2, 2, h, w)
// float32 scratch of any content: two (du, dv) pairs a lane. The result is
// pair (inner - 1) % 2 of each lane.
extern "C" int sor_inner(const float* ix, const float* iy, const float* iz,
                         const float* ixx, const float* ixy, const float* iyy,
                         const float* ixz, const float* iyz, const float* u,
                         const float* v, float* buf, int lanes, int h, int w,
                         float alpha, float gamma, float omega, int inner,
                         int sweeps, void* stream) {
  if (inner < 1 || sweeps < 0 || lanes < 1 || lanes > 65535 ||
      4LL * lanes * h * w >= (1LL << 31) ||
      sor_inner_launches(h, w, inner, sweeps) < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Level L{ix, iy, iz, ixx, ixy, iyy, ixz, iyz, u, v, h, w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      sor_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kBlockX, kBlockY);

  if (fits_one_block(h, w)) {
    const Params P{alpha, gamma, omega, sweeps, inner, h > w ? h : w, 0};
    sor_tile_kernel<<<dim3(1, 1, lanes), block,
                      kFields * 4 * tile_pixels(h, w), s>>>(
        L, buf, -1, (inner - 1) % 2, P);
    return static_cast<int>(cudaGetLastError());
  }

  const int halo = 2 * sweeps + 1;
  const int interior = kTile - 2 * halo;
  const Params P{alpha, gamma, omega, sweeps, 1, interior, halo};
  const dim3 grid((w + interior - 1) / interior, (h + interior - 1) / interior,
                  lanes);
  const size_t smem = kFields * 4 * tile_pixels(kTile, kTile);
  for (int it = 0; it < inner; ++it) {
    const int out = it % 2;
    sor_tile_kernel<<<grid, block, smem, s>>>(L, buf, it ? 1 - out : -1, out,
                                              P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
