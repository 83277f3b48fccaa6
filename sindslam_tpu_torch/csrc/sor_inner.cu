// K1: one variational-flow inner solve on a pyramid level, for Hopper.
//
// Replaces sor_inner_pallas (sindslam_tpu/ops/pallas_kernels.py:169-199,
// body _make_kernel 55-163). `inner` lagged re-weightings (robust data,
// gradient and smoothness weights, each rsqrt(x^2 + 1e-6)), each followed by
// `sweeps` red-black SOR sweeps on (du, dv) with relaxation omega.
//
// Bound on the H100: memory traffic. A 288x384 level is 442 KB per field, so
// the 10 input fields, du/dv and the 10 sweep-invariant coefficient fields
// (~10 MB) live in the 50 MB L2 but not in one SM's shared memory, and every
// colour half-sweep needs a grid-wide barrier: a red pixel reads only black
// neighbours and the reverse, so each half-sweep is parallel and exact, but
// it must see the whole previous half-sweep.
// Design: one launch per re-weighting (computes and stores the coefficients,
// folding the sweep-invariant terms as the Pallas body does) and one launch
// per colour half-sweep (updates du/dv in place). One call issues
// inner * (1 + 2 * sweeps) launches on the caller's stream; the kernel
// boundaries are the grid barriers.

#include <cuda_runtime.h>

namespace {

constexpr float kEps2 = 1e-6f;

struct Level {
  const float* ix; const float* iy; const float* iz;
  const float* ixx; const float* ixy; const float* iyy;
  const float* ixz; const float* iyz;
  const float* u; const float* v;
  int h; int w;
};

__device__ __forceinline__ float psi_s_at(const Level& L, const float* du,
                                          const float* dv, int r, int c) {
  // smoothness weight on the total flow (u + du, v + dv), replicate borders
  const int w = L.w;
  const int rl = max(r - 1, 0), rh = min(r + 1, L.h - 1);
  const int cl = max(c - 1, 0), ch = min(c + 1, w - 1);
  auto U = [&](int y, int x) { int i = y * w + x; return L.u[i] + du[i]; };
  auto V = [&](int y, int x) { int i = y * w + x; return L.v[i] + dv[i]; };
  const float ux = (U(r, ch) - U(r, cl)) * 0.5f;
  const float uy = (U(rh, c) - U(rl, c)) * 0.5f;
  const float vx = (V(r, ch) - V(r, cl)) * 0.5f;
  const float vy = (V(rh, c) - V(rl, c)) * 0.5f;
  return rsqrtf(ux * ux + uy * uy + vx * vx + vy * vy + kEps2);
}

__global__ void reweight_kernel(Level L, const float* __restrict__ du,
                                const float* __restrict__ dv,
                                float* __restrict__ coef, float alpha,
                                float gamma) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  const int h = L.h, w = L.w;
  if (r >= h || c >= w) return;
  const int i = r * w + c;
  const float ix = L.ix[i], iy = L.iy[i], iz = L.iz[i];
  const float ixx = L.ixx[i], ixy = L.ixy[i], iyy = L.iyy[i];
  const float ixz = L.ixz[i], iyz = L.iyz[i];
  const float d_u = du[i], d_v = dv[i];

  const float r_data = iz + ix * d_u + iy * d_v;
  const float psi_d = rsqrtf(r_data * r_data + kEps2);
  const float gx = ixz + ixx * d_u + ixy * d_v;
  const float gy = iyz + ixy * d_u + iyy * d_v;
  const float psi_g = rsqrtf(gx * gx + gy * gy + kEps2) * gamma;

  const int up = max(r - 1, 0), down = min(r + 1, h - 1);
  const int left = max(c - 1, 0), right = min(c + 1, w - 1);
  const float ps = psi_s_at(L, du, dv, r, c);
  const float w_up = r > 0 ? 0.5f * (ps + psi_s_at(L, du, dv, up, c)) : 0.0f;
  const float w_down =
      r < h - 1 ? 0.5f * (ps + psi_s_at(L, du, dv, down, c)) : 0.0f;
  const float w_left =
      c > 0 ? 0.5f * (ps + psi_s_at(L, du, dv, r, left)) : 0.0f;
  const float w_right =
      c < w - 1 ? 0.5f * (ps + psi_s_at(L, du, dv, r, right)) : 0.0f;
  const float wsum = w_up + w_down + w_left + w_right;

  const float a11 = psi_d * ix * ix + psi_g * (ixx * ixx + ixy * ixy);
  const float a12 = psi_d * ix * iy + psi_g * (ixx * ixy + ixy * iyy);
  const float a22 = psi_d * iy * iy + psi_g * (ixy * ixy + iyy * iyy);
  const float b_u = -(psi_d * ix * iz + psi_g * (ixx * ixz + ixy * iyz));
  const float b_v = -(psi_d * iy * iz + psi_g * (ixy * ixz + iyy * iyz));
  const float inv_du = 1.0f / (a11 + alpha * wsum + 1e-12f);
  const float inv_dv = 1.0f / (a22 + alpha * wsum + 1e-12f);

  // the neighbour sum over the BASE flow is constant across sweeps
  const float* u = L.u;
  const float* v = L.v;
  const float su_base = w_up * u[up * w + c] + w_down * u[down * w + c] +
                        w_left * u[r * w + left] + w_right * u[r * w + right] -
                        wsum * u[i];
  const float sv_base = w_up * v[up * w + c] + w_down * v[down * w + c] +
                        w_left * v[r * w + left] + w_right * v[r * w + right] -
                        wsum * v[i];
  const int n = h * w;
  coef[0 * n + i] = (b_u + alpha * su_base) * inv_du;
  coef[1 * n + i] = (b_v + alpha * sv_base) * inv_dv;
  coef[2 * n + i] = a12 * inv_du;
  coef[3 * n + i] = a12 * inv_dv;
  coef[4 * n + i] = alpha * w_up;
  coef[5 * n + i] = alpha * w_down;
  coef[6 * n + i] = alpha * w_left;
  coef[7 * n + i] = alpha * w_right;
  coef[8 * n + i] = inv_du;
  coef[9 * n + i] = inv_dv;
}

__global__ void color_kernel(const float* __restrict__ coef, float* du,
                             float* dv, int h, int w, int color,
                             float omega) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= h || c >= w || ((r + c) & 1) != color) return;
  const int n = h * w;
  const int i = r * w + c;
  const int iu = max(r - 1, 0) * w + c, id = min(r + 1, h - 1) * w + c;
  const int il = r * w + max(c - 1, 0), ir = r * w + min(c + 1, w - 1);
  const float inv_du = coef[8 * n + i], inv_dv = coef[9 * n + i];
  const float awu = coef[4 * n + i], awd = coef[5 * n + i];
  const float awl = coef[6 * n + i], awr = coef[7 * n + i];
  // neighbours are of the other colour: untouched by this launch
  const float new_du = coef[0 * n + i] - coef[2 * n + i] * dv[i] +
                       awu * inv_du * du[iu] + awd * inv_du * du[id] +
                       awl * inv_du * du[il] + awr * inv_du * du[ir];
  const float new_dv = coef[1 * n + i] - coef[3 * n + i] * new_du +
                       awu * inv_dv * dv[iu] + awd * inv_dv * dv[id] +
                       awl * inv_dv * dv[il] + awr * inv_dv * dv[ir];
  du[i] = (1.0f - omega) * du[i] + omega * new_du;
  dv[i] = (1.0f - omega) * dv[i] + omega * new_dv;
}

}  // namespace

extern "C" int sor_inner(const float* ix, const float* iy, const float* iz,
                         const float* ixx, const float* ixy, const float* iyy,
                         const float* ixz, const float* iyz, const float* u,
                         const float* v, float* du, float* dv, float* coef,
                         int h, int w, float alpha, float gamma, float omega,
                         int inner, int sweeps, void* stream) {
  // du, dv arrive zeroed; coef is (10, h, w) scratch:
  // cu cv a12u a12v awu awd awl awr inv_du inv_dv
  const Level L{ix, iy, iz, ixx, ixy, iyy, ixz, iyz, u, v, h, w};
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int it = 0; it < inner; ++it) {
    reweight_kernel<<<grid, block, 0, s>>>(L, du, dv, coef, alpha, gamma);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int sw = 0; sw < sweeps; ++sw) {
      for (int color = 0; color < 2; ++color) {
        color_kernel<<<grid, block, 0, s>>>(coef, du, dv, h, w, color, omega);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}
