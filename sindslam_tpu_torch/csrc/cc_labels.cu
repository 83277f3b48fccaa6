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
// Bound on the H100: launch latency and barriers, not bytes or operations.
// A sweep of a 240x320 image is ~10 integer operations a pixel (a fraction
// of a microsecond on the whole card) but must see the whole previous sweep,
// and with one launch a sweep a call is 770 launches of ~3 us.
// Design: k sweeps a launch, in shared memory. A block loads a tile of
// tile_h x tile_w pixels: its interior with a halo of k pixels. Pixels
// outside the image are outside the mask. It derives each pixel's links from
// the mask and the cluster image as it loads them (a link across the tile's
// edge is cut), then runs k Jacobi sweeps on the tile, ping-ponging between
// two shared buffers with one barrier a sweep. A sweep spoils one more ring
// of the halo (its neighbours outside the tile are missing), so after k
// sweeps exactly the interior is still what the whole image would hold, and
// only the interior is written back. Launches ping-pong between two global
// buffers, so no block reads what another writes. ceil(n_sweeps / k)
// launches a call, the last one taking the remainder. Tiles are 64x64 and k
// is the largest of 24, 20, 16, 12 at which the blocks of a launch (tiles
// times lanes) are no more than the card's multiprocessors, else 8: for one
// lane 24 at 120x160 and 16 at 240x320, for the batched front-end's four
// lanes 16 at 120x160 and 8 at 240x320.
//  - Lanes: a call labels B images of one shape at once ((B, h, w) seeds,
//    masks and cluster images, the batched front-end's B frame pairs). The
//    lane is blockIdx.z, the mask and the cluster image take a lane stride
//    beside their row and column strides, and the two label buffers are
//    (B, h, w) each. A launch's blocks are the tiles of every lane, so the
//    wave rule above counts tiles times lanes. The fixed-point flag is
//    shared by the lanes: a launch goes on while any lane changed in the
//    launch before, and a sweep past a lane's own fixed point leaves it as it
//    is, so each lane is exactly the same call on that lane alone; an
//    unbatched call is the one-lane case.
//  - A thread owns a run of 4 pixels of a row for the whole launch (1024
//    threads, 16 runs a row): its own labels and its links stay in
//    registers, a sweep reads the rows above and below as two 16-byte shared
//    loads and the left and right neighbours by warp shuffle (a warp holds
//    two whole rows; what crosses a row's end is cut like any tile edge).
//    A sweep leaves out the rows from which nothing can reach the interior
//    in the sweeps that are left.
//  - "No label yet" is 2^30 and a neighbour that is not linked is ORed with
//    all ones, both compared as unsigned: one OR a neighbour and two
//    three-input minima (Hopper's DPX instructions) a pixel.
//  - Every launch writes labels in their final form (0 outside the mask), so
//    there is no pass after the last sweep, and the links need no image of
//    their own in device memory.
//  - Early exit, exact because labels never rise: a block whose tile did not
//    change in a sweep stops sweeping (the rest would be the identity on its
//    tile), and a launch in which no interior pixel changed leaves its word
//    of `flags` clear, at which the next launch returns at once and leaves
//    its own clear: the labels are a fixed point and both global buffers
//    hold it. The host enqueues every launch and never waits.
//  - A launch after the first of a call is a programmatic dependent launch:
//    its blocks start on multiprocessors the launch before leaves idle or
//    frees, load the mask and the cluster image (which no launch changes),
//    and wait for the launch before to end before they read its labels and
//    its flag. What one launch costs beyond its sweeps is mostly latency
//    (the gap between two kernels, two round trips to device memory), and
//    this hides part of it.
// Measured on the card and dropped: larger tiles (a block's sweep costs in
// proportion to its tile), one block holding a whole small image for every
// sweep, k beyond one wave of blocks, and launches that do not overlap.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr unsigned kBig = 1u << 30;    // no label yet
constexpr unsigned kUp = 1, kDown = 2, kLeft = 4, kRight = 8, kIn = 16;
constexpr int kTile = 64;              // side of the loaded tile
constexpr int kRuns = kTile / 4;       // runs of 4 pixels in a row
constexpr int kThreads = kTile * kRuns;
constexpr int kSMs = 132;              // an H100's: the blocks of one wave
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Image {
  const int* seed;     // (B, h, w) contiguous, or null: linear index + 1
  const void* mask;    // bytes or int32, in the mask where > 0
  const int* labels;   // or null: the mask's own values
  int mask_bytes;      // 1 or 4
  long long mask_sb, labels_sb;                // lane strides in elements
  int mask_sy, mask_sx, labels_sy, labels_sx;  // strides in elements
  int h, w;
};

// min of five, as two three-input minima where the toolkit has Hopper's
__device__ inline unsigned umin5(unsigned a, unsigned b, unsigned c,
                                 unsigned d, unsigned e) {
#if CUDART_VERSION >= 12000
  return __vimin3_u32(__vimin3_u32(a, b, c), d, e);
#else
  return min(min(a, b), min(min(c, d), e));
#endif
}

// out[e] = p[e * sx] for the pixels gc + e of a run that lie in [0, w); one
// 16-byte (int) or 4-byte (byte) load where the run is whole, dense and
// aligned
template <typename T>
__device__ inline void load_run(const T* p, int sx, bool whole, int gc, int w,
                                int* out) {
  using Vec = typename std::conditional<sizeof(T) == 4, int4, uchar4>::type;
  if (whole && sx == 1 && (reinterpret_cast<size_t>(p) & (sizeof(Vec) - 1)) == 0) {
    const Vec t = *reinterpret_cast<const Vec*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (gc + e >= 0 && gc + e < w) out[e] = p[static_cast<long long>(e) * sx];
  }
}

// in: the labels before this launch in their final form, or null on the
// first launch of a call (labels come from the seed). out: receives each
// block's interior. flags[launch]: whether the launch before changed a
// label; flags[launch + 1]: set if this one does. halo: the rings around the
// interior, at least `sweeps`.
__global__ void __launch_bounds__(kThreads, 1)
cc_tile_kernel(Image I, const int* __restrict__ in, int* __restrict__ out,
               int* __restrict__ flags, int launch, int sweeps, int halo) {
  // the next launch of the call may place its blocks while this one runs
  // (see launch_one): it waits below before it reads what this one writes
  asm volatile("griddepcontrol.launch_dependents;");
  // two label buffers and a mask byte a pixel, each with a row above and a
  // row below that are read and never used
  __shared__ __align__(16) unsigned s_a[(kTile + 2) * kTile];
  __shared__ __align__(16) unsigned s_b[(kTile + 2) * kTile];
  __shared__ __align__(16) unsigned char s_m[(kTile + 2) * kTile];
  unsigned* buf_a = s_a + kTile;
  unsigned* buf_b = s_b + kTile;
  unsigned char* s_in = s_m + kTile;
  const int tid = threadIdx.x;
  const int row = tid / kRuns, col = (tid % kRuns) * 4;  // the run in the tile
  const int i = row * kTile + col;
  const int side = kTile - 2 * halo;                     // of the interior
  const int gr = blockIdx.y * side - halo + row;         // the run in the image
  const int gc = blockIdx.x * side - halo + col;
  const int h = I.h, w = I.w;
  const bool any = gr >= 0 && gr < h && gc + 3 >= 0 && gc < w;
  const bool whole = gc >= 0 && gc + 3 < w;
  const int g = gr * w + gc;                             // within the lane
  // this block's lane: the label buffers and the seed are (B, h, w)
  const long long lane = blockIdx.z;
  const long long lane_px = lane * h * w;
  if (in != nullptr) in += lane_px;
  out += lane_px;
  const int* const seed = I.seed != nullptr ? I.seed + lane_px : nullptr;

  // load what no launch of the call changes: the cluster image to buf_b,
  // the mask to s_in (pixels outside the image are outside the mask)
  int mv[4] = {0, 0, 0, 0}, lv[4] = {0, 0, 0, 0};
  if (any) {
    const long long mo = lane * I.mask_sb +
                         static_cast<long long>(gr) * I.mask_sy +
                         static_cast<long long>(gc) * I.mask_sx;
    if (I.mask_bytes == 1) {
      load_run(static_cast<const unsigned char*>(I.mask) + mo, I.mask_sx,
               whole, gc, w, mv);
    } else {
      load_run(static_cast<const int*>(I.mask) + mo, I.mask_sx, whole, gc, w,
               mv);
    }
    if (I.labels != nullptr) {
      load_run(I.labels + lane * I.labels_sb +
                   static_cast<long long>(gr) * I.labels_sy +
                   static_cast<long long>(gc) * I.labels_sx,
               I.labels_sx, whole, gc, w, lv);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) lv[e] = mv[e];
    }
  }
  unsigned m = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) m |= (mv[e] > 0 ? 1u : 0u) << (8 * e);
  const uint4 me = make_uint4(lv[0], lv[1], lv[2], lv[3]);
  *reinterpret_cast<uint4*>(buf_b + i) = me;
  *reinterpret_cast<unsigned*>(s_in + i) = m;

  // the launch before has ended and its labels and its flag are written
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int go = in != nullptr ? flags[launch] : 1;
  // the labels before this launch, to buf_a (read whether or not the launch
  // goes on, so that the flag's latency and theirs overlap)
  int x[4] = {0, 0, 0, 0};
  if (any) {
    if (in != nullptr) {
      load_run(in + g, 1, whole, gc, w, x);
    } else if (seed != nullptr) {
      load_run(seed + g, 1, whole, gc, w, x);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = g + e + 1;
    }
  }
  unsigned v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = (((m >> (8 * e)) & 1u) && x[e] > 0 &&
            static_cast<unsigned>(x[e]) < kBig)
               ? static_cast<unsigned>(x[e]) : kBig;
  }
  uint4 own = make_uint4(v[0], v[1], v[2], v[3]);   // the run's labels
  *reinterpret_cast<uint4*>(buf_a + i) = own;
  if (!go) return;
  __syncthreads();

  // links, a byte a pixel (kUp .. kIn): both in the mask, equal cluster
  // labels, not across the tile edge. The rows above and below come as
  // 16-byte loads; what lies beyond the tile's first and last row is read
  // and not used.
  unsigned links = 0;
  {
    const uint4 up = *reinterpret_cast<const uint4*>(buf_b + i - kTile);
    const uint4 dn = *reinterpret_cast<const uint4*>(buf_b + i + kTile);
    const unsigned up_m = *reinterpret_cast<const unsigned*>(s_in + i - kTile);
    const unsigned dn_m = *reinterpret_cast<const unsigned*>(s_in + i + kTile);
    const unsigned left = __shfl_up_sync(kFull, me.w, 1);
    const unsigned right = __shfl_down_sync(kFull, me.x, 1);
    const unsigned left_m = __shfl_up_sync(kFull, m >> 24, 1);
    const unsigned right_m = __shfl_down_sync(kFull, m & 1u, 1);
    const unsigned c[4] = {me.x, me.y, me.z, me.w};
    const unsigned u[4] = {up.x, up.y, up.z, up.w};
    const unsigned d[4] = {dn.x, dn.y, dn.z, dn.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!((m >> (8 * e)) & 1u)) continue;
      const unsigned l_lab = e ? c[e - 1] : left;
      const unsigned r_lab = e < 3 ? c[e + 1] : right;
      const unsigned l_m = e ? (m >> (8 * (e - 1))) & 1u : left_m;
      const unsigned r_m = e < 3 ? (m >> (8 * (e + 1))) & 1u : right_m;
      unsigned b = kIn;
      if (row > 0 && ((up_m >> (8 * e)) & 1u) && u[e] == c[e]) b |= kUp;
      if (row < kTile - 1 && ((dn_m >> (8 * e)) & 1u) && d[e] == c[e]) b |= kDown;
      if (col + e > 0 && l_m && l_lab == c[e]) b |= kLeft;
      if (col + e < kTile - 1 && r_m && r_lab == c[e]) b |= kRight;
      links |= b << (8 * e);
    }
  }
  __syncthreads();

  // cuts[4 * e + d]: all ones where pixel e of the run has no link in
  // direction d (0 up, 1 down, 2 left, 3 right)
  unsigned cuts[16];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    cuts[n] = ((links >> (8 * (n >> 2) + (n & 3))) & 1u) - 1u;
  }
  unsigned ever = 0;   // whether the run changed in any sweep
  for (int s = 0; s < sweeps; ++s) {
    const unsigned* src = (s & 1) ? buf_b : buf_a;
    unsigned* dst = (s & 1) ? buf_a : buf_b;
    // rows that the interior can still hear of in the sweeps that are left:
    // the others are spoiled or will be, and are left as they are
    const int reach = sweeps - 1 - s;
    const uint4 cur = own;
    const unsigned left = __shfl_up_sync(kFull, cur.w, 1);
    const unsigned right = __shfl_down_sync(kFull, cur.x, 1);
    unsigned changed = 0;
    if (row >= halo - reach && row < kTile - halo + reach) {
      const uint4 up = *reinterpret_cast<const uint4*>(src + i - kTile);
      const uint4 dn = *reinterpret_cast<const uint4*>(src + i + kTile);
      uint4 nxt;
      nxt.x = umin5(cur.x, up.x | cuts[0], dn.x | cuts[1], left | cuts[2],
                    cur.y | cuts[3]);
      nxt.y = umin5(cur.y, up.y | cuts[4], dn.y | cuts[5], cur.x | cuts[6],
                    cur.z | cuts[7]);
      nxt.z = umin5(cur.z, up.z | cuts[8], dn.z | cuts[9], cur.y | cuts[10],
                    cur.w | cuts[11]);
      nxt.w = umin5(cur.w, up.w | cuts[12], dn.w | cuts[13], cur.z | cuts[14],
                    right | cuts[15]);
      changed = (nxt.x ^ cur.x) | (nxt.y ^ cur.y) | (nxt.z ^ cur.z) |
                (nxt.w ^ cur.w);
      ever |= changed;
      own = nxt;
      *reinterpret_cast<uint4*>(dst + i) = nxt;
    }
    // the tile is at its own fixed point: further sweeps change nothing
    if (!__syncthreads_or(changed)) break;
  }

  // write the interior back, in the final form. Labels only fall, so a run
  // of the interior that changed in some sweep differs from what was read.
  unsigned moved = 0;
  if (row >= halo && row < kTile - halo && gr < h && col + 3 >= halo &&
      col < kTile - halo && gc < w) {
    moved = ever;
    const unsigned lab[4] = {own.x, own.y, own.z, own.w};
    int val[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      val[e] = 0;
      if ((links >> (8 * e)) & kIn) {
        val[e] = lab[e] < kBig ? static_cast<int>(lab[e])
                               : (seed ? seed[g + e] : 0);
      }
    }
    if (col >= halo && col + 3 < kTile - halo && gc + 3 < w &&
        (reinterpret_cast<size_t>(out + g) & 15) == 0) {
      *reinterpret_cast<int4*>(out + g) =
          make_int4(val[0], val[1], val[2], val[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col + e >= halo && col + e < kTile - halo && gc + e < w) {
          out[g + e] = val[e];
        }
      }
    }
  }
  // the first launch reads no buffer: the second must run to fill its own
  if (in == nullptr) {
    moved = blockIdx.x == 0 && blockIdx.y == 0 && lane == 0 && tid == 0;
  }
  if (moved) flags[launch + 1] = 1;
}

// Sweeps a launch = rings of halo. A block's sweep costs the same whatever k
// is, so the most sweeps a launch whose blocks still run all at once (one a
// multiprocessor) make the fewest launches at no cost in time a sweep. A
// launch's blocks are the tiles of all its lanes.
int sweeps_a_launch(int h, int w, int lanes) {
  for (int k = 24; k > 8; k -= 4) {
    const int side = kTile - 2 * k;
    if (static_cast<long long>((h + side - 1) / side) *
            ((w + side - 1) / side) * lanes <= kSMs) {
      return k;
    }
  }
  return 8;
}

int n_launches(int k, int n_sweeps) {
  return n_sweeps <= 0 ? 1 : (n_sweeps + k - 1) / k;
}

// A launch after the first of a call is a programmatic dependent launch: its
// blocks may start, and load the mask and the cluster image, while the
// launch before still runs, and wait inside the kernel for that launch to
// end before they touch its labels.
cudaError_t launch_one(dim3 grid, cudaStream_t s, const Image& I,
                       const int* in, int* out, int* flags, int launch,
                       int sweeps, int halo) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = launch > 0 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, cc_tile_kernel, I, in, out, flags, launch,
                            sweeps, halo);
}

}  // namespace

// CUDA launches one call of cc_labels on `lanes` images makes.
extern "C" int cc_labels_launches(int h, int w, int n_sweeps, int lanes) {
  return n_launches(sweeps_a_launch(h, w, lanes), n_sweeps);
}

// seed: (B, h, w) int32, contiguous, or null (linear index + 1 inside each
// lane's mask). mask: (B, h, w) of mask_bytes (1 or 4) bytes an element,
// labels: (B, h, w) int32 or null (the mask's values), both with lane, row
// and column strides in elements. buf: (2, B, h, w) int32 scratch of any
// content; the result is buf[(launches - 1) % 2]. flags: launches + 1 int32
// words, zero. *n_launched (host) receives the launches made.
extern "C" int cc_labels(const int* seed, const void* mask, const int* labels,
                         int mask_bytes, long long mask_sb, int mask_sy,
                         int mask_sx, long long labels_sb, int labels_sy,
                         int labels_sx, int* buf, int* flags, int lanes, int h,
                         int w, int n_sweeps, int* n_launched, void* stream) {
  *n_launched = 0;
  if ((mask_bytes != 1 && mask_bytes != 4) || n_sweeps < 0 || h < 1 ||
      w < 1 || lanes < 1 || lanes > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Image I{seed, mask, labels, mask_bytes, mask_sb, labels_sb, mask_sy,
                mask_sx, labels_sy, labels_sx, h, w};
  const int k = sweeps_a_launch(h, w, lanes);
  const int side = kTile - 2 * k;
  const dim3 grid((w + side - 1) / side, (h + side - 1) / side, lanes);
  const size_t px = static_cast<size_t>(h) * w * lanes;
  int left = n_sweeps;
  for (int i = 0, n = n_launches(k, n_sweeps); i < n; ++i) {
    const int sweeps = left < k ? left : k;
    left -= sweeps;
    const cudaError_t err = launch_one(
        grid, static_cast<cudaStream_t>(stream), I,
        i ? buf + px * ((i - 1) & 1) : nullptr, buf + px * (i & 1), flags, i,
        sweeps, k);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*n_launched;
  }
  return 0;
}
