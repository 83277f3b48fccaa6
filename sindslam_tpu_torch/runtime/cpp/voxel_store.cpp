// Native voxel map store + asynchronous insertion pipeline.
//
// TPU-native replacement for the reference's octomap back-end
// (octomap_pub/src/pubPointCloud.cc: per-point insertRay + integrateNodeColor
// into a ColorOcTree, reference :300-320) and its ROS decoupling: the DEVICE
// does the geometric work in batch (back-projection, occlusion veto, ray
// voxelization -> flat arrays of voxel coords), and this store integrates
// log-odds occupancy + color on a background thread, so tracking never waits
// on mapping (the role ROS pub/sub played between the two reference nodes).
//
// Plain C ABI for ctypes. Built with g++ at first use by
// sindslam_tpu_torch/runtime/native.py (flags there).
//
// Voxel key packing: 21 bits per axis, biased; resolution fixed at creation
// (reference: 0.02 m, pubPointCloud.cc:91).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <limits>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr int64_t kBias = 1 << 20;  // 21-bit signed range per axis

inline int64_t pack(int32_t x, int32_t y, int32_t z) {
  return (((int64_t)(x + kBias)) << 42) | (((int64_t)(y + kBias)) << 21) |
         ((int64_t)(z + kBias));
}

inline void unpack(int64_t k, int32_t* x, int32_t* y, int32_t* z) {
  *x = (int32_t)((k >> 42) & 0x1FFFFF) - kBias;
  *y = (int32_t)((k >> 21) & 0x1FFFFF) - kBias;
  *z = (int32_t)(k & 0x1FFFFF) - kBias;
}

struct Cell {
  float log_odds = 0.f;
  uint32_t r = 0, g = 0, b = 0;
  uint32_t hits = 0;
};

struct Batch {
  std::vector<int32_t> xyz;   // n*3 voxel coords
  std::vector<uint8_t> rgb;   // n*3 (only meaningful for hits)
  std::vector<uint8_t> hit;   // n
};

struct VoxelStore {
  double resolution;
  float lo_hit, lo_miss, lo_min, lo_max;
  std::unordered_map<int64_t, Cell> cells;

  std::deque<Batch> queue;
  std::mutex mu;
  // Guards `cells`: held by the worker for each integrate() and by every
  // reader (size/export/save). Separate from `mu` so enqueue never blocks
  // behind a long integration.
  std::mutex cells_mu;
  std::condition_variable cv;
  std::condition_variable cv_done;
  std::atomic<bool> stop{false};
  size_t pending = 0;
  std::thread worker;

  void integrate(const Batch& b) {
    std::lock_guard<std::mutex> lk(cells_mu);
    const size_t n = b.hit.size();
    for (size_t i = 0; i < n; ++i) {
      int64_t key = pack(b.xyz[3 * i], b.xyz[3 * i + 1], b.xyz[3 * i + 2]);
      Cell& c = cells[key];
      if (b.hit[i]) {
        c.log_odds += lo_hit;
        if (c.log_odds > lo_max) c.log_odds = lo_max;
        c.r += b.rgb[3 * i];
        c.g += b.rgb[3 * i + 1];
        c.b += b.rgb[3 * i + 2];
        c.hits += 1;
      } else {
        c.log_odds += lo_miss;
        if (c.log_odds < lo_min) c.log_odds = lo_min;
      }
    }
  }

  void run() {
    for (;;) {
      Batch b;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop.load() || !queue.empty(); });
        if (queue.empty()) {
          if (stop.load()) return;
          continue;
        }
        b = std::move(queue.front());
        queue.pop_front();
      }
      integrate(b);
      {
        std::lock_guard<std::mutex> lk(mu);
        --pending;
        if (pending == 0) cv_done.notify_all();
      }
    }
  }
};

// One occupied voxel pulled out of the hash for export/filter/serialize.
struct Entry {
  int32_t x, y, z;
  uint8_t r, g, b;
  float value;  // clamped log-odds
};

// Gather cells passing the occupancy/hit gates. Caller must hold cells_mu
// or guarantee the worker is idle (collect_entries flushes via the caller).
static void collect_entries(VoxelStore* s, float min_log_odds,
                            uint32_t min_hits, std::vector<Entry>* out) {
  std::lock_guard<std::mutex> lk(s->cells_mu);
  out->reserve(s->cells.size());
  for (const auto& kv : s->cells) {
    const Cell& c = kv.second;
    if (c.log_odds < min_log_odds || c.hits < min_hits) continue;
    int32_t x, y, z;
    unpack(kv.first, &x, &y, &z);
    uint32_t n = c.hits ? c.hits : 1;
    out->push_back(Entry{x, y, z, (uint8_t)(c.r / n), (uint8_t)(c.g / n),
                         (uint8_t)(c.b / n), c.log_odds});
  }
}

// kNN statistical outlier removal over voxel centers, the role of the
// reference's pcl::StatisticalOutlierRemoval (meanK=100, stddev mult 1.0,
// octomap_pub/src/pubPointCloud.cc:291-296). Neighbor search walks a
// precomputed distance-sorted offset table over the occupied-voxel hash, so
// the first k occupied offsets found ARE the k nearest (ties irrelevant for
// the mean). Points whose mean-kNN distance exceeds
// global_mean + stddev_mult * global_std are dropped. Multithreaded.
static void sor_filter(std::vector<Entry>* entries, int mean_k,
                       float stddev_mult, int max_radius) {
  const size_t n = entries->size();
  if (n == 0 || mean_k <= 0) return;
  if ((size_t)mean_k >= n) return;  // too few points to judge outliers

  std::unordered_set<int64_t> occ;
  occ.reserve(n * 2);
  for (const Entry& e : *entries) occ.insert(pack(e.x, e.y, e.z));

  // offsets within Chebyshev radius R (excluding self), sorted by distance
  struct Off { int16_t dx, dy, dz; float d; };
  std::vector<Off> offs;
  const int R = max_radius;
  offs.reserve((2 * R + 1) * (2 * R + 1) * (2 * R + 1) - 1);
  for (int dx = -R; dx <= R; ++dx)
    for (int dy = -R; dy <= R; ++dy)
      for (int dz = -R; dz <= R; ++dz) {
        if (!dx && !dy && !dz) continue;
        offs.push_back(Off{(int16_t)dx, (int16_t)dy, (int16_t)dz,
                           std::sqrt((float)(dx * dx + dy * dy + dz * dz))});
      }
  std::sort(offs.begin(), offs.end(),
            [](const Off& a, const Off& b) { return a.d < b.d; });

  std::vector<float> mean_d(n, std::numeric_limits<float>::infinity());
  unsigned n_threads = std::max(1u, std::thread::hardware_concurrency());
  n_threads = std::min<unsigned>(n_threads, 16);
  std::vector<std::thread> pool;
  std::atomic<size_t> next{0};
  const size_t chunk = 1024;
  auto work = [&] {
    for (;;) {
      size_t lo = next.fetch_add(chunk);
      if (lo >= n) return;
      size_t hi = std::min(lo + chunk, n);
      for (size_t i = lo; i < hi; ++i) {
        const Entry& e = (*entries)[i];
        int found = 0;
        float acc = 0.f;
        for (const Off& o : offs) {
          if (occ.count(pack(e.x + o.dx, e.y + o.dy, e.z + o.dz))) {
            acc += o.d;
            if (++found >= mean_k) break;
          }
        }
        // PCL computes the mean over exactly k neighbors; if the table is
        // exhausted first the point is in a sparse region -> mean stays inf
        // unless at least half of k were found (then extrapolate with R).
        if (found >= mean_k)
          mean_d[i] = acc / found;
        else if (found >= mean_k / 2)
          mean_d[i] = (acc + (mean_k - found) * (float)R) / mean_k;
      }
    }
  };
  for (unsigned t = 0; t < n_threads; ++t) pool.emplace_back(work);
  for (auto& t : pool) t.join();

  // global mean/std over FINITE means; infinite means are always outliers
  double sum = 0, sum2 = 0;
  size_t m = 0;
  for (float d : mean_d)
    if (std::isfinite(d)) { sum += d; sum2 += (double)d * d; ++m; }
  if (m < 2) return;
  double mu = sum / m;
  double var = std::max(0.0, sum2 / m - mu * mu);
  float thr = (float)(mu + stddev_mult * std::sqrt(var));

  size_t w = 0;
  for (size_t i = 0; i < n; ++i)
    if (std::isfinite(mean_d[i]) && mean_d[i] <= thr)
      (*entries)[w++] = (*entries)[i];
  entries->resize(w);
}

// ---------------------------------------------------------------------------
// Octree serialization (octomap ColorOcTree .ot container, the role of the
// reference's tree->write(outfile) at pubPointCloud.cc:184-185).
//
// Format (public octomap spec): ASCII header
//   "# Octomap OcTree file\nid ColorOcTree\nsize N\nres R\ndata\n"
// then a depth-first binary node stream; each node writes
//   float value (log-odds), uint8 r,g,b, uint8 child-exists bitmask,
// followed by its existing children in index order. Keys use the standard
// 16-level tree with bias 2^15; child bit i at depth d is
//   (kx>>(15-d) & 1) | (ky>>(15-d) & 1)<<1 | (kz>>(15-d) & 1)<<2.
// Inner nodes carry max-child occupancy and mean-child color (octomap's
// updateOccupancyChildren / updateColorChildren pruning-free convention).
// ---------------------------------------------------------------------------

static const int kTreeDepth = 16;
static const int32_t kOtBias = 1 << 15;

struct OtNode {
  float value = -1e9f;
  uint32_t r = 0, g = 0, b = 0, cnt = 0;
  uint8_t child_mask = 0;
};

static int save_ot(const std::vector<Entry>& entries, double resolution,
                   const char* path) {
  // per-level hash maps, leaves at depth kTreeDepth
  std::vector<std::unordered_map<int64_t, OtNode>> levels(kTreeDepth + 1);
  for (const Entry& e : entries) {
    int32_t kx = e.x + kOtBias, ky = e.y + kOtBias, kz = e.z + kOtBias;
    if ((kx | ky | kz) & ~0xFFFF) continue;  // outside the 16-bit key range
    OtNode& nd = levels[kTreeDepth][pack(kx, ky, kz)];
    nd.value = e.value;
    nd.r = e.r; nd.g = e.g; nd.b = e.b; nd.cnt = 1;
  }
  for (int d = kTreeDepth; d > 0; --d) {
    for (const auto& kv : levels[d]) {
      int32_t x, y, z;
      unpack(kv.first, &x, &y, &z);
      int child = (x & 1) | ((y & 1) << 1) | ((z & 1) << 2);
      OtNode& p = levels[d - 1][pack(x >> 1, y >> 1, z >> 1)];
      p.value = std::max(p.value, kv.second.value);
      p.r += kv.second.r; p.g += kv.second.g; p.b += kv.second.b;
      p.cnt += 1;
      p.child_mask |= (uint8_t)(1 << child);
    }
  }
  size_t total = 0;
  for (auto& lvl : levels) total += lvl.size();

  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "# Octomap OcTree file\n# (feel free to add / change comments, "
             "but leave the first line as it is!)\n#\n");
  fprintf(f, "id ColorOcTree\n");
  fprintf(f, "size %zu\n", total);
  fprintf(f, "res %.6f\n", resolution);
  fprintf(f, "data\n");

  // iterative DFS from the root (depth 0, key 0)
  struct Item { int depth; int64_t key; };
  std::vector<Item> stack;
  if (!levels[0].empty()) stack.push_back(Item{0, levels[0].begin()->first});
  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    const OtNode& nd = levels[it.depth][it.key];
    float value = nd.value;
    uint32_t c = nd.cnt ? nd.cnt : 1;
    uint8_t rgb[3] = {(uint8_t)(nd.r / c), (uint8_t)(nd.g / c),
                      (uint8_t)(nd.b / c)};
    fwrite(&value, sizeof(float), 1, f);
    fwrite(rgb, 1, 3, f);
    fwrite(&nd.child_mask, 1, 1, f);
    int32_t x, y, z;
    unpack(it.key, &x, &y, &z);
    // push children in REVERSE index order so they pop in order 0..7
    for (int ci = 7; ci >= 0; --ci) {
      if (!(nd.child_mask & (1 << ci))) continue;
      int64_t ck = pack((x << 1) | (ci & 1), (y << 1) | ((ci >> 1) & 1),
                        (z << 1) | ((ci >> 2) & 1));
      stack.push_back(Item{it.depth + 1, ck});
    }
  }
  fclose(f);
  return 0;
}

}  // namespace

extern "C" {

void* vstore_create(double resolution, float lo_hit, float lo_miss,
                    float lo_min, float lo_max) {
  auto* s = new VoxelStore();
  s->resolution = resolution;
  s->lo_hit = lo_hit;
  s->lo_miss = lo_miss;
  s->lo_min = lo_min;
  s->lo_max = lo_max;
  s->worker = std::thread([s] { s->run(); });
  return s;
}

void vstore_destroy(void* h) {
  auto* s = (VoxelStore*)h;
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->stop = true;
  }
  s->cv.notify_all();
  s->worker.join();
  delete s;
}

// Enqueue a batch (copied) for background integration.
void vstore_insert_async(void* h, const int32_t* xyz, const uint8_t* rgb,
                         const uint8_t* hit, int64_t n) {
  auto* s = (VoxelStore*)h;
  Batch b;
  b.xyz.assign(xyz, xyz + 3 * n);
  b.rgb.assign(rgb, rgb + 3 * n);
  b.hit.assign(hit, hit + n);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->queue.push_back(std::move(b));
    ++s->pending;
  }
  s->cv.notify_one();
}

// Block until every queued batch is integrated.
void vstore_flush(void* h) {
  auto* s = (VoxelStore*)h;
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv_done.wait(lk, [&] { return s->pending == 0; });
}

int64_t vstore_size(void* h) {
  auto* s = (VoxelStore*)h;
  std::lock_guard<std::mutex> lk(s->cells_mu);
  return (int64_t)s->cells.size();
}

// Export occupied voxels. sor_mean_k > 0 enables kNN statistical outlier
// removal (reference pubPointCloud.cc:291-296: meanK=100, stddev 1.0).
int64_t vstore_export_sor(void* h, float min_log_odds, uint32_t min_hits,
                          int32_t sor_mean_k, float sor_stddev,
                          int32_t sor_radius, int32_t* out_xyz,
                          uint8_t* out_rgb, int64_t max_out) {
  auto* s = (VoxelStore*)h;
  std::vector<Entry> es;
  collect_entries(s, min_log_odds, min_hits, &es);
  if (sor_mean_k > 0) sor_filter(&es, sor_mean_k, sor_stddev, sor_radius);
  int64_t n = std::min<int64_t>((int64_t)es.size(), max_out);
  for (int64_t i = 0; i < n; ++i) {
    out_xyz[3 * i] = es[i].x;
    out_xyz[3 * i + 1] = es[i].y;
    out_xyz[3 * i + 2] = es[i].z;
    out_rgb[3 * i] = es[i].r;
    out_rgb[3 * i + 1] = es[i].g;
    out_rgb[3 * i + 2] = es[i].b;
  }
  return n;
}

// Export KNOWN-FREE voxels: observed cells whose clamped log-odds fell to or
// below `max_log_odds` (ray misses outvoted hits). Feeds the 2-D projected
// occupancy map (the reference octomap_server's downprojected_map,
// octomap_mapping/octomap_server/src/OctomapServer.cpp:1285 update2DMap):
// free cells come only from evidence, never from absence of data.
int64_t vstore_export_free(void* h, float max_log_odds, int32_t* out_xyz,
                           int64_t max_out) {
  auto* s = (VoxelStore*)h;
  vstore_flush(h);
  std::lock_guard<std::mutex> lk(s->cells_mu);
  int64_t n = 0;
  for (const auto& kv : s->cells) {
    if (kv.second.log_odds > max_log_odds) continue;
    if (n >= max_out) break;
    int32_t x, y, z;
    unpack(kv.first, &x, &y, &z);
    out_xyz[3 * n] = x;
    out_xyz[3 * n + 1] = y;
    out_xyz[3 * n + 2] = z;
    ++n;
  }
  return n;
}

int64_t vstore_export(void* h, float min_log_odds, uint32_t min_hits,
                      int32_t* out_xyz, uint8_t* out_rgb, int64_t max_out) {
  return vstore_export_sor(h, min_log_odds, min_hits, 0, 0.f, 0, out_xyz,
                           out_rgb, max_out);
}

// Re-voxelize the occupied set at a coarser resolution `res2` (the
// octomap_server secondary-map role, reference
// octomap_mapping/octomap_server/src/OctomapServer.cpp:80, 0.025 m).
// Colors are averaged, occupancy is max over children.
int64_t vstore_export_coarse(void* h, double res2, float min_log_odds,
                             uint32_t min_hits, int32_t sor_mean_k,
                             float sor_stddev, int32_t sor_radius,
                             int32_t* out_xyz, uint8_t* out_rgb,
                             int64_t max_out) {
  auto* s = (VoxelStore*)h;
  std::vector<Entry> es;
  collect_entries(s, min_log_odds, min_hits, &es);
  if (sor_mean_k > 0) sor_filter(&es, sor_mean_k, sor_stddev, sor_radius);
  std::unordered_map<int64_t, OtNode> coarse;
  coarse.reserve(es.size());
  const double inv = 1.0 / res2;
  for (const Entry& e : es) {
    double cx = (e.x + 0.5) * s->resolution, cy = (e.y + 0.5) * s->resolution,
           cz = (e.z + 0.5) * s->resolution;
    int64_t k = pack((int32_t)std::floor(cx * inv),
                     (int32_t)std::floor(cy * inv),
                     (int32_t)std::floor(cz * inv));
    OtNode& nd = coarse[k];
    nd.value = std::max(nd.value, e.value);
    nd.r += e.r; nd.g += e.g; nd.b += e.b; nd.cnt += 1;
  }
  int64_t n = 0;
  for (const auto& kv : coarse) {
    if (n >= max_out) break;
    int32_t x, y, z;
    unpack(kv.first, &x, &y, &z);
    out_xyz[3 * n] = x;
    out_xyz[3 * n + 1] = y;
    out_xyz[3 * n + 2] = z;
    uint32_t c = kv.second.cnt ? kv.second.cnt : 1;
    out_rgb[3 * n] = (uint8_t)(kv.second.r / c);
    out_rgb[3 * n + 1] = (uint8_t)(kv.second.g / c);
    out_rgb[3 * n + 2] = (uint8_t)(kv.second.b / c);
    ++n;
  }
  return n;
}

// ASCII PCD export (reference saves pointcloud.pcd in its destructor,
// pubPointCloud.cc:184-185).
int vstore_save_pcd_sor(void* h, const char* path, float min_log_odds,
                        uint32_t min_hits, int32_t sor_mean_k,
                        float sor_stddev, int32_t sor_radius) {
  auto* s = (VoxelStore*)h;
  std::vector<Entry> es;
  collect_entries(s, min_log_odds, min_hits, &es);
  if (sor_mean_k > 0) sor_filter(&es, sor_mean_k, sor_stddev, sor_radius);
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  fprintf(f,
          "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
          "FIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F U\nCOUNT 1 1 1 1\n"
          "WIDTH %zu\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS %zu\n"
          "DATA ascii\n",
          es.size(), es.size());
  for (const Entry& e : es) {
    uint32_t rgb = ((uint32_t)e.r << 16) | ((uint32_t)e.g << 8) | e.b;
    fprintf(f, "%.4f %.4f %.4f %u\n", (e.x + 0.5) * s->resolution,
            (e.y + 0.5) * s->resolution, (e.z + 0.5) * s->resolution, rgb);
  }
  fclose(f);
  return 0;
}

int vstore_save_pcd(void* h, const char* path, float min_log_odds,
                    uint32_t min_hits) {
  return vstore_save_pcd_sor(h, path, min_log_odds, min_hits, 0, 0.f, 0);
}

// Octree-format map save (ColorOcTree .ot container; the role of the
// reference's tree->write() at pubPointCloud.cc:184-185). If res2 > 0 the
// octree is built at that (coarser) resolution instead of the store's own.
int vstore_save_ot(void* h, const char* path, double res2, float min_log_odds,
                   uint32_t min_hits, int32_t sor_mean_k, float sor_stddev,
                   int32_t sor_radius) {
  auto* s = (VoxelStore*)h;
  std::vector<Entry> es;
  collect_entries(s, min_log_odds, min_hits, &es);
  if (sor_mean_k > 0) sor_filter(&es, sor_mean_k, sor_stddev, sor_radius);
  if (res2 > 0 && res2 != s->resolution) {
    std::unordered_map<int64_t, OtNode> coarse;
    const double inv = 1.0 / res2;
    for (const Entry& e : es) {
      int64_t k = pack((int32_t)std::floor((e.x + 0.5) * s->resolution * inv),
                       (int32_t)std::floor((e.y + 0.5) * s->resolution * inv),
                       (int32_t)std::floor((e.z + 0.5) * s->resolution * inv));
      OtNode& nd = coarse[k];
      nd.value = std::max(nd.value, e.value);
      nd.r += e.r; nd.g += e.g; nd.b += e.b; nd.cnt += 1;
    }
    std::vector<Entry> es2;
    es2.reserve(coarse.size());
    for (const auto& kv : coarse) {
      int32_t x, y, z;
      unpack(kv.first, &x, &y, &z);
      uint32_t c = kv.second.cnt ? kv.second.cnt : 1;
      es2.push_back(Entry{x, y, z, (uint8_t)(kv.second.r / c),
                          (uint8_t)(kv.second.g / c),
                          (uint8_t)(kv.second.b / c), kv.second.value});
    }
    return save_ot(es2, res2, path);
  }
  return save_ot(es, s->resolution, path);
}

}  // extern "C"
