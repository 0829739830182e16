// Native host runtime of the GIE mapping engine.
//
// The reference implements its host-side runtime in C++ (ROS node +
// PCL/FLANN helpers); this engine keeps the same split: JAX/XLA owns the
// device compute path, this library owns the host-side subsystems:
//
//  * DBSCAN clustering + AABB extraction for the external-observer channel
//    (reference: /root/reference/src/volumetric_mapper.cpp:391-496, which
//    uses a PCL KdTree radius search; here a uniform-grid neighbour search).
//  * Brute-force 1-NN EDT ground-truth checking
//    (reference: /root/reference/include/gt_checker.h:30-80, FLANN KD-tree;
//    here a 3-D KD-tree built in-place over the occupied cloud).
//  * A voxel-block mirror store (reference CPU mirror hash map,
//    /root/reference/include/par_wave/glb_hash_map.h:33-38) with occupied /
//    EDT cloud extraction.
//  * Multi-ring LiDAR PointCloud->range-rings conversion
//    (reference: /root/reference/src/vlp16_map_maker.cpp:73-148).
//
// Exposed as a plain C ABI consumed via ctypes (runtime/native.py).

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <unordered_map>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline float sqdist(const Vec3& a, const Vec3& b) {
  const float dx = a.x - b.x, dy = a.y - b.y, dz = a.z - b.z;
  return dx * dx + dy * dy + dz * dz;
}

// ------------------------------------------------------------------------
// KD-tree (3-D, median split, array-backed) for 1-NN queries.
// ------------------------------------------------------------------------
class KdTree {
 public:
  void build(const float* pts, int n) {
    pts_.resize(n);
    std::memcpy(pts_.data(), pts, sizeof(Vec3) * n);
    order_.resize(n);
    std::iota(order_.begin(), order_.end(), 0);
    nodes_.clear();
    nodes_.reserve(2 * n);
    root_ = build_rec(0, n, 0);
  }

  float nn_sqdist(const Vec3& q) const {
    float best = std::numeric_limits<float>::max();
    nn_rec(root_, q, best);
    return best;
  }

 private:
  struct Node {
    int left = -1, right = -1;
    int point = -1;
    int axis = 0;
  };

  int build_rec(int lo, int hi, int depth) {
    if (lo >= hi) return -1;
    const int axis = depth % 3;
    const int mid = (lo + hi) / 2;
    std::nth_element(order_.begin() + lo, order_.begin() + mid,
                     order_.begin() + hi, [&](int a, int b) {
                       return coord(pts_[a], axis) < coord(pts_[b], axis);
                     });
    Node node;
    node.point = order_[mid];
    node.axis = axis;
    const int self = static_cast<int>(nodes_.size());
    nodes_.push_back(node);
    nodes_[self].left = build_rec(lo, mid, depth + 1);
    nodes_[self].right = build_rec(mid + 1, hi, depth + 1);
    return self;
  }

  static float coord(const Vec3& p, int axis) {
    return axis == 0 ? p.x : (axis == 1 ? p.y : p.z);
  }

  void nn_rec(int idx, const Vec3& q, float& best) const {
    if (idx < 0) return;
    const Node& nd = nodes_[idx];
    const Vec3& p = pts_[nd.point];
    best = std::min(best, sqdist(p, q));
    const float delta = coord(q, nd.axis) - coord(p, nd.axis);
    const int near = delta < 0 ? nd.left : nd.right;
    const int far = delta < 0 ? nd.right : nd.left;
    nn_rec(near, q, best);
    if (delta * delta < best) nn_rec(far, q, best);
  }

  std::vector<Vec3> pts_;
  std::vector<int> order_;
  std::vector<Node> nodes_;
  int root_ = -1;
};

}  // namespace

extern "C" {

// ------------------------------------------------------------------------
// Ground-truth checker: RMSE / max / mean-abs error of EDT values vs exact
// 1-NN distances to the occupied cloud (gt_checker.h:30-80 semantics).
// occ: [n_occ,3] float32; query: [n_q,3] float32; edt_dist: [n_q] float32
// (metres).  Writes {rmse, max_err, mean_abs} to out[3].  Returns n_q used.
// ------------------------------------------------------------------------
int gie_gt_check(const float* occ, int n_occ, const float* query, int n_q,
                 const float* edt_dist, float* out) {
  if (n_occ <= 0 || n_q <= 0) {
    out[0] = out[1] = out[2] = -1.f;
    return 0;
  }
  KdTree tree;
  tree.build(occ, n_occ);
  double se = 0.0, ae = 0.0, mx = 0.0;
  for (int i = 0; i < n_q; ++i) {
    Vec3 q{query[3 * i], query[3 * i + 1], query[3 * i + 2]};
    const double knn = std::sqrt(static_cast<double>(tree.nn_sqdist(q)));
    const double err = knn - static_cast<double>(edt_dist[i]);
    se += err * err;
    ae += std::fabs(err);
    mx = std::max(mx, std::fabs(err));
  }
  out[0] = static_cast<float>(std::sqrt(se / n_q));
  out[1] = static_cast<float>(mx);
  out[2] = static_cast<float>(ae / n_q);
  return n_q;
}

// ------------------------------------------------------------------------
// DBSCAN over a point cloud (min_pts, eps) + per-cluster AABB extraction.
// Mirrors the hand-rolled PCL DBSCAN of volumetric_mapper.cpp:391-496:
// min_nbrPts=3 within eps=0.3, clusters of >=4 points kept.
// Neighbour search uses a uniform grid of cell size eps.
// out_boxes: [max_boxes, 6] (ll.xyz, ur.xyz); returns #boxes.
// labels (optional, may be null): [n] int32 cluster id or -1.
// ------------------------------------------------------------------------
int gie_dbscan_aabb(const float* pts_in, int n, float eps, int min_pts,
                    int min_cluster, float* out_boxes, int max_boxes,
                    int32_t* labels) {
  if (n <= 0) return 0;
  std::vector<Vec3> pts(n);
  std::memcpy(pts.data(), pts_in, sizeof(Vec3) * n);

  // uniform grid
  const float inv = 1.f / eps;
  auto cell_of = [&](const Vec3& p) {
    return std::array<int64_t, 3>{
        static_cast<int64_t>(std::floor(p.x * inv)),
        static_cast<int64_t>(std::floor(p.y * inv)),
        static_cast<int64_t>(std::floor(p.z * inv))};
  };
  struct CellHash {
    size_t operator()(const std::array<int64_t, 3>& c) const {
      return static_cast<size_t>(c[0] * 73856093LL) ^
             static_cast<size_t>(c[1] * 19349669LL) ^
             static_cast<size_t>(c[2] * 83492791LL);
    }
  };
  std::unordered_map<std::array<int64_t, 3>, std::vector<int>, CellHash> grid;
  for (int i = 0; i < n; ++i) grid[cell_of(pts[i])].push_back(i);

  const float eps2 = eps * eps;
  auto neighbours = [&](int i, std::vector<int>& out) {
    out.clear();
    const auto c = cell_of(pts[i]);
    for (int64_t dx = -1; dx <= 1; ++dx)
      for (int64_t dy = -1; dy <= 1; ++dy)
        for (int64_t dz = -1; dz <= 1; ++dz) {
          auto it = grid.find({c[0] + dx, c[1] + dy, c[2] + dz});
          if (it == grid.end()) continue;
          for (int j : it->second)
            if (sqdist(pts[i], pts[j]) <= eps2) out.push_back(j);
        }
  };

  std::vector<int> state(n, 0);  // 0 untouched, 1 queued, 2 done
  std::vector<int32_t> lab(n, -1);
  int n_boxes = 0;
  std::vector<int> nbrs, seed;
  for (int i = 0; i < n && n_boxes < max_boxes; ++i) {
    if (state[i] == 2) continue;
    neighbours(i, nbrs);
    seed.clear();
    seed.push_back(i);
    state[i] = 2;
    for (int j : nbrs)
      if (j != i) {
        seed.push_back(j);
        state[j] = 1;
      }
    for (size_t k = 1; k < seed.size(); ++k) {
      const int p = seed[k];
      if (state[p] == 2) continue;
      neighbours(p, nbrs);
      if (static_cast<int>(nbrs.size()) >= min_pts) {
        for (int j : nbrs)
          if (state[j] == 0) {
            seed.push_back(j);
            state[j] = 1;
          }
      }
      state[p] = 2;
    }
    if (static_cast<int>(seed.size()) >= min_cluster) {
      Vec3 ll{1e30f, 1e30f, 1e30f}, ur{-1e30f, -1e30f, -1e30f};
      for (int p : seed) {
        lab[p] = n_boxes;
        ll.x = std::min(ll.x, pts[p].x);
        ll.y = std::min(ll.y, pts[p].y);
        ll.z = std::min(ll.z, pts[p].z);
        ur.x = std::max(ur.x, pts[p].x);
        ur.y = std::max(ur.y, pts[p].y);
        ur.z = std::max(ur.z, pts[p].z);
      }
      float* b = out_boxes + 6 * n_boxes;
      b[0] = ll.x; b[1] = ll.y; b[2] = ll.z;
      b[3] = ur.x; b[4] = ur.y; b[5] = ur.z;
      ++n_boxes;
    }
  }
  if (labels) std::memcpy(labels, lab.data(), sizeof(int32_t) * n);
  return n_boxes;
}

// ------------------------------------------------------------------------
// Multi-ring LiDAR cloud -> range-ring image.
// points: [n,3] float32 in sensor frame, rings int32 [n] (ring index per
// point, as in the velodyne 'ring' field).  Output rings_img [ring_num,
// scan_num] float32 horizontal ranges (NaN where empty), matching
// vlp16_map_maker.cpp:73-148.
// ------------------------------------------------------------------------
void gie_cloud_to_rings(const float* points, const int32_t* rings, int n,
                        int ring_num, int scan_num, float theta_min,
                        float theta_inc, float* rings_img) {
  const float nan = std::numeric_limits<float>::quiet_NaN();
  for (int i = 0; i < ring_num * scan_num; ++i) rings_img[i] = nan;
  for (int i = 0; i < n; ++i) {
    const float x = points[3 * i], y = points[3 * i + 1];
    const int r = rings[i];
    if (r < 0 || r >= ring_num) continue;
    const float theta = std::atan2(y, x);
    int t = static_cast<int>(std::floor((theta - theta_min) / theta_inc + 0.5f));
    t = ((t % scan_num) + scan_num) % scan_num;
    const float range = std::sqrt(x * x + y * y);
    float& cell = rings_img[r * scan_num + t];
    if (std::isnan(cell) || range < cell) cell = range;
  }
}

// ------------------------------------------------------------------------
// Voxel-block mirror store: open handle-based API.
// Block payload layout per voxel: occ u8 | type i8 | dist i32 | coc i16[3]
// packed as separate arrays for cheap bulk ingest.
// ------------------------------------------------------------------------
struct MirrorBlock {
  uint8_t occ[512];
  int8_t type[512];
  int32_t dist[512];
  int16_t coc[512 * 3];
};

struct Mirror {
  struct KeyHash {
    size_t operator()(const std::array<int32_t, 3>& k) const {
      return static_cast<size_t>(k[0] * 73856093LL) ^
             static_cast<size_t>(k[1] * 19349669LL) ^
             static_cast<size_t>(k[2] * 83492791LL);
    }
  };
  std::unordered_map<std::array<int32_t, 3>, MirrorBlock, KeyHash> blocks;
};

void* gie_mirror_new() { return new Mirror(); }
void gie_mirror_free(void* h) { delete static_cast<Mirror*>(h); }
int gie_mirror_size(void* h) {
  return static_cast<int>(static_cast<Mirror*>(h)->blocks.size());
}

// ingest n blocks: keys [n,3] i32, occ [n,512] u8, type [n,512] i8,
// dist [n,512] i32, coc [n,512,3] i16
void gie_mirror_ingest(void* h, const int32_t* keys, const uint8_t* occ,
                       const int8_t* type, const int32_t* dist,
                       const int16_t* coc, int n) {
  Mirror* m = static_cast<Mirror*>(h);
  for (int i = 0; i < n; ++i) {
    std::array<int32_t, 3> key{keys[3 * i], keys[3 * i + 1], keys[3 * i + 2]};
    MirrorBlock& b = m->blocks[key];
    std::memcpy(b.occ, occ + 512 * i, 512);
    std::memcpy(b.type, type + 512 * i, 512);
    std::memcpy(b.dist, dist + 512 * i, 512 * 4);
    std::memcpy(b.coc, coc + 512 * 3 * i, 512 * 3 * 2);
  }
}

// extract world positions of voxels with type==want (e.g. occupied cloud).
// out capacity: max_pts triples.  Returns count.
int gie_mirror_extract_cloud(void* h, int8_t want, float voxel_width,
                             float* out, int max_pts) {
  Mirror* m = static_cast<Mirror*>(h);
  int cnt = 0;
  for (const auto& kv : m->blocks) {
    const auto& key = kv.first;
    const MirrorBlock& b = kv.second;
    for (int v = 0; v < 512 && cnt < max_pts; ++v) {
      if (b.type[v] != want) continue;
      const int vx = v / 64, vy = (v / 8) % 8, vz = v % 8;
      out[3 * cnt] = (key[0] * 8 + vx) * voxel_width;
      out[3 * cnt + 1] = (key[1] * 8 + vy) * voxel_width;
      out[3 * cnt + 2] = (key[2] * 8 + vz) * voxel_width;
      ++cnt;
    }
    if (cnt >= max_pts) break;
  }
  return cnt;
}

// extract (pos, dist_m) of voxels with valid EDT (< empty_value).
int gie_mirror_extract_edt(void* h, int32_t empty_value, float voxel_width,
                           float* out_pos, float* out_dist, int max_pts) {
  Mirror* m = static_cast<Mirror*>(h);
  int cnt = 0;
  for (const auto& kv : m->blocks) {
    const auto& key = kv.first;
    const MirrorBlock& b = kv.second;
    for (int v = 0; v < 512 && cnt < max_pts; ++v) {
      if (b.dist[v] >= empty_value) continue;
      const int vx = v / 64, vy = (v / 8) % 8, vz = v % 8;
      out_pos[3 * cnt] = (key[0] * 8 + vx) * voxel_width;
      out_pos[3 * cnt + 1] = (key[1] * 8 + vy) * voxel_width;
      out_pos[3 * cnt + 2] = (key[2] * 8 + vz) * voxel_width;
      out_dist[cnt] =
          std::sqrt(static_cast<float>(b.dist[v])) * voxel_width;
      ++cnt;
    }
    if (cnt >= max_pts) break;
  }
  return cnt;
}

}  // extern "C"
