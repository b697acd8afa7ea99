// Iso-surface extraction via marching tetrahedra.
//
// The reference uses scikit-image's marching_cubes (Mesher.py:437-458); this
// framework extracts surfaces with a first-party native kernel instead.  We
// use the tetrahedral decomposition (6 tets per cube) rather than classic
// MC because its case table is derivable from first principles: each tet has
// 16 sign configurations, each producing 0, 1, or 2 triangles whose vertices
// lie on the tet's edges — no external lookup tables required.  Vertices are
// welded on shared edges (hash map on global edge keys) so meshes are
// watertight where the field is, and usable for connected-component
// filtering downstream.
//
// C ABI for ctypes (nice_slam_torch/native/__init__.py).  The PyTorch
// port's own copy of the JAX package's host kernel: the port imports
// nothing of that package.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct MeshResult {
  std::vector<float> verts;   // 3 floats per vertex
  std::vector<int64_t> tris;  // 3 indices per triangle
};

// The 6-tetrahedra decomposition of a cube.  Corner ids are the cube's
// local corners numbered by bits (x | y<<1 | z<<2).  Every tet shares the
// main diagonal 0-7 so faces of adjacent cubes tile consistently.
constexpr int kTets[6][4] = {
    {0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
    {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7},
};

constexpr int kCornerOff[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1},
};

struct EdgeKeyHash {
  size_t operator()(uint64_t k) const { return std::hash<uint64_t>()(k); }
};

class Extractor {
 public:
  Extractor(const float* vol, int64_t nx, int64_t ny, int64_t nz, float iso,
            const float* origin, const float* spacing)
      : vol_(vol), nx_(nx), ny_(ny), nz_(nz), iso_(iso) {
    for (int i = 0; i < 3; i++) {
      origin_[i] = origin[i];
      spacing_[i] = spacing[i];
    }
  }

  // Global corner id for voxel-grid vertex (x, y, z).
  inline int64_t gid(int64_t x, int64_t y, int64_t z) const {
    return (x * ny_ + y) * nz_ + z;
  }

  inline float value(int64_t g) const { return vol_[g]; }

  // Vertex on edge (a, b), interpolated at the iso crossing; welded.
  int64_t edge_vertex(int64_t ga, int64_t gb) {
    if (ga > gb) std::swap(ga, gb);
    uint64_t key = (uint64_t)ga * 0x100000000ULL ^ (uint64_t)gb;
    auto it = edge_map_.find(key);
    if (it != edge_map_.end()) return it->second;

    float va = value(ga), vb = value(gb);
    float denom = vb - va;
    float t = denom == 0.0f ? 0.5f : (iso_ - va) / denom;
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;

    int64_t az = ga % nz_, ay = (ga / nz_) % ny_, ax = ga / (nz_ * ny_);
    int64_t bz = gb % nz_, by = (gb / nz_) % ny_, bx = gb / (nz_ * ny_);
    float p[3] = {
        origin_[0] + spacing_[0] * (ax + t * (bx - ax)),
        origin_[1] + spacing_[1] * (ay + t * (by - ay)),
        origin_[2] + spacing_[2] * (az + t * (bz - az)),
    };
    int64_t id = (int64_t)(res_.verts.size() / 3);
    res_.verts.insert(res_.verts.end(), p, p + 3);
    edge_map_.emplace(key, id);
    return id;
  }

  void emit_tri(int64_t a, int64_t b, int64_t c) {
    if (a == b || b == c || a == c) return;  // degenerate
    res_.tris.push_back(a);
    res_.tris.push_back(b);
    res_.tris.push_back(c);
  }

  // Process one tetrahedron given global corner ids.
  void do_tet(const int64_t g[4]) {
    int inside = 0;
    bool in[4];
    for (int i = 0; i < 4; i++) {
      in[i] = value(g[i]) > iso_;
      inside += in[i];
    }
    if (inside == 0 || inside == 4) return;

    // Collect the 1 or 2 "minority" corners.
    int lone[2], other[3];
    int nl = 0, no = 0;
    bool lone_inside = inside <= 2 ? true : false;
    // pick the side with fewer corners as "lone"
    bool pick = (inside == 1) ? true : (inside == 3 ? false : true);
    for (int i = 0; i < 4; i++) {
      if (in[i] == pick) lone[nl++] = i;
      else other[no++] = i;
    }

    if (nl == 1) {
      // single corner cut off: one triangle on its three edges
      int64_t a = edge_vertex(g[lone[0]], g[other[0]]);
      int64_t b = edge_vertex(g[lone[0]], g[other[1]]);
      int64_t c = edge_vertex(g[lone[0]], g[other[2]]);
      emit_tri(a, b, c);
    } else {
      // two vs two: quad across four edges -> two triangles
      int64_t a = edge_vertex(g[lone[0]], g[other[0]]);
      int64_t b = edge_vertex(g[lone[0]], g[other[1]]);
      int64_t c = edge_vertex(g[lone[1]], g[other[1]]);
      int64_t d = edge_vertex(g[lone[1]], g[other[0]]);
      emit_tri(a, b, c);
      emit_tri(a, c, d);
    }
  }

  MeshResult run() {
    edge_map_.reserve((size_t)(nx_ * ny_) * 4);
    int64_t g[4];
    for (int64_t x = 0; x + 1 < nx_; x++) {
      for (int64_t y = 0; y + 1 < ny_; y++) {
        for (int64_t z = 0; z + 1 < nz_; z++) {
          // skip cubes with no crossing (cheap test on the 8 corners)
          bool any_in = false, any_out = false;
          int64_t cg[8];
          for (int c = 0; c < 8; c++) {
            cg[c] = gid(x + kCornerOff[c][0], y + kCornerOff[c][1],
                        z + kCornerOff[c][2]);
            (value(cg[c]) > iso_ ? any_in : any_out) = true;
          }
          if (!any_in || !any_out) continue;
          for (const auto& tet : kTets) {
            for (int i = 0; i < 4; i++) g[i] = cg[tet[i]];
            do_tet(g);
          }
        }
      }
    }
    return std::move(res_);
  }

 private:
  const float* vol_;
  int64_t nx_, ny_, nz_;
  float iso_;
  float origin_[3], spacing_[3];
  MeshResult res_;
  std::unordered_map<uint64_t, int64_t, EdgeKeyHash> edge_map_;
};

}  // namespace

extern "C" {

void* mt_run(const float* vol, int64_t nx, int64_t ny, int64_t nz, float iso,
             const float* origin, const float* spacing) {
  Extractor ex(vol, nx, ny, nz, iso, origin, spacing);
  auto* out = new MeshResult(ex.run());
  return out;
}

int64_t mt_nverts(void* h) {
  return (int64_t)(((MeshResult*)h)->verts.size() / 3);
}

int64_t mt_ntris(void* h) {
  return (int64_t)(((MeshResult*)h)->tris.size() / 3);
}

void mt_get(void* h, float* verts, int64_t* tris) {
  auto* r = (MeshResult*)h;
  std::memcpy(verts, r->verts.data(), r->verts.size() * sizeof(float));
  std::memcpy(tris, r->tris.data(), r->tris.size() * sizeof(int64_t));
}

void mt_free(void* h) { delete (MeshResult*)h; }

}  // extern "C"
