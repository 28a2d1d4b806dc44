// Native geometry runtime of nsdp_tpu_torch (host-side, C ABI for ctypes).
//
// The port's own copy of nsdp_tpu/native/src/nsdp_native.cpp, the same code
// line for line, so both libraries compute the same bits when built with the
// same compiler and flags:
//  * isosurface extraction from a scalar grid (the reference vendors
//    PyMarchingCubes, ~2k LoC C++/Cython, for remeshing workflows; here a
//    marching-tetrahedra kernel with vertex welding — simpler tables, same
//    watertight output contract);
//  * exact 3-D KD-tree nearest-neighbour queries (the Chamfer metric's hot
//    host-side loop).
//
// Build: at first use by nsdp_tpu_torch/native/__init__.py (`c++ -O3
// -march=native -fPIC -shared -std=c++17 -Wall`, into native/build/).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// KD-tree (3D, median split, branch-and-bound NN)
// ---------------------------------------------------------------------------

namespace {

struct KDNode {
  int32_t left = -1, right = -1;
  int32_t begin = 0, end = 0;  // leaf range into point index array
  float split = 0.f;
  int8_t axis = -1;  // -1: leaf
};

struct KDTree {
  std::vector<KDNode> nodes;
  std::vector<int32_t> idx;
  const float* pts = nullptr;

  int32_t build(int32_t begin, int32_t end, int depth) {
    KDNode node;
    const int32_t id = static_cast<int32_t>(nodes.size());
    nodes.push_back(node);
    if (end - begin <= 8) {
      nodes[id].begin = begin;
      nodes[id].end = end;
      return id;
    }
    // pick the widest axis
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int32_t i = begin; i < end; ++i) {
      const float* p = pts + 3 * idx[i];
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], p[a]);
        hi[a] = std::max(hi[a], p[a]);
      }
    }
    int axis = 0;
    for (int a = 1; a < 3; ++a)
      if (hi[a] - lo[a] > hi[axis] - lo[axis]) axis = a;

    const int32_t mid = (begin + end) / 2;
    std::nth_element(
        idx.begin() + begin, idx.begin() + mid, idx.begin() + end,
        [&](int32_t a, int32_t b) {
          return pts[3 * a + axis] < pts[3 * b + axis];
        });
    nodes[id].axis = static_cast<int8_t>(axis);
    nodes[id].split = pts[3 * idx[mid] + axis];
    const int32_t l = build(begin, mid, depth + 1);
    const int32_t r = build(mid, end, depth + 1);
    nodes[id].left = l;
    nodes[id].right = r;
    return id;
  }

  void query(const float* q, int32_t node_id, float& best_d2,
             int32_t& best_i) const {
    const KDNode& node = nodes[node_id];
    if (node.axis < 0) {
      for (int32_t i = node.begin; i < node.end; ++i) {
        const float* p = pts + 3 * idx[i];
        const float dx = q[0] - p[0], dy = q[1] - p[1], dz = q[2] - p[2];
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < best_d2) {
          best_d2 = d2;
          best_i = idx[i];
        }
      }
      return;
    }
    const float diff = q[node.axis] - node.split;
    const int32_t near = diff < 0 ? node.left : node.right;
    const int32_t far = diff < 0 ? node.right : node.left;
    query(q, near, best_d2, best_i);
    if (diff * diff < best_d2) query(q, far, best_d2, best_i);
  }
};

}  // namespace

// Nearest neighbour of each query among points; writes distances (and
// optionally indices when out_idx != nullptr).
void nsdp_nn_query(const float* points, int64_t n_points, const float* queries,
                   int64_t n_queries, float* out_dist, int32_t* out_idx) {
  KDTree tree;
  tree.pts = points;
  tree.idx.resize(n_points);
  for (int64_t i = 0; i < n_points; ++i) tree.idx[i] = static_cast<int32_t>(i);
  tree.nodes.reserve(2 * n_points / 8 + 8);
  tree.build(0, static_cast<int32_t>(n_points), 0);

  for (int64_t j = 0; j < n_queries; ++j) {
    float best_d2 = 1e30f;
    int32_t best_i = -1;
    tree.query(queries + 3 * j, 0, best_d2, best_i);
    out_dist[j] = std::sqrt(best_d2);
    if (out_idx) out_idx[j] = best_i;
  }
}

// ---------------------------------------------------------------------------
// Isosurface extraction: marching tetrahedra with vertex welding
// ---------------------------------------------------------------------------

namespace {

// Each grid cell (i,j,k)-(i+1,j+1,k+1) splits into 6 tetrahedra sharing the
// main diagonal; every tet case reduces to 0, 1 or 2 triangles with vertices
// on tet edges, interpolated to the isolevel.  Welding dedups vertices by
// their (edge endpoint pair) key so the output mesh is watertight.
const int kTets[6][4] = {{0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
                         {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6}};
// cube corner offsets (x, y, z)
const int kCorners[8][3] = {{0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
                            {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};

struct MeshBuilder {
  std::vector<float> verts;
  std::vector<int32_t> faces;
  std::unordered_map<uint64_t, int32_t> edge_map;

  int32_t edge_vertex(uint64_t a, uint64_t b, const float* pa, const float* pb,
                      float va, float vb, float level) {
    if (a > b) {
      std::swap(a, b);
      std::swap(pa, pb);
      std::swap(va, vb);
    }
    const uint64_t key = (a << 32) | b;
    auto it = edge_map.find(key);
    if (it != edge_map.end()) return it->second;
    float t = (level - va) / (vb - va);
    t = std::min(1.f, std::max(0.f, t));
    const int32_t id = static_cast<int32_t>(verts.size() / 3);
    verts.push_back(pa[0] + t * (pb[0] - pa[0]));
    verts.push_back(pa[1] + t * (pb[1] - pa[1]));
    verts.push_back(pa[2] + t * (pb[2] - pa[2]));
    edge_map.emplace(key, id);
    return id;
  }
};

}  // namespace

// Extract the isosurface {f = level} from a dense nx*ny*nz grid (C order:
// index = (x*ny + y)*nz + z).  Returns counts; call nsdp_mc_copy to fetch
// the buffers, then nsdp_mc_free.
static thread_local MeshBuilder* g_mc_result = nullptr;

void nsdp_marching_tetrahedra(const float* grid, int32_t nx, int32_t ny,
                              int32_t nz, float level, int64_t* out_n_verts,
                              int64_t* out_n_faces) {
  MeshBuilder* mb = new MeshBuilder();
  const auto gid = [&](int x, int y, int z) -> uint64_t {
    return (static_cast<uint64_t>(x) * ny + y) * nz + z;
  };

  float corner_pos[8][3];
  float corner_val[8];
  uint64_t corner_id[8];

  for (int x = 0; x + 1 < nx; ++x) {
    for (int y = 0; y + 1 < ny; ++y) {
      for (int z = 0; z + 1 < nz; ++z) {
        for (int c = 0; c < 8; ++c) {
          const int cx = x + kCorners[c][0];
          const int cy = y + kCorners[c][1];
          const int cz = z + kCorners[c][2];
          corner_pos[c][0] = static_cast<float>(cx);
          corner_pos[c][1] = static_cast<float>(cy);
          corner_pos[c][2] = static_cast<float>(cz);
          corner_val[c] = grid[gid(cx, cy, cz)];
          corner_id[c] = gid(cx, cy, cz);
        }
        for (int t = 0; t < 6; ++t) {
          const int* tet = kTets[t];
          int inside[4], n_in = 0, n_out = 0;
          int in_v[4], out_v[4];
          for (int v = 0; v < 4; ++v) {
            inside[v] = corner_val[tet[v]] < level;
            if (inside[v])
              in_v[n_in++] = tet[v];
            else
              out_v[n_out++] = tet[v];
          }
          if (n_in == 0 || n_in == 4) continue;

          const auto ev = [&](int a, int b) {
            return mb->edge_vertex(corner_id[a], corner_id[b], corner_pos[a],
                                   corner_pos[b], corner_val[a], corner_val[b],
                                   level);
          };
          if (n_in == 1) {
            const int a = in_v[0];
            mb->faces.push_back(ev(a, out_v[0]));
            mb->faces.push_back(ev(a, out_v[1]));
            mb->faces.push_back(ev(a, out_v[2]));
          } else if (n_in == 3) {
            const int a = out_v[0];
            mb->faces.push_back(ev(in_v[0], a));
            mb->faces.push_back(ev(in_v[2], a));
            mb->faces.push_back(ev(in_v[1], a));
          } else {  // 2 in, 2 out -> quad -> two triangles
            const int a = in_v[0], b = in_v[1], c = out_v[0], d = out_v[1];
            const int32_t v_ac = ev(a, c);
            const int32_t v_ad = ev(a, d);
            const int32_t v_bc = ev(b, c);
            const int32_t v_bd = ev(b, d);
            mb->faces.push_back(v_ac);
            mb->faces.push_back(v_ad);
            mb->faces.push_back(v_bd);
            mb->faces.push_back(v_ac);
            mb->faces.push_back(v_bd);
            mb->faces.push_back(v_bc);
          }
        }
      }
    }
  }

  delete g_mc_result;
  g_mc_result = mb;
  *out_n_verts = static_cast<int64_t>(mb->verts.size() / 3);
  *out_n_faces = static_cast<int64_t>(mb->faces.size() / 3);
}

void nsdp_mc_copy(float* out_verts, int32_t* out_faces) {
  if (!g_mc_result) return;
  std::memcpy(out_verts, g_mc_result->verts.data(),
              g_mc_result->verts.size() * sizeof(float));
  std::memcpy(out_faces, g_mc_result->faces.data(),
              g_mc_result->faces.size() * sizeof(int32_t));
}

void nsdp_mc_free() {
  delete g_mc_result;
  g_mc_result = nullptr;
}

}  // extern "C"
