// Host mesh kernels of the PyTorch port: its own copy of the JAX package's
// csrc/mesh_kernels.cpp (host C++, not device code).
//
// Replaces the reference's host-side third-party mesh dependencies
// (skimage.measure.marching_cubes at src/utils/Mesher.py:441-458, trimesh
// connected-component filtering at :484-510) with in-repo C++:
//
//   * iso-surface extraction via marching tetrahedra (table-free: each cell
//     splits into 6 tets; per-tet triangulation has 3 generic cases), with
//     global vertex dedup on grid-edge keys so the surface is watertight;
//   * triangle-mesh connected components (union-find) with per-component
//     triangle area sums, for largest-component / small-geometry filtering.
//
// Exposed with a plain C ABI for ctypes.  Buffers are malloc'd here and
// released by free_buffer().
//
// Build: nice_slam_torch/ops/kernels.py compiles it with g++ -O3 -shared
// -fPIC -std=c++17 on first use into build/nice_slam_torch/.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <functional>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

// The 6-tetrahedra decomposition of a unit cell.  Cube corner numbering:
// bit 0 -> +x, bit 1 -> +y, bit 2 -> +z  (corner i = (i&1, (i>>1)&1, (i>>2)&1)).
// All six tets share the main diagonal 0-7, guaranteeing face compatibility
// between neighboring cells.
static const int kTets[6][4] = {
    {0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
    {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7},
};

struct MeshBuilder {
  std::vector<float> verts;
  std::vector<int64_t> tris;
  // edge key (packed global corner ids) -> vertex index
  std::unordered_map<uint64_t, int64_t> edge_cache;

  int64_t edge_vertex(uint64_t ga, uint64_t gb, V3 pa, V3 pb, float va,
                      float vb, float level) {
    if (ga > gb) {
      std::swap(ga, gb);
      std::swap(va, vb);
      std::swap(pa, pb);
    }
    const uint64_t key = (ga << 32) | gb;
    auto it = edge_cache.find(key);
    if (it != edge_cache.end()) return it->second;
    float denom = vb - va;
    float t = (std::fabs(denom) > 1e-12f) ? (level - va) / denom : 0.5f;
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;
    const int64_t idx = static_cast<int64_t>(verts.size() / 3);
    verts.push_back(pa.x + t * (pb.x - pa.x));
    verts.push_back(pa.y + t * (pb.y - pa.y));
    verts.push_back(pa.z + t * (pb.z - pa.z));
    edge_cache.emplace(key, idx);
    return idx;
  }

  void tri(int64_t a, int64_t b, int64_t c) {
    if (a == b || b == c || a == c) return;  // degenerate
    tris.push_back(a);
    tris.push_back(b);
    tris.push_back(c);
  }
};

}  // namespace

extern "C" {

// Extract the iso-surface of a scalar field at `level`.
// field: (nx, ny, nz) row-major (x-major: index = (ix*ny + iy)*nz + iz).
// origin/spacing: world placement of grid node (0,0,0) and per-axis step.
// Outputs malloc'd arrays: *out_verts (3*n_verts floats, xyz),
// *out_tris (3*n_tris int64).  Returns 0 on success.
int marching_tetrahedra(const float* field, int64_t nx, int64_t ny, int64_t nz,
                        float level, const float* origin, const float* spacing,
                        float** out_verts, int64_t* n_verts,
                        int64_t** out_tris, int64_t* n_tris) {
  if (nx < 2 || ny < 2 || nz < 2) {
    *out_verts = nullptr;
    *out_tris = nullptr;
    *n_verts = 0;
    *n_tris = 0;
    return 0;
  }
  MeshBuilder mb;
  mb.verts.reserve(1 << 16);
  mb.tris.reserve(1 << 16);

  const float ox = origin[0], oy = origin[1], oz = origin[2];
  const float sx = spacing[0], sy = spacing[1], sz = spacing[2];

  auto gid = [ny, nz](int64_t ix, int64_t iy, int64_t iz) -> uint64_t {
    return static_cast<uint64_t>((ix * (ny) + iy) * (nz) + iz);
  };

  float cv[8];
  V3 cp[8];
  uint64_t cg[8];

  for (int64_t ix = 0; ix + 1 < nx; ++ix) {
    for (int64_t iy = 0; iy + 1 < ny; ++iy) {
      const float* col0 = field + (ix * ny + iy) * nz;
      const float* col1 = field + (ix * ny + iy + 1) * nz;
      const float* col2 = field + ((ix + 1) * ny + iy) * nz;
      const float* col3 = field + ((ix + 1) * ny + iy + 1) * nz;
      for (int64_t iz = 0; iz + 1 < nz; ++iz) {
        // corner order: bit0->+x, bit1->+y, bit2->+z
        cv[0] = col0[iz];
        cv[1] = col2[iz];
        cv[2] = col1[iz];
        cv[3] = col3[iz];
        cv[4] = col0[iz + 1];
        cv[5] = col2[iz + 1];
        cv[6] = col1[iz + 1];
        cv[7] = col3[iz + 1];

        // quick reject: all above or all below
        bool any_lo = false, any_hi = false;
        for (int c = 0; c < 8; ++c) {
          if (cv[c] < level) any_lo = true; else any_hi = true;
        }
        if (!any_lo || !any_hi) continue;

        for (int c = 0; c < 8; ++c) {
          const int64_t dx = c & 1, dy = (c >> 1) & 1, dz = (c >> 2) & 1;
          cp[c].x = ox + sx * static_cast<float>(ix + dx);
          cp[c].y = oy + sy * static_cast<float>(iy + dy);
          cp[c].z = oz + sz * static_cast<float>(iz + dz);
          cg[c] = gid(ix + dx, iy + dy, iz + dz);
        }

        for (int t = 0; t < 6; ++t) {
          const int* tet = kTets[t];
          int code = 0;
          for (int c = 0; c < 4; ++c) {
            if (cv[tet[c]] < level) code |= (1 << c);
          }
          if (code == 0 || code == 15) continue;

          // orient so the "inside" (< level) set is {cases}
          auto ev = [&](int a, int b) {
            return mb.edge_vertex(cg[tet[a]], cg[tet[b]], cp[tet[a]],
                                  cp[tet[b]], cv[tet[a]], cv[tet[b]], level);
          };
          switch (code) {
            // one corner inside
            case 1: mb.tri(ev(0, 1), ev(0, 2), ev(0, 3)); break;
            case 2: mb.tri(ev(1, 0), ev(1, 3), ev(1, 2)); break;
            case 4: mb.tri(ev(2, 0), ev(2, 1), ev(2, 3)); break;
            case 8: mb.tri(ev(3, 0), ev(3, 2), ev(3, 1)); break;
            // one corner outside (complement, opposite winding)
            case 14: mb.tri(ev(0, 1), ev(0, 3), ev(0, 2)); break;
            case 13: mb.tri(ev(1, 0), ev(1, 2), ev(1, 3)); break;
            case 11: mb.tri(ev(2, 0), ev(2, 3), ev(2, 1)); break;
            case 7:  mb.tri(ev(3, 0), ev(3, 1), ev(3, 2)); break;
            // two corners inside: quad = two triangles
            case 3:  // 0,1 inside
              mb.tri(ev(0, 2), ev(0, 3), ev(1, 3));
              mb.tri(ev(0, 2), ev(1, 3), ev(1, 2));
              break;
            case 12:
              mb.tri(ev(0, 2), ev(1, 3), ev(0, 3));
              mb.tri(ev(0, 2), ev(1, 2), ev(1, 3));
              break;
            case 5:  // 0,2 inside
              mb.tri(ev(0, 1), ev(2, 3), ev(0, 3));
              mb.tri(ev(0, 1), ev(2, 1), ev(2, 3));
              break;
            case 10:
              mb.tri(ev(0, 1), ev(0, 3), ev(2, 3));
              mb.tri(ev(0, 1), ev(2, 3), ev(2, 1));
              break;
            case 6:  // 1,2 inside
              mb.tri(ev(1, 0), ev(2, 3), ev(1, 3));
              mb.tri(ev(1, 0), ev(2, 0), ev(2, 3));
              break;
            case 9:
              mb.tri(ev(1, 0), ev(1, 3), ev(2, 3));
              mb.tri(ev(1, 0), ev(2, 3), ev(2, 0));
              break;
            default:
              break;
          }
        }
      }
    }
  }

  *n_verts = static_cast<int64_t>(mb.verts.size() / 3);
  *n_tris = static_cast<int64_t>(mb.tris.size() / 3);
  *out_verts = static_cast<float*>(std::malloc(mb.verts.size() * sizeof(float)));
  *out_tris =
      static_cast<int64_t*>(std::malloc(mb.tris.size() * sizeof(int64_t)));
  if ((*out_verts == nullptr && !mb.verts.empty()) ||
      (*out_tris == nullptr && !mb.tris.empty()))
    return 1;
  std::memcpy(*out_verts, mb.verts.data(), mb.verts.size() * sizeof(float));
  std::memcpy(*out_tris, mb.tris.data(), mb.tris.size() * sizeof(int64_t));
  return 0;
}

// Classic cube-cell marching cubes (the reference meshes with
// skimage.measure.marching_cubes, src/utils/Mesher.py:441-458).
//
// Topology is produced per CUBE cell (vertices only on cube edges, unlike
// marching tetrahedra which adds diagonal vertices), via face-consistent
// contour tracing instead of the memorized 256-case table:
//   * each of the 6 faces is contoured with marching squares, the ambiguous
//     diagonal case resolved by the face-center average — a rule that uses
//     face data only, so the two cells sharing a face always agree
//     (watertight by construction, like MC33's face deciders);
//   * segments are directed so the inside (field < level) region lies to
//     the left viewed from outside the cell; every intersection point gets
//     exactly one incoming and one outgoing segment, so the segments chain
//     into closed loops which are fan-triangulated.
int marching_cubes_classic(const float* field, int64_t nx, int64_t ny,
                           int64_t nz, float level, const float* origin,
                           const float* spacing, float** out_verts,
                           int64_t* n_verts, int64_t** out_tris,
                           int64_t* n_tris) {
  if (nx < 2 || ny < 2 || nz < 2) {
    *out_verts = nullptr;
    *out_tris = nullptr;
    *n_verts = 0;
    *n_tris = 0;
    return 0;
  }
  MeshBuilder mb;
  mb.verts.reserve(1 << 16);
  mb.tris.reserve(1 << 16);

  const float ox = origin[0], oy = origin[1], oz = origin[2];
  const float sx = spacing[0], sy = spacing[1], sz = spacing[2];

  auto gid = [ny, nz](int64_t ix, int64_t iy, int64_t iz) -> uint64_t {
    return static_cast<uint64_t>((ix * ny + iy) * nz + iz);
  };

  // Face corner cycles, CCW viewed from OUTSIDE the cell (verified:
  // (q1-q0)x(q2-q0) points along the outward face normal).  Corner
  // numbering bit0->+x, bit1->+y, bit2->+z.
  static const int kFaces[6][4] = {
      {0, 4, 6, 2},  // -x
      {1, 3, 7, 5},  // +x
      {0, 1, 5, 4},  // -y
      {2, 6, 7, 3},  // +y
      {0, 2, 3, 1},  // -z
      {4, 5, 7, 6},  // +z
  };

  float cv[8];
  V3 cp[8];
  uint64_t cg[8];
  // per-cell segment list: (start vertex, end vertex), <= 2 per face
  int64_t seg_s[12], seg_e[12];

  for (int64_t ix = 0; ix + 1 < nx; ++ix) {
    for (int64_t iy = 0; iy + 1 < ny; ++iy) {
      const float* col0 = field + (ix * ny + iy) * nz;
      const float* col1 = field + (ix * ny + iy + 1) * nz;
      const float* col2 = field + ((ix + 1) * ny + iy) * nz;
      const float* col3 = field + ((ix + 1) * ny + iy + 1) * nz;
      for (int64_t iz = 0; iz + 1 < nz; ++iz) {
        cv[0] = col0[iz];
        cv[1] = col2[iz];
        cv[2] = col1[iz];
        cv[3] = col3[iz];
        cv[4] = col0[iz + 1];
        cv[5] = col2[iz + 1];
        cv[6] = col1[iz + 1];
        cv[7] = col3[iz + 1];

        bool any_lo = false, any_hi = false;
        for (int c = 0; c < 8; ++c) {
          if (cv[c] < level) any_lo = true; else any_hi = true;
        }
        if (!any_lo || !any_hi) continue;

        for (int c = 0; c < 8; ++c) {
          const int64_t dx = c & 1, dy = (c >> 1) & 1, dz = (c >> 2) & 1;
          cp[c].x = ox + sx * static_cast<float>(ix + dx);
          cp[c].y = oy + sy * static_cast<float>(iy + dy);
          cp[c].z = oz + sz * static_cast<float>(iz + dz);
          cg[c] = gid(ix + dx, iy + dy, iz + dz);
        }

        int n_seg = 0;
        for (int f = 0; f < 6; ++f) {
          const int* q = kFaces[f];
          bool in[4];
          int n_in = 0;
          for (int k = 0; k < 4; ++k) {
            in[k] = cv[q[k]] < level;
            n_in += in[k] ? 1 : 0;
          }
          if (n_in == 0 || n_in == 4) continue;
          // edge k = q[k] -> q[(k+1)%4]; intersection point where signs
          // differ (deduplicated globally on the cube edge)
          int64_t pt[4];
          for (int k = 0; k < 4; ++k) {
            const int a = q[k], b = q[(k + 1) & 3];
            pt[k] = (in[k] != in[(k + 1) & 3])
                        ? mb.edge_vertex(cg[a], cg[b], cp[a], cp[b], cv[a],
                                         cv[b], level)
                        : -1;
          }
          // ambiguous diagonal case: the face-center average decides the
          // pairing (consistent across the two cells sharing this face)
          const bool center_in =
              0.25f * (cv[q[0]] + cv[q[1]] + cv[q[2]] + cv[q[3]]) < level;
          for (int k = 0; k < 4; ++k) {
            if (!(in[k] && !in[(k + 1) & 3])) continue;  // in->out start
            // scan for the matching out->in edge: forward when the center
            // is inside (band pairing), backward otherwise
            for (int s = 1; s < 4; ++s) {
              const int m = center_in ? (k + s) & 3 : (k - s + 4) & 3;
              if (!in[m] && in[(m + 1) & 3]) {
                seg_s[n_seg] = pt[k];
                seg_e[n_seg] = pt[m];
                ++n_seg;
                break;
              }
            }
          }
        }

        // chain directed segments into loops, fan-triangulate each
        bool used[12] = {false};
        for (int s0 = 0; s0 < n_seg; ++s0) {
          if (used[s0]) continue;
          int64_t loop[12];
          int len = 0;
          int cur = s0;
          while (true) {
            used[cur] = true;
            loop[len++] = seg_s[cur];
            const int64_t target = seg_e[cur];
            if (target == seg_s[s0] || len >= 12) break;
            int nxt = -1;
            for (int s = 0; s < n_seg; ++s) {
              if (!used[s] && seg_s[s] == target) {
                nxt = s;
                break;
              }
            }
            if (nxt < 0) break;  // open chain (degenerate values) — drop tail
            cur = nxt;
          }
          for (int k = 1; k + 1 < len; ++k) {
            mb.tri(loop[0], loop[k], loop[k + 1]);
          }
        }
      }
    }
  }

  *n_verts = static_cast<int64_t>(mb.verts.size() / 3);
  *n_tris = static_cast<int64_t>(mb.tris.size() / 3);
  *out_verts = static_cast<float*>(std::malloc(mb.verts.size() * sizeof(float)));
  *out_tris =
      static_cast<int64_t*>(std::malloc(mb.tris.size() * sizeof(int64_t)));
  if ((*out_verts == nullptr && !mb.verts.empty()) ||
      (*out_tris == nullptr && !mb.tris.empty()))
    return 1;
  std::memcpy(*out_verts, mb.verts.data(), mb.verts.size() * sizeof(float));
  std::memcpy(*out_tris, mb.tris.data(), mb.tris.size() * sizeof(int64_t));
  return 0;
}

// Label connected components of a triangle mesh (vertex-connectivity).
// Writes a component id per triangle into comp_out (n_tris) and the triangle
// area sum per component into area_out (n_tris capacity; entry c valid for
// c < n_components).  Returns the number of components.
int64_t mesh_components(const float* verts, int64_t n_verts,
                        const int64_t* tris, int64_t n_tris,
                        int32_t* comp_out, float* area_out) {
  std::vector<int64_t> parent(static_cast<size_t>(n_verts));
  for (int64_t i = 0; i < n_verts; ++i) parent[static_cast<size_t>(i)] = i;

  std::function<int64_t(int64_t)> find = [&](int64_t x) {
    while (parent[static_cast<size_t>(x)] != x) {
      parent[static_cast<size_t>(x)] =
          parent[static_cast<size_t>(parent[static_cast<size_t>(x)])];
      x = parent[static_cast<size_t>(x)];
    }
    return x;
  };
  auto unite = [&](int64_t a, int64_t b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[static_cast<size_t>(a)] = b;
  };

  for (int64_t t = 0; t < n_tris; ++t) {
    unite(tris[3 * t], tris[3 * t + 1]);
    unite(tris[3 * t], tris[3 * t + 2]);
  }

  std::unordered_map<int64_t, int32_t> root2comp;
  int32_t n_comp = 0;
  for (int64_t t = 0; t < n_tris; ++t) {
    const int64_t r = find(tris[3 * t]);
    auto it = root2comp.find(r);
    int32_t c;
    if (it == root2comp.end()) {
      c = n_comp++;
      root2comp.emplace(r, c);
      area_out[c] = 0.f;
    } else {
      c = it->second;
    }
    comp_out[t] = c;
    // triangle area
    const float* a = verts + 3 * tris[3 * t];
    const float* b = verts + 3 * tris[3 * t + 1];
    const float* cvtx = verts + 3 * tris[3 * t + 2];
    const float ux = b[0] - a[0], uy = b[1] - a[1], uz = b[2] - a[2];
    const float vx = cvtx[0] - a[0], vy = cvtx[1] - a[1], vz = cvtx[2] - a[2];
    const float cxx = uy * vz - uz * vy;
    const float cyy = uz * vx - ux * vz;
    const float czz = ux * vy - uy * vx;
    area_out[c] += 0.5f * std::sqrt(cxx * cxx + cyy * cyy + czz * czz);
  }
  return n_comp;
}

void free_buffer(void* ptr) { std::free(ptr); }

}  // extern "C"

// ---------------------------------------------------------------------------
// BVH raycaster: offscreen mesh depth rendering.
//
// Replaces Open3D's offscreen depth capture used by the reference's 2D
// reconstruction metric (src/tools/eval_recon.py:155-204).  Median-split
// BVH, Moller-Trumbore intersection, pinhole camera with the standard CV
// convention (+z forward): depth buffer = hit z in camera space (0 = miss),
// matching o3d capture_depth_float_buffer semantics.
// ---------------------------------------------------------------------------

namespace {

struct AABB {
  float lo[3] = {1e30f, 1e30f, 1e30f};
  float hi[3] = {-1e30f, -1e30f, -1e30f};
  void grow(const float* p) {
    for (int k = 0; k < 3; ++k) {
      if (p[k] < lo[k]) lo[k] = p[k];
      if (p[k] > hi[k]) hi[k] = p[k];
    }
  }
  void grow(const AABB& o) {
    grow(o.lo);
    grow(o.hi);
  }
};

struct BVHNode {
  AABB box;
  int32_t left = -1, right = -1;  // children; -1 for leaf
  int32_t start = 0, count = 0;   // triangle range for leaves
};

struct BVH {
  std::vector<BVHNode> nodes;
  std::vector<int32_t> tri_order;
  const float* verts;
  const int64_t* tris;

  void build(const float* v, const int64_t* t, int64_t n_tris) {
    verts = v;
    tris = t;
    tri_order.resize(static_cast<size_t>(n_tris));
    for (int64_t i = 0; i < n_tris; ++i) tri_order[static_cast<size_t>(i)] = static_cast<int32_t>(i);
    std::vector<std::array<float, 3>> centroids(static_cast<size_t>(n_tris));
    for (int64_t i = 0; i < n_tris; ++i) {
      for (int k = 0; k < 3; ++k) {
        centroids[static_cast<size_t>(i)][static_cast<size_t>(k)] =
            (v[3 * t[3 * i] + k] + v[3 * t[3 * i + 1] + k] +
             v[3 * t[3 * i + 2] + k]) / 3.f;
      }
    }
    nodes.reserve(static_cast<size_t>(2 * n_tris));
    build_node(0, static_cast<int32_t>(n_tris), centroids);
  }

  int32_t build_node(int32_t start, int32_t count,
                     const std::vector<std::array<float, 3>>& cent) {
    const int32_t idx = static_cast<int32_t>(nodes.size());
    nodes.emplace_back();
    AABB box;
    for (int32_t i = start; i < start + count; ++i) {
      const int32_t tri = tri_order[static_cast<size_t>(i)];
      for (int c = 0; c < 3; ++c) box.grow(verts + 3 * tris[3 * tri + c]);
    }
    nodes[static_cast<size_t>(idx)].box = box;
    if (count <= 4) {
      nodes[static_cast<size_t>(idx)].start = start;
      nodes[static_cast<size_t>(idx)].count = count;
      return idx;
    }
    // split along widest axis at median centroid
    int axis = 0;
    float widest = -1.f;
    for (int k = 0; k < 3; ++k) {
      const float w = box.hi[k] - box.lo[k];
      if (w > widest) {
        widest = w;
        axis = k;
      }
    }
    const int32_t mid = start + count / 2;
    std::nth_element(
        tri_order.begin() + start, tri_order.begin() + mid,
        tri_order.begin() + start + count,
        [&](int32_t a, int32_t b) {
          return cent[static_cast<size_t>(a)][static_cast<size_t>(axis)] <
                 cent[static_cast<size_t>(b)][static_cast<size_t>(axis)];
        });
    const int32_t l = build_node(start, mid - start, cent);
    const int32_t r = build_node(mid, start + count - mid, cent);
    nodes[static_cast<size_t>(idx)].left = l;
    nodes[static_cast<size_t>(idx)].right = r;
    return idx;
  }

  static bool hit_box(const AABB& b, const float* o, const float* inv_d,
                      float t_max) {
    float t0 = 0.f, t1 = t_max;
    for (int k = 0; k < 3; ++k) {
      float ta = (b.lo[k] - o[k]) * inv_d[k];
      float tb = (b.hi[k] - o[k]) * inv_d[k];
      if (ta > tb) std::swap(ta, tb);
      if (ta > t0) t0 = ta;
      if (tb < t1) t1 = tb;
      if (t0 > t1) return false;
    }
    return true;
  }

  // returns nearest hit t (ray parameter), or -1
  float cast(const float* o, const float* d) const {
    float inv_d[3];
    for (int k = 0; k < 3; ++k)
      inv_d[k] = 1.f / (std::fabs(d[k]) > 1e-12f ? d[k]
                                                 : (d[k] >= 0 ? 1e-12f : -1e-12f));
    float best = 1e30f;
    int32_t stack[64];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const BVHNode& node = nodes[static_cast<size_t>(stack[--sp])];
      if (!hit_box(node.box, o, inv_d, best)) continue;
      if (node.left < 0) {
        for (int32_t i = node.start; i < node.start + node.count; ++i) {
          const int32_t tri = tri_order[static_cast<size_t>(i)];
          const float* a = verts + 3 * tris[3 * tri];
          const float* b = verts + 3 * tris[3 * tri + 1];
          const float* c = verts + 3 * tris[3 * tri + 2];
          // Moller-Trumbore (two-sided)
          float e1[3], e2[3], pv[3], tv[3], qv[3];
          for (int k = 0; k < 3; ++k) {
            e1[k] = b[k] - a[k];
            e2[k] = c[k] - a[k];
          }
          pv[0] = d[1] * e2[2] - d[2] * e2[1];
          pv[1] = d[2] * e2[0] - d[0] * e2[2];
          pv[2] = d[0] * e2[1] - d[1] * e2[0];
          const float det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2];
          if (std::fabs(det) < 1e-12f) continue;
          const float inv_det = 1.f / det;
          for (int k = 0; k < 3; ++k) tv[k] = o[k] - a[k];
          // slightly edge-inclusive so rays grazing shared edges cannot
          // slip between adjacent triangles
          const float kEdgeEps = 1e-6f;
          const float u =
              (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]) * inv_det;
          if (u < -kEdgeEps || u > 1.f + kEdgeEps) continue;
          qv[0] = tv[1] * e1[2] - tv[2] * e1[1];
          qv[1] = tv[2] * e1[0] - tv[0] * e1[2];
          qv[2] = tv[0] * e1[1] - tv[1] * e1[0];
          const float vv =
              (d[0] * qv[0] + d[1] * qv[1] + d[2] * qv[2]) * inv_det;
          if (vv < -kEdgeEps || u + vv > 1.f + kEdgeEps) continue;
          const float t =
              (e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2]) * inv_det;
          if (t > 1e-6f && t < best) best = t;
        }
      } else {
        stack[sp++] = node.left;
        stack[sp++] = node.right;
      }
    }
    return best < 1e30f ? best : -1.f;
  }
};

}  // namespace

extern "C" {

// Opaque BVH handle API.
void* bvh_build(const float* verts, int64_t n_verts, const int64_t* tris,
                int64_t n_tris) {
  (void)n_verts;
  BVH* bvh = new BVH();
  bvh->build(verts, tris, n_tris);
  return bvh;
}

void bvh_free(void* handle) { delete static_cast<BVH*>(handle); }

// Render a z-depth buffer (H*W floats, row-major; 0 where no hit) through a
// standard CV pinhole camera: +z forward, x right, y down.
// c2w: 4x4 row-major camera-to-world.
void bvh_render_depth(void* handle, const float* c2w, int32_t H, int32_t W,
                      float fx, float fy, float cx, float cy, float z_far,
                      float* out_depth) {
  const BVH* bvh = static_cast<const BVH*>(handle);
  const float ox = c2w[3], oy = c2w[7], oz = c2w[11];
  const float o[3] = {ox, oy, oz};
  for (int32_t vpix = 0; vpix < H; ++vpix) {
    for (int32_t upix = 0; upix < W; ++upix) {
      const float xc = (static_cast<float>(upix) - cx) / fx;
      const float yc = (static_cast<float>(vpix) - cy) / fy;
      // camera dir (xc, yc, 1) -> world
      float d[3];
      d[0] = c2w[0] * xc + c2w[1] * yc + c2w[2];
      d[1] = c2w[4] * xc + c2w[5] * yc + c2w[6];
      d[2] = c2w[8] * xc + c2w[9] * yc + c2w[10];
      const float t = bvh->cast(o, d);
      float depth = 0.f;
      if (t > 0.f) {
        depth = t;  // ray parameter * |dir_z-normalization|: dir has unit z in
                    // camera space, so t IS the z-depth
        if (depth > z_far) depth = 0.f;
      }
      out_depth[vpix * W + upix] = depth;
    }
  }
}

// Cast arbitrary rays; out_t gets the hit parameter (-1 on miss).
void bvh_cast_rays(void* handle, const float* origins, const float* dirs,
                   int64_t n_rays, float* out_t) {
  const BVH* bvh = static_cast<const BVH*>(handle);
  for (int64_t i = 0; i < n_rays; ++i) {
    out_t[i] = bvh->cast(origins + 3 * i, dirs + 3 * i);
  }
}

}  // extern "C"
