// Native host-geometry library of neumesh_tpu_torch: an own copy of
// neumesh_tpu/cpp/src/host_lib.cpp, with the same algorithms, traversal
// orders and extern "C" API, so that the port's extraction, candidate
// tables, ARAP and ray casts equal the JAX package's default path.
//
// Replacements for the reference's C++ dependencies (SURVEY §2.4):
//   - marching tetrahedra isosurfacing   (PyMCubes analog)
//   - KD-tree exact kNN                  (scipy cKDTree analog)
//   - BVH ray-triangle casting           (Open3D RaycastingScene analog)
//   - ARAP deformation (cotan local-global, CG solver)
//                                        (Open3D deform_as_rigid_as_possible)
//
// The KD-tree keeps the first of equal distances it visits, and ARAP's CG
// is capped at 200 iterations: results depend on both, so neither is to
// be changed here alone.
//
// All entry points are extern "C" with plain pointers (ctypes-friendly).
// Built at first use by neumesh_tpu_torch/ops/_build.py::build_host:
//   g++ -O3 -march=native -shared -fPIC -std=c++17 -o <lib> host_lib.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// simple parallel-for over [0, n) with hardware threads
template <typename F>
void parallel_for(long long n, F &&f) {
  unsigned nt = std::thread::hardware_concurrency();
  if (nt == 0) nt = 4;
  if (n < 4096 || nt <= 1) {
    for (long long i = 0; i < n; i++) f(i);
    return;
  }
  std::vector<std::thread> threads;
  long long chunk = (n + nt - 1) / nt;
  for (unsigned t = 0; t < nt; t++) {
    long long lo = (long long)t * chunk;
    long long hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=, &f]() {
      for (long long i = lo; i < hi; i++) f(i);
    });
  }
  for (auto &th : threads) th.join();
}

}  // namespace

namespace {

struct V3 {
  double x = 0, y = 0, z = 0;
  V3() = default;
  V3(double a, double b, double c) : x(a), y(b), z(c) {}
  V3 operator+(const V3 &o) const { return {x + o.x, y + o.y, z + o.z}; }
  V3 operator-(const V3 &o) const { return {x - o.x, y - o.y, z - o.z}; }
  V3 operator*(double s) const { return {x * s, y * s, z * s}; }
  double dot(const V3 &o) const { return x * o.x + y * o.y + z * o.z; }
  V3 cross(const V3 &o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double norm() const { return std::sqrt(dot(*this)); }
  double &operator[](int i) { return i == 0 ? x : (i == 1 ? y : z); }
  double operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

}  // namespace

// ===========================================================================
// Marching tetrahedra
// ===========================================================================

namespace mt {

struct Result {
  std::vector<double> verts;   // V*3
  std::vector<int64_t> tris;   // M*3
};

static const int CORNERS[8][3] = {{0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
                                  {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};
static const int TETS[6][4] = {{0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
                               {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6}};

struct Extractor {
  const float *f;
  int nx, ny, nz;
  float iso;
  std::unordered_map<uint64_t, int64_t> edge_map;
  Result out;

  inline int64_t vid(int i, int j, int k) const {
    return ((int64_t)i * ny + j) * nz + k;
  }
  inline float val(int64_t id) const { return f[id]; }
  inline V3 pos(int64_t id) const {
    int k = (int)(id % nz);
    int j = (int)((id / nz) % ny);
    int i = (int)(id / ((int64_t)nz * ny));
    return V3(i, j, k);
  }

  int64_t edge_vertex(int64_t a, int64_t b) {
    int64_t lo = std::min(a, b), hi = std::max(a, b);
    uint64_t key = ((uint64_t)lo << 32) ^ (uint64_t)hi;
    // NOTE: lo < nx*ny*nz <= 2^31 for realistic grids; pack as lo<<32|hi
    key = ((uint64_t)lo << 32) | (uint64_t)(uint32_t)hi;
    auto it = edge_map.find(key);
    if (it != edge_map.end()) return it->second;
    double v0 = val(lo), v1 = val(hi);
    double denom = std::abs(v1 - v0) < 1e-12 ? 1e-12 : (v1 - v0);
    double t = (iso - v0) / denom;
    t = std::max(0.0, std::min(1.0, t));
    V3 p = pos(lo) + (pos(hi) - pos(lo)) * t;
    int64_t idx = (int64_t)out.verts.size() / 3;
    out.verts.push_back(p.x);
    out.verts.push_back(p.y);
    out.verts.push_back(p.z);
    edge_map.emplace(key, idx);
    return idx;
  }

  void emit_tri(int64_t a0, int64_t b0, int64_t a1, int64_t b1, int64_t a2,
                int64_t b2) {
    // vertices on edges (a_i inside, b_i outside); orient normal towards
    // outside: check cross against (mean(b) - mean(a))
    int64_t e0 = edge_vertex(a0, b0);
    int64_t e1 = edge_vertex(a1, b1);
    int64_t e2 = edge_vertex(a2, b2);
    if (e0 == e1 || e1 == e2 || e0 == e2) return;
    V3 p0(out.verts[e0 * 3], out.verts[e0 * 3 + 1], out.verts[e0 * 3 + 2]);
    V3 p1(out.verts[e1 * 3], out.verts[e1 * 3 + 1], out.verts[e1 * 3 + 2]);
    V3 p2(out.verts[e2 * 3], out.verts[e2 * 3 + 1], out.verts[e2 * 3 + 2]);
    V3 outdir = (pos(b0) + pos(b1) + pos(b2)) * (1.0 / 3.0) -
                (pos(a0) + pos(a1) + pos(a2)) * (1.0 / 3.0);
    V3 n = (p1 - p0).cross(p2 - p0);
    if (n.dot(outdir) < 0) std::swap(e1, e2);
    out.tris.push_back(e0);
    out.tris.push_back(e1);
    out.tris.push_back(e2);
  }

  void tet(int64_t c[4]) {
    bool in[4];
    int n_in = 0;
    for (int i = 0; i < 4; i++) {
      in[i] = val(c[i]) < iso;
      n_in += in[i];
    }
    if (n_in == 0 || n_in == 4) return;
    int ins[4], outs[4];
    int ni = 0, no = 0;
    for (int i = 0; i < 4; i++) (in[i] ? ins[ni++] : outs[no++]) = i;
    if (n_in == 1) {
      int a = ins[0];
      emit_tri(c[a], c[outs[0]], c[a], c[outs[1]], c[a], c[outs[2]]);
    } else if (n_in == 3) {
      int b = outs[0];
      emit_tri(c[ins[0]], c[b], c[ins[1]], c[b], c[ins[2]], c[b]);
    } else {  // 2-2: quad split into two triangles
      int i0 = ins[0], i1 = ins[1], o0 = outs[0], o1 = outs[1];
      emit_tri(c[i0], c[o0], c[i0], c[o1], c[i1], c[o1]);
      emit_tri(c[i0], c[o0], c[i1], c[o1], c[i1], c[o0]);
    }
  }

  void run() {
    for (int i = 0; i + 1 < nx; i++)
      for (int j = 0; j + 1 < ny; j++)
        for (int k = 0; k + 1 < nz; k++) {
          // quick reject: all corners same side
          bool any_in = false, all_in = true;
          int64_t cid[8];
          for (int c = 0; c < 8; c++) {
            cid[c] = vid(i + CORNERS[c][0], j + CORNERS[c][1],
                         k + CORNERS[c][2]);
            bool b = f[cid[c]] < iso;
            any_in |= b;
            all_in &= b;
          }
          if (!any_in || all_in) continue;
          for (int t = 0; t < 6; t++) {
            int64_t tc[4] = {cid[TETS[t][0]], cid[TETS[t][1]],
                             cid[TETS[t][2]], cid[TETS[t][3]]};
            tet(tc);
          }
        }
  }
};

}  // namespace mt

extern "C" {

long long mt_extract(const float *field, int nx, int ny, int nz, float iso,
                     void **handle) {
  auto *ex = new mt::Extractor();
  ex->f = field;
  ex->nx = nx;
  ex->ny = ny;
  ex->nz = nz;
  ex->iso = iso;
  ex->run();
  *handle = ex;
  return (long long)(ex->out.verts.size() / 3);
}

long long mt_num_tris(void *handle) {
  auto *ex = (mt::Extractor *)handle;
  return (long long)(ex->out.tris.size() / 3);
}

void mt_get_results(void *handle, double *verts, int64_t *tris) {
  auto *ex = (mt::Extractor *)handle;
  std::memcpy(verts, ex->out.verts.data(),
              ex->out.verts.size() * sizeof(double));
  std::memcpy(tris, ex->out.tris.data(),
              ex->out.tris.size() * sizeof(int64_t));
}

void mt_free(void *handle) { delete (mt::Extractor *)handle; }

}  // extern "C"

// ===========================================================================
// Marching cubes (table-free face-walking formulation)
//
// One vertex per crossed grid EDGE with linear interpolation — the exact
// vertex set classic marching cubes (PyMCubes, reference
// extract_mesh.py:139) produces on the same field, so extractions are
// vertex-comparable with reference-extracted meshes (VERDICT r3 #9).
// Connectivity is built by walking the isosurface polygon(s) around each
// cell: on every face, crossed edges pair up (4-crossing ambiguous faces
// resolved by the face-center average — crack-free, the same decision on
// both adjacent cells); cycles are fan-triangulated with normals oriented
// toward field > iso (outward for an SDF), matching the MT convention.
// ===========================================================================

namespace mc {

// cube corners as in mt::CORNERS; edges and faces in cyclic corner order
static const int EDGES[12][2] = {{0, 1}, {1, 2}, {2, 3}, {3, 0},
                                 {4, 5}, {5, 6}, {6, 7}, {7, 4},
                                 {0, 4}, {1, 5}, {2, 6}, {3, 7}};
static const int FACE_C[6][4] = {{0, 1, 2, 3}, {4, 5, 6, 7}, {0, 1, 5, 4},
                                 {1, 2, 6, 5}, {2, 3, 7, 6}, {3, 0, 4, 7}};
static const int FACE_E[6][4] = {{0, 1, 2, 3}, {4, 5, 6, 7}, {0, 9, 4, 8},
                                 {1, 10, 5, 9}, {2, 11, 6, 10},
                                 {3, 8, 7, 11}};

struct Extractor {
  const float *f;
  int nx, ny, nz;
  float iso;
  std::unordered_map<uint64_t, int64_t> edge_map;
  mt::Result out;

  inline int64_t vid(int i, int j, int k) const {
    return ((int64_t)i * ny + j) * nz + k;
  }
  inline float val(int64_t id) const { return f[id]; }
  inline V3 pos(int64_t id) const {
    int k = (int)(id % nz);
    int j = (int)((id / nz) % ny);
    int i = (int)(id / ((int64_t)nz * ny));
    return V3(i, j, k);
  }

  int64_t edge_vertex(int64_t a, int64_t b) {
    int64_t lo = std::min(a, b), hi = std::max(a, b);
    uint64_t key = ((uint64_t)lo << 32) | (uint64_t)(uint32_t)hi;
    auto it = edge_map.find(key);
    if (it != edge_map.end()) return it->second;
    double v0 = val(lo), v1 = val(hi);
    double denom = std::abs(v1 - v0) < 1e-12 ? 1e-12 : (v1 - v0);
    double t = (iso - v0) / denom;
    t = std::max(0.0, std::min(1.0, t));
    V3 p = pos(lo) + (pos(hi) - pos(lo)) * t;
    int64_t idx = (int64_t)out.verts.size() / 3;
    out.verts.push_back(p.x);
    out.verts.push_back(p.y);
    out.verts.push_back(p.z);
    edge_map.emplace(key, idx);
    return idx;
  }

  void cell(const int64_t cid[8], const bool in[8]) {
    bool crossed[12];
    int partner[12][2];
    int pcount[12] = {0};
    for (int e = 0; e < 12; e++)
      crossed[e] = in[EDGES[e][0]] != in[EDGES[e][1]];

    auto link = [&](int a, int b) {
      partner[a][pcount[a]++] = b;
      partner[b][pcount[b]++] = a;
    };

    for (int fc = 0; fc < 6; fc++) {
      int ce[4], m = 0;
      for (int s = 0; s < 4; s++)
        if (crossed[FACE_E[fc][s]]) ce[m++] = s;
      if (m == 0) continue;
      if (m == 2) {
        link(FACE_E[fc][ce[0]], FACE_E[fc][ce[1]]);
      } else {  // m == 4: corners alternate in/out around the face.
        // Pairing A = (e0,e1)+(e2,e3) cuts off corners c1 and c3; it
        // cuts off the OUTSIDE corners iff c0 is inside. Keep the
        // inside region connected iff the face-center average is
        // inside: use A when (center inside) == (c0 inside).
        double cavg = 0.25 * (val(cid[FACE_C[fc][0]]) +
                              val(cid[FACE_C[fc][1]]) +
                              val(cid[FACE_C[fc][2]]) +
                              val(cid[FACE_C[fc][3]]));
        bool center_in = cavg < iso;
        if (center_in == in[FACE_C[fc][0]]) {
          link(FACE_E[fc][0], FACE_E[fc][1]);
          link(FACE_E[fc][2], FACE_E[fc][3]);
        } else {
          link(FACE_E[fc][1], FACE_E[fc][2]);
          link(FACE_E[fc][3], FACE_E[fc][0]);
        }
      }
    }

    bool used[12] = {false};
    for (int s = 0; s < 12; s++) {
      if (!crossed[s] || used[s]) continue;
      int poly[12], m = 0;
      int prev = -1, cur = s;
      do {
        poly[m++] = cur;
        used[cur] = true;
        int nxt = (partner[cur][0] == prev) ? partner[cur][1]
                                            : partner[cur][0];
        prev = cur;
        cur = nxt;
      } while (cur != s && m < 12);
      if (m < 3) continue;

      int64_t vidx[12];
      V3 p[12], outdir(0, 0, 0);
      for (int t = 0; t < m; t++) {
        int e = poly[t];
        int64_t ga = cid[EDGES[e][0]], gb = cid[EDGES[e][1]];
        vidx[t] = edge_vertex(ga, gb);
        p[t] = V3(out.verts[vidx[t] * 3], out.verts[vidx[t] * 3 + 1],
                  out.verts[vidx[t] * 3 + 2]);
        // in -> out direction of each crossed edge accumulates an
        // outward estimate for the polygon
        V3 pa = pos(ga), pb = pos(gb);
        outdir = outdir + (in[EDGES[e][0]] ? pb - pa : pa - pb);
      }
      V3 n(0, 0, 0);  // Newell normal
      for (int t = 0; t < m; t++) n = n + p[t].cross(p[(t + 1) % m]);
      if (n.dot(outdir) < 0) {  // orient toward field > iso
        for (int t = 0; t < m / 2; t++) {
          std::swap(vidx[t], vidx[m - 1 - t]);
        }
      }
      for (int t = 1; t + 1 < m; t++) {
        if (vidx[0] == vidx[t] || vidx[t] == vidx[t + 1] ||
            vidx[0] == vidx[t + 1])
          continue;
        out.tris.push_back(vidx[0]);
        out.tris.push_back(vidx[t]);
        out.tris.push_back(vidx[t + 1]);
      }
    }
  }

  void run() {
    for (int i = 0; i + 1 < nx; i++)
      for (int j = 0; j + 1 < ny; j++)
        for (int k = 0; k + 1 < nz; k++) {
          bool any_in = false, all_in = true;
          int64_t cid[8];
          bool in[8];
          for (int c = 0; c < 8; c++) {
            cid[c] = vid(i + mt::CORNERS[c][0], j + mt::CORNERS[c][1],
                         k + mt::CORNERS[c][2]);
            in[c] = f[cid[c]] < iso;
            any_in |= in[c];
            all_in &= in[c];
          }
          if (!any_in || all_in) continue;
          cell(cid, in);
        }
  }
};

}  // namespace mc

extern "C" {

long long mc_extract(const float *field, int nx, int ny, int nz, float iso,
                     void **handle) {
  auto *ex = new mc::Extractor();
  ex->f = field;
  ex->nx = nx;
  ex->ny = ny;
  ex->nz = nz;
  ex->iso = iso;
  ex->run();
  *handle = ex;
  return (long long)(ex->out.verts.size() / 3);
}

long long mc_num_tris(void *handle) {
  auto *ex = (mc::Extractor *)handle;
  return (long long)(ex->out.tris.size() / 3);
}

void mc_get_results(void *handle, double *verts, int64_t *tris) {
  auto *ex = (mc::Extractor *)handle;
  std::memcpy(verts, ex->out.verts.data(),
              ex->out.verts.size() * sizeof(double));
  std::memcpy(tris, ex->out.tris.data(),
              ex->out.tris.size() * sizeof(int64_t));
}

void mc_free(void *handle) { delete (mc::Extractor *)handle; }

}  // extern "C"

// ===========================================================================
// KD-tree (exact kNN)
// ===========================================================================

namespace kd {

struct Node {
  int axis = -1;        // -1 for leaf
  double split = 0;
  int64_t lo = 0, hi = 0;  // leaf range into order[]
  int left = -1, right = -1;
};

struct Tree {
  std::vector<V3> pts;
  std::vector<int64_t> order;
  std::vector<Node> nodes;

  int build(int64_t lo, int64_t hi, int depth) {
    Node node;
    if (hi - lo <= 16) {
      node.axis = -1;
      node.lo = lo;
      node.hi = hi;
      nodes.push_back(node);
      return (int)nodes.size() - 1;
    }
    int axis = depth % 3;
    int64_t mid = (lo + hi) / 2;
    std::nth_element(order.begin() + lo, order.begin() + mid,
                     order.begin() + hi,
                     [&](int64_t a, int64_t b) {
                       return pts[a][axis] < pts[b][axis];
                     });
    node.axis = axis;
    node.split = pts[order[mid]][axis];
    int self = (int)nodes.size();
    nodes.push_back(node);
    int l = build(lo, mid, depth + 1);
    int r = build(mid, hi, depth + 1);
    nodes[self].left = l;
    nodes[self].right = r;
    nodes[self].lo = lo;
    nodes[self].hi = hi;
    return self;
  }

  void knn(const V3 &q, int k, std::priority_queue<std::pair<double, int64_t>> &heap,
           int ni) const {
    const Node &n = nodes[ni];
    if (n.axis < 0) {
      for (int64_t i = n.lo; i < n.hi; i++) {
        int64_t pi = order[i];
        double d2 = (pts[pi] - q).dot(pts[pi] - q);
        if ((int)heap.size() < k)
          heap.emplace(d2, pi);
        else if (d2 < heap.top().first) {
          heap.pop();
          heap.emplace(d2, pi);
        }
      }
      return;
    }
    double diff = q[n.axis] - n.split;
    int first = diff < 0 ? n.left : n.right;
    int second = diff < 0 ? n.right : n.left;
    knn(q, k, heap, first);
    if ((int)heap.size() < k || diff * diff < heap.top().first)
      knn(q, k, heap, second);
  }
};

}  // namespace kd

extern "C" {

void *kdtree_build(const double *points, long long n) {
  auto *t = new kd::Tree();
  t->pts.resize(n);
  for (long long i = 0; i < n; i++)
    t->pts[i] = V3(points[i * 3], points[i * 3 + 1], points[i * 3 + 2]);
  t->order.resize(n);
  for (long long i = 0; i < n; i++) t->order[i] = i;
  if (n > 0) t->build(0, n, 0);
  return t;
}

void kdtree_free(void *h) { delete (kd::Tree *)h; }

void kdtree_knn(void *h, const double *queries, long long nq, int k,
                int64_t *out_idx, double *out_dist) {
  auto *t = (kd::Tree *)h;
  parallel_for(nq, [&](long long i) {
    V3 q(queries[i * 3], queries[i * 3 + 1], queries[i * 3 + 2]);
    std::priority_queue<std::pair<double, int64_t>> heap;
    t->knn(q, k, heap, 0);
    int m = (int)heap.size();
    for (int j = m - 1; j >= 0; j--) {
      out_dist[i * k + j] = std::sqrt(heap.top().first);
      out_idx[i * k + j] = heap.top().second;
      heap.pop();
    }
    for (int j = m; j < k; j++) {  // fewer points than k
      out_dist[i * k + j] = INFINITY;
      out_idx[i * k + j] = -1;
    }
  });
}

}  // extern "C"

// ===========================================================================
// BVH ray casting
// ===========================================================================

namespace bvh {

struct AABB {
  V3 lo{1e30, 1e30, 1e30}, hi{-1e30, -1e30, -1e30};
  void grow(const V3 &p) {
    lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y);
    lo.z = std::min(lo.z, p.z);
    hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y);
    hi.z = std::max(hi.z, p.z);
  }
  void grow(const AABB &b) { grow(b.lo); grow(b.hi); }
  bool hit(const V3 &o, const V3 &inv_d, double tmax) const {
    double t0 = 0, t1 = tmax;
    for (int a = 0; a < 3; a++) {
      double ta = (lo[a] - o[a]) * inv_d[a];
      double tb = (hi[a] - o[a]) * inv_d[a];
      if (ta > tb) std::swap(ta, tb);
      t0 = std::max(t0, ta);
      t1 = std::min(t1, tb);
      if (t0 > t1) return false;
    }
    return true;
  }
};

struct Node {
  AABB box;
  int left = -1, right = -1;
  int64_t lo = 0, hi = 0;  // leaf triangle range
};

struct Scene {
  std::vector<V3> v;
  std::vector<int64_t> tri;  // M*3
  std::vector<int64_t> order;
  std::vector<Node> nodes;

  V3 centroid(int64_t t) const {
    return (v[tri[t * 3]] + v[tri[t * 3 + 1]] + v[tri[t * 3 + 2]]) *
           (1.0 / 3.0);
  }
  AABB tri_box(int64_t t) const {
    AABB b;
    b.grow(v[tri[t * 3]]);
    b.grow(v[tri[t * 3 + 1]]);
    b.grow(v[tri[t * 3 + 2]]);
    return b;
  }

  int build(int64_t lo, int64_t hi) {
    Node n;
    for (int64_t i = lo; i < hi; i++) n.box.grow(tri_box(order[i]));
    int self = (int)nodes.size();
    nodes.push_back(n);
    if (hi - lo <= 4) {
      nodes[self].lo = lo;
      nodes[self].hi = hi;
      return self;
    }
    V3 ext = n.box.hi - n.box.lo;
    int axis = 0;
    if (ext.y > ext.x) axis = 1;
    if (ext.z > ext[axis]) axis = 2;
    int64_t mid = (lo + hi) / 2;
    std::nth_element(order.begin() + lo, order.begin() + mid,
                     order.begin() + hi, [&](int64_t a, int64_t b) {
                       return centroid(a)[axis] < centroid(b)[axis];
                     });
    int l = build(lo, mid);
    int r = build(mid, hi);
    nodes[self].left = l;
    nodes[self].right = r;
    return self;
  }

  // Moller-Trumbore
  bool intersect_tri(int64_t t, const V3 &o, const V3 &d, double &t_hit) const {
    const V3 &p0 = v[tri[t * 3]];
    const V3 &p1 = v[tri[t * 3 + 1]];
    const V3 &p2 = v[tri[t * 3 + 2]];
    V3 e1 = p1 - p0, e2 = p2 - p0;
    V3 pv = d.cross(e2);
    double det = e1.dot(pv);
    if (std::abs(det) < 1e-14) return false;
    double inv = 1.0 / det;
    V3 tv = o - p0;
    double u = tv.dot(pv) * inv;
    if (u < -1e-9 || u > 1 + 1e-9) return false;
    V3 qv = tv.cross(e1);
    double w = d.dot(qv) * inv;
    if (w < -1e-9 || u + w > 1 + 1e-9) return false;
    double tt = e2.dot(qv) * inv;
    if (tt <= 1e-12) return false;
    t_hit = tt;
    return true;
  }

  void cast(const V3 &o, const V3 &d, double &best_t, int64_t &best_tri,
            int ni) const {
    const Node &n = nodes[ni];
    V3 inv_d(1.0 / (d.x == 0 ? 1e-30 : d.x), 1.0 / (d.y == 0 ? 1e-30 : d.y),
             1.0 / (d.z == 0 ? 1e-30 : d.z));
    if (!n.box.hit(o, inv_d, best_t)) return;
    if (n.left < 0) {
      for (int64_t i = n.lo; i < n.hi; i++) {
        double t_hit;
        if (intersect_tri(order[i], o, d, t_hit) && t_hit < best_t) {
          best_t = t_hit;
          best_tri = order[i];
        }
      }
      return;
    }
    cast(o, d, best_t, best_tri, n.left);
    cast(o, d, best_t, best_tri, n.right);
  }
};

}  // namespace bvh

extern "C" {

void *bvh_build(const double *verts, long long nv, const int64_t *tris,
                long long nt) {
  auto *s = new bvh::Scene();
  s->v.resize(nv);
  for (long long i = 0; i < nv; i++)
    s->v[i] = V3(verts[i * 3], verts[i * 3 + 1], verts[i * 3 + 2]);
  s->tri.assign(tris, tris + nt * 3);
  s->order.resize(nt);
  for (long long i = 0; i < nt; i++) s->order[i] = i;
  if (nt > 0) s->build(0, nt);
  return s;
}

void bvh_free(void *h) { delete (bvh::Scene *)h; }

void bvh_cast(void *h, const double *rays_o, const double *rays_d,
              long long n, double *t_hit, int64_t *prim_id) {
  auto *s = (bvh::Scene *)h;
  parallel_for(n, [&](long long i) {
    V3 o(rays_o[i * 3], rays_o[i * 3 + 1], rays_o[i * 3 + 2]);
    V3 d(rays_d[i * 3], rays_d[i * 3 + 1], rays_d[i * 3 + 2]);
    double best = 1e30;
    int64_t tri = -1;
    if (!s->nodes.empty()) s->cast(o, d, best, tri, 0);
    t_hit[i] = tri >= 0 ? best : INFINITY;
    prim_id[i] = tri;
  });
}

}  // extern "C"

// ===========================================================================
// ARAP (cotangent local-global with conjugate-gradient solve)
// ===========================================================================

namespace arap {

// 3x3 SVD via Jacobi eigen-decomposition of A^T A (sufficient for rotation
// fitting of well-conditioned covariance matrices)
struct M3 {
  double m[3][3] = {};
  static M3 identity() {
    M3 r;
    r.m[0][0] = r.m[1][1] = r.m[2][2] = 1;
    return r;
  }
  M3 mul(const M3 &o) const {
    M3 r;
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++) {
        double s = 0;
        for (int k = 0; k < 3; k++) s += m[i][k] * o.m[k][j];
        r.m[i][j] = s;
      }
    return r;
  }
  M3 transposed() const {
    M3 r;
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++) r.m[i][j] = m[j][i];
    return r;
  }
  double det() const {
    return m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1]) -
           m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0]) +
           m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]);
  }
  V3 apply(const V3 &v) const {
    return V3(m[0][0] * v.x + m[0][1] * v.y + m[0][2] * v.z,
              m[1][0] * v.x + m[1][1] * v.y + m[1][2] * v.z,
              m[2][0] * v.x + m[2][1] * v.y + m[2][2] * v.z);
  }
};

// Jacobi eigendecomposition of symmetric 3x3
static void sym_eig(const M3 &A, M3 &V, double w[3]) {
  M3 a = A;
  V = M3::identity();
  for (int sweep = 0; sweep < 32; sweep++) {
    double off = std::abs(a.m[0][1]) + std::abs(a.m[0][2]) +
                 std::abs(a.m[1][2]);
    if (off < 1e-15) break;
    for (int p = 0; p < 2; p++)
      for (int q = p + 1; q < 3; q++) {
        if (std::abs(a.m[p][q]) < 1e-18) continue;
        double theta = (a.m[q][q] - a.m[p][p]) / (2 * a.m[p][q]);
        double t = (theta >= 0 ? 1.0 : -1.0) /
                   (std::abs(theta) + std::sqrt(theta * theta + 1));
        double c = 1 / std::sqrt(t * t + 1), s = t * c;
        M3 J = M3::identity();
        J.m[p][p] = c; J.m[q][q] = c; J.m[p][q] = s; J.m[q][p] = -s;
        a = J.transposed().mul(a).mul(J);
        V = V.mul(J);
      }
  }
  for (int i = 0; i < 3; i++) w[i] = a.m[i][i];
}

// polar rotation R from covariance S (R = V * U^T convention for
// S = sum(w e e'^T): fit R minimizing ||R e - e'||)
static M3 fit_rotation(const M3 &S) {
  // SVD: S = U Sigma V^T; R = V U^T with reflection fix.
  M3 StS = S.transposed().mul(S);
  M3 Vm;
  double w[3];
  sym_eig(StS, Vm, w);
  // U = S V Sigma^-1
  M3 U;
  for (int j = 0; j < 3; j++) {
    double sigma = std::sqrt(std::max(w[j], 1e-18));
    V3 vj(Vm.m[0][j], Vm.m[1][j], Vm.m[2][j]);
    V3 uj = S.apply(vj) * (1.0 / sigma);
    double nrm = uj.norm();
    if (nrm < 1e-12) { uj = V3(j == 0, j == 1, j == 2); nrm = 1; }
    uj = uj * (1.0 / nrm);
    U.m[0][j] = uj.x; U.m[1][j] = uj.y; U.m[2][j] = uj.z;
  }
  M3 R = U.mul(Vm.transposed());  // note: rotation mapping e -> e'
  if (R.det() < 0) {
    // flip the column of U with smallest singular value
    int jmin = 0;
    for (int j = 1; j < 3; j++) if (w[j] < w[jmin]) jmin = j;
    for (int i = 0; i < 3; i++) U.m[i][jmin] = -U.m[i][jmin];
    R = U.mul(Vm.transposed());
  }
  return R;
}

}  // namespace arap

extern "C" {

int arap_deform(const double *verts, long long nv, const int64_t *tris,
                long long nt, const int64_t *cids, const double *cpos,
                long long nc, int max_iter, double *out_verts) {
  using arap::M3;
  using arap::fit_rotation;
  std::vector<V3> V(nv), P(nv);
  for (long long i = 0; i < nv; i++)
    V[i] = V3(verts[i * 3], verts[i * 3 + 1], verts[i * 3 + 2]);

  // cotangent weights per edge
  std::unordered_map<uint64_t, double> wmap;
  auto ekey = [](int64_t a, int64_t b) {
    if (a > b) std::swap(a, b);
    return ((uint64_t)a << 32) | (uint64_t)(uint32_t)b;
  };
  for (long long t = 0; t < nt; t++) {
    int64_t i0 = tris[t * 3], i1 = tris[t * 3 + 1], i2 = tris[t * 3 + 2];
    const V3 &p0 = V[i0], &p1 = V[i1], &p2 = V[i2];
    auto cot = [](const V3 &a, const V3 &b) {
      double c = a.dot(b);
      double s = a.cross(b).norm();
      return c / std::max(s, 1e-12);
    };
    double c0 = cot(p1 - p0, p2 - p0);  // angle at v0 -> edge (1,2)
    double c1 = cot(p0 - p1, p2 - p1);  // angle at v1 -> edge (0,2)
    double c2 = cot(p0 - p2, p1 - p2);  // angle at v2 -> edge (0,1)
    wmap[ekey(i1, i2)] += 0.5 * c0;
    wmap[ekey(i0, i2)] += 0.5 * c1;
    wmap[ekey(i0, i1)] += 0.5 * c2;
  }
  // adjacency (CSR)
  std::vector<std::vector<std::pair<int64_t, double>>> nbr(nv);
  for (auto &kv : wmap) {
    int64_t a = (int64_t)(kv.first >> 32);
    int64_t b = (int64_t)(uint32_t)kv.first;
    double w = std::max(kv.second, 1e-8);  // clamp negative cotans
    nbr[a].push_back({b, w});
    nbr[b].push_back({a, w});
  }

  std::vector<char> fixed(nv, 0);
  P = V;
  for (long long c = 0; c < nc; c++) {
    int64_t id = cids[c];
    if (id < 0 || id >= nv) return 1;
    fixed[id] = 1;
    P[id] = V3(cpos[c * 3], cpos[c * 3 + 1], cpos[c * 3 + 2]);
  }

  std::vector<M3> R(nv);

  auto solve_global = [&](std::vector<V3> &rhs) {
    // CG on the free vertices for L x = rhs (component-wise, 3 systems
    // solved simultaneously on V3)
    auto applyL = [&](const std::vector<V3> &x, std::vector<V3> &y) {
      for (long long i = 0; i < nv; i++) {
        if (fixed[i]) { y[i] = V3(); continue; }
        double wsum = 0;
        for (auto &pr : nbr[i]) wsum += pr.second;
        V3 s = x[i] * wsum;
        for (auto &pr : nbr[i])
          if (!fixed[pr.first]) s = s - x[pr.first] * pr.second;
        y[i] = s;
      }
    };
    std::vector<V3> x(nv), r(nv), p(nv), Ap(nv);
    for (long long i = 0; i < nv; i++) x[i] = fixed[i] ? V3() : P[i];
    applyL(x, Ap);
    double rr = 0;
    for (long long i = 0; i < nv; i++) {
      if (fixed[i]) continue;
      r[i] = rhs[i] - Ap[i];
      p[i] = r[i];
      rr += r[i].dot(r[i]);
    }
    for (int it = 0; it < 200 && rr > 1e-16; it++) {
      applyL(p, Ap);
      double pAp = 0;
      for (long long i = 0; i < nv; i++)
        if (!fixed[i]) pAp += p[i].dot(Ap[i]);
      if (pAp <= 0) break;
      double alpha = rr / pAp;
      double rr_new = 0;
      for (long long i = 0; i < nv; i++) {
        if (fixed[i]) continue;
        x[i] = x[i] + p[i] * alpha;
        r[i] = r[i] - Ap[i] * alpha;
        rr_new += r[i].dot(r[i]);
      }
      double beta = rr_new / rr;
      rr = rr_new;
      for (long long i = 0; i < nv; i++)
        if (!fixed[i]) p[i] = r[i] + p[i] * beta;
    }
    for (long long i = 0; i < nv; i++)
      if (!fixed[i]) P[i] = x[i];
  };

  for (int iter = 0; iter < max_iter; iter++) {
    // local: fit rotations
    for (long long i = 0; i < nv; i++) {
      M3 S;
      for (auto &pr : nbr[i]) {
        V3 e = V[pr.first] - V[i];
        V3 ep = P[pr.first] - P[i];
        for (int a = 0; a < 3; a++)
          for (int b = 0; b < 3; b++)
            S.m[a][b] += pr.second * ep[a] * e[b];
      }
      R[i] = fit_rotation(S.transposed());
      R[i] = R[i].transposed();  // map source edge e -> target ep
    }
    // global: rhs_i = sum_j w_ij/2 (R_i + R_j)(v_i - v_j) (+ fixed terms)
    std::vector<V3> rhs(nv);
    for (long long i = 0; i < nv; i++) {
      if (fixed[i]) continue;
      V3 acc;
      for (auto &pr : nbr[i]) {
        int64_t j = pr.first;
        V3 e = V[i] - V[j];
        M3 Rsum;
        for (int a = 0; a < 3; a++)
          for (int b = 0; b < 3; b++)
            Rsum.m[a][b] = 0.5 * (R[i].m[a][b] + R[j].m[a][b]);
        acc = acc + Rsum.apply(e) * pr.second;
        if (fixed[j]) acc = acc + P[j] * pr.second;
      }
      rhs[i] = acc;
    }
    solve_global(rhs);
  }

  for (long long i = 0; i < nv; i++) {
    out_verts[i * 3] = P[i].x;
    out_verts[i * 3 + 1] = P[i].y;
    out_verts[i * 3 + 2] = P[i].z;
  }
  return 0;
}

}  // extern "C"
