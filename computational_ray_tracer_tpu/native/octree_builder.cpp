// Native octree builder for the spectral path tracer.
//
// Host-side, one-shot scene setup (SURVEY §7 design stance #2): the
// *capability* of Octtree_Model::CreateOcttree/AddTriangle/Split
// (/root/reference RayTracer/Octtree_Model.h:33-358 — leaf capacity split,
// padded children, abort-split-when-no-separation, Möller triangle-box SAT
// gating) re-expressed as a top-down builder that emits the flat node/leaf
// tensors consumed by the JAX traversal kernels.
//
// Semantics intentionally mirror ops/octree.py::build_octree bit-for-bit
// (same LIFO worklist order, same child enumeration, same float64 math) so
// the Python test suite can assert native == numpy tree equality.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libcrt_native.so octree_builder.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

struct Vec3 {
    double x, y, z;
    Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
    double operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

inline Vec3 cross(const Vec3& a, const Vec3& b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
inline double dot(const Vec3& a, const Vec3& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}

// One cross-axis SAT test; mirrors ops/octree.py::_tri_box_overlap axis_test.
inline bool axis_test(double a, double b, double fa, double fb,
                      const Vec3& va, const Vec3& vb, int i, int j,
                      const double* half) {
    double p0 = a * va[i] - b * va[j];
    double p1 = a * vb[i] - b * vb[j];
    double pmin = std::min(p0, p1), pmax = std::max(p0, p1);
    double rad = fa * half[i] + fb * half[j];
    return pmin <= rad && pmax >= -rad;
}

// Möller triangle-box overlap (ThirdParty/AABB_triangle_Moller.h capability),
// with the exact test set/signs of the Python builder.
bool tri_box_overlap(const double* center, const double* half,
                     Vec3 v0, Vec3 v1, Vec3 v2) {
    Vec3 c{center[0], center[1], center[2]};
    v0 = v0 - c; v1 = v1 - c; v2 = v2 - c;
    Vec3 e0 = v1 - v0, e1 = v2 - v1, e2 = v0 - v2;

    const Vec3* edges[3] = {&e0, &e1, &e2};
    const Vec3* pa[3] = {&v0, &v0, &v0};
    const Vec3* pb[3] = {&v2, &v2, &v1};
    for (int k = 0; k < 3; ++k) {
        const Vec3& e = *edges[k];
        double fex = std::fabs(e.x), fey = std::fabs(e.y), fez = std::fabs(e.z);
        if (!axis_test(e.z, e.y, fez, fey, *pa[k], *pb[k], 1, 2, half)) return false;
        if (!axis_test(-e.z, -e.x, fez, fex, *pa[k], *pb[k], 0, 2, half)) return false;
        if (!axis_test(e.y, e.x, fey, fex, *pa[k], *pb[k], 0, 1, half)) return false;
    }

    for (int i = 0; i < 3; ++i) {
        double lo = std::min({v0[i], v1[i], v2[i]});
        double hi = std::max({v0[i], v1[i], v2[i]});
        if (lo > half[i] || hi < -half[i]) return false;
    }

    Vec3 n = cross(e0, e1);
    double d = -dot(n, v0);
    double r = std::fabs(n.x) * half[0] + std::fabs(n.y) * half[1]
             + std::fabs(n.z) * half[2];
    return std::fabs(d) <= r;
}

struct WorkItem {
    int32_t node;
    std::vector<int32_t> tris;
    int32_t depth;
};

}  // namespace

extern "C" {

// Output tree; all buffers malloc'd here, freed with crt_free_octree.
struct CrtOctree {
    int64_t n_nodes;
    int64_t n_leaves;
    int64_t leaf_cap;        // max triangles in any leaf (padded width)
    float* node_lo;          // (n_nodes, 3)
    float* node_hi;          // (n_nodes, 3)
    int32_t* node_child0;    // (n_nodes,)  -1 for leaf
    int32_t* node_leaf_id;   // (n_nodes,)  -1 for interior
    int32_t* leaf_tris;      // (n_leaves, leaf_cap), -1 padded
    int32_t* leaf_counts;    // (n_leaves,)
};

int crt_build_octree(const float* positions, int64_t n_verts,
                     const int32_t* indices, int64_t n_tris,
                     int32_t capacity, int32_t max_depth, double padding,
                     CrtOctree* out) {
    if (n_verts <= 0 || n_tris <= 0) return -1;

    std::vector<Vec3> tv0(n_tris), tv1(n_tris), tv2(n_tris);
    // Per-triangle AABBs for the cheap candidate pre-filter below.
    std::vector<double> tlo(n_tris * 3), thi(n_tris * 3);
    double root_lo[3] = {1e300, 1e300, 1e300};
    double root_hi[3] = {-1e300, -1e300, -1e300};
    for (int64_t v = 0; v < n_verts; ++v) {
        for (int i = 0; i < 3; ++i) {
            double p = positions[v * 3 + i];
            root_lo[i] = std::min(root_lo[i], p);
            root_hi[i] = std::max(root_hi[i], p);
        }
    }
    for (int i = 0; i < 3; ++i) { root_lo[i] -= 1e-4; root_hi[i] += 1e-4; }
    for (int64_t t = 0; t < n_tris; ++t) {
        const float* a = positions + (int64_t)indices[t * 3 + 0] * 3;
        const float* b = positions + (int64_t)indices[t * 3 + 1] * 3;
        const float* c = positions + (int64_t)indices[t * 3 + 2] * 3;
        tv0[t] = {a[0], a[1], a[2]};
        tv1[t] = {b[0], b[1], b[2]};
        tv2[t] = {c[0], c[1], c[2]};
        for (int i = 0; i < 3; ++i) {
            tlo[t * 3 + i] = std::min({tv0[t][i], tv1[t][i], tv2[t][i]});
            thi[t * 3 + i] = std::max({tv0[t][i], tv1[t][i], tv2[t][i]});
        }
    }

    std::vector<double> nlo, nhi;        // (M, 3)
    std::vector<int32_t> child0, leaf_id;
    std::vector<std::vector<int32_t>> leaves;

    auto add_node = [&](const double lo[3], const double hi[3]) -> int32_t {
        nlo.insert(nlo.end(), lo, lo + 3);
        nhi.insert(nhi.end(), hi, hi + 3);
        child0.push_back(-1);
        leaf_id.push_back(-1);
        return (int32_t)child0.size() - 1;
    };

    int32_t root = add_node(root_lo, root_hi);
    std::vector<WorkItem> work;
    {
        WorkItem w;
        w.node = root;
        w.depth = 0;
        w.tris.resize(n_tris);
        for (int64_t t = 0; t < n_tris; ++t) w.tris[t] = (int32_t)t;
        work.push_back(std::move(w));
    }

    while (!work.empty()) {
        WorkItem item = std::move(work.back());
        work.pop_back();
        int32_t nid = item.node;
        const double* lo = &nlo[(size_t)nid * 3];
        const double* hi = &nhi[(size_t)nid * 3];

        if ((int64_t)item.tris.size() <= capacity || item.depth >= max_depth) {
            leaf_id[nid] = (int32_t)leaves.size();
            leaves.push_back(std::move(item.tris));
            continue;
        }

        double mid[3] = {(lo[0] + hi[0]) / 2.0, (lo[1] + hi[1]) / 2.0,
                         (lo[2] + hi[2]) / 2.0};
        // Padding is a FRACTION of the child box extent (per axis, per
        // level) — an absolute pad is either negligible at the root or
        // larger than the boxes themselves at depth 10+, where it made
        // every fine-region triangle a member of all neighboring leaves
        // (870k-tri mixed-scale mesh: 16+ average leaf memberships).
        double pad[3] = {padding * (hi[0] - lo[0]) * 0.5,
                         padding * (hi[1] - lo[1]) * 0.5,
                         padding * (hi[2] - lo[2]) * 0.5};
        std::vector<int32_t> child_sets[8];
        double child_lo[8][3], child_hi[8][3];
        double centers[8][3], halves[8][3];
        int ci = 0;
        for (int ix = 0; ix < 2; ++ix)
        for (int iy = 0; iy < 2; ++iy)
        for (int iz = 0; iz < 2; ++iz, ++ci) {
            double clo[3] = {ix == 0 ? lo[0] : mid[0],
                             iy == 0 ? lo[1] : mid[1],
                             iz == 0 ? lo[2] : mid[2]};
            double chi[3] = {ix == 0 ? mid[0] : hi[0],
                             iy == 0 ? mid[1] : hi[1],
                             iz == 0 ? mid[2] : hi[2]};
            for (int i = 0; i < 3; ++i) { clo[i] -= pad[i]; chi[i] += pad[i]; }
            for (int i = 0; i < 3; ++i) {
                centers[ci][i] = (clo[i] + chi[i]) / 2.0;
                halves[ci][i] = (chi[i] - clo[i]) / 2.0;
            }
            std::memcpy(child_lo[ci], clo, sizeof clo);
            std::memcpy(child_hi[ci], chi, sizeof chi);
            child_sets[ci].reserve(item.tris.size() / 6);
        }

        // One pass over the triangles: a per-axis padded half-slab overlap
        // of the triangle's AABB picks candidate children (12 compares),
        // and the full Möller SAT runs only on candidates. AABB overlap is
        // a NECESSARY condition for SAT overlap (the SAT includes the same
        // three box-axis interval tests), so this prunes without changing
        // any membership — the tree stays bit-identical to the NumPy
        // oracle builder, just ~10x cheaper on real meshes.
        for (int32_t t : item.tris) {
            bool ov[3][2];
            for (int i = 0; i < 3; ++i) {
                double a = tlo[(size_t)t * 3 + i], b = thi[(size_t)t * 3 + i];
                ov[i][0] = (a <= mid[i] + pad[i]) && (b >= lo[i] - pad[i]);
                ov[i][1] = (a <= hi[i] + pad[i]) && (b >= mid[i] - pad[i]);
            }
            for (int ix = 0; ix < 2; ++ix) {
                if (!ov[0][ix]) continue;
                for (int iy = 0; iy < 2; ++iy) {
                    if (!ov[1][iy]) continue;
                    for (int iz = 0; iz < 2; ++iz) {
                        if (!ov[2][iz]) continue;
                        int c = ix * 4 + iy * 2 + iz;
                        if (tri_box_overlap(centers[c], halves[c],
                                            tv0[t], tv1[t], tv2[t]))
                            child_sets[c].push_back(t);
                    }
                }
            }
        }
        size_t max_child = 0;
        for (int c = 0; c < 8; ++c)
            max_child = std::max(max_child, child_sets[c].size());

        // Abort-split rule (Octtree_Model.h:331-340): no separation achieved.
        if (max_child >= item.tris.size()) {
            leaf_id[nid] = (int32_t)leaves.size();
            leaves.push_back(std::move(item.tris));
            continue;
        }

        int32_t base = (int32_t)child0.size();
        child0[nid] = base;
        for (int c = 0; c < 8; ++c) {
            int32_t cid = add_node(child_lo[c], child_hi[c]);
            WorkItem w;
            w.node = cid;
            w.depth = item.depth + 1;
            w.tris = std::move(child_sets[c]);
            work.push_back(std::move(w));
        }
    }

    int64_t M = (int64_t)child0.size();
    int64_t L = (int64_t)leaves.size();
    int64_t cap = 1;
    for (auto& t : leaves) cap = std::max(cap, (int64_t)t.size());

    out->n_nodes = M;
    out->n_leaves = L;
    out->leaf_cap = cap;
    out->node_lo = (float*)std::malloc(sizeof(float) * M * 3);
    out->node_hi = (float*)std::malloc(sizeof(float) * M * 3);
    out->node_child0 = (int32_t*)std::malloc(sizeof(int32_t) * M);
    out->node_leaf_id = (int32_t*)std::malloc(sizeof(int32_t) * M);
    out->leaf_tris = (int32_t*)std::malloc(sizeof(int32_t) * L * cap);
    out->leaf_counts = (int32_t*)std::malloc(sizeof(int32_t) * L);
    if (!out->node_lo || !out->node_hi || !out->node_child0 ||
        !out->node_leaf_id || !out->leaf_tris || !out->leaf_counts)
        return -2;

    for (int64_t i = 0; i < M * 3; ++i) {
        out->node_lo[i] = (float)nlo[i];
        out->node_hi[i] = (float)nhi[i];
    }
    std::memcpy(out->node_child0, child0.data(), sizeof(int32_t) * M);
    std::memcpy(out->node_leaf_id, leaf_id.data(), sizeof(int32_t) * M);
    std::fill(out->leaf_tris, out->leaf_tris + L * cap, -1);
    for (int64_t l = 0; l < L; ++l) {
        out->leaf_counts[l] = (int32_t)leaves[l].size();
        std::memcpy(out->leaf_tris + l * cap, leaves[l].data(),
                    sizeof(int32_t) * leaves[l].size());
    }
    return 0;
}

void crt_free_octree(CrtOctree* t) {
    std::free(t->node_lo); std::free(t->node_hi);
    std::free(t->node_child0); std::free(t->node_leaf_id);
    std::free(t->leaf_tris); std::free(t->leaf_counts);
    std::memset(t, 0, sizeof *t);
}

}  // extern "C"
