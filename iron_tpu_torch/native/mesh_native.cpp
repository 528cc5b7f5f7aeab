// Native mesh runtime for iron_tpu: iso-surface extraction (marching
// tetrahedra) and point<->mesh distance queries (BVH), exposed via a C ABI
// for ctypes.
//
// Replaces the reference's external native deps: PyMCubes / skimage
// marching cubes (models/renderer.py:34-42, models/export_mesh.py) and
// igl::point_mesh_squared_distance (evaluation/eval_mesh.py:6-26), neither
// of which is available in this image.
//
// Marching tetrahedra: each grid cell is split into 6 tetrahedra; each tet
// with a sign change contributes 1-2 triangles with vertices interpolated
// on its edges.  Vertices are deduplicated via an edge-keyed hash map so
// the mesh is watertight across cells.
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -fopenmp

#include <cstdint>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>
#include <algorithm>

namespace {

struct V3 { float x, y, z; };

// 6-tetrahedra decomposition of the unit cube (indices into cube corners).
// Corner numbering: bit0 -> +x, bit1 -> +y, bit2 -> +z.
static const int TETS[6][4] = {
    {0, 5, 1, 3}, {0, 5, 3, 7}, {0, 5, 7, 4},
    {0, 7, 3, 2}, {0, 7, 2, 6}, {0, 7, 6, 4},
};

static const int CORNER_OFF[8][3] = {
    {0,0,0},{1,0,0},{0,1,0},{1,1,0},{0,0,1},{1,0,1},{0,1,1},{1,1,1}};

struct MeshBuf {
    std::vector<float> verts;
    std::vector<int32_t> tris;
    std::unordered_map<uint64_t, int32_t> edge_to_vert;
};

// global corner id for (i,j,k) in an (nx,ny,nz) grid
static inline uint64_t corner_id(int64_t i, int64_t j, int64_t k, int64_t ny, int64_t nz) {
    return (uint64_t)((i * ny + j) * nz + k);
}

static int32_t edge_vertex(MeshBuf& m, uint64_t a, uint64_t b,
                           const V3& pa, const V3& pb, float va, float vb,
                           float iso) {
    if (a > b) { return edge_vertex(m, b, a, pb, pa, vb, va, iso); }
    uint64_t key = a * 0x9E3779B97F4A7C15ULL ^ b;  // cheap pair key
    // NOTE: use exact pair key to avoid collisions: pack assuming < 2^32 ids
    key = (a << 32) | (b & 0xFFFFFFFFULL);
    auto it = m.edge_to_vert.find(key);
    if (it != m.edge_to_vert.end()) return it->second;
    float t = (iso - va) / (vb - va + 1e-30f);
    t = std::min(1.0f, std::max(0.0f, t));
    V3 p{pa.x + t * (pb.x - pa.x), pa.y + t * (pb.y - pa.y), pa.z + t * (pb.z - pa.z)};
    int32_t idx = (int32_t)(m.verts.size() / 3);
    m.verts.push_back(p.x); m.verts.push_back(p.y); m.verts.push_back(p.z);
    m.edge_to_vert.emplace(key, idx);
    return idx;
}

}  // namespace

extern "C" {

// field: nx*ny*nz float32 array (C order); origin/spacing define coords.
// Returns number of triangles; fills out_verts/out_tris via callback-free
// two-phase protocol: call once with out_* null to get counts, then again.
// Simpler: allocate internally and expose getters.
static MeshBuf* g_mesh = nullptr;

int64_t mc_extract(const float* field, int64_t nx, int64_t ny, int64_t nz,
                   const float* origin, const float* spacing, float iso) {
    delete g_mesh;
    g_mesh = new MeshBuf();
    MeshBuf& m = *g_mesh;
    m.verts.reserve(1 << 16);
    m.tris.reserve(1 << 16);

    auto val = [&](int64_t i, int64_t j, int64_t k) {
        return field[(i * ny + j) * nz + k];
    };
    auto pos = [&](int64_t i, int64_t j, int64_t k) {
        return V3{origin[0] + (float)i * spacing[0],
                  origin[1] + (float)j * spacing[1],
                  origin[2] + (float)k * spacing[2]};
    };

    for (int64_t i = 0; i + 1 < nx; ++i)
    for (int64_t j = 0; j + 1 < ny; ++j)
    for (int64_t k = 0; k + 1 < nz; ++k) {
        float cv[8]; V3 cp[8]; uint64_t cid[8];
        bool all_pos = true, all_neg = true;
        for (int c = 0; c < 8; ++c) {
            int64_t ci = i + CORNER_OFF[c][0];
            int64_t cj = j + CORNER_OFF[c][1];
            int64_t ck = k + CORNER_OFF[c][2];
            cv[c] = val(ci, cj, ck);
            cp[c] = pos(ci, cj, ck);
            cid[c] = corner_id(ci, cj, ck, ny, nz);
            if (cv[c] < iso) all_pos = false; else all_neg = false;
        }
        if (all_pos || all_neg) continue;

        for (int t = 0; t < 6; ++t) {
            const int* T = TETS[t];
            int inside = 0, in_idx[4], out_idx[4], ni = 0, no = 0;
            for (int c = 0; c < 4; ++c) {
                if (cv[T[c]] < iso) { in_idx[ni++] = T[c]; inside++; }
                else out_idx[no++] = T[c];
            }
            if (inside == 0 || inside == 4) continue;

            auto ev = [&](int a, int b) {
                return edge_vertex(m, cid[a], cid[b], cp[a], cp[b], cv[a], cv[b], iso);
            };

            if (inside == 1) {
                int a = in_idx[0];
                int32_t v0 = ev(a, out_idx[0]);
                int32_t v1 = ev(a, out_idx[1]);
                int32_t v2 = ev(a, out_idx[2]);
                m.tris.push_back(v0); m.tris.push_back(v1); m.tris.push_back(v2);
            } else if (inside == 3) {
                int a = out_idx[0];
                int32_t v0 = ev(a, in_idx[0]);
                int32_t v1 = ev(a, in_idx[1]);
                int32_t v2 = ev(a, in_idx[2]);
                m.tris.push_back(v0); m.tris.push_back(v2); m.tris.push_back(v1);
            } else {  // 2-2: quad -> two triangles
                int a0 = in_idx[0], a1 = in_idx[1];
                int b0 = out_idx[0], b1 = out_idx[1];
                int32_t v00 = ev(a0, b0);
                int32_t v01 = ev(a0, b1);
                int32_t v10 = ev(a1, b0);
                int32_t v11 = ev(a1, b1);
                m.tris.push_back(v00); m.tris.push_back(v10); m.tris.push_back(v11);
                m.tris.push_back(v00); m.tris.push_back(v11); m.tris.push_back(v01);
            }
        }
    }
    return (int64_t)(m.tris.size() / 3);
}

int64_t mc_num_verts() { return g_mesh ? (int64_t)(g_mesh->verts.size() / 3) : 0; }
int64_t mc_num_tris() { return g_mesh ? (int64_t)(g_mesh->tris.size() / 3) : 0; }
void mc_get_verts(float* out) {
    if (g_mesh) std::memcpy(out, g_mesh->verts.data(), g_mesh->verts.size() * sizeof(float));
}
void mc_get_tris(int32_t* out) {
    if (g_mesh) std::memcpy(out, g_mesh->tris.data(), g_mesh->tris.size() * sizeof(int32_t));
}
void mc_free() { delete g_mesh; g_mesh = nullptr; }

// ---------------- point -> mesh squared distance (BVH) ----------------

struct BVHNode { float bmin[3], bmax[3]; int32_t left, right, start, count; };

struct BVH {
    std::vector<BVHNode> nodes;
    std::vector<int32_t> tri_order;
    const float* verts;
    const int32_t* tris;
};

static float tri_point_sqdist(const float* p, const float* a, const float* b, const float* c) {
    // Ericson, Real-Time Collision Detection: closest point on triangle.
    float ab[3] = {b[0]-a[0], b[1]-a[1], b[2]-a[2]};
    float ac[3] = {c[0]-a[0], c[1]-a[1], c[2]-a[2]};
    float ap[3] = {p[0]-a[0], p[1]-a[1], p[2]-a[2]};
    auto dot = [](const float* u, const float* v) { return u[0]*v[0]+u[1]*v[1]+u[2]*v[2]; };
    float d1 = dot(ab, ap), d2 = dot(ac, ap);
    auto sq = [&](float x, float y, float z) { return x*x + y*y + z*z; };
    if (d1 <= 0 && d2 <= 0) return sq(ap[0], ap[1], ap[2]);
    float bp[3] = {p[0]-b[0], p[1]-b[1], p[2]-b[2]};
    float d3 = dot(ab, bp), d4 = dot(ac, bp);
    if (d3 >= 0 && d4 <= d3) return sq(bp[0], bp[1], bp[2]);
    float vc = d1*d4 - d3*d2;
    if (vc <= 0 && d1 >= 0 && d3 <= 0) {
        float v = d1 / (d1 - d3);
        return sq(ap[0]-v*ab[0], ap[1]-v*ab[1], ap[2]-v*ab[2]);
    }
    float cp[3] = {p[0]-c[0], p[1]-c[1], p[2]-c[2]};
    float d5 = dot(ab, cp), d6 = dot(ac, cp);
    if (d6 >= 0 && d5 <= d6) return sq(cp[0], cp[1], cp[2]);
    float vb = d5*d2 - d1*d6;
    if (vb <= 0 && d2 >= 0 && d6 <= 0) {
        float w = d2 / (d2 - d6);
        return sq(ap[0]-w*ac[0], ap[1]-w*ac[1], ap[2]-w*ac[2]);
    }
    float va = d3*d6 - d5*d4;
    if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
        float w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
        float bc[3] = {c[0]-b[0], c[1]-b[1], c[2]-b[2]};
        return sq(bp[0]-w*bc[0], bp[1]-w*bc[1], bp[2]-w*bc[2]);
    }
    float denom = 1.0f / (va + vb + vc);
    float v = vb * denom, w = vc * denom;
    float q[3] = {a[0]+ab[0]*v+ac[0]*w, a[1]+ab[1]*v+ac[1]*w, a[2]+ab[2]*v+ac[2]*w};
    return sq(p[0]-q[0], p[1]-q[1], p[2]-q[2]);
}

static BVH* g_bvh = nullptr;

static int32_t bvh_build(BVH& bvh, int32_t start, int32_t count,
                         std::vector<float>& centroids) {
    BVHNode node;
    node.bmin[0] = node.bmin[1] = node.bmin[2] = 1e30f;
    node.bmax[0] = node.bmax[1] = node.bmax[2] = -1e30f;
    for (int32_t i = start; i < start + count; ++i) {
        int32_t t = bvh.tri_order[i];
        for (int c = 0; c < 3; ++c) {
            const float* v = bvh.verts + 3 * bvh.tris[3 * t + c];
            for (int d = 0; d < 3; ++d) {
                node.bmin[d] = std::min(node.bmin[d], v[d]);
                node.bmax[d] = std::max(node.bmax[d], v[d]);
            }
        }
    }
    int32_t idx = (int32_t)bvh.nodes.size();
    bvh.nodes.push_back(node);
    if (count <= 4) {
        bvh.nodes[idx].left = -1; bvh.nodes[idx].right = -1;
        bvh.nodes[idx].start = start; bvh.nodes[idx].count = count;
        return idx;
    }
    int axis = 0;
    float ext[3] = {node.bmax[0]-node.bmin[0], node.bmax[1]-node.bmin[1], node.bmax[2]-node.bmin[2]};
    if (ext[1] > ext[0]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    int32_t mid = start + count / 2;
    std::nth_element(bvh.tri_order.begin() + start,
                     bvh.tri_order.begin() + mid,
                     bvh.tri_order.begin() + start + count,
                     [&](int32_t a, int32_t b) {
                         return centroids[3*a+axis] < centroids[3*b+axis];
                     });
    int32_t l = bvh_build(bvh, start, mid - start, centroids);
    int32_t r = bvh_build(bvh, mid, start + count - mid, centroids);
    bvh.nodes[idx].left = l; bvh.nodes[idx].right = r;
    bvh.nodes[idx].start = -1; bvh.nodes[idx].count = 0;
    return idx;
}

void bvh_create(const float* verts, int64_t n_verts,
                const int32_t* tris, int64_t n_tris) {
    delete g_bvh;
    g_bvh = new BVH();
    g_bvh->verts = verts;
    g_bvh->tris = tris;
    g_bvh->tri_order.resize(n_tris);
    std::vector<float> centroids(3 * n_tris);
    for (int64_t t = 0; t < n_tris; ++t) {
        g_bvh->tri_order[t] = (int32_t)t;
        for (int d = 0; d < 3; ++d)
            centroids[3*t+d] = (verts[3*tris[3*t]+d] + verts[3*tris[3*t+1]+d]
                                + verts[3*tris[3*t+2]+d]) / 3.0f;
    }
    g_bvh->nodes.reserve(2 * n_tris);
    bvh_build(*g_bvh, 0, (int32_t)n_tris, centroids);
}

static float box_sqdist(const float* p, const float* bmin, const float* bmax) {
    float d = 0;
    for (int i = 0; i < 3; ++i) {
        float v = p[i];
        if (v < bmin[i]) d += (bmin[i]-v)*(bmin[i]-v);
        else if (v > bmax[i]) d += (v-bmax[i])*(v-bmax[i]);
    }
    return d;
}

void bvh_sq_distances(const float* points, int64_t n_points, float* out) {
    if (!g_bvh) return;
    const BVH& bvh = *g_bvh;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
    for (int64_t p = 0; p < n_points; ++p) {
        const float* pt = points + 3 * p;
        float best = 1e30f;
        int32_t stack[128]; int sp = 0;
        stack[sp++] = 0;
        while (sp > 0) {
            int32_t ni = stack[--sp];
            const BVHNode& n = bvh.nodes[ni];
            if (box_sqdist(pt, n.bmin, n.bmax) >= best) continue;
            if (n.left < 0) {
                for (int32_t i = n.start; i < n.start + n.count; ++i) {
                    int32_t t = bvh.tri_order[i];
                    float d = tri_point_sqdist(pt,
                        bvh.verts + 3*bvh.tris[3*t],
                        bvh.verts + 3*bvh.tris[3*t+1],
                        bvh.verts + 3*bvh.tris[3*t+2]);
                    best = std::min(best, d);
                }
            } else {
                float dl = box_sqdist(pt, bvh.nodes[n.left].bmin, bvh.nodes[n.left].bmax);
                float dr = box_sqdist(pt, bvh.nodes[n.right].bmin, bvh.nodes[n.right].bmax);
                if (dl < dr) { stack[sp++] = n.right; stack[sp++] = n.left; }
                else { stack[sp++] = n.left; stack[sp++] = n.right; }
            }
        }
        out[p] = best;
    }
}

void bvh_free() { delete g_bvh; g_bvh = nullptr; }

// ---------------- ray -> mesh closest-hit (Moller-Trumbore) ----------------

static bool ray_tri(const float* o, const float* d,
                    const float* a, const float* b, const float* c,
                    float& t, float& u, float& v) {
    float e1[3] = {b[0]-a[0], b[1]-a[1], b[2]-a[2]};
    float e2[3] = {c[0]-a[0], c[1]-a[1], c[2]-a[2]};
    float p[3] = {d[1]*e2[2]-d[2]*e2[1], d[2]*e2[0]-d[0]*e2[2], d[0]*e2[1]-d[1]*e2[0]};
    float det = e1[0]*p[0] + e1[1]*p[1] + e1[2]*p[2];
    if (std::fabs(det) < 1e-12f) return false;
    float inv = 1.0f / det;
    float s[3] = {o[0]-a[0], o[1]-a[1], o[2]-a[2]};
    u = (s[0]*p[0] + s[1]*p[1] + s[2]*p[2]) * inv;
    if (u < 0.0f || u > 1.0f) return false;
    float q[3] = {s[1]*e1[2]-s[2]*e1[1], s[2]*e1[0]-s[0]*e1[2], s[0]*e1[1]-s[1]*e1[0]};
    v = (d[0]*q[0] + d[1]*q[1] + d[2]*q[2]) * inv;
    if (v < 0.0f || u + v > 1.0f) return false;
    t = (e2[0]*q[0] + e2[1]*q[1] + e2[2]*q[2]) * inv;
    return t > 1e-6f;
}

static float box_ray_tmin(const float* o, const float* inv_d,
                          const float* bmin, const float* bmax, float tmax) {
    float t0 = 0.0f, t1 = tmax;
    for (int i = 0; i < 3; ++i) {
        float ta = (bmin[i] - o[i]) * inv_d[i];
        float tb = (bmax[i] - o[i]) * inv_d[i];
        if (ta > tb) std::swap(ta, tb);
        t0 = std::max(t0, ta);
        t1 = std::min(t1, tb);
        if (t0 > t1) return -1.0f;
    }
    return t0;
}

// For each ray: out_t[i] = hit distance (or -1), out_tri[i] = triangle id,
// out_uv[2i..] = barycentric (u, v).
void bvh_ray_intersect(const float* ray_o, const float* ray_d, int64_t n_rays,
                       float* out_t, int32_t* out_tri, float* out_uv) {
    if (!g_bvh) return;
    const BVH& bvh = *g_bvh;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
    for (int64_t r = 0; r < n_rays; ++r) {
        const float* o = ray_o + 3 * r;
        const float* d = ray_d + 3 * r;
        float inv_d[3];
        for (int i = 0; i < 3; ++i)
            inv_d[i] = 1.0f / (std::fabs(d[i]) > 1e-12f ? d[i]
                               : (d[i] >= 0 ? 1e-12f : -1e-12f));
        float best_t = 1e30f;
        int32_t best_tri = -1;
        float best_u = 0, best_v = 0;
        int32_t stack[128]; int sp = 0;
        stack[sp++] = 0;
        while (sp > 0) {
            int32_t ni = stack[--sp];
            const BVHNode& n = bvh.nodes[ni];
            float tmin = box_ray_tmin(o, inv_d, n.bmin, n.bmax, best_t);
            if (tmin < 0.0f || tmin >= best_t) continue;
            if (n.left < 0) {
                for (int32_t i = n.start; i < n.start + n.count; ++i) {
                    int32_t tr = bvh.tri_order[i];
                    float t, u, v;
                    if (ray_tri(o, d,
                                bvh.verts + 3*bvh.tris[3*tr],
                                bvh.verts + 3*bvh.tris[3*tr+1],
                                bvh.verts + 3*bvh.tris[3*tr+2], t, u, v)
                        && t < best_t) {
                        best_t = t; best_tri = tr; best_u = u; best_v = v;
                    }
                }
            } else {
                stack[sp++] = n.left;
                stack[sp++] = n.right;
            }
        }
        out_t[r] = best_tri >= 0 ? best_t : -1.0f;
        out_tri[r] = best_tri;
        out_uv[2*r] = best_u;
        out_uv[2*r+1] = best_v;
    }
}

}  // extern "C"
