// Binned-SAH BVH builder for the host, built with g++ and called through a
// plain C interface (ctypes) by luisarender_tpu_torch/accel/native.py.
//
// The code below is luisarender_tpu/accel/cpp/bvh_builder.cpp line for line
// (only this note differs). The scene compiler orders its triangles by this
// tree and builds the cluster kernel's tables from it, so the port's tables
// equal the reference's only while both builders are the same code built
// with the same flags (g++ -O3 -march=native -shared -fPIC) on one machine.
//
// Binned SAH (Wald 2007, 16 bins on the widest centroid axis, median split
// when degenerate); the flattened output is per-node AABBs in preorder, DFS
// skip links, leaf first/count, and the sorted primitive order.

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
    Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
    Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
    void grow(const AABB &b) {
        lo = vmin(lo, b.lo);
        hi = vmax(hi, b.hi);
    }
    void grow(const Vec3 &p) {
        lo = vmin(lo, p);
        hi = vmax(hi, p);
    }
    float area() const {
        if (hi.x < lo.x) return 0.0f;
        float dx = hi.x - lo.x, dy = hi.y - lo.y, dz = hi.z - lo.z;
        return 2.0f * (dx * dy + dy * dz + dz * dx);
    }
    Vec3 centroid() const {
        return {0.5f * (lo.x + hi.x), 0.5f * (lo.y + hi.y), 0.5f * (lo.z + hi.z)};
    }
};

struct BuildNode {
    AABB bounds;
    int32_t left = -1;   // child index; -1 for leaf
    int32_t right = -1;
    int32_t first = -1;  // leaf: first prim in order[]
    int32_t count = 0;   // leaf: prim count
};

constexpr int kNumBins = 16;

struct Builder {
    const float *verts;    // (V, 3)
    const int32_t *tris;   // (T, 3)
    int32_t leaf_size;
    std::vector<AABB> prim_bounds;
    std::vector<Vec3> prim_centroids;
    std::vector<int32_t> order;
    std::vector<BuildNode> nodes;

    int32_t build(int32_t lo, int32_t hi) {
        BuildNode node;
        AABB cb;  // centroid bounds
        for (int32_t i = lo; i < hi; ++i) {
            node.bounds.grow(prim_bounds[order[i]]);
            cb.grow(prim_centroids[order[i]]);
        }
        int32_t count = hi - lo;
        if (count <= leaf_size) {
            node.first = lo;
            node.count = count;
            nodes.push_back(node);
            return int32_t(nodes.size()) - 1;
        }
        // pick the widest centroid axis
        float ex = cb.hi.x - cb.lo.x, ey = cb.hi.y - cb.lo.y, ez = cb.hi.z - cb.lo.z;
        int axis = (ex > ey && ex > ez) ? 0 : (ey > ez ? 1 : 2);
        float cmin = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
        float cext = axis == 0 ? ex : (axis == 1 ? ey : ez);
        int32_t mid;
        if (cext < 1e-12f) {
            mid = lo + count / 2;  // degenerate: median split
        } else {
            // binned SAH
            AABB bin_bounds[kNumBins];
            int32_t bin_count[kNumBins] = {0};
            const float scale = kNumBins / cext;
            auto bin_of = [&](int32_t prim) {
                const Vec3 &c = prim_centroids[prim];
                float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
                int b = int((v - cmin) * scale);
                return std::min(std::max(b, 0), kNumBins - 1);
            };
            for (int32_t i = lo; i < hi; ++i) {
                int b = bin_of(order[i]);
                bin_bounds[b].grow(prim_bounds[order[i]]);
                bin_count[b]++;
            }
            // sweep for best split
            AABB right_acc[kNumBins];
            AABB acc;
            for (int b = kNumBins - 1; b > 0; --b) {
                acc.grow(bin_bounds[b]);
                right_acc[b] = acc;
            }
            float best_cost = FLT_MAX;
            int best_split = -1;
            AABB left_acc;
            int32_t left_n = 0;
            for (int b = 0; b < kNumBins - 1; ++b) {
                left_acc.grow(bin_bounds[b]);
                left_n += bin_count[b];
                int32_t right_n = count - left_n;
                if (left_n == 0 || right_n == 0) continue;
                float cost = left_acc.area() * left_n + right_acc[b + 1].area() * right_n;
                if (cost < best_cost) {
                    best_cost = cost;
                    best_split = b;
                }
            }
            if (best_split < 0) {
                mid = lo + count / 2;
            } else {
                auto it = std::partition(
                    order.begin() + lo, order.begin() + hi,
                    [&](int32_t p) { return bin_of(p) <= best_split; });
                mid = int32_t(it - order.begin());
                if (mid == lo || mid == hi) mid = lo + count / 2;
            }
        }
        int32_t self = int32_t(nodes.size());
        nodes.push_back(node);
        int32_t l = build(lo, mid);
        int32_t r = build(mid, hi);
        nodes[self].left = l;
        nodes[self].right = r;
        return self;
    }
};

}  // namespace

extern "C" {

// Returns the number of nodes written (<= 2 * ceil(T / leaf) capacity the
// caller must provide), or -1 on error.
//
// Outputs (caller-allocated):
//   out_aabb_min/max: (max_nodes, 3) float32
//   out_skip:         (max_nodes,)   int32   DFS skip links (-1 = done)
//   out_first:        (max_nodes,)   int32   leaf first prim (-1 = interior)
//   out_count:        (max_nodes,)   int32   leaf prim count (0 = interior)
//   out_order:        (T,)           int32   primitive order
int32_t lr_build_bvh(
    const float *verts, int64_t n_verts,
    const int32_t *tris, int64_t n_tris,
    int32_t leaf_size,
    float *out_aabb_min, float *out_aabb_max,
    int32_t *out_skip, int32_t *out_first, int32_t *out_count,
    int32_t *out_order, int64_t max_nodes) {
    if (n_tris <= 0 || leaf_size <= 0) return -1;
    Builder b;
    b.verts = verts;
    b.tris = tris;
    b.leaf_size = leaf_size;
    b.prim_bounds.resize(n_tris);
    b.prim_centroids.resize(n_tris);
    b.order.resize(n_tris);
    for (int64_t i = 0; i < n_tris; ++i) {
        AABB box;
        for (int k = 0; k < 3; ++k) {
            const float *v = verts + int64_t(tris[i * 3 + k]) * 3;
            box.grow(Vec3{v[0], v[1], v[2]});
        }
        b.prim_bounds[i] = box;
        b.prim_centroids[i] = box.centroid();
        b.order[i] = int32_t(i);
    }
    b.nodes.reserve(size_t(2 * (n_tris / leaf_size + 1)));
    b.build(0, int32_t(n_tris));
    int64_t n = int64_t(b.nodes.size());
    if (n > max_nodes) return -1;

    // DFS skip links: node i+1 is its first child (preorder); skip = next
    // sibling of the nearest ancestor. Compute with an explicit stack.
    std::vector<int32_t> skip(n, -1);
    {
        std::vector<std::pair<int32_t, int32_t>> stack;  // (node, skip)
        stack.push_back({0, -1});
        while (!stack.empty()) {
            auto [ni, sk] = stack.back();
            stack.pop_back();
            skip[ni] = sk;
            const BuildNode &nd = b.nodes[ni];
            if (nd.left >= 0) {
                stack.push_back({nd.right, sk});
                stack.push_back({nd.left, nd.right});
            }
        }
    }
    for (int64_t i = 0; i < n; ++i) {
        const BuildNode &nd = b.nodes[i];
        out_aabb_min[i * 3 + 0] = nd.bounds.lo.x;
        out_aabb_min[i * 3 + 1] = nd.bounds.lo.y;
        out_aabb_min[i * 3 + 2] = nd.bounds.lo.z;
        out_aabb_max[i * 3 + 0] = nd.bounds.hi.x;
        out_aabb_max[i * 3 + 1] = nd.bounds.hi.y;
        out_aabb_max[i * 3 + 2] = nd.bounds.hi.z;
        out_skip[i] = skip[i];
        out_first[i] = nd.left >= 0 ? -1 : nd.first;
        out_count[i] = nd.left >= 0 ? 0 : nd.count;
    }
    std::memcpy(out_order, b.order.data(), size_t(n_tris) * sizeof(int32_t));
    return int32_t(n);
}

}  // extern "C"
