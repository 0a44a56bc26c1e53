// The port's own copy of rgk_tpu/native/bvh_builder.cpp, kept equal to it.
// Native binned-SAH BVH builder with skip-link flattening.
//
// The C++ runtime piece of the scene pipeline: for multi-million-
// triangle scenes the Python/numpy builder (rgk_tpu_torch/scene/bvh.py,
// same algorithm, the test oracle) dominates scene commit time; this
// library builds the identical flat layout ~20x faster.  Exposed via
// a plain C ABI and loaded with ctypes (rgk_tpu_torch/native/bvh_native.py).
//
// Layout produced (see scene/bvh.py docstring):
//   nodes in DFS pre-order, left child == parent+1;
//   meta = (first, count, skip); leaves carry count > 0 and an offset
//   into the primitive order permutation; skip links make device
//   traversal stackless.
//
// Build: c++ -O3 -march=native -shared -fPIC bvh_builder.cpp -o libbvh.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kBins = 16;

struct Aabb {
    float mn[3] = {std::numeric_limits<float>::infinity(),
                   std::numeric_limits<float>::infinity(),
                   std::numeric_limits<float>::infinity()};
    float mx[3] = {-std::numeric_limits<float>::infinity(),
                   -std::numeric_limits<float>::infinity(),
                   -std::numeric_limits<float>::infinity()};

    void grow(const float* lo, const float* hi) {
        for (int k = 0; k < 3; ++k) {
            mn[k] = std::min(mn[k], lo[k]);
            mx[k] = std::max(mx[k], hi[k]);
        }
    }
    void grow(const Aabb& o) { grow(o.mn, o.mx); }
    float area() const {
        float d0 = std::max(0.f, mx[0] - mn[0]);
        float d1 = std::max(0.f, mx[1] - mn[1]);
        float d2 = std::max(0.f, mx[2] - mn[2]);
        return d0 * d1 + d1 * d2 + d2 * d0;
    }
};

struct Builder {
    const float* centroids;
    const float* prim_min;
    const float* prim_max;
    int leaf_size;
    std::vector<int64_t> order;

    std::vector<float> node_min, node_max;
    std::vector<int64_t> first, count, right;

    int64_t emit(const Aabb& bb, int64_t f, int64_t c) {
        int64_t row = (int64_t)count.size();
        node_min.insert(node_min.end(), bb.mn, bb.mn + 3);
        node_max.insert(node_max.end(), bb.mx, bb.mx + 3);
        first.push_back(f);
        count.push_back(c);
        right.push_back(-1);
        return row;
    }

    // Recursive build in DFS pre-order (left child emitted first).
    int64_t build(int64_t start, int64_t end) {
        Aabb bb;
        for (int64_t i = start; i < end; ++i) {
            const int64_t p = order[i];
            bb.grow(prim_min + 3 * p, prim_max + 3 * p);
        }
        const int64_t n = end - start;
        if (n <= leaf_size) {
            return emit(bb, start, n);
        }

        // Centroid bounds.
        Aabb cb;
        for (int64_t i = start; i < end; ++i) {
            const float* c = centroids + 3 * order[i];
            cb.grow(c, c);
        }

        float best_cost = std::numeric_limits<float>::infinity();
        int best_axis = -1, best_bin = -1;
        float best_lo = 0.f, best_inv = 0.f;

        for (int axis = 0; axis < 3; ++axis) {
            const float lo = cb.mn[axis], hi = cb.mx[axis];
            if (hi - lo <= 1e-12f) continue;
            const float inv = kBins / (hi - lo);

            Aabb bins[kBins];
            int64_t counts[kBins] = {0};
            for (int64_t i = start; i < end; ++i) {
                const int64_t p = order[i];
                int b = (int)((centroids[3 * p + axis] - lo) * inv);
                b = std::min(b, kBins - 1);
                bins[b].grow(prim_min + 3 * p, prim_max + 3 * p);
                counts[b]++;
            }
            // Left-to-right and right-to-left sweeps.
            float larea[kBins], rarea[kBins];
            int64_t lcount[kBins], rcount[kBins];
            Aabb acc;
            int64_t csum = 0;
            for (int b = 0; b < kBins; ++b) {
                acc.grow(bins[b]);
                csum += counts[b];
                larea[b] = acc.area();
                lcount[b] = csum;
            }
            acc = Aabb();
            csum = 0;
            for (int b = kBins - 1; b >= 0; --b) {
                acc.grow(bins[b]);
                csum += counts[b];
                rarea[b] = acc.area();
                rcount[b] = csum;
            }
            for (int b = 0; b < kBins - 1; ++b) {
                if (lcount[b] == 0 || rcount[b + 1] == 0) continue;
                const float cost =
                    larea[b] * lcount[b] + rarea[b + 1] * rcount[b + 1];
                if (cost < best_cost) {
                    best_cost = cost;
                    best_axis = axis;
                    best_bin = b;
                    best_lo = lo;
                    best_inv = inv;
                }
            }
        }

        int64_t mid;
        if (best_axis < 0) {
            mid = start + n / 2;  // degenerate: median split
        } else {
            auto pred = [&](int64_t p) {
                int b = (int)((centroids[3 * p + best_axis] - best_lo)
                              * best_inv);
                return std::min(b, kBins - 1) <= best_bin;
            };
            int64_t* base = order.data();
            int64_t* m = std::partition(base + start, base + end, pred);
            mid = m - base;
            if (mid == start || mid == end) mid = start + n / 2;
        }

        const int64_t row = emit(bb, -1, 0);
        const int64_t left = build(start, mid);
        (void)left;  // left == row + 1 by construction
        right[row] = build(mid, end);
        first[row] = row + 1;
        return row;
    }
};

}  // namespace

extern "C" {

// Returns the number of nodes written.  Output arrays must be sized
// for the worst case: 2*n_prims - 1 nodes (n_prims >= 1).
int64_t rgk_build_bvh(
    const float* centroids,  // [n,3]
    const float* prim_min,   // [n,3]
    const float* prim_max,   // [n,3]
    int64_t n_prims,
    int64_t leaf_size,
    float* out_node_min,     // [max_nodes,3]
    float* out_node_max,     // [max_nodes,3]
    int64_t* out_first,      // [max_nodes]
    int64_t* out_count,      // [max_nodes]
    int64_t* out_skip,       // [max_nodes]
    int64_t* out_order) {    // [n]
    if (n_prims <= 0) return 0;

    Builder b;
    b.centroids = centroids;
    b.prim_min = prim_min;
    b.prim_max = prim_max;
    b.leaf_size = (int)leaf_size;
    b.order.resize(n_prims);
    for (int64_t i = 0; i < n_prims; ++i) b.order[i] = i;

    const size_t reserve = (size_t)(2 * n_prims);
    b.node_min.reserve(3 * reserve);
    b.node_max.reserve(3 * reserve);
    b.first.reserve(reserve);
    b.count.reserve(reserve);
    b.right.reserve(reserve);

    b.build(0, n_prims);
    const int64_t n_nodes = (int64_t)b.count.size();

    // Skip links: iterative DFS mirroring the Python builder.
    std::vector<int64_t> skip(n_nodes, n_nodes);
    std::vector<std::pair<int64_t, int64_t>> stack;
    stack.push_back({0, n_nodes});
    while (!stack.empty()) {
        auto [row, s] = stack.back();
        stack.pop_back();
        skip[row] = s;
        if (b.count[row] == 0) {
            const int64_t left = b.first[row], rc = b.right[row];
            stack.push_back({left, rc});
            stack.push_back({rc, s});
        }
    }

    std::memcpy(out_node_min, b.node_min.data(),
                sizeof(float) * 3 * n_nodes);
    std::memcpy(out_node_max, b.node_max.data(),
                sizeof(float) * 3 * n_nodes);
    std::memcpy(out_first, b.first.data(), sizeof(int64_t) * n_nodes);
    std::memcpy(out_count, b.count.data(), sizeof(int64_t) * n_nodes);
    std::memcpy(out_skip, skip.data(), sizeof(int64_t) * n_nodes);
    std::memcpy(out_order, b.order.data(), sizeof(int64_t) * n_prims);
    return n_nodes;
}

}  // extern "C"
