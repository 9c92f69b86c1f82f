// Barnes-Hut sp-tree repulsion for t-SNE (host-side, O(N log N)).
//
// Parity target: the reference's
// deeplearning4j-nearestneighbors-parent/nearestneighbor-core/src/main/
// java/org/deeplearning4j/clustering/sptree/SpTree.java (generic-dim
// space-partitioning tree with center-of-mass subdivision) and
// deeplearning4j-manifold/deeplearning4j-tsne/.../BarnesHutTsne.java
// (computeNonEdgeForces with the theta criterion). Re-implemented from
// the algorithm, not the code: flat arena allocation instead of node
// objects, iterative traversal with an explicit stack, OpenMP over
// points.
//
// Supports dim in {2, 3} (t-SNE embedding dims); 2^dim children.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Arena {
    // Node i: center[dim], half-width hw (uniform cube), center of mass
    // com[dim], cumulative count, child index base (-1 = leaf), point
    // index (-1 = empty/internal).
    std::vector<float> center, com;
    std::vector<float> hw;
    std::vector<int64_t> count, child_base, point;
    int dim;
    int fanout;

    explicit Arena(int d) : dim(d), fanout(1 << d) {}

    int64_t alloc(const float* c, float h) {
        int64_t id = (int64_t)hw.size();
        for (int k = 0; k < dim; ++k) center.push_back(c[k]);
        for (int k = 0; k < dim; ++k) com.push_back(0.0f);
        hw.push_back(h);
        count.push_back(0);
        child_base.push_back(-1);
        point.push_back(-1);
        return id;
    }

    int child_slot(int64_t node, const float* y) const {
        int slot = 0;
        for (int k = 0; k < dim; ++k)
            if (y[k] > center[node * dim + k]) slot |= (1 << k);
        return slot;
    }

    void subdivide(int64_t node) {
        float h = hw[node] * 0.5f;
        int64_t base = (int64_t)hw.size();
        for (int s = 0; s < fanout; ++s) {
            float c[3];
            for (int k = 0; k < dim; ++k)
                c[k] = center[node * dim + k] + ((s >> k) & 1 ? h : -h);
            alloc(c, h);
        }
        child_base[node] = base;
    }

    void insert(int64_t node, const float* y, int64_t pidx) {
        for (;;) {
            // update cumulative center of mass on the way down
            double cnt = (double)count[node];
            for (int k = 0; k < dim; ++k)
                com[node * dim + k] = (float)(
                    (com[node * dim + k] * cnt + y[k]) / (cnt + 1.0));
            count[node] += 1;
            if (child_base[node] < 0 && point[node] < 0) {   // empty leaf
                point[node] = pidx;
                return;
            }
            if (hw[node] < 1e-9f)   // depth cap: merge into count/com
                return;
            if (child_base[node] < 0) {         // occupied leaf: split
                int64_t old = point[node];
                const float* oy = y_all + old * dim;
                // duplicate-point guard: nudge into count only
                bool same = true;
                for (int k = 0; k < dim; ++k)
                    if (oy[k] != y[k]) { same = false; break; }
                if (same) return;   // keep as multiplicity in count/com
                subdivide(node);
                int64_t tgt = child_base[node] + child_slot(node, oy);
                // push the old occupant one level down, PRESERVING its
                // merged-duplicate multiplicity: count[node] was already
                // incremented for the incoming point, so the occupant
                // (plus any exact duplicates merged into this leaf)
                // accounts for count[node] - 1; its com is exactly oy
                // since merged points are bitwise-equal
                for (int k = 0; k < dim; ++k)
                    com[tgt * dim + k] = oy[k];
                count[tgt] = count[node] - 1;
                point[tgt] = old;
                point[node] = -1;
            }
            node = child_base[node] + child_slot(node, y);
        }
    }

    const float* y_all = nullptr;
};

}   // namespace

extern "C" {

// Build the tree over Y (n x dim), then for every point i accumulate the
// Barnes-Hut-approximated repulsive numerator
//     neg_f[i] += q^2 * (y_i - com_cell) * count_cell
// and the partition function Z = sum q * count (q = 1/(1+d^2)), visiting
// a cell as a summary when hw_cell / dist < theta (SpTree.java theta
// condition). Returns Z; stats[0] receives total cells visited (the
// O(N log N) diagnostic).
double bh_repulsion_f32(const float* Y, int64_t n, int32_t dim,
                        float theta, float* neg_f, int64_t* stats) {
    if (n == 0 || dim < 1 || dim > 3) return 0.0;
    // bounding cube
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t i = 0; i < n; ++i)
        for (int k = 0; k < dim; ++k) {
            lo[k] = std::min(lo[k], Y[i * dim + k]);
            hi[k] = std::max(hi[k], Y[i * dim + k]);
        }
    float c[3] = {0, 0, 0}, h = 0.0f;
    for (int k = 0; k < dim; ++k) {
        c[k] = 0.5f * (lo[k] + hi[k]);
        h = std::max(h, 0.5f * (hi[k] - lo[k]));
    }
    h = std::max(h, 1e-5f) * 1.0001f;   // keep formula in sync: PySpTree

    Arena tree(dim);
    tree.y_all = Y;
    tree.center.reserve((size_t)n * 2 * dim);
    tree.alloc(c, h);
    for (int64_t i = 0; i < n; ++i) tree.insert(0, Y + i * dim, i);

    const float theta2 = theta * theta;
    double z_total = 0.0;
    int64_t visits_total = 0;

#ifdef _OPENMP
#pragma omp parallel for reduction(+ : z_total, visits_total) \
    schedule(static) if (n > 256)
#endif
    for (int64_t i = 0; i < n; ++i) {
        const float* yi = Y + i * dim;
        float acc[3] = {0, 0, 0};
        double zi = 0.0;
        int64_t visits = 0;
        std::vector<int64_t> stack;
        stack.reserve(256);
        stack.push_back(0);
        while (!stack.empty()) {
            int64_t node = stack.back();
            stack.pop_back();
            ++visits;
            int64_t cnt = tree.count[node];
            if (cnt == 0) continue;
            float d2 = 0.0f, diff[3];
            const float* com = tree.com.data() + node * dim;
            for (int k = 0; k < dim; ++k) {
                diff[k] = yi[k] - com[k];
                d2 += diff[k] * diff[k];
            }
            bool is_self_leaf =
                tree.child_base[node] < 0 && tree.point[node] == i;
            float w = 2.0f * tree.hw[node];   // cell width
            if (tree.child_base[node] < 0 || w * w < theta2 * d2) {
                // leaf or far-enough cell: use the summary
                if (is_self_leaf && cnt == 1) continue;
                double mult = (double)cnt - (is_self_leaf ? 1.0 : 0.0);
                float q = 1.0f / (1.0f + d2);
                zi += mult * q;
                float q2 = q * q;
                for (int k = 0; k < dim; ++k)
                    acc[k] += (float)mult * q2 * diff[k];
            } else {
                for (int s = 0; s < tree.fanout; ++s) {
                    int64_t ch = tree.child_base[node] + s;
                    if (tree.count[ch] > 0) stack.push_back(ch);
                }
            }
        }
        for (int k = 0; k < dim; ++k) neg_f[i * dim + k] = acc[k];
        z_total += zi;
        visits_total += visits;
    }
    if (stats) stats[0] = visits_total;
    return z_total;
}

}   // extern "C"
