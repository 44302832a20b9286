// Native BVH builder: binned-SAH, emitting the same flat preorder skip-link
// arrays as gi_raytracer_tpu_torch/scene/bvh.py (node_min/max, skip, first,
// count, prim order).  The port's own copy of gi_raytracer_tpu/native/
// bvh_builder.cpp, kept identical so both packages build the same tree.
// Replaces the reference's recursive pointer octree (reference
// include/octree.cpp:316-384) with a cache-friendly array build; SAH
// binning gives tighter trees than the midpoint octree for the same query
// contract.
//
// C API (ctypes): all outputs preallocated by the caller with capacity
// 2*n_prims nodes.
#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Box {
  float lo[3], hi[3];
  void reset() {
    for (int a = 0; a < 3; ++a) { lo[a] = FLT_MAX; hi[a] = -FLT_MAX; }
  }
  void grow(const float* plo, const float* phi) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], plo[a]);
      hi[a] = std::max(hi[a], phi[a]);
    }
  }
  float area() const {
    float dx = std::max(hi[0] - lo[0], 0.f);
    float dy = std::max(hi[1] - lo[1], 0.f);
    float dz = std::max(hi[2] - lo[2], 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Builder {
  const float* pmin;  // (n,3)
  const float* pmax;
  std::vector<float> cx, cy, cz;  // centroids
  int leaf_size;

  std::vector<float> node_min, node_max;
  std::vector<int32_t> first, count;
  std::vector<int32_t> children_l, children_r;  // -1 for leaves
  std::vector<int32_t> order;

  const float* C(int axis) const {
    return axis == 0 ? cx.data() : (axis == 1 ? cy.data() : cz.data());
  }

  int emit(int32_t* idx, int n) {
    int nid = (int)count.size();
    Box b; b.reset();
    for (int i = 0; i < n; ++i) b.grow(&pmin[3 * idx[i]], &pmax[3 * idx[i]]);
    for (int a = 0; a < 3; ++a) {
      node_min.push_back(b.lo[a]);
    }
    for (int a = 0; a < 3; ++a) node_max.push_back(b.hi[a]);
    first.push_back(0); count.push_back(0);
    children_l.push_back(-1); children_r.push_back(-1);

    if (n <= leaf_size) {
      first[nid] = (int32_t)order.size();
      count[nid] = n;
      order.insert(order.end(), idx, idx + n);
      return nid;
    }

    // centroid bounds
    Box cb; cb.reset();
    for (int i = 0; i < n; ++i) {
      float c[3] = {cx[idx[i]], cy[idx[i]], cz[idx[i]]};
      cb.grow(c, c);
    }
    int axis = 0;
    float ext = -1.f;
    for (int a = 0; a < 3; ++a) {
      float e = cb.hi[a] - cb.lo[a];
      if (e > ext) { ext = e; axis = a; }
    }

    int mid = n / 2;
    if (ext > 1e-12f) {
      // binned SAH over the longest centroid axis
      constexpr int NB = 16;
      Box bins[NB];
      int cnt[NB] = {0};
      for (auto& bb : bins) bb.reset();
      const float* cc = C(axis);
      float scale = NB / ext;
      auto bin_of = [&](int32_t p) {
        int bi = (int)((cc[p] - cb.lo[axis]) * scale);
        return std::min(std::max(bi, 0), NB - 1);
      };
      for (int i = 0; i < n; ++i) {
        int bi = bin_of(idx[i]);
        bins[bi].grow(&pmin[3 * idx[i]], &pmax[3 * idx[i]]);
        cnt[bi]++;
      }
      float rarea[NB];
      Box acc; acc.reset();
      int racc = 0;
      float best = FLT_MAX;
      int best_split = -1;
      for (int i = NB - 1; i > 0; --i) {
        acc.grow(bins[i].lo, bins[i].hi);
        racc += cnt[i];
        rarea[i] = (racc > 0) ? acc.area() * racc : 0.f;
      }
      acc.reset();
      int lacc = 0;
      for (int i = 0; i < NB - 1; ++i) {
        acc.grow(bins[i].lo, bins[i].hi);
        lacc += cnt[i];
        if (lacc == 0 || lacc == n) continue;
        float cost = acc.area() * lacc + rarea[i + 1];
        if (cost < best) { best = cost; best_split = i; }
      }
      if (best_split >= 0) {
        int32_t* pm = std::partition(
            idx, idx + n, [&](int32_t p) { return bin_of(p) <= best_split; });
        mid = (int)(pm - idx);
        if (mid == 0 || mid == n) mid = n / 2;
      }
    }
    if (mid == 0 || mid == n) mid = n / 2;
    if (ext <= 1e-12f || mid == 0 || mid == n) {
      // degenerate: split by median of centroid order
      const float* cc = C(axis);
      std::nth_element(idx, idx + n / 2, idx + n,
                       [&](int32_t a2, int32_t b2) { return cc[a2] < cc[b2]; });
      mid = n / 2;
    }

    int l = emit(idx, mid);
    int r = emit(idx + mid, n - mid);
    children_l[nid] = l;
    children_r[nid] = r;
    return nid;
  }
};

}  // namespace

extern "C" {

// Returns number of nodes, or -1 on error.  Output capacity: 2*n nodes.
int32_t gi_build_bvh(const float* pmin, const float* pmax, int32_t n,
                     int32_t leaf_size, float* node_min, float* node_max,
                     int32_t* skip, int32_t* first, int32_t* count,
                     int32_t* prim_idx) {
  if (n <= 0) return -1;
  Builder b;
  b.pmin = pmin;
  b.pmax = pmax;
  b.leaf_size = std::max(leaf_size, 1);
  b.cx.resize(n); b.cy.resize(n); b.cz.resize(n);
  for (int i = 0; i < n; ++i) {
    b.cx[i] = 0.5f * (pmin[3 * i + 0] + pmax[3 * i + 0]);
    b.cy[i] = 0.5f * (pmin[3 * i + 1] + pmax[3 * i + 1]);
    b.cz[i] = 0.5f * (pmin[3 * i + 2] + pmax[3 * i + 2]);
  }
  std::vector<int32_t> idx(n);
  for (int i = 0; i < n; ++i) idx[i] = i;
  b.node_min.reserve(6 * n);
  b.order.reserve(n);
  b.emit(idx.data(), n);

  int nn = (int)b.count.size();
  // preorder skip links, iterative
  std::vector<int32_t> sk(nn, nn);
  std::vector<std::pair<int32_t, int32_t>> stack;
  stack.push_back({0, nn});
  while (!stack.empty()) {
    auto [nid, esc] = stack.back();
    stack.pop_back();
    sk[nid] = esc;
    if (b.children_l[nid] >= 0) {
      stack.push_back({b.children_l[nid], b.children_r[nid]});
      stack.push_back({b.children_r[nid], esc});
    }
  }
  std::memcpy(node_min, b.node_min.data(), sizeof(float) * 3 * nn);
  std::memcpy(node_max, b.node_max.data(), sizeof(float) * 3 * nn);
  std::memcpy(skip, sk.data(), sizeof(int32_t) * nn);
  std::memcpy(first, b.first.data(), sizeof(int32_t) * nn);
  std::memcpy(count, b.count.data(), sizeof(int32_t) * nn);
  std::memcpy(prim_idx, b.order.data(), sizeof(int32_t) * n);
  return nn;
}
}
