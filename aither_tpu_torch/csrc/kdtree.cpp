// Median-split k-d tree for nearest-neighbor searches on TPU-host
// preprocessing: viscous wall distances and point-cloud initial
// conditions.  Same structure as the reference's tree (reference:
// include/kdtree.hpp:30-80, src/kdtree.cpp: median split with leaf bin
// 32, nodes reordered so the left branch is the next index and the right
// branch index is stored per node), exposed through a C ABI for ctypes.
//
// Build:  g++ -O3 -march=native -shared -fPIC -o libaither_native.so
//             kdtree.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

constexpr int kBinSize = 32;

struct KdTree {
  std::vector<double> pts;   // (n, 3) in tree order
  std::vector<int64_t> idx;  // original index per tree slot
  std::vector<int64_t> right;

  double *P(int64_t i) { return &pts[3 * i]; }
  const double *P(int64_t i) const { return &pts[3 * i]; }
};

double Dist2(const double *a, const double *b) {
  const double dx = a[0] - b[0];
  const double dy = a[1] - b[1];
  const double dz = a[2] - b[2];
  return dx * dx + dy * dy + dz * dz;
}

void Swap(KdTree &t, int64_t a, int64_t b) {
  for (int d = 0; d < 3; ++d) std::swap(t.pts[3 * a + d], t.pts[3 * b + d]);
  std::swap(t.idx[a], t.idx[b]);
}

// median via nth_element on [start, end), returns median position
int64_t FindMedian(KdTree &t, int64_t start, int64_t end, int dim) {
  const int64_t med = start + (end - start - 1) / 2;
  // index-based nth_element over the interleaved storage
  std::vector<int64_t> order(end - start);
  for (int64_t i = 0; i < end - start; ++i) order[i] = start + i;
  std::nth_element(order.begin(), order.begin() + (med - start), order.end(),
                   [&](int64_t a, int64_t b) {
                     return t.pts[3 * a + dim] < t.pts[3 * b + dim];
                   });
  // apply the permutation by copying
  std::vector<double> tmp_p(3 * (end - start));
  std::vector<int64_t> tmp_i(end - start);
  for (int64_t i = 0; i < end - start; ++i) {
    for (int d = 0; d < 3; ++d) tmp_p[3 * i + d] = t.pts[3 * order[i] + d];
    tmp_i[i] = t.idx[order[i]];
  }
  std::copy(tmp_p.begin(), tmp_p.end(), t.pts.begin() + 3 * start);
  std::copy(tmp_i.begin(), tmp_i.end(), t.idx.begin() + start);
  return med;
}

void Build(KdTree &t, int64_t start, int64_t end, int dim) {
  const int64_t n = end - start;
  if (n <= kBinSize) return;  // leaf
  const int64_t med = FindMedian(t, start, end, dim);
  Swap(t, start, med);
  // partition the remainder around the median value
  const double pivot = t.pts[3 * start + dim];
  int64_t lo = start + 1, hi = end - 1;
  while (lo <= hi) {
    if (t.pts[3 * lo + dim] <= pivot) {
      ++lo;
    } else {
      Swap(t, lo, hi);
      --hi;
    }
  }
  const int64_t rightStart = lo;
  t.right[start] = rightStart < end ? rightStart : -1;
  const int nextDim = (dim + 1) % 3;
  Build(t, start + 1, rightStart, nextDim);
  if (rightStart < end) Build(t, rightStart, end, nextDim);
}

void Nearest(const KdTree &t, int64_t start, int64_t end, int dim,
             const double *q, int64_t &bestIdx, double &bestD2) {
  const int64_t n = end - start;
  if (n <= kBinSize) {  // leaf: linear scan
    for (int64_t i = start; i < end; ++i) {
      const double d2 = Dist2(t.P(i), q);
      if (d2 < bestD2) {
        bestD2 = d2;
        bestIdx = i;
      }
    }
    return;
  }
  // root of this subtree
  const double d2 = Dist2(t.P(start), q);
  if (d2 < bestD2) {
    bestD2 = d2;
    bestIdx = start;
  }
  const int64_t rightStart = t.right[start] < 0 ? end : t.right[start];
  const double split = t.pts[3 * start + dim];
  const int nextDim = (dim + 1) % 3;
  const bool goLeft = q[dim] <= split;
  // search the near side first, then the far side if the best sphere
  // crosses the splitting plane
  if (goLeft) {
    Nearest(t, start + 1, rightStart, nextDim, q, bestIdx, bestD2);
    if (rightStart < end && (split - q[dim]) * (split - q[dim]) < bestD2) {
      Nearest(t, rightStart, end, nextDim, q, bestIdx, bestD2);
    }
  } else {
    if (rightStart < end) {
      Nearest(t, rightStart, end, nextDim, q, bestIdx, bestD2);
    }
    if ((split - q[dim]) * (split - q[dim]) < bestD2) {
      Nearest(t, start + 1, rightStart, nextDim, q, bestIdx, bestD2);
    }
  }
}

}  // namespace

extern "C" {

void *kdtree_build(const double *points, int64_t n) {
  auto *t = new KdTree;
  t->pts.assign(points, points + 3 * n);
  t->idx.resize(n);
  for (int64_t i = 0; i < n; ++i) t->idx[i] = i;
  t->right.assign(n, -1);
  Build(*t, 0, n, 0);
  return t;
}

void kdtree_free(void *tree) { delete static_cast<KdTree *>(tree); }

// nearest original-index + distance for m query points
void kdtree_nearest(const void *tree, const double *queries, int64_t m,
                    int64_t *out_idx, double *out_dist) {
  const auto *t = static_cast<const KdTree *>(tree);
  const int64_t n = static_cast<int64_t>(t->idx.size());
#pragma omp parallel for schedule(static)
  for (int64_t j = 0; j < m; ++j) {
    int64_t best = 0;
    double bestD2 = std::numeric_limits<double>::max();
    Nearest(*t, 0, n, 0, &queries[3 * j], best, bestD2);
    out_idx[j] = t->idx[best];
    out_dist[j] = std::sqrt(bestD2);
  }
}

}  // extern "C"
