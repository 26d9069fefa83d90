// Frozen copy of glia_tpu_torch/native/src/glia_forest.cc at commit 95324b0,
// the port's CART trainer: the benchmark grows its forests with it, so a
// later change to the program's trainer does not move the cell's forests.
//
// CART forest training for glia_tpu_torch (no sklearn on the card's host).
//
// Grows the trees of a random forest the way scikit-learn's
// RandomForestClassifier grows them with the defaults glia_tpu uses
// (criterion "gini", splitter "best", min_samples_split 2, min_samples_leaf
// 1, no min_weight_fraction_leaf, no min_impurity_decrease, no pruning):
//
//   - each tree is fit on integer sample weights, the bootstrap counts the
//     caller drew (rows with count 0 are not in the tree);
//   - features are float32; a split position p of a node's rows sorted by a
//     feature is skipped while x[p] <= x[p-1] + 1e-7 (float32 arithmetic), a
//     feature whose values span <= 1e-7 in a node is constant there and for
//     every node below it;
//   - features are drawn by a Fisher-Yates walk over the feature list until
//     mtry features that are not constant have been evaluated (constant
//     ones found on the way do not count), from a 32-bit xorshift stream
//     seeded per tree;
//   - the best split maximises -w_R * gini_R - w_L * gini_L; the first one
//     found wins a tie; its threshold is x[p-1] / 2 + x[p] / 2 in float64,
//     or x[p-1] where that equals x[p] or is infinite;
//   - a node is a leaf at max_depth, with fewer than 2 rows, or when its
//     Gini impurity is <= float64 epsilon;
//   - nodes are numbered in preorder, left child first.
//
// The arithmetic of the impurities follows scikit-learn's expression by
// expression; the file is compiled with -ffp-contract=off so that no
// multiply-add is fused and ties between splits break the same way.
// Trees are independent: n_threads only spreads them over threads.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <limits>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr float kFeatureThreshold = 1e-7f;
constexpr uint32_t kRandMax = 0x7FFFFFFFu;
const double kEpsilon = std::numeric_limits<double>::epsilon();
const double kInf = std::numeric_limits<double>::infinity();

// leaf markers of scikit-learn's tree arrays, which ForestModel.from_sklearn
// copies: feature and threshold -2 at a leaf, children 0
constexpr int32_t kLeafFeature = -2;
constexpr float kLeafThreshold = -2.0f;

uint32_t xorshift(uint32_t* s) {
  if (*s == 0) *s = 1;
  *s ^= *s << 13;
  *s ^= *s >> 17;
  *s ^= *s << 5;
  return *s % (kRandMax + 1u);
}

int64_t rand_int(int64_t lo, int64_t hi, uint32_t* s) {
  return lo + static_cast<int64_t>(xorshift(s)) % (hi - lo);
}

struct Data {
  const float* X;       // [n, D] row-major
  const int32_t* y;     // [n] class index in [0, C)
  int64_t n, D;
  int C;
  int64_t mtry, max_depth;
};

struct Split {
  int64_t feature = 0, pos = 0;
  double threshold = 0.0, impurity_left = 0.0, impurity_right = 0.0,
         improvement = 0.0;
};

struct Record {
  int64_t start, end, depth, parent;
  bool is_left;
  double impurity;
  int64_t n_constant;
};

// a row's value of the feature being searched, and the row
struct Value {
  float v;
  int32_t row;
};

struct Tree {
  std::vector<int32_t> feature, left, right, leaf_class;
  std::vector<float> threshold;
  int64_t depth = 0;
};

double gini(const double* sums, int C, double w) {
  double sq = 0.0;
  for (int c = 0; c < C; ++c) sq += sums[c] * sums[c];
  return 1.0 - sq / (w * w);
}

class TreeGrower {
 public:
  TreeGrower(const Data& d, const int32_t* counts, uint32_t seed)
      : d_(d), w_(counts), rng_(seed), features_(d.D), constant_(d.D),
        sum_total_(d.C), sum_left_(d.C), sum_right_(d.C) {
    for (int64_t i = 0; i < d.n; ++i) {
      if (counts[i] != 0) samples_.push_back(i);
      weighted_n_samples_ += static_cast<double>(counts[i]);
    }
    for (int64_t f = 0; f < d.D; ++f) features_[f] = f;
    values_.resize(samples_.size());
  }

  Tree build() {
    Tree tree;
    std::vector<Record> stack;
    stack.push_back({0, static_cast<int64_t>(samples_.size()), 0, -1, false,
                     kInf, 0});
    bool first = true;
    while (!stack.empty()) {
      Record r = stack.back();
      stack.pop_back();
      const int64_t n_node = r.end - r.start;
      const double wn = node_sums(r.start, r.end);
      bool is_leaf = r.depth >= d_.max_depth || n_node < 2;
      double impurity = r.impurity;
      if (first) {
        impurity = gini(sum_total_.data(), d_.C, wn);
        first = false;
      }
      is_leaf = is_leaf || impurity <= kEpsilon;
      Split split;
      int64_t n_constant = r.n_constant;
      if (!is_leaf) {
        split = node_split(r.start, r.end, impurity, wn, &n_constant);
        is_leaf = split.pos >= r.end || split.improvement + kEpsilon < 0.0;
      }
      // node_split leaves the node's class sums as they were
      const int32_t id = static_cast<int32_t>(tree.feature.size());
      if (r.parent >= 0)
        (r.is_left ? tree.left : tree.right)[r.parent] = id;
      tree.feature.push_back(is_leaf ? kLeafFeature
                                     : static_cast<int32_t>(split.feature));
      tree.threshold.push_back(is_leaf ? kLeafThreshold
                                       : static_cast<float>(split.threshold));
      tree.left.push_back(0);
      tree.right.push_back(0);
      int best = 0;
      for (int c = 1; c < d_.C; ++c)
        if (sum_total_[c] > sum_total_[best]) best = c;
      tree.leaf_class.push_back(best);
      if (!is_leaf) {
        stack.push_back({split.pos, r.end, r.depth + 1, id, false,
                         split.impurity_right, n_constant});
        stack.push_back({r.start, split.pos, r.depth + 1, id, true,
                         split.impurity_left, n_constant});
      }
      tree.depth = std::max(tree.depth, r.depth);
    }
    return tree;
  }

 private:
  // class sums of samples_[start, end) into sum_total_; returns their weight
  double node_sums(int64_t start, int64_t end) {
    std::fill(sum_total_.begin(), sum_total_.end(), 0.0);
    double wn = 0.0;
    for (int64_t p = start; p < end; ++p) {
      const int64_t i = samples_[p];
      const double w = static_cast<double>(w_[i]);
      sum_total_[d_.y[i]] += w;
      wn += w;
    }
    return wn;
  }

  float x(int64_t i, int64_t f) const { return d_.X[i * d_.D + f]; }

  // the rows of samples_[start, end) and their values of feature f, sorted
  // by value, into values_[0, end - start)
  void sort_by(int64_t start, int64_t end, int64_t f) {
    const int64_t m = end - start;
    for (int64_t k = 0; k < m; ++k) {
      const int64_t i = samples_[start + k];
      values_[k] = {x(i, f), static_cast<int32_t>(i)};
    }
    std::sort(values_.begin(), values_.begin() + m,
              [](const Value& a, const Value& b) { return a.v < b.v; });
  }

  // children's Gini impurities with sum_left_ / wl on the left
  void children(double wn, double wl, double* il, double* ir) {
    for (int c = 0; c < d_.C; ++c)
      sum_right_[c] = sum_total_[c] - sum_left_[c];
    *il = gini(sum_left_.data(), d_.C, wl);
    *ir = gini(sum_right_.data(), d_.C, wn - wl);
  }

  Split node_split(int64_t start, int64_t end, double impurity, double wn,
                   int64_t* n_constant) {
    Split best;
    best.pos = end;
    double best_proxy = -kInf;
    int64_t f_i = d_.D, n_visited = 0, n_found = 0, n_drawn = 0;
    const int64_t n_known = *n_constant;
    int64_t n_total = n_known;
    while (f_i > n_total &&
           (n_visited < d_.mtry || n_visited <= n_found + n_drawn)) {
      ++n_visited;
      int64_t f_j = rand_int(n_drawn, f_i - n_found, &rng_);
      if (f_j < n_known) {
        std::swap(features_[n_drawn], features_[f_j]);
        ++n_drawn;
        continue;
      }
      f_j += n_found;
      const int64_t f = features_[f_j];
      sort_by(start, end, f);
      auto fv = [&](int64_t p) { return values_[p - start].v; };
      if (fv(end - 1) <= fv(start) + kFeatureThreshold) {
        std::swap(features_[f_j], features_[n_total]);
        ++n_found;
        ++n_total;
        continue;
      }
      --f_i;
      std::swap(features_[f_i], features_[f_j]);
      std::fill(sum_left_.begin(), sum_left_.end(), 0.0);
      double wl = 0.0;
      int64_t pos = start, p = start;
      while (p < end) {
        ++p;
        while (p < end && fv(p) <= fv(p - 1) + kFeatureThreshold) ++p;
        const int64_t p_prev = p - 1;
        if (p == end) continue;
        for (; pos < p; ++pos) {
          const int64_t i = values_[pos - start].row;
          const double w = static_cast<double>(w_[i]);
          sum_left_[d_.y[i]] += w;
          wl += w;
        }
        double il, ir;
        children(wn, wl, &il, &ir);
        const double wr = wn - wl;
        const double proxy = -wr * ir - wl * il;
        if (proxy > best_proxy) {
          best_proxy = proxy;
          best.feature = f;
          best.pos = p;
          const double t = fv(p_prev) / 2.0 + fv(p) / 2.0;
          best.threshold = (t == fv(p) || std::isinf(t))
                               ? static_cast<double>(fv(p_prev)) : t;
        }
      }
    }
    if (best.pos < end) {
      // the node's rows split by the best threshold: samples_[start, pos)
      // go left
      int64_t lo = start, hi = end;
      while (lo < hi) {
        if (static_cast<double>(x(samples_[lo], best.feature)) <=
            best.threshold) {
          ++lo;
        } else {
          --hi;
          std::swap(samples_[lo], samples_[hi]);
        }
      }
      std::fill(sum_left_.begin(), sum_left_.end(), 0.0);
      double wl = 0.0;
      for (int64_t p = start; p < best.pos; ++p) {
        const int64_t i = samples_[p];
        const double w = static_cast<double>(w_[i]);
        sum_left_[d_.y[i]] += w;
        wl += w;
      }
      children(wn, wl, &best.impurity_left, &best.impurity_right);
      const double wr = wn - wl;
      best.improvement =
          (wn / weighted_n_samples_) *
          (impurity - (wr / wn * best.impurity_right) -
           (wl / wn * best.impurity_left));
    }
    // features_[:n_known] back as the node found them; the constants found
    // here follow them, for the nodes below
    std::copy(constant_.begin(), constant_.begin() + n_known,
              features_.begin());
    std::copy(features_.begin() + n_known,
              features_.begin() + n_known + n_found,
              constant_.begin() + n_known);
    *n_constant = n_total;
    return best;
  }

  const Data& d_;
  const int32_t* w_;
  uint32_t rng_;
  std::vector<int64_t> samples_, features_, constant_;
  std::vector<Value> values_;
  std::vector<double> sum_total_, sum_left_, sum_right_;
  double weighted_n_samples_ = 0.0;
};

}  // namespace

extern "C" {

// Grows n_trees trees.  counts [n_trees, n]: each tree's bootstrap counts;
// seeds [n_trees]: each tree's feature stream.  Tree t writes its nodes at
// offset[t] of the flat outputs (room for 2 * (rows with a count) - 1
// nodes), its node count to node_count[t] and its depth to depth[t].
// max_depth < 0: unlimited.  Returns 0, or -1 when a tree needs more room
// than its offsets give it.
int glia_forest_train(int64_t n, int64_t D, const float* X, const int32_t* y,
                      int n_classes, int64_t n_trees, const int32_t* counts,
                      const uint32_t* seeds, int64_t mtry, int64_t max_depth,
                      int n_threads, const int64_t* offset,
                      int32_t* feature, float* threshold, int32_t* left,
                      int32_t* right, int32_t* leaf_class,
                      int64_t* node_count, int64_t* depth) {
  Data d{X, y, n, D, n_classes, mtry,
         max_depth < 0 ? std::numeric_limits<int32_t>::max() : max_depth};
  std::atomic<int64_t> next(0);
  std::atomic<int> failed(0);
  auto work = [&]() {
    for (int64_t t = next++; t < n_trees; t = next++) {
      TreeGrower b(d, counts + t * n, seeds[t]);
      Tree tree = b.build();
      const int64_t m = static_cast<int64_t>(tree.feature.size());
      if (m > offset[t + 1] - offset[t]) {
        failed = 1;
        continue;
      }
      const int64_t o = offset[t];
      std::copy(tree.feature.begin(), tree.feature.end(), feature + o);
      std::copy(tree.threshold.begin(), tree.threshold.end(), threshold + o);
      std::copy(tree.left.begin(), tree.left.end(), left + o);
      std::copy(tree.right.begin(), tree.right.end(), right + o);
      std::copy(tree.leaf_class.begin(), tree.leaf_class.end(),
                leaf_class + o);
      node_count[t] = m;
      depth[t] = tree.depth;
    }
  };
  const int k =
      std::max(1, std::min<int>(n_threads, static_cast<int>(n_trees)));
  std::vector<std::thread> pool;
  for (int i = 1; i < k; ++i) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
  return failed ? -1 : 0;
}

}  // extern "C"
