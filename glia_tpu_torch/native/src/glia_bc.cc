// Native serial classifier-in-the-loop greedy merge (BC oracle).
//
// The reference's production inference engine is a serial C++ loop that
// rescoreds every candidate pair with a random-forest probability over
// freshly assembled BoundaryClassificationFeats
// (code/util/struct_merge_bc.hxx:10-58 driven by
// code/hmt/main_merge_order_bc.cxx); the repo's Python oracle
// (graph/merge_bc.py) reproduces it at ~20 merges/s, which caps
// serial-vs-device comparisons at about 512^2.
// This file is that SAME algorithm, bit-for-bit: every floating-point
// accumulation follows the Python oracle's canonical (sorted-neighbor)
// order, numpy reductions are reproduced with numpy's exact pairwise
// summation, and the heap tie rule matches heapq's (-p, -seq) ordering
// -- so the emitted orders are identical, not merely close (tests
// assert row equality against the Python engine).
//
// Scope: the FeatureConfig.standard subset (r_images == b_images,
// rl_images empty, normalizing 1.0, no log shape, histogram/median
// feats off) -- the configuration every tool and benchmark uses.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <map>
#include <queue>
#include <set>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

using i64 = int64_t;
using i32 = int32_t;

constexpr double FEPS = 2.22e-16;
constexpr double POS_INF = std::numeric_limits<double>::infinity();
constexpr double NEG_INF = -std::numeric_limits<double>::infinity();

inline double sdivide(double lhs, double rhs, double dummy) {
  return std::fabs(rhs) >= FEPS ? lhs / rhs : dummy;
}

// numpy's pairwise summation (umath loops.c.src, PW_BLOCKSIZE=128) so
// leaf-stat reductions match np.sum() bit-for-bit on contiguous f64.
double pairwise_sum(const double* a, i64 n) {
  if (n < 8) {
    double res = 0.0;
    for (i64 i = 0; i < n; ++i) res += a[i];
    return res;
  }
  if (n <= 128) {
    double r[8];
    for (int j = 0; j < 8; ++j) r[j] = a[j];
    i64 i = 8;
    for (; i + 8 <= n; i += 8)
      for (int j = 0; j < 8; ++j) r[j] += a[i + j];
    double res = ((r[0] + r[1]) + (r[2] + r[3])) +
                 ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; ++i) res += a[i];
    return res;
  }
  i64 n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

// Reference histc bin index (util/image_stats.hxx:13-37 quirk; see
// _histutil.py).
inline int hist_bin(double v, i64 n_bins, double lo, double hi) {
  if (v <= lo) return 0;
  if (v >= hi) return (int)(n_bins - 1);
  double interval = (hi - lo) / (double)n_bins;
  if (!(v < interval * (double)n_bins)) return -1;
  i64 b = (i64)std::floor(v / interval);
  if (b < 0) b = 0;
  if (b > n_bins - 1) b = n_bins - 1;
  return (int)b;
}

// One (cnt, sum, sumsq, min, max, hist[n_bins]) record.
struct Stat {
  double cnt = 0.0, sum = 0.0, sumsq = 0.0;
  double mn = POS_INF, mx = NEG_INF;
  std::vector<double> hist;
  explicit Stat(i64 n_bins = 0) : hist(n_bins, 0.0) {}
  void add(const Stat& o) {
    cnt += o.cnt;
    sum += o.sum;
    sumsq += o.sumsq;
    mn = std::min(mn, o.mn);
    mx = std::max(mx, o.mx);
    for (size_t i = 0; i < hist.size(); ++i) hist[i] += o.hist[i];
  }
};

// One-sided boundary stat bundle: cnt, vp[nT], per-b-image Stat.
struct BStats {
  double cnt = 0.0;
  std::vector<double> vp;
  std::vector<Stat> b;
  BStats(i64 nt, i64 n_img, i64 n_bins) : vp(nt, 0.0) {
    b.reserve(n_img);
    for (i64 i = 0; i < n_img; ++i) b.emplace_back(n_bins);
  }
  void add(const BStats& o) {
    cnt += o.cnt;
    for (size_t i = 0; i < vp.size(); ++i) vp[i] += o.vp[i];
    for (size_t i = 0; i < b.size(); ++i) b[i].add(o.b[i]);
  }
};

struct RegionRec {
  double area = 0.0, border = 0.0;
  std::vector<double> bbox_lo, bbox_hi;  // merge_bc axis order
  std::vector<Stat> r;                   // per r_image
};

struct PairHashBC {
  size_t operator()(const std::pair<i64, i64>& p) const {
    return std::hash<i64>()(p.first * 0x9E3779B97F4A7C15LL + p.second);
  }
};

struct Entry {
  BStats m, n;
  Entry(i64 nt, i64 n_img, i64 n_bins)
      : m(nt, n_img, n_bins), n(nt, n_img, n_bins) {}
};

struct Forest {
  i64 n_trees, n_nodes;
  const i32* feature;
  const float* threshold;
  const i32* left;
  const i32* right;
  const i32* leaf_class;
  i32 target_class;
  i64 n_classes;
  double predict(const std::vector<double>& x) const {
    i64 votes = 0;
    for (i64 t = 0; t < n_trees; ++t) {
      const i32* f = feature + t * n_nodes;
      const float* th = threshold + t * n_nodes;
      const i32* lc = left + t * n_nodes;
      const i32* rc = right + t * n_nodes;
      i64 node = 0;
      while (f[node] >= 0) {
        node = x[f[node]] <= (double)th[node] ? lc[node] : rc[node];
      }
      if (leaf_class[t * n_nodes + node] == target_class) ++votes;
    }
    return (double)votes / (double)n_trees;
  }
};

class BCState {
 public:
  i64 nt, n_img, n_bins, ndim;
  double hist_lo, hist_hi;
  const double* thresholds;
  std::unordered_map<i64, RegionRec> rec;
  std::unordered_map<std::pair<i64, i64>, Entry, PairHashBC> entries;
  std::unordered_map<i64, BStats> residual;
  std::unordered_map<i64, std::set<i64>> adj;  // ordered: canonical sums
  std::vector<std::pair<i64, i64>> dir_first_order;  // directed keys

  BStats make_bstats() const { return BStats(nt, n_img, n_bins); }

  // ---- leaf construction ------------------------------------------------
  void init(i64 n_regions, const i64* region_keys, const i64* region_ptr,
            const i64* region_pixels, const i64* border_counts,
            i64 n_dir, const i64* dir_a, const i64* dir_b,
            const i64* dir_ptr, const i64* dir_pixels,
            const i64* shape_arr, const double* images, i64 n_pixels,
            const double* pb) {
    // strides for unravel (C order), bbox dims = unraveled[ndim-1-d]
    std::vector<i64> strides(ndim);
    i64 s = 1;
    for (i64 d = ndim - 1; d >= 0; --d) {
      strides[d] = s;
      s *= shape_arr[d];
    }
    std::vector<double> buf;
    for (i64 i = 0; i < n_regions; ++i) {
      i64 key = region_keys[i];
      i64 p0 = region_ptr[i], p1 = region_ptr[i + 1];
      RegionRec& rr = rec[key];
      rr.area = (double)(p1 - p0);
      rr.border = (double)border_counts[i];
      rr.bbox_lo.assign(ndim, 0.0);
      rr.bbox_hi.assign(ndim, 0.0);
      if (p1 > p0) {
        for (i64 d = 0; d < ndim; ++d) {
          rr.bbox_lo[d] = POS_INF;
          rr.bbox_hi[d] = NEG_INF;
        }
        for (i64 p = p0; p < p1; ++p) {
          i64 r = region_pixels[p];
          for (i64 d = 0; d < ndim; ++d) {
            i64 coord = (r / strides[d]) % shape_arr[d];
            // bbox dim (ndim-1-d) holds unraveled axis d
            i64 j = ndim - 1 - d;
            rr.bbox_lo[j] = std::min(rr.bbox_lo[j], (double)coord);
            rr.bbox_hi[j] = std::max(rr.bbox_hi[j], (double)coord);
          }
        }
      }
      rr.r.reserve(n_img);
      for (i64 im = 0; im < n_img; ++im) {
        const double* img = images + im * n_pixels;
        Stat st(n_bins);
        i64 n = p1 - p0;
        if (n > 0) {
          buf.resize(n);
          for (i64 p = 0; p < n; ++p) buf[p] = img[region_pixels[p0 + p]];
          st.cnt = (double)n;
          st.sum = pairwise_sum(buf.data(), n);
          std::vector<double> sq(n);
          for (i64 p = 0; p < n; ++p) sq[p] = buf[p] * buf[p];
          st.sumsq = pairwise_sum(sq.data(), n);
          st.mn = *std::min_element(buf.begin(), buf.end());
          st.mx = *std::max_element(buf.begin(), buf.end());
          for (i64 p = 0; p < n; ++p) {
            int bi = hist_bin(buf[p], n_bins, hist_lo, hist_hi);
            if (bi >= 0) st.hist[bi] += 1.0;
          }
        } else {
          // merge_bc._scalar_stats: all-zero record when empty
          st.mn = 0.0;
          st.mx = 0.0;
        }
        rr.r.push_back(std::move(st));
      }
      residual.emplace(key, make_bstats());
      adj[key];
    }

    // mutual detection: reverse directed pair present?
    std::unordered_set<std::pair<i64, i64>, PairHashBC> dirset;
    dirset.reserve(n_dir * 2);
    for (i64 e = 0; e < n_dir; ++e) dirset.insert({dir_a[e], dir_b[e]});

    for (i64 e = 0; e < n_dir; ++e) {
      i64 a = dir_a[e], b = dir_b[e];
      i64 p0 = dir_ptr[e], p1 = dir_ptr[e + 1];
      BStats st = make_bstats();
      st.cnt = (double)(p1 - p0);
      for (i64 t = 0; t < nt; ++t) {
        i64 cnt = 0;
        for (i64 p = p0; p < p1; ++p)
          if (pb[dir_pixels[p]] >= thresholds[t]) ++cnt;
        st.vp[t] = (double)cnt;
      }
      i64 n = p1 - p0;
      for (i64 im = 0; im < n_img; ++im) {
        const double* img = images + im * n_pixels;
        Stat& bs = st.b[im];
        if (n > 0) {
          buf.resize(n);
          for (i64 p = 0; p < n; ++p) buf[p] = img[dir_pixels[p0 + p]];
          bs.cnt = (double)n;
          bs.sum = pairwise_sum(buf.data(), n);
          std::vector<double> sq(n);
          for (i64 p = 0; p < n; ++p) sq[p] = buf[p] * buf[p];
          bs.sumsq = pairwise_sum(sq.data(), n);
          bs.mn = *std::min_element(buf.begin(), buf.end());
          bs.mx = *std::max_element(buf.begin(), buf.end());
          for (i64 p = 0; p < n; ++p) {
            int bi = hist_bin(buf[p], n_bins, hist_lo, hist_hi);
            if (bi >= 0) bs.hist[bi] += 1.0;
          }
        } else {
          bs.cnt = (double)n;  // 0; min/max stay +-inf (= _empty_bstat)
        }
      }
      auto it = entries.find({a, b});
      if (it == entries.end()) {
        it = entries.emplace(std::make_pair(a, b),
                             Entry(nt, n_img, n_bins)).first;
        dir_first_order.push_back({a, b});
      }
      bool mutual = dirset.count({b, a}) > 0;
      (mutual ? it->second.m : it->second.n).add(st);
      adj[a].insert(b);
      adj[b].insert(a);
    }
  }

  // ---- component boundary bundles (canonical sorted order) --------------
  BStats boundary_totals(i64 c) const {
    BStats tot = make_bstats();
    tot.add(residual.at(c));
    auto ait = adj.find(c);
    if (ait != adj.end()) {
      for (i64 nb : ait->second) {  // std::set: ascending
        auto it = entries.find({c, nb});
        if (it != entries.end()) {
          tot.add(it->second.m);
          tot.add(it->second.n);
        }
      }
    }
    return tot;
  }

  BStats pair_boundary(i64 c0, i64 c1) const {
    BStats tot = make_bstats();
    auto it = entries.find({c0, c1});
    if (it != entries.end()) {
      tot.add(it->second.m);
      tot.add(it->second.n);
    }
    it = entries.find({c1, c0});
    if (it != entries.end()) {
      tot.add(it->second.m);
      tot.add(it->second.n);
    }
    return tot;
  }

  // merged region record (no boundary) + merged one-sided boundary bundle
  void merged_record(i64 c0, i64 c1, RegionRec& out, BStats& btot) const {
    const RegionRec& r0 = rec.at(c0);
    const RegionRec& r1 = rec.at(c1);
    out.area = r0.area + r1.area;
    out.border = r0.border + r1.border;
    out.bbox_lo.resize(ndim);
    out.bbox_hi.resize(ndim);
    for (i64 d = 0; d < ndim; ++d) {
      out.bbox_lo[d] = std::min(r0.bbox_lo[d], r1.bbox_lo[d]);
      out.bbox_hi[d] = std::max(r0.bbox_hi[d], r1.bbox_hi[d]);
    }
    out.r.clear();
    out.r.reserve(n_img);
    for (i64 im = 0; im < n_img; ++im) {
      const Stat& a = r0.r[im];
      const Stat& b = r1.r[im];
      Stat st(n_bins);
      st.cnt = a.cnt + b.cnt;
      st.sum = a.sum + b.sum;
      st.sumsq = a.sumsq + b.sumsq;
      // merge_bc.merged_record: conditional min/max on non-empty sides
      if (a.cnt != 0.0 && b.cnt != 0.0) {
        st.mn = std::min(a.mn, b.mn);
        st.mx = std::max(a.mx, b.mx);
      } else if (a.cnt != 0.0) {
        st.mn = a.mn;
        st.mx = a.mx;
      } else {
        st.mn = b.mn;
        st.mx = b.mx;
      }
      for (i64 i = 0; i < n_bins; ++i) st.hist[i] = a.hist[i] + b.hist[i];
      out.r.push_back(std::move(st));
    }
    btot = make_bstats();
    btot.add(residual.at(c0));
    btot.add(residual.at(c1));
    const i64 srcs[2] = {c0, c1};
    const i64 others[2] = {c1, c0};
    for (int k = 0; k < 2; ++k) {
      i64 src = srcs[k], other = others[k];
      auto ait = adj.find(src);
      if (ait == adj.end()) continue;
      for (i64 nb : ait->second) {
        auto it = entries.find({src, nb});
        if (it == entries.end()) continue;
        if (nb == other) {
          btot.add(it->second.n);  // mutual part cancels
        } else {
          btot.add(it->second.m);
          btot.add(it->second.n);
        }
      }
    }
  }

  // ---- commit a merge ---------------------------------------------------
  void merge(i64 c0, i64 c1, i64 c2) {
    RegionRec merged;
    BStats unused = make_bstats();
    merged_record(c0, c1, merged, unused);
    rec[c2] = std::move(merged);
    BStats res = make_bstats();
    res.add(residual.at(c0));
    res.add(residual.at(c1));
    residual.erase(c0);
    residual.erase(c1);
    auto it = entries.find({c0, c1});
    if (it != entries.end()) {
      res.add(it->second.n);
      entries.erase(it);
    }
    it = entries.find({c1, c0});
    if (it != entries.end()) {
      res.add(it->second.n);
      entries.erase(it);
    }
    residual.emplace(c2, std::move(res));
    std::set<i64> neighbors;
    for (i64 x : adj[c0]) neighbors.insert(x);
    for (i64 x : adj[c1]) neighbors.insert(x);
    neighbors.erase(c0);
    neighbors.erase(c1);
    adj.erase(c0);
    adj.erase(c1);
    auto& a2 = adj[c2];
    const i64 srcs[2] = {c0, c1};
    for (i64 nb : neighbors) {
      for (int k = 0; k < 2; ++k) {
        i64 src = srcs[k];
        auto e1 = entries.find({src, nb});
        if (e1 != entries.end()) {
          auto d = entries.find({c2, nb});
          if (d == entries.end())
            d = entries.emplace(std::make_pair(c2, nb),
                                Entry(nt, n_img, n_bins)).first;
          d->second.m.add(e1->second.m);
          d->second.n.add(e1->second.n);
          entries.erase(e1);
        }
        auto e2 = entries.find({nb, src});
        if (e2 != entries.end()) {
          auto d = entries.find({nb, c2});
          if (d == entries.end())
            d = entries.emplace(std::make_pair(nb, c2),
                                Entry(nt, n_img, n_bins)).first;
          d->second.m.add(e2->second.m);
          d->second.n.add(e2->second.n);
          entries.erase(e2);
        }
        adj[nb].erase(src);
      }
      adj[nb].insert(c2);
      a2.insert(nb);
    }
    rec.erase(c0);
    rec.erase(c1);
  }

  // ---- serialization (features/serialize.py, standard subset) -----------
  void img_feats(const Stat& st, std::vector<double>& out) const {
    if (st.cnt <= 0.0) {
      for (int i = 0; i < 5; ++i) out.push_back(0.0);
      return;
    }
    double mean = st.sum / st.cnt;
    double var = st.sumsq / st.cnt - mean * mean;
    double sd = std::sqrt(std::max(var, 0.0));
    // entropy over p > FEPS (masked pairwise sum like numpy)
    std::vector<double> terms;
    terms.reserve(n_bins);
    for (i64 i = 0; i < n_bins; ++i) {
      double p = st.hist[i] / st.cnt;
      if (p > FEPS) terms.push_back(p * std::log2(p));
    }
    double ent = terms.empty()
        ? 0.0
        : -pairwise_sum(terms.data(), (i64)terms.size());
    out.push_back(ent);
    out.push_back(mean);
    out.push_back(sd);
    out.push_back(st.mn);
    out.push_back(st.mx);
  }

  void region_vector(const RegionRec& rr, const BStats& tot,
                     std::vector<double>& out) const {
    double area_raw = rr.area;
    double perim_raw = tot.cnt + rr.border;
    double compact = sdivide(
        std::pow(perim_raw, (double)ndim / ((double)ndim - 1.0)),
        area_raw, 0.0);
    double bbox_area = 1.0;
    for (i64 d = 0; d < ndim; ++d)
      bbox_area *= std::max(rr.bbox_hi[d] - rr.bbox_lo[d], 0.0);
    out.push_back(area_raw);
    out.push_back(perim_raw);
    out.push_back(compact);
    out.push_back(bbox_area);
    for (i64 d = 0; d < ndim; ++d)
      out.push_back(std::max(rr.bbox_hi[d] - rr.bbox_lo[d], 0.0));
    for (i64 t = 0; t < nt; ++t) out.push_back(tot.vp[t]);
    for (i64 t = 0; t < nt; ++t)
      out.push_back(sdivide(tot.vp[t], tot.cnt, 0.0));
    for (i64 im = 0; im < n_img; ++im) img_feats(rr.r[im], out);
    for (i64 im = 0; im < n_img; ++im) img_feats(tot.b[im], out);
  }

  void boundary_vector(const RegionRec& r0, const BStats& t0,
                       const RegionRec& r1, const BStats& t1,
                       const BStats& pair,
                       std::vector<double>& out) const {
    double area0 = r0.area, area1 = r1.area;
    double perim0 = t0.cnt + r0.border;
    double perim1 = t1.cnt + r1.border;
    double area_diff = std::fabs(area0 - area1);
    double perim_diff = std::fabs(perim0 - perim1);
    double blen = std::ceil(pair.cnt / 2.0);
    out.push_back(area_diff);
    out.push_back(sdivide(area_diff, area0, 0.0));
    out.push_back(sdivide(area_diff, area1, 0.0));
    out.push_back(perim_diff);
    out.push_back(sdivide(perim_diff, perim0, 0.0));
    out.push_back(sdivide(perim_diff, perim1, 0.0));
    out.push_back(blen);
    out.push_back(sdivide(blen, area0, 0.0));
    out.push_back(sdivide(blen, area1, 0.0));
    out.push_back(sdivide(blen, perim0, 0.0));
    out.push_back(sdivide(blen, perim1, 0.0));
    std::vector<double> vbl(nt);
    for (i64 t = 0; t < nt; ++t) vbl[t] = std::ceil(pair.vp[t] / 2.0);
    for (i64 t = 0; t < nt; ++t) out.push_back(vbl[t]);
    for (i64 t = 0; t < nt; ++t)
      out.push_back(sdivide(vbl[t], blen, 0.0));
    for (i64 t = 0; t < nt; ++t)
      out.push_back(sdivide(vbl[t], perim0, 0.0));
    for (i64 t = 0; t < nt; ++t)
      out.push_back(sdivide(vbl[t], perim1, 0.0));
    for (i64 im = 0; im < n_img; ++im) {
      std::vector<double> f0, f1;
      img_feats(r0.r[im], f0);
      img_feats(r1.r[im], f1);
      double c0 = std::max(r0.r[im].cnt, 1.0);
      double c1 = std::max(r1.r[im].cnt, 1.0);
      std::vector<double> l1t(n_bins), x2t(n_bins);
      for (i64 i = 0; i < n_bins; ++i) {
        double h0 = r0.r[im].hist[i] / c0;
        double h1 = r1.r[im].hist[i] / c1;
        double d = h0 - h1;
        l1t[i] = std::fabs(d);
        x2t[i] = (d * d) / (h0 + h1 + FEPS);
      }
      out.push_back(pairwise_sum(l1t.data(), n_bins));
      out.push_back(pairwise_sum(x2t.data(), n_bins));
      for (int j = 0; j < 5; ++j)
        out.push_back(std::fabs(f0[j] - f1[j]));
    }
    for (i64 im = 0; im < n_img; ++im) img_feats(pair.b[im], out);
  }

  std::vector<double> candidate_features(i64 c0, i64 c1) const {
    const RegionRec* r0 = &rec.at(c0);
    const RegionRec* r1 = &rec.at(c1);
    BStats t0 = boundary_totals(c0);
    BStats t1 = boundary_totals(c1);
    RegionRec r2;
    BStats t2 = make_bstats();
    merged_record(c0, c1, r2, t2);
    BStats pair = pair_boundary(c0, c1);
    // area ordering (bc_feat.hxx:219-243 + main_bc_feat.cxx:86-89)
    if (r0->area > r1->area) {
      std::swap(r0, r1);
      std::swap(t0, t1);
    }
    std::vector<double> out;
    out.reserve(160);
    boundary_vector(*r0, t0, *r1, t1, pair, out);
    region_vector(*r0, t0, out);
    region_vector(*r1, t1, out);
    region_vector(r2, t2, out);
    return out;
  }
};

struct BCHeapEntry {
  double p;
  i64 seq;
  i64 c0, c1;
  bool operator<(const BCHeapEntry& o) const {
    if (p != o.p) return p < o.p;
    return seq < o.seq;  // ties: latest-inserted pops first
  }
};

}  // namespace

extern "C" {

// Serial classifier-in-the-loop greedy merge; returns n_merges.
// out_order: [max_merges, 3] label-key triples; out_probs: [max_merges].
// out_feat_dim (optional, may be null): writes the feature width used.
i64 glia_bc_greedy_merge(
    i64 n_regions, const i64* region_keys, const i64* region_ptr,
    const i64* region_pixels, const i64* border_counts, i64 n_dir,
    const i64* dir_a, const i64* dir_b, const i64* dir_ptr,
    const i64* dir_pixels, i64 ndim, const i64* shape, i64 n_img,
    const double* images, i64 n_pixels, i64 n_bins, double hist_lo,
    double hist_hi, const double* pb, i64 n_thresh,
    const double* thresholds, i64 n_trees, i64 n_nodes,
    const i32* feature, const float* threshold, const i32* left,
    const i32* right, const i32* leaf_class, i32 target_class,
    i64* out_order, double* out_probs, i64 max_merges,
    i64* out_feat_dim) {
  BCState st;
  st.nt = n_thresh;
  st.n_img = n_img;
  st.n_bins = n_bins;
  st.ndim = ndim;
  st.hist_lo = hist_lo;
  st.hist_hi = hist_hi;
  st.thresholds = thresholds;
  st.init(n_regions, region_keys, region_ptr, region_pixels,
          border_counts, n_dir, dir_a, dir_b, dir_ptr, dir_pixels, shape,
          images, n_pixels, pb);
  Forest forest{n_trees, n_nodes, feature,  threshold,
                left,    right,   leaf_class, target_class, 0};

  std::priority_queue<BCHeapEntry> heap;
  std::unordered_map<std::pair<i64, i64>, i64, PairHashBC> entry_seq;
  std::unordered_set<std::pair<i64, i64>, PairHashBC> table_pairs;
  i64 seq = 0;

  auto push = [&](i64 c0, i64 c1) {
    auto x = st.candidate_features(c0, c1);
    if (out_feat_dim) *out_feat_dim = (i64)x.size();
    double p = forest.predict(x);
    std::pair<i64, i64> key{std::min(c0, c1), std::max(c0, c1)};
    entry_seq[key] = seq;
    heap.push(BCHeapEntry{p, seq, key.first, key.second});
    ++seq;
  };

  // initial table: pairs whose boundary is mutual in BOTH directions,
  // in first-directed-occurrence order (matches the Python oracle's
  // dict-insertion iteration)
  for (auto& ab : st.dir_first_order) {
    std::pair<i64, i64> key{std::min(ab.first, ab.second),
                            std::max(ab.first, ab.second)};
    if (table_pairs.count(key)) continue;
    if (st.entries.count({ab.first, ab.second}) &&
        st.entries.count({ab.second, ab.first})) {
      table_pairs.insert(key);
      push(key.first, key.second);
    }
  }

  i64 max_key = 0;
  for (i64 i = 0; i < n_regions; ++i)
    max_key = std::max(max_key, region_keys[i]);
  i64 next_key = max_key + 1;
  i64 n_merges = 0;

  while (n_merges < max_merges) {
    i64 c0 = -1, c1 = -1;
    double prob = 0.0;
    while (!heap.empty()) {
      BCHeapEntry top = heap.top();
      heap.pop();
      std::pair<i64, i64> key{top.c0, top.c1};
      auto sit = entry_seq.find(key);
      if (sit == entry_seq.end() || sit->second != top.seq) continue;
      if (!table_pairs.count(key)) continue;
      c0 = top.c0;
      c1 = top.c1;
      prob = top.p;
      break;
    }
    if (c0 < 0) break;
    i64 c2 = next_key++;
    out_order[n_merges * 3] = c0;
    out_order[n_merges * 3 + 1] = c1;
    out_order[n_merges * 3 + 2] = c2;
    out_probs[n_merges] = prob;
    ++n_merges;
    std::pair<i64, i64> key{c0, c1};
    table_pairs.erase(key);
    entry_seq.erase(key);
    // neighbors currently holding table entries with c0/c1
    std::set<i64> rekey;
    std::set<i64> nbs;
    auto a0 = st.adj.find(c0);
    if (a0 != st.adj.end()) nbs.insert(a0->second.begin(), a0->second.end());
    auto a1 = st.adj.find(c1);
    if (a1 != st.adj.end()) nbs.insert(a1->second.begin(), a1->second.end());
    nbs.erase(c0);
    nbs.erase(c1);
    for (i64 nb : nbs) {
      for (i64 cc : {c0, c1}) {
        std::pair<i64, i64> k{std::min(cc, nb), std::max(cc, nb)};
        if (table_pairs.count(k)) {
          table_pairs.erase(k);
          entry_seq.erase(k);
          rekey.insert(nb);
        }
      }
    }
    st.merge(c0, c1, c2);
    for (i64 nb : rekey) {  // ascending, like sorted(rekey)
      std::pair<i64, i64> k{std::min(nb, c2), std::max(nb, c2)};
      table_pairs.insert(k);
      push(k.first, k.second);
    }
  }
  return n_merges;
}

}  // extern "C"
