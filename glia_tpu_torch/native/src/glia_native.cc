// glia_tpu native runtime components.
//
// TPU-native framework policy: all production *compute* runs under JAX/XLA;
// the serial, pointer-chasing parts of the pipeline that a TPU cannot host
// efficiently (exact priority-queue greedy merging, priority-flood
// watershed) live here as a C++ runtime, exposed via a C ABI for ctypes.
//
// Semantics notes (behavioral parity with the reference, no code reuse):
//  * greedy merge: reference hot loop is code/type/boundary_table.hxx:122-167
//    driven by code/util/struct_merge.hxx:13-33.  Saliency = -statistic;
//    pop highest saliency; ties resolved latest-inserted-first; merged pair
//    (r0,r1) -> fresh key r2 = ++maxKey; incident edges splice their pixel
//    value lists.  Statistic: upper median sorted[n/2]
//    (code/util/stats.hxx:83-91), pooled mean, or median*minsize.
//  * watershed: equivalent of itk::MorphologicalWatershedImageFilter
//    (code/util/image_alg.hxx:9-21): h-minima suppression at `level` via
//    morphological reconstruction by erosion, then Meyer priority-flood from
//    regional minima, 2*D connectivity, no watershed lines, labels from 1.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

using i64 = int64_t;
using i32 = int32_t;

// ---------------------------------------------------------------------------
// Greedy merge engine
// ---------------------------------------------------------------------------

struct PairHash {
  size_t operator()(const std::pair<i64, i64>& p) const {
    return std::hash<i64>()(p.first * 0x9E3779B97F4A7C15LL + p.second);
  }
};

struct Item {
  std::vector<double> vals;  // median policies
  double sum = 0.0;          // mean policy
  i64 count = 0;
  i64 seq = 0;
};

struct HeapEntry {
  double stat;
  i64 neg_seq;
  i64 u, v;
  bool operator>(const HeapEntry& o) const {
    if (stat != o.stat) return stat > o.stat;
    return neg_seq > o.neg_seq;
  }
};

double upper_median(std::vector<double>& v) {
  if (v.empty()) return -1.0;  // DUMMY
  size_t k = v.size() / 2;
  std::nth_element(v.begin(), v.begin() + k, v.end());
  return v[k];
}

}  // namespace

namespace {

// Shared serial greedy core.  When use_premerge != 0 the pop honors the
// pre_merge admission condition (gadget/main_pre_merge.cxx:27-77): merge
// iff the smaller region is tiny (< t0) or either region is medium
// (< t1) with mean pb above rpb_threshold.  Failing candidates are
// dropped from the heap permanently -- equivalent to the reference's
// multimap rescan because the condition depends only on endpoint-region
// state, which cannot change without the pair being rekeyed (see
// glia_tpu/graph/merge.py pop_valid for the full argument).
i64 greedy_merge_core(i64 n_edges, const i64* edges_u, const i64* edges_v,
                      const i64* edge_ptr, const double* edge_vals, int policy,
                      i64 n_regions, const i64* region_keys,
                      const i64* region_sizes, i64* out_order,
                      double* out_saliencies, i64 max_merges,
                      int use_premerge, double t0, double t1,
                      double rpb_threshold, const double* region_pb_sums) {
  std::unordered_map<std::pair<i64, i64>, Item, PairHash> table;
  std::unordered_map<i64, std::unordered_set<i64>> adj;
  std::unordered_map<i64, i64> sizes;
  std::unordered_map<i64, double> pb_sums;
  std::priority_queue<HeapEntry, std::vector<HeapEntry>,
                      std::greater<HeapEntry>>
      heap;
  i64 seq = 0;
  bool need_sizes = (policy == 2) || use_premerge;
  if (need_sizes) {
    sizes.reserve(n_regions * 2);
    for (i64 i = 0; i < n_regions; ++i) sizes[region_keys[i]] = region_sizes[i];
  }
  if (use_premerge) {
    pb_sums.reserve(n_regions * 2);
    for (i64 i = 0; i < n_regions; ++i)
      pb_sums[region_keys[i]] = region_pb_sums[i];
  }

  auto stat_of = [&](Item& it, i64 u, i64 v) -> double {
    switch (policy) {
      case 0:
        return upper_median(it.vals);
      case 1:
        return it.count ? it.sum / it.count : 0.0;
      default: {
        double m = upper_median(it.vals);
        i64 s = std::min(sizes[u], sizes[v]);
        return m * s;
      }
    }
  };

  auto push = [&](i64 u, i64 v, Item&& item) {
    item.seq = seq;
    auto res = table.emplace(std::make_pair(u, v), std::move(item));
    Item& it = res.first->second;
    double s = stat_of(it, u, v);
    heap.push(HeapEntry{s, -seq, u, v});
    adj[u].insert(v);
    adj[v].insert(u);
    ++seq;
  };

  i64 max_key = 0;
  for (i64 i = 0; i < n_regions; ++i)
    max_key = std::max(max_key, region_keys[i]);

  for (i64 e = 0; e < n_edges; ++e) {
    Item item;
    i64 a = edge_ptr[e], b = edge_ptr[e + 1];
    if (policy == 1) {
      for (i64 i = a; i < b; ++i) item.sum += edge_vals[i];
      item.count = b - a;
    } else {
      item.vals.assign(edge_vals + a, edge_vals + b);
    }
    max_key = std::max(max_key, std::max(edges_u[e], edges_v[e]));
    push(edges_u[e], edges_v[e], std::move(item));
  }

  i64 next_key = max_key + 1;
  i64 n_merges = 0;

  while (!table.empty() && n_merges < max_merges) {
    // pop first live entry
    i64 r0 = -1, r1 = -1;
    double stat = 0.0;
    while (!heap.empty()) {
      HeapEntry top = heap.top();
      heap.pop();
      auto it = table.find(std::make_pair(top.u, top.v));
      if (it == table.end() || it->second.seq != -top.neg_seq) continue;
      if (use_premerge) {
        // smaller region first; on equal sizes keep (u, v) order like the
        // reference's swap-only-if-greater (main_pre_merge.cxx:37-41)
        i64 k0 = top.u, k1 = top.v;
        i64 s0 = sizes[k0], s1 = sizes[k1];
        if (s0 > s1) { std::swap(k0, k1); std::swap(s0, s1); }
        bool pass = s0 < t0;
        if (!pass && t1 >= 0.0) {
          if (s0 < t1 && (s0 > 0 ? pb_sums[k0] / s0 : 0.0) > rpb_threshold)
            pass = true;
          else if (s1 < t1 &&
                   (s1 > 0 ? pb_sums[k1] / s1 : 0.0) > rpb_threshold)
            pass = true;
        }
        if (!pass) continue;  // frozen until rekeyed
      }
      r0 = top.u;
      r1 = top.v;
      stat = top.stat;
      break;
    }
    if (r0 < 0) break;

    i64 r2 = next_key++;
    out_order[n_merges * 3] = r0;
    out_order[n_merges * 3 + 1] = r1;
    out_order[n_merges * 3 + 2] = r2;
    out_saliencies[n_merges] = -stat;
    ++n_merges;
    if (need_sizes) sizes[r2] = sizes[r0] + sizes[r1];
    if (use_premerge) pb_sums[r2] = pb_sums[r0] + pb_sums[r1];

    table.erase(std::make_pair(r0, r1));
    adj[r0].erase(r1);
    adj[r1].erase(r0);
    std::unordered_set<i64> neighbors = std::move(adj[r0]);
    for (i64 x : adj[r1]) neighbors.insert(x);
    adj.erase(r0);
    adj.erase(r1);

    for (i64 rs : neighbors) {
      Item merged;
      for (i64 rr : {r0, r1}) {
        auto key = rr < rs ? std::make_pair(rr, rs) : std::make_pair(rs, rr);
        auto it = table.find(key);
        if (it != table.end()) {
          if (policy == 1) {
            merged.sum += it->second.sum;
            merged.count += it->second.count;
          } else if (merged.vals.empty()) {
            merged.vals = std::move(it->second.vals);
          } else {
            merged.vals.insert(merged.vals.end(), it->second.vals.begin(),
                               it->second.vals.end());
          }
          table.erase(it);
        }
      }
      adj[rs].erase(r0);
      adj[rs].erase(r1);
      push(rs, r2, std::move(merged));
    }
  }
  return n_merges;
}

}  // namespace

extern "C" {

// policy: 0=median, 1=mean, 2=median_minsize
// Returns the number of merges written (<= max_merges).
i64 glia_greedy_merge(i64 n_edges, const i64* edges_u, const i64* edges_v,
                      const i64* edge_ptr, const double* edge_vals, int policy,
                      i64 n_regions, const i64* region_keys,
                      const i64* region_sizes, i64* out_order,
                      double* out_saliencies, i64 max_merges) {
  return greedy_merge_core(n_edges, edges_u, edges_v, edge_ptr, edge_vals,
                           policy, n_regions, region_keys, region_sizes,
                           out_order, out_saliencies, max_merges,
                           /*use_premerge=*/0, 0.0, -1.0, 0.0, nullptr);
}

// pre_merge (gadget/main_pre_merge.cxx): pooled-mean greedy merge admitting
// only (small) or (medium & high mean-pb) regions.  t1 < 0 disables the
// second threshold.  region_pb_sums: per-region summed pb (maintained
// additively under merges, equal to the reference's lazy per-key mean).
i64 glia_greedy_merge_premerge(
    i64 n_edges, const i64* edges_u, const i64* edges_v, const i64* edge_ptr,
    const double* edge_vals, i64 n_regions, const i64* region_keys,
    const i64* region_sizes, const double* region_pb_sums, double t0,
    double t1, double rpb_threshold, i64* out_order, double* out_saliencies,
    i64 max_merges) {
  return greedy_merge_core(n_edges, edges_u, edges_v, edge_ptr, edge_vals,
                           /*policy=*/1, n_regions, region_keys, region_sizes,
                           out_order, out_saliencies, max_merges,
                           /*use_premerge=*/1, t0, t1, rpb_threshold,
                           region_pb_sums);
}

// Replay a FIXED merge order through a (sum, count) boundary table,
// writing each merge's exact pooled-mean statistic at merge time -- the
// quantity the reference's serial engine uses as saliency at its pop
// (boundary_table.hxx:122-167 update semantics with the order imposed).
// order rows are dense-index triples (r0, r1, r2), ids < n_ids.  A pair
// not adjacent at its turn writes NaN and is skipped.
void glia_replay_saliency(i64 n_edges, const i32* u, const i32* v,
                          const double* s, const double* c, i64 n_ids,
                          i64 n_merges, const i32* order, double* out) {
  std::vector<std::unordered_map<i64, std::pair<double, double>>> adj(n_ids);
  for (i64 e = 0; e < n_edges; ++e) {
    i64 a = u[e], b = v[e];
    if (a == b || a < 0 || b < 0 || a >= n_ids || b >= n_ids) continue;
    auto& pa = adj[a][b];
    pa.first += s[e];
    pa.second += c[e];
    auto& pb = adj[b][a];
    pb.first += s[e];
    pb.second += c[e];
  }
  for (i64 i = 0; i < n_merges; ++i) {
    i64 a = order[3 * i], b = order[3 * i + 1], r2 = order[3 * i + 2];
    if (a < 0 || b < 0 || r2 < 0 || a >= n_ids || b >= n_ids ||
        r2 >= n_ids) {
      out[i] = std::numeric_limits<double>::quiet_NaN();
      continue;
    }
    auto ita = adj[a].find(b);
    if (ita == adj[a].end()) {
      out[i] = std::numeric_limits<double>::quiet_NaN();
      continue;
    }
    out[i] = ita->second.first / std::max(ita->second.second, 1.0);
    adj[a].erase(b);
    adj[b].erase(a);
    i64 big = a, small = b;
    if (adj[big].size() < adj[small].size()) std::swap(big, small);
    for (auto& kv : adj[small]) {
      auto& tgt = adj[big][kv.first];
      tgt.first += kv.second.first;
      tgt.second += kv.second.second;
      adj[kv.first].erase(small);
    }
    adj[small].clear();
    if (big != r2) {
      adj[r2] = std::move(adj[big]);
      adj[big].clear();
    }
    for (auto& kv : adj[r2]) {
      i64 nbr = kv.first;
      adj[nbr].erase(big);
      adj[nbr][r2] = kv.second;
    }
  }
}

// Replay a FIXED merge order through a VALUE-MULTISET boundary table,
// writing each merge's exact upper-median statistic at merge time (the
// reference's policy-0 quantity, util/stats.hxx:83-91 amedian over the
// spliced pixel-value lists of boundary_table.hxx:122-167).  Same
// contract as glia_replay_saliency, but exact medians need the full
// per-pair multiset: pairs splice by small-to-large vector append, so
// total work is O(P log P) for P boundary pixels.  edge_ptr/edge_vals:
// CSR pixel values per base edge.
// region_sizes (nullable, length n_ids with leaf sizes in [0, n_regions)):
// when given, the written statistic is median * min(size(r0), size(r1))
// with sizes pooled additively along the replay -- the reference's
// median_minsize policy (struct_merge.hxx:141-185) under a fixed order.
void glia_replay_saliency_median(i64 n_edges, const i32* u, const i32* v,
                                 const i64* edge_ptr,
                                 const double* edge_vals, i64 n_ids,
                                 i64 n_merges, const i32* order,
                                 const i64* region_sizes, double* out) {
  std::vector<std::unordered_map<i64, std::vector<double>>> adj(n_ids);
  for (i64 e = 0; e < n_edges; ++e) {
    i64 a = u[e], b = v[e];
    if (a == b || a < 0 || b < 0 || a >= n_ids || b >= n_ids) continue;
    auto& va = adj[a][b];
    va.insert(va.end(), edge_vals + edge_ptr[e], edge_vals + edge_ptr[e + 1]);
  }
  // mirror map: adj[b][a] shares content lazily -- keep one copy keyed by
  // the SMALLER endpoint and a neighbor set for rewiring
  // (simpler: store both directions as before but with shared sizes --
  // value vectors are heavy, so store data only at (min, max))
  std::vector<std::unordered_set<i64>> nbrs(n_ids);
  {
    std::vector<std::unordered_map<i64, std::vector<double>>> keyed(n_ids);
    for (i64 a = 0; a < n_ids; ++a) {
      for (auto& kv : adj[a]) {
        i64 b = kv.first;
        nbrs[a].insert(b);
        nbrs[b].insert(a);
        i64 lo = std::min(a, b), hi = std::max(a, b);
        auto& dst = keyed[lo][hi];
        if (dst.empty()) {
          dst = std::move(kv.second);
        } else {  // both orientations present among base edges
          dst.insert(dst.end(), kv.second.begin(), kv.second.end());
        }
      }
    }
    adj = std::move(keyed);
  }
  auto table_at = [&](i64 a, i64 b) -> std::vector<double>* {
    i64 lo = std::min(a, b), hi = std::max(a, b);
    auto it = adj[lo].find(hi);
    return it == adj[lo].end() ? nullptr : &it->second;
  };
  auto table_erase = [&](i64 a, i64 b) {
    i64 lo = std::min(a, b), hi = std::max(a, b);
    adj[lo].erase(hi);
  };
  std::vector<i64> sizes;
  if (region_sizes) sizes.assign(region_sizes, region_sizes + n_ids);
  for (i64 i = 0; i < n_merges; ++i) {
    i64 a = order[3 * i], b = order[3 * i + 1], r2 = order[3 * i + 2];
    if (a < 0 || b < 0 || r2 < 0 || a >= n_ids || b >= n_ids ||
        r2 >= n_ids) {
      out[i] = std::numeric_limits<double>::quiet_NaN();
      continue;
    }
    if (region_sizes) sizes[r2] = sizes[a] + sizes[b];
    auto* vals = table_at(a, b);
    if (vals == nullptr) {
      out[i] = std::numeric_limits<double>::quiet_NaN();
      continue;
    }
    out[i] = upper_median(*vals);
    if (region_sizes) out[i] *= (double)std::min(sizes[a], sizes[b]);
    table_erase(a, b);
    nbrs[a].erase(b);
    nbrs[b].erase(a);
    for (i64 src : {a, b}) {
      for (i64 x : nbrs[src]) {
        auto* ev = table_at(src, x);
        if (ev == nullptr) continue;
        auto* tv = table_at(r2, x);
        if (tv == nullptr) {
          i64 lo = std::min(r2, x), hi = std::max(r2, x);
          adj[lo][hi] = std::move(*ev);
        } else {
          // small-to-large append
          if (tv->size() < ev->size()) std::swap(*tv, *ev);
          tv->insert(tv->end(), ev->begin(), ev->end());
        }
        table_erase(src, x);
        nbrs[x].erase(src);
        nbrs[x].insert(r2);
        nbrs[r2].insert(x);
      }
      nbrs[src].clear();
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Watershed (h-minima + Meyer priority flood), arbitrary dimension
// ---------------------------------------------------------------------------

extern "C" {

namespace {

struct FloodEntry {
  float value;
  i64 seq;
  i64 pixel;
  bool operator>(const FloodEntry& o) const {
    if (value != o.value) return value > o.value;
    return seq > o.seq;
  }
};

// Neighbor offsets for 2*D connectivity given dims (C-order strides).
void neighbor_strides(const i64* dims, int ndim, std::vector<i64>& strides) {
  strides.assign(ndim, 0);
  i64 s = 1;
  for (int d = ndim - 1; d >= 0; --d) {
    strides[d] = s;
    s *= dims[d];
  }
}

}  // namespace

// Morphological reconstruction by erosion of `marker` constrained below by
// `mask` (marker >= mask pointwise required): returns pointwise smallest
// erosion-reconstruction.  Hybrid raster/anti-raster + FIFO algorithm.
void glia_reconstruct_erosion(float* marker, const float* mask,
                              const i64* dims, int ndim) {
  std::vector<i64> strides;
  neighbor_strides(dims, ndim, strides);
  i64 n = 1;
  for (int d = 0; d < ndim; ++d) n *= dims[d];

  std::vector<i64> coord(ndim);
  auto decode = [&](i64 p) {
    i64 r = p;
    for (int d = 0; d < ndim; ++d) {
      coord[d] = r / strides[d];
      r %= strides[d];
    }
  };

  // raster scan
  for (i64 p = 0; p < n; ++p) {
    decode(p);
    float m = marker[p];
    for (int d = 0; d < ndim; ++d) {
      if (coord[d] > 0) m = std::min(m, marker[p - strides[d]]);
    }
    marker[p] = std::max(m, mask[p]);
  }
  // anti-raster scan + queue init
  std::queue<i64> fifo;
  for (i64 p = n - 1; p >= 0; --p) {
    decode(p);
    float m = marker[p];
    for (int d = 0; d < ndim; ++d) {
      if (coord[d] + 1 < dims[d]) m = std::min(m, marker[p + strides[d]]);
    }
    marker[p] = std::max(m, mask[p]);
    for (int d = 0; d < ndim; ++d) {
      if (coord[d] + 1 < dims[d]) {
        i64 q = p + strides[d];
        if (marker[q] > marker[p] && marker[q] > mask[q]) {
          fifo.push(p);
          break;
        }
      }
    }
  }
  // FIFO propagation
  while (!fifo.empty()) {
    i64 p = fifo.front();
    fifo.pop();
    decode(p);
    for (int d = 0; d < ndim; ++d) {
      for (int sgn = -1; sgn <= 1; sgn += 2) {
        if (sgn < 0 ? coord[d] == 0 : coord[d] + 1 == dims[d]) continue;
        i64 q = p + sgn * strides[d];
        if (marker[q] > marker[p] && marker[q] > mask[q]) {
          marker[q] = std::max(marker[p], mask[q]);
          fifo.push(q);
        }
      }
    }
  }
}

// Watershed segmentation.  img: float array (C-order, `dims`/`ndim`).
// level: h-minima depth.  out: int32 labels (1-based, every pixel labeled).
// Returns number of labels.
i64 glia_watershed(const float* img, const i64* dims, int ndim, double level,
                   i32* out) {
  std::vector<i64> strides;
  neighbor_strides(dims, ndim, strides);
  i64 n = 1;
  for (int d = 0; d < ndim; ++d) n *= dims[d];

  // 1. h-minima suppression via reconstruction-by-erosion of (img+level)
  std::vector<float> work(img, img + n);
  if (level > 0.0) {
    std::vector<float> marker(n);
    for (i64 p = 0; p < n; ++p) marker[p] = img[p] + (float)level;
    glia_reconstruct_erosion(marker.data(), img, dims, ndim);
    work = std::move(marker);
  }

  std::vector<i64> coord(ndim);
  auto decode = [&](i64 p) {
    i64 r = p;
    for (int d = 0; d < ndim; ++d) {
      coord[d] = r / strides[d];
      r %= strides[d];
    }
  };

  // 2. regional minima: plateau BFS; plateau is a minimum iff no strictly
  // lower neighbor anywhere along it.
  std::memset(out, 0, n * sizeof(i32));
  std::vector<i32> state(n, 0);  // 0 unvisited, 1 in-plateau, 2 done
  i32 next_label = 0;
  std::vector<i64> plateau;
  std::queue<i64> bfs;
  for (i64 p0 = 0; p0 < n; ++p0) {
    if (state[p0]) continue;
    // explore plateau of p0
    plateau.clear();
    bool is_min = true;
    float v = work[p0];
    bfs.push(p0);
    state[p0] = 1;
    while (!bfs.empty()) {
      i64 p = bfs.front();
      bfs.pop();
      plateau.push_back(p);
      decode(p);
      for (int d = 0; d < ndim; ++d) {
        for (int sgn = -1; sgn <= 1; sgn += 2) {
          if (sgn < 0 ? coord[d] == 0 : coord[d] + 1 == dims[d]) continue;
          i64 q = p + sgn * strides[d];
          if (work[q] < v) {
            is_min = false;
          } else if (work[q] == v && !state[q]) {
            state[q] = 1;
            bfs.push(q);
          }
        }
      }
    }
    if (is_min) {
      ++next_label;
      for (i64 p : plateau) out[p] = next_label;
    }
    for (i64 p : plateau) state[p] = 2;
  }

  // 3. Meyer flood: seed queue with labeled pixels' unlabeled neighbors.
  std::priority_queue<FloodEntry, std::vector<FloodEntry>,
                      std::greater<FloodEntry>>
      pq;
  i64 seq = 0;
  std::vector<char> queued(n, 0);
  for (i64 p = 0; p < n; ++p) {
    if (out[p] == 0) continue;
    decode(p);
    for (int d = 0; d < ndim; ++d) {
      for (int sgn = -1; sgn <= 1; sgn += 2) {
        if (sgn < 0 ? coord[d] == 0 : coord[d] + 1 == dims[d]) continue;
        i64 q = p + sgn * strides[d];
        if (out[q] == 0 && !queued[q]) {
          queued[q] = 1;
          pq.push(FloodEntry{work[q], seq++, q});
        }
      }
    }
  }
  while (!pq.empty()) {
    FloodEntry e = pq.top();
    pq.pop();
    i64 p = e.pixel;
    if (out[p] != 0) continue;
    // adopt label of any labeled neighbor (first found in canonical order)
    decode(p);
    i32 lab = 0;
    for (int d = 0; d < ndim && !lab; ++d) {
      for (int sgn = -1; sgn <= 1; sgn += 2) {
        if (sgn < 0 ? coord[d] == 0 : coord[d] + 1 == dims[d]) continue;
        i64 q = p + sgn * strides[d];
        if (out[q] != 0) {
          lab = out[q];
          break;
        }
      }
    }
    out[p] = lab;
    for (int d = 0; d < ndim; ++d) {
      for (int sgn = -1; sgn <= 1; sgn += 2) {
        if (sgn < 0 ? coord[d] == 0 : coord[d] + 1 == dims[d]) continue;
        i64 q = p + sgn * strides[d];
        if (out[q] == 0 && !queued[q]) {
          queued[q] = 1;
          pq.push(FloodEntry{work[q], seq++, q});
        }
      }
    }
  }
  return next_label;
}

// Connected components of equal-label plateaus (relabeling utility used by
// labelcc/labelicc equivalents).  4/6-connectivity; labels from 1; masked-out
// pixels (mask==0) stay 0.  Returns number of components.
i64 glia_connected_components(const i32* labels, const i32* mask,
                              const i64* dims, int ndim, i32* out) {
  std::vector<i64> strides;
  neighbor_strides(dims, ndim, strides);
  i64 n = 1;
  for (int d = 0; d < ndim; ++d) n *= dims[d];
  std::vector<i64> coord(ndim);
  auto decode = [&](i64 p) {
    i64 r = p;
    for (int d = 0; d < ndim; ++d) {
      coord[d] = r / strides[d];
      r %= strides[d];
    }
  };
  std::memset(out, 0, n * sizeof(i32));
  i32 next = 0;
  std::queue<i64> bfs;
  for (i64 p0 = 0; p0 < n; ++p0) {
    if (out[p0] || (mask && !mask[p0])) continue;
    ++next;
    out[p0] = next;
    bfs.push(p0);
    while (!bfs.empty()) {
      i64 p = bfs.front();
      bfs.pop();
      decode(p);
      for (int d = 0; d < ndim; ++d) {
        for (int sgn = -1; sgn <= 1; sgn += 2) {
          if (sgn < 0 ? coord[d] == 0 : coord[d] + 1 == dims[d]) continue;
          i64 q = p + sgn * strides[d];
          if (!out[q] && labels[q] == labels[p] && (!mask || mask[q])) {
            out[q] = next;
            bfs.push(q);
          }
        }
      }
    }
  }
  return next;
}

}  // extern "C"
