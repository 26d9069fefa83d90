// Frozen copy of the watershed of glia_tpu_torch/native/src/glia_native.cc
// at commit 28cc36d (the file's other parts left out: no cell runs them).
// The benchmark builds it itself (benchmark/reference/host/native.py) for
// its inputs; nothing of the program is loaded for them.
//
// Semantics notes (behavioral parity with the reference, no code reuse):
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

using i64 = int64_t;
using i32 = int32_t;

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

}  // extern "C"
