// Segment sum on NVIDIA Hopper (sm_90a): out[s, :] = sum of values[i, :]
// over ids[i] == s.
//
// Replaces the TPU kernel glia_tpu/ops/pallas/segment_csr.py ::
// segment_sum_pallas.  Rows whose id is negative or >= S are dropped (the
// padding convention).  values is [B, F] row-major (F = 1 for a vector),
// ids is int64 [B], out is [S, F] and was zeroed by the caller on the same
// stream.
//
// Design.  The TPU kernel expands every chunk of ids to a one-hot
// [chunk, S] matrix and multiplies on the MXU, because the TPU has a matrix
// unit and no fast scatter; that costs bf16 rounding.  A GPU scatters, so
// both entry points here add in the values' own type (float or double) and
// are exact to rounding:
//
//   glia_segment_sum         any ids.  One thread per (row, feature) does
//                            one atomicAdd, so the order of the additions,
//                            and the last bit of a float sum, can change
//                            between launches.
//   glia_segment_sum_sorted  ids non-decreasing (the caller states it; it
//                            is not checked here).  Every run of equal ids
//                            is added in index order, starting from zero,
//                            by one thread per feature, and written once.
//                            No atomics: two launches give the same bits,
//                            and the order is that of a sequential loop
//                            over the rows (the CPU's index_add_).
//
// Bound.  Bytes: each value and id read once, each output written once; no
// arithmetic to speak of (one add per value).  The atomic form is limited
// by contention when many rows share a segment.  The sorted form must keep
// the additions of a run in order, so a run is a serial chain; what the
// card can do is make each link cheap and keep many chains going.  Walked
// from global memory with the exit test (ids[j] == s) on a load in every
// step, as this kernel first did, a link was an L2 round trip and B * F
// threads each read two ids to learn that they had nothing to do.
//
// Design of the sorted form.  A block takes a tile of consecutive rows
// (all F features while F <= 256, else a chunk of 256 columns) and a
// quarter as many rows of lookahead behind it, copies their values into
// shared memory with 16-byte cp.async where the tile is one aligned stretch
// of memory, and their ids.  One thread per row of the tile compares its id
// with the one before; the rows that start a run are listed (one atomic per
// warp), so no thread is spent on a row that starts nothing.  The threads
// are then (run start, feature) pairs: each adds its run from shared memory,
// the first four rows loaded before any test (most runs of a dedupe end
// there), then eight rows a step (the ids are sorted, so ids[j + 7] == s
// says that rows j .. j + 7 all belong to the run: one test per eight adds,
// and the loads do not wait for the running sum).  A run that starts in
// the tile and ends in the lookahead is finished there; the rows of that
// run are no run starts for the next tile's block and are skipped there.
// Only one run of a tile can go on past the lookahead: the block first
// finds where it ends (all threads look at the following ids at once), then
// the run's threads finish it from global memory sixteen independent loads
// at a time.
// A tile holds up to 4096 values and 512 rows, fewer for a small batch so
// that it still makes two blocks for every SM.

#include <cuda_runtime.h>

template <typename T>
__global__ void segment_sum_atomic_kernel(
    const T* __restrict__ values, const long long* __restrict__ ids,
    long long B, int F, long long S, T* __restrict__ out) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= B * F) return;
  const long long i = idx / F;
  const int f = (int)(idx - i * F);
  const long long s = ids[i];
  if (s < 0 || s >= S) return;
  atomicAdd(out + s * F + f, values[idx]);
}

// geometry of the sorted form: threads in a block, widest column chunk,
// values in a tile, most and fewest rows in a tile, and the tile's rows per
// row of lookahead.  With these a block's shared memory stays under the
// 48 KB that need no opt-in (float64: 5120 values, 641 ids, 512 starts).
#define GLIA_SORTED_THREADS 256
#define GLIA_SORTED_MAX_COLS 256
#define GLIA_SORTED_TILE_ELEMS 4096
#define GLIA_SORTED_MAX_ROWS 512
#define GLIA_SORTED_MIN_ROWS 32
#define GLIA_SORTED_LA_DIV 4

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// bytes of the values in shared memory, rounded up so that the ids behind
// them are aligned
template <typename T>
__host__ __device__ inline size_t sorted_ids_offset(int rows, int cols) {
  return ((size_t)rows * cols * sizeof(T) + 15) / 16 * 16;
}

// RT rows (and LA more rows of lookahead) by FC columns to a tile;
// blockIdx.x is the row tile, blockIdx.y the column chunk.  Shared memory:
// values [RT + LA, fc], ids [RT + LA + 1], run starts [RT].
template <typename T>
__global__ void __launch_bounds__(GLIA_SORTED_THREADS)
segment_sum_sorted_kernel(const T* __restrict__ values,
                          const long long* __restrict__ ids, long long B,
                          int F, long long S, int RT, int LA, int FC,
                          T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sv = (T*)smem;
  long long* sid = (long long*)(smem + sorted_ids_offset<T>(RT + LA, FC));
  int* starts = (int*)(sid + RT + LA + 1);
  __shared__ long long s_end;
  __shared__ int s_n_starts;

  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * RT;
  const int f0 = blockIdx.y * FC;
  const int fc = min(FC, F - f0);
  const int nr = (int)min((long long)RT, B - r0);       // rows that may start
  const int na = (int)min((long long)RT + LA, B - r0);  // rows staged
  const int n = na * fc;

  if (tid == 0) {
    s_end = B;
    s_n_starts = 0;
  }
  __syncthreads();

  // the values: 16-byte copies where the tile is one aligned stretch
  const T* tile = values + r0 * F + f0;
  if (fc == F && ((size_t)tile & 15) == 0) {
    const int per = 16 / (int)sizeof(T);
    const int n16 = n / per;
    for (int i = tid; i < n16; i += GLIA_SORTED_THREADS)
      cp_async_16(sv + i * per, tile + i * per);
    for (int i = n16 * per + tid; i < n; i += GLIA_SORTED_THREADS)
      sv[i] = tile[i];
  } else {
    for (int i = tid; i < n; i += GLIA_SORTED_THREADS) {
      const int r = i / fc;
      sv[i] = tile[(long long)r * F + (i - r * fc)];
    }
  }
  // the ids, with -1 (never a valid id) past the end, and the list of the
  // rows that start a run (in any order), one atomic per warp
  const int lane = tid & 31;
  for (int base = 0; base <= na; base += GLIA_SORTED_THREADS) {
    const int r = base + tid;
    bool start = false;
    if (r <= na) {
      // both loads at once: the one before does not wait for this one
      const long long s = (r0 + r < B) ? ids[r0 + r] : -1;
      const long long before = (r0 + r > 0) ? ids[r0 + r - 1] : -1;
      sid[r] = s;
      start = r < nr && s >= 0 && s < S && before != s;
    }
    const unsigned m = __ballot_sync(0xffffffffu, start);
    if (m) {
      const int leader = __ffs(m) - 1;
      int at = 0;
      if (lane == leader) at = atomicAdd(&s_n_starts, __popc(m));
      at = __shfl_sync(0xffffffffu, at, leader);
      if (start) starts[at + __popc(m & ((1u << lane) - 1))] = r;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // only the run that holds the tile's last row can go on past the staged
  // rows; if it does, find where it ends (all threads look at once)
  const long long s_tail = sid[na - 1];
  const bool cont = s_tail >= 0 && s_tail < S && sid[na] == s_tail &&
                    sid[nr - 1] == s_tail;
  if (cont) {
    for (long long base = r0 + na;; base += GLIA_SORTED_THREADS) {
      const long long j = base + tid;
      const bool stop = j >= B || ids[j] != s_tail;
      if (stop) atomicMin(&s_end, min(j, B));
      if (__syncthreads_or(stop)) break;
    }
  }
  const long long n_after = s_end - (r0 + na);

  const int n_starts = s_n_starts;
  // one thread per (run start, feature)
  for (int i = tid; i < n_starts * fc; i += GLIA_SORTED_THREADS) {
    const int k = i / fc;
    const int c = i - k * fc;
    const int r = starts[k];
    const long long s = sid[r];
    // the first four rows' ids at once, where the tile has them
    const bool four = r + 4 <= na;
    const long long s1 = four ? sid[r + 1] : -1;
    const long long s2 = four ? sid[r + 2] : -1;
    const long long s3 = four ? sid[r + 3] : -1;
    const T* col = sv + c;
    T acc = (T)0;
    int j = r;
    if (four) {
      // loads that wait for no test; most runs of a dedupe end here
      const T v0 = col[r * fc], v1 = col[(r + 1) * fc];
      const T v2 = col[(r + 2) * fc], v3 = col[(r + 3) * fc];
      acc += v0;
      j = r + 1;
      if (s1 == s) {
        acc += v1;
        j = r + 2;
        if (s2 == s) {
          acc += v2;
          j = r + 3;
          if (s3 == s) {
            acc += v3;
            j = r + 4;
          }
        }
      }
    }
    if (!four || j == r + 4) {
      // the ids are sorted: ids[j + 7] == s says rows j .. j + 7 are the
      // run's, so one test serves eight adds
      for (; j + 8 <= na && sid[j + 7] == s; j += 8) {
        T v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = col[(j + q) * fc];
#pragma unroll
        for (int q = 0; q < 8; ++q) acc += v[q];
      }
      for (; j < na && sid[j] == s; ++j) acc += col[j * fc];
    }
    if (j == na && cont) {
      const T* g = values + (r0 + na) * F + f0 + c;
      long long left = n_after;
      for (; left >= 16; left -= 16, g += 16 * (long long)F) {
        T v[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) v[q] = g[q * (long long)F];
#pragma unroll
        for (int q = 0; q < 16; ++q) acc += v[q];
      }
      for (; left > 0; --left, g += F) acc += *g;
    }
    out[s * F + f0 + c] = acc;
  }
}

template <typename T>
static int launch(bool sorted, const void* values, const long long* ids,
                  long long B, int F, long long S, void* out,
                  cudaStream_t stream) {
  if (sorted) {
    const int FC = F < GLIA_SORTED_MAX_COLS ? F : GLIA_SORTED_MAX_COLS;
    int RT = GLIA_SORTED_TILE_ELEMS / FC / 4 * 4;
    if (RT > GLIA_SORTED_MAX_ROWS) RT = GLIA_SORTED_MAX_ROWS;
    // a small batch gets smaller tiles, so that it still makes two blocks
    // for every SM
    int dev = 0, n_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    long long par = B / (2 * n_sm) / 4 * 4;
    if (par < GLIA_SORTED_MIN_ROWS) par = GLIA_SORTED_MIN_ROWS;
    if (RT > par) RT = (int)par;
    const int LA = RT / GLIA_SORTED_LA_DIV;
    const long long tiles = (B + RT - 1) / RT;
    const int chunks = (F + FC - 1) / FC;
    if (tiles > 2147483647LL || chunks > 65535)
      return (int)cudaErrorInvalidValue;
    const size_t smem = sorted_ids_offset<T>(RT + LA, FC) +
                        (size_t)(RT + LA + 1) * 8 + (size_t)RT * 4;
    segment_sum_sorted_kernel<T>
        <<<dim3((unsigned)tiles, (unsigned)chunks), GLIA_SORTED_THREADS, smem,
           stream>>>((const T*)values, ids, B, F, S, RT, LA, FC, (T*)out);
  } else {
    const int threads = 256;
    const long long blocks = (B * F + threads - 1) / threads;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    segment_sum_atomic_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
        (const T*)values, ids, B, F, S, (T*)out);
  }
  return (int)cudaGetLastError();
}

static int dispatch(bool sorted, const void* values, const long long* ids,
                    long long B, int F, long long S, int is_double, void* out,
                    void* stream) {
  if (B < 0 || F < 1 || S < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return is_double ? launch<double>(sorted, values, ids, B, F, S, out, st)
                   : launch<float>(sorted, values, ids, B, F, S, out, st);
}

extern "C" int glia_segment_sum(const void* values, const long long* ids,
                                long long B, int F, long long S,
                                int is_double, void* out, void* stream) {
  return dispatch(false, values, ids, B, F, S, is_double, out, stream);
}

extern "C" int glia_segment_sum_sorted(const void* values,
                                       const long long* ids, long long B,
                                       int F, long long S, int is_double,
                                       void* out, void* stream) {
  return dispatch(true, values, ids, B, F, S, is_double, out, stream);
}
