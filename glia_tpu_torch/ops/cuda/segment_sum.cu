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
//                            is not checked here).  The thread of the first
//                            row of a run of equal ids adds the run's rows
//                            in index order, starting from zero, and writes
//                            once; every other thread returns.  No atomics:
//                            two launches give the same bits, and the order
//                            is that of a sequential loop over the rows.
//
// Bound.  Bytes: each value and id read once, each output written once; no
// arithmetic to speak of (one add per value).  The atomic form is limited
// by contention when many rows share a segment; the sorted form by its
// longest run, which one thread walks alone (runs are short where the merge
// engine calls it: duplicate region pairs).  A warp per run and a
// segmented scan for long runs are left for later work.

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

template <typename T>
__global__ void segment_sum_sorted_kernel(
    const T* __restrict__ values, const long long* __restrict__ ids,
    long long B, int F, long long S, T* __restrict__ out) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= B * F) return;
  const long long i = idx / F;
  const int f = (int)(idx - i * F);
  const long long s = ids[i];
  if (s < 0 || s >= S) return;
  if (i > 0 && ids[i - 1] == s) return;
  T acc = (T)0;
  for (long long j = i; j < B && ids[j] == s; ++j) acc += values[j * F + f];
  out[s * F + f] = acc;
}

template <typename T>
static int launch(bool sorted, const void* values, const long long* ids,
                  long long B, int F, long long S, void* out,
                  cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (B * F + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (sorted) {
    segment_sum_sorted_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
        (const T*)values, ids, B, F, S, (T*)out);
  } else {
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
