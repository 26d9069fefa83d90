// Random-forest vote fractions on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel glia_tpu/ops/pallas/forest.py ::
// forest_votes_pallas_fn.  Semantics are classForest's
// (code/ml/rf/rf.hxx:362-372): every tree is walked from its root,
// descending left iff x[feature] <= threshold compared in fp32; a sample
// that reaches a leaf (feature < 0) stops; after at most max_depth + 1
// steps the tree votes the class of the node it stands on; the output is
// votes[c] * fl32(1 / T), bit for bit what glia_tpu computes for
// votes / T (XLA turns a division by a constant into a multiplication by
// its reciprocal, which differs from IEEE count / T in the last bit for
// some counts).
//
// Design.  The TPU kernel packs every tree level by level because the TPU
// has no fast dynamic gather.  A GPU gathers, so this kernel walks the flat
// node arrays directly: one thread per sample, a loop over the T trees, a
// loop over the levels of each tree.  Votes are counted per class in
// registers (no atomics), so the result is deterministic.  The file is
// built without --use_fast_math, so 1 / T is correctly rounded.
//
// Bound.  The work is a dependent chain of gathers: per (sample, tree) one
// read of the node's feature, threshold and child index and one read of the
// sample's feature value, for every level the walk descends.  The node
// tables (a few MB at 255 trees) fit in the 50 MB L2; the chain's latency,
// not HBM bandwidth or arithmetic, bounds this simple form.  Staging tables
// in shared memory, a warp per block of samples, and compacting the batch
// to the valid candidates are left for later work.

#include <cuda_runtime.h>

#define GLIA_MAX_CLASSES 8

__global__ void forest_votes_kernel(
    const float* __restrict__ X, int B, int D,
    const int* __restrict__ feature, const float* __restrict__ threshold,
    const int* __restrict__ left, const int* __restrict__ right,
    const int* __restrict__ leaf_class, int T, int N, int C, int n_steps,
    float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* x = X + (long long)b * D;
  int counts[GLIA_MAX_CLASSES];
#pragma unroll
  for (int c = 0; c < GLIA_MAX_CLASSES; ++c) counts[c] = 0;

  for (int t = 0; t < T; ++t) {
    const long long base = (long long)t * N;
    int node = 0;
    for (int s = 0; s < n_steps; ++s) {
      const int f = __ldg(feature + base + node);
      if (f < 0) break;
      const float v = __ldg(x + f);
      node = (v <= __ldg(threshold + base + node))
                 ? __ldg(left + base + node)
                 : __ldg(right + base + node);
    }
    const int cls = __ldg(leaf_class + base + node);
    // compare against every class instead of counts[cls] so the counters
    // stay in registers (a dynamic index would put them in local memory)
#pragma unroll
    for (int c = 0; c < GLIA_MAX_CLASSES; ++c) counts[c] += (cls == c);
  }
  const float inv_t = 1.0f / (float)T;
  for (int c = 0; c < C; ++c) out[(long long)b * C + c] = (float)counts[c] * inv_t;
}

extern "C" int glia_forest_votes(
    const float* X, int B, int D, const int* feature, const float* threshold,
    const int* left, const int* right, const int* leaf_class, int T, int N,
    int C, int n_steps, float* out, void* stream) {
  if (C < 1 || C > GLIA_MAX_CLASSES) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  forest_votes_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      X, B, D, feature, threshold, left, right, leaf_class, T, N, C, n_steps,
      out);
  return (int)cudaGetLastError();
}
