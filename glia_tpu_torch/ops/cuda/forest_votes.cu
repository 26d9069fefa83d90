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
// some counts).  The file is built without --use_fast_math, so 1 / T is
// correctly rounded.
//
// Bound.  By bytes the work is small (X once, each real node once, the
// output once: microseconds), and one compare per step is less still.  What
// costs is the walk: every step is two dependent gathers (the node, then
// the sample's value of the node's feature), a few thousand of them in a
// row per sample.  Walked from L2 with one thread per sample, as this
// kernel first did, the card waits on a round trip per gather with few
// warps in flight, and the time does not fall with the batch.
//
// Design.  The TPU kernel packs every tree level by level because the TPU
// has no fast dynamic gather.  A GPU gathers, so this kernel walks node
// records, and keeps everything a step touches in shared memory:
//
//   - a node is one 16-byte record {feature, threshold bits, left, right}
//     (a leaf: feature = -1, class in the left field), the real nodes of
//     the trees back to back (models/forest.py :: pack_nodes), so a step's
//     node is one 16-byte load;
//   - a block of 1024 threads takes a tile of TS samples (256 when the rows
//     fit) and stages their rows of X once, the row stride padded to an odd
//     number of words so that lanes reading different features of
//     neighbouring samples spread over the banks;
//   - threads are (sample, tree lane) pairs, 1024 / TS tree lanes; the lanes
//     of a warp are neighbouring samples on the same tree, so the top levels
//     of a tree are broadcasts;
//   - the trees come in stages of G consecutive trees whose records fit one
//     of two buffers; while a stage is walked the next one is copied in with
//     cp.async (16 bytes a thread), one __syncthreads per stage;
//   - blockIdx.y splits the stages across blocks so that a small batch also
//     fills the SMs.  Votes are integer counts in registers, added across
//     tree lanes in shared memory and across blocks with integer atomicAdd
//     on a zeroed int32 [B, C] scratch; the last block of a sample tile to
//     arrive (a ticket counter per tile) multiplies by fl32(1 / T).  Integer
//     adds are exact in any order: the result is the same on every launch.
//
// A forest whose largest tree does not fit a buffer beside the smallest X
// tile (or whose rows are too wide for one) takes the kernel's other
// instantiation: the same threads, votes and tickets, with the records and
// X read through the read-only cache from global memory.
//
// The launch geometry is planned in Python (ops/cuda/__init__.py ::
// forest_launch_plan for TS, G and the buffers' size, forest_splits for the
// split), where the CPU tests reach it; the entry point checks it against
// the device's limits.

#include <cuda_runtime.h>

#define GLIA_MAX_CLASSES 8
#define GLIA_THREADS 1024

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct ForestArgs {
  const float* X;          // [B, D]
  const int4* packed;      // node records, trees back to back
  const int* tree_start;   // [T + 1] first record of each tree
  const int* leaf_class;   // flat [T * N]: class of a node that is no leaf
  int* counts;             // [B, C] zeroed scratch
  unsigned* tickets;       // [tiles] zeroed scratch
  float* out;              // [B, C]
  int B, D, T, N, C, n_steps;
  int ts_log2;             // log2 of the samples in a tile
  int x_stride;            // words between two rows of the X tile (odd)
  int G;                   // trees in a stage
  int buf_nodes;           // records one stage buffer holds
  int tree_words;          // words reserved for tree_start (multiple of 4)
  int n_splits;            // blocks that share a sample tile's stages
};

// STAGED: records and X in shared memory; otherwise both from global memory.
template <bool STAGED>
__global__ void __launch_bounds__(GLIA_THREADS, 1)
forest_votes_kernel(const ForestArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_votes = (int*)smem;                       // [TS, 8]
  const int TS = 1 << a.ts_log2;
  const int TL = GLIA_THREADS >> a.ts_log2;
  int* s_tree = s_votes + TS * GLIA_MAX_CLASSES;   // [T + 1], STAGED only
  int4* s_nodes = (int4*)(s_tree + a.tree_words);  // two buffers
  float* s_x = (float*)(s_nodes + 2 * a.buf_nodes);
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int sample = tid & (TS - 1);
  const int lane = tid >> a.ts_log2;
  const long long b0 = (long long)blockIdx.x * TS;
  const long long b = b0 + sample;
  const bool live = b < a.B;
  const int rows = (int)min((long long)TS, a.B - b0);
  const int n_stages = (a.T + a.G - 1) / a.G;

  int counts[GLIA_MAX_CLASSES];
#pragma unroll
  for (int c = 0; c < GLIA_MAX_CLASSES; ++c) counts[c] = 0;
  for (int i = tid; i < TS * GLIA_MAX_CLASSES; i += GLIA_THREADS)
    s_votes[i] = 0;

  if (STAGED) {
    for (int i = tid; i <= a.T; i += GLIA_THREADS)
      s_tree[i] = a.tree_start[i];
    __syncthreads();
    // the tile's rows of X, 4 bytes a copy (the padded stride breaks
    // 16-byte alignment), all in flight at once
    const float* xg = a.X + b0 * a.D;
    for (int i = tid; i < rows * a.D; i += GLIA_THREADS) {
      const int r = i / a.D;
      cp_async_4(s_x + r * a.x_stride + (i - r * a.D), xg + i);
    }
  }

  // copy stage `stage`'s records into buffer `buf`
  auto stage_in = [&](int stage, int buf) {
    const int t0 = stage * a.G;
    const int n0 = s_tree[t0];
    const int n = s_tree[min(a.T, t0 + a.G)] - n0;
    const int4* src = a.packed + n0;
    int4* dst = s_nodes + buf * a.buf_nodes;
    for (int i = tid; i < n; i += GLIA_THREADS) cp_async_16(dst + i, src + i);
  };

  int stage = blockIdx.y;
  if (STAGED) {
    if (stage < n_stages) stage_in(stage, 0);
    cp_async_commit();
  }
  for (int buf = 0; stage < n_stages; stage += a.n_splits, buf ^= 1) {
    if (STAGED) {
      // this stage's records (and, the first time, X) have landed, and
      // every thread is done with the other buffer: refill it
      cp_async_wait_all();
      __syncthreads();
      if (stage + a.n_splits < n_stages) stage_in(stage + a.n_splits, buf ^ 1);
      cp_async_commit();
    }
    const int t0 = stage * a.G;
    const int nt = min(a.T, t0 + a.G) - t0;
    if (live) {
      for (int k = lane; k < nt; k += TL) {
        const int t = t0 + k;
        int node = 0;
        int4 nd;
        if (STAGED) {
          const int4* tr =
              s_nodes + buf * a.buf_nodes + (s_tree[t] - s_tree[t0]);
          const float* x = s_x + sample * a.x_stride;
          nd = tr[0];
          for (int s = 0; s < a.n_steps && nd.x >= 0; ++s) {
            node = (x[nd.x] <= __int_as_float(nd.y)) ? nd.z : nd.w;
            nd = tr[node];
          }
        } else {
          const int4* tr = a.packed + __ldg(a.tree_start + t);
          const float* x = a.X + b * a.D;
          nd = __ldg(tr);
          for (int s = 0; s < a.n_steps && nd.x >= 0; ++s) {
            node = (__ldg(x + nd.x) <= __int_as_float(nd.y)) ? nd.z : nd.w;
            nd = __ldg(tr + node);
          }
        }
        // a walk cut short by n_steps stands on a split node, whose class
        // only the flat table has
        const int cls = nd.x < 0
                            ? nd.z
                            : __ldg(a.leaf_class + (long long)t * a.N + node);
        // compare against every class instead of counts[cls] so the
        // counters stay in registers
#pragma unroll
        for (int c = 0; c < GLIA_MAX_CLASSES; ++c) counts[c] += (cls == c);
      }
    }
  }
  if (STAGED) cp_async_wait_all();
  __syncthreads();

  // votes: across tree lanes in shared memory, across blocks in the scratch
  if (live) {
#pragma unroll
    for (int c = 0; c < GLIA_MAX_CLASSES; ++c)
      if (counts[c]) atomicAdd(s_votes + sample * GLIA_MAX_CLASSES + c,
                               counts[c]);
  }
  __syncthreads();
  for (int i = tid; i < rows * a.C; i += GLIA_THREADS) {
    const int r = i / a.C;
    const int v = s_votes[r * GLIA_MAX_CLASSES + (i - r * a.C)];
    if (v) atomicAdd(a.counts + b0 * a.C + i, v);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(a.tickets + blockIdx.x, 1u) ==
             (unsigned)(a.n_splits - 1);
  __syncthreads();
  if (!s_last) return;
  // the last block of this tile: every other block's adds are visible
  __threadfence();
  const float inv_t = 1.0f / (float)a.T;
  for (int i = tid; i < rows * a.C; i += GLIA_THREADS)
    a.out[b0 * a.C + i] = (float)__ldcg(a.counts + b0 * a.C + i) * inv_t;
}

// The device's SM count and the shared memory one block may ask for.
extern "C" int glia_forest_votes_limits(int* n_sm, int* max_smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

// scratch: int32 [B * C + tiles], zeroed by the caller on the same stream.
// staged, ts_log2, x_stride, G, buf_nodes, n_splits: the launch plan.
extern "C" int glia_forest_votes(
    const float* X, int B, int D, const void* packed, const int* tree_start,
    const int* leaf_class, int T, int N, int C, int n_steps, int staged,
    int ts_log2, int x_stride, int G, int buf_nodes, int n_splits,
    int* scratch, float* out, void* stream) {
  if (C < 1 || C > GLIA_MAX_CLASSES || T < 1 || D < 1 || B < 0)
    return (int)cudaErrorInvalidValue;
  if (ts_log2 < 5 || ts_log2 > 8 || G < 1 || n_splits < 1 ||
      n_splits > (T + G - 1) / G || n_splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (((size_t)packed & 15) != 0) return (int)cudaErrorMisalignedAddress;
  if (B == 0) return 0;
  const int TS = 1 << ts_log2;
  const long long tiles = ((long long)B + TS - 1) / TS;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  ForestArgs a;
  a.X = X;
  a.packed = (const int4*)packed;
  a.tree_start = tree_start;
  a.leaf_class = leaf_class;
  a.counts = scratch;
  a.tickets = (unsigned*)(scratch + (long long)B * C);
  a.out = out;
  a.B = B; a.D = D; a.T = T; a.N = N; a.C = C; a.n_steps = n_steps;
  a.ts_log2 = ts_log2;
  a.n_splits = n_splits;
  a.G = G;
  size_t smem = (size_t)TS * GLIA_MAX_CLASSES * sizeof(int);
  if (staged) {
    if (x_stride < D || buf_nodes < 1) return (int)cudaErrorInvalidValue;
    a.x_stride = x_stride;
    a.buf_nodes = buf_nodes;
    a.tree_words = (T + 1 + 3) / 4 * 4;
    smem += (size_t)a.tree_words * 4 + (size_t)2 * buf_nodes * 16 +
            (size_t)TS * x_stride * 4;
  } else {
    a.x_stride = D;
    a.buf_nodes = 0;
    a.tree_words = 0;
  }
  const dim3 grid((unsigned)tiles, (unsigned)n_splits);
  cudaError_t e;
  if (staged) {
    e = cudaFuncSetAttribute(forest_votes_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    forest_votes_kernel<true>
        <<<grid, GLIA_THREADS, smem, (cudaStream_t)stream>>>(a);
  } else {
    forest_votes_kernel<false>
        <<<grid, GLIA_THREADS, smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
