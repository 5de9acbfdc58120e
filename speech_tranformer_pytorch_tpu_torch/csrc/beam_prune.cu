// Fused beam-candidate scoring and top-k2 (one beam-search step's prune).
//
// Replaces the TPU kernel `_kernel` / `candidate_topk_rows` and the merge in
// `candidate_topk` (speech_tranformer_pytorch_tpu/kernels/beam_prune.py:36,
// :68, :93). For logits [B*K, V] and running beam scores alive [B, K]:
//   cand[b, k, v] = log_softmax(logits[b*K + k])[v] + alive[b, k], with the
//   <pad> and <sos> columns set to -1e9 before the add;
//   out = the k2 best of cand[b] over the flat index k*V + v, ties to the
//   lowest flat index (the order of a stable descending sort).
//
// What bounds it on an H100: bytes, one read of the logits (V*4 bytes a
// row) for ~(5 + k2) f32 operations an element: 0.2 us for [40, 4336]. At
// that size the time is latency: launches, barriers and dependent rounds.
// So `beam_prune_cluster_kernel` is one launch, one thread-block cluster
// of K blocks per utterance, one block per beam row, with no serial
// extraction rounds:
//  * the block stages its row in shared memory with 16-byte loads (scalar
//    head and tail where the row is not 16-byte aligned), takes the row's
//    max and log-sum-exp (two block reductions), and forms each candidate
//    as ((x - max) - lse) + alive, -1e9 + alive for the banned columns;
//  * a bound: each lane's best candidate, ranked within its warp by
//    shuffles; the lane best of rank k2 - 1 has k2 candidates at least as
//    good, so the block's k2 best are at least as good as the best of the
//    warps' bounds. Only candidates that good are kept (compacted in
//    thread order by a warp scan: a few dozen on random logits, at most
//    the elements of 8 k2 lanes, the size of the buffer);
//  * each kept candidate counts the kept ones that beat it; rank r < k2
//    goes to slot beam*k2 + r of rank 0's shared memory (DSMEM), with
//    flat index beam*V + v; after a cluster barrier rank 0 ranks the K*k2
//    winners the same way and writes the output.
// (value desc, index asc) is a strict total order on distinct indices, so
// ranks are distinct and every level is exact: the result equals a stable
// sort's, with no global scratch and no atomics. The wrapper takes this
// kernel for K <= 8 (the portable cluster size) and k2 <= 16, every beam
// up to 8, when the row and its buffer fit one block's shared memory.
//
// Larger shapes go to the first version, two launches joined by global
// scratch: `row_topk_kernel` (one block per row) extracts each row's k2
// best by repeated block argmax, consuming each winner with -inf (not
// -1e9, which real banned or dead-beam candidates carry); `merge_kernel`
// (one warp per utterance) merges the K*k2 row winners the same way.
#include <climits>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBeams = 8;    // the portable cluster size
constexpr int kMaxK2 = 16;
constexpr float kNegInf = -1.0e9f;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// ----------------------------------------------------- cluster kernel
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, int v) {
  asm volatile("st.shared::cluster.s32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

// The most candidates a block can keep: only lanes whose best is at least
// the bound hold candidates, at most k2 of them a warp, each with at most
// 4 ceil(V / 4 / kThreads) + 2 elements (its vectors, a head and a tail
// element).
__host__ __device__ inline int candidate_cap(int V, int k2) {
  return kWarps * k2 * (4 * ((V / 4 + kThreads - 1) / kThreads) + 2);
}

__global__ void __launch_bounds__(kThreads)
beam_prune_cluster_kernel(const float* __restrict__ logits, const float* __restrict__ alive,
                          float* __restrict__ vals, int* __restrict__ idx, int V, int K,
                          int k2, int pad_id, int sos_id) {
  extern __shared__ __align__(16) float xs[];   // row value j at xs[j + 4 - head]
  __shared__ float red[32];
  __shared__ float bound_v[kWarps];
  __shared__ int bound_i[kWarps];
  __shared__ int warp_count[kWarps];
  __shared__ float beam_v[kMaxBeams * kMaxK2];   // rank 0: every block's winners
  __shared__ int beam_i[kMaxBeams * kMaxK2];
  // Every block of the cluster must be running before its shared memory
  // is written: arrive now, wait just before the DSMEM stores.
  st::cluster_arrive();

  const int row = blockIdx.x;
  const int beam = row % K;   // the block's rank in its cluster
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* in = logits + static_cast<size_t>(row) * V;
  const int head = min(V, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(in) & 15)) & 15) >> 2));
  const int n_vec = (V - head) >> 2;
  const int tail0 = head + 4 * n_vec;
  float* x = xs + 4 - head;   // x[j] for j in [0, V); x + head is 16-byte aligned
  float* cand_v = xs + V + 4;
  int* cand_i = reinterpret_cast<int*>(cand_v + candidate_cap(V, k2));

  // Each thread touches only its own elements: head j < head, vectors
  // c = tid, tid + 256, ..., tail j = tail0 + tid.
  float m = -INFINITY;
  if (tid < head) {
    const float v = in[tid];
    x[tid] = v;
    m = v;
  }
  const float4* in4 = reinterpret_cast<const float4*>(in + head);
  float4* x4 = reinterpret_cast<float4*>(x + head);
#pragma unroll 4
  for (int c = tid; c < n_vec; c += kThreads) {
    const float4 q = in4[c];
    x4[c] = q;
    m = fmaxf(m, fmaxf(fmaxf(q.x, q.y), fmaxf(q.z, q.w)));
  }
  if (tail0 + tid < V) {
    const float v = in[tail0 + tid];
    x[tail0 + tid] = v;
    m = fmaxf(m, v);
  }
  m = st::block_reduce<true>(m, red);

  auto for_own = [&](auto&& fn) {
    if (tid < head) fn(tid);
#pragma unroll 2
    for (int c = tid; c < n_vec; c += kThreads) {
      const int j = head + 4 * c;
      fn(j);
      fn(j + 1);
      fn(j + 2);
      fn(j + 3);
    }
    if (tail0 + tid < V) fn(tail0 + tid);
  };
  float s = 0.f;
  for_own([&](int j) { s += expf(x[j] - m); });
  s = st::block_reduce<false>(s, red);
  const float lse = logf(s);
  const float a = alive[row];

  // The candidates, over the row in shared memory, and this lane's best.
  float bv = -INFINITY;
  int bi = INT_MAX;
  for_own([&](int j) {
    float v = (x[j] - m) - lse;
    if (j == pad_id || j == sos_id) v = kNegInf;
    v += a;
    x[j] = v;
    if (better(v, j, bv, bi)) {
      bv = v;
      bi = j;
    }
  });
  // A bound: in each warp, the lane best of rank k2 - 1 among its 32 (k2
  // lane bests, so k2 distinct candidates, are at least as good); the
  // block's k2 best are at least as good as the best of these.
  int rank = 0;
#pragma unroll
  for (int u = 1; u < 32; ++u) {
    const int src = (lane + u) & 31;
    const float ov = __shfl_sync(0xffffffffu, bv, src);
    const int oi = __shfl_sync(0xffffffffu, bi, src);
    rank += better(ov, oi, bv, bi);
  }
  if (lane == 0) {
    bound_v[warp] = -INFINITY;   // fewer than k2 lanes with elements: no bound
    bound_i[warp] = INT_MAX;
  }
  __syncwarp();
  if (rank == k2 - 1 && bi != INT_MAX) {
    bound_v[warp] = bv;
    bound_i[warp] = bi;
  }
  __syncthreads();
  float lim_v = bound_v[0];
  int lim_i = bound_i[0];
  for (int w = 1; w < kWarps; ++w) {
    if (better(bound_v[w], bound_i[w], lim_v, lim_i)) {
      lim_v = bound_v[w];
      lim_i = bound_i[w];
    }
  }
  // Compact the candidates at least as good as the bound, in thread
  // order (a warp scan of the counts, then the warps' totals).
  int count = 0;
  for_own([&](int j) { count += !better(lim_v, lim_i, x[j], j); });
  int incl = count;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_count[warp] = incl;
  __syncthreads();
  int pos = incl - count, n_cand = 0;
  for (int w = 0; w < kWarps; ++w) {
    pos += w < warp ? warp_count[w] : 0;
    n_cand += warp_count[w];
  }
  for_own([&](int j) {
    if (!better(lim_v, lim_i, x[j], j)) {
      cand_v[pos] = x[j];
      cand_i[pos] = j;
      ++pos;
    }
  });
  __syncthreads();

  // The block's k2 best by rank: the candidate with r better ones goes to
  // slot r of rank 0's list (indices are distinct, so ranks are too).
  st::cluster_wait();
  for (int t = tid; t < n_cand; t += kThreads) {
    const float v = cand_v[t];
    const int i = cand_i[t];
    int r = 0;
#pragma unroll 4
    for (int u = 0; u < n_cand; ++u) r += better(cand_v[u], cand_i[u], v, i);
    if (r < k2) {
      const uint32_t slot = beam * k2 + r;
      st_cluster(st::map_rank(st::smem_u32(&beam_v[slot]), 0), v);
      st_cluster(st::map_rank(st::smem_u32(&beam_i[slot]), 0), beam * V + i);
    }
  }
  st::cluster_arrive();
  st::cluster_wait();

  if (beam == 0 && tid < K * k2) {
    const float v = beam_v[tid];
    const int i = beam_i[tid];
    int r = 0;
#pragma unroll 4
    for (int u = 0; u < K * k2; ++u) r += better(beam_v[u], beam_i[u], v, i);
    if (r < k2) {
      const int b = row / K;
      vals[static_cast<size_t>(b) * k2 + r] = v;
      idx[static_cast<size_t>(b) * k2 + r] = i;
    }
  }
}

cudaError_t launch_cluster(const float* logits, const float* alive, float* vals, int* idx,
                           int batch, int beams, int vocab, int k2, int pad_id, int sos_id,
                           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (vocab + 4 + 2 * candidate_cap(vocab, k2));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_prune_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * beams);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = beams;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, beam_prune_cluster_kernel, logits, alive,
                                             vals, idx, vocab, beams, k2, pad_id, sos_id);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ----------------------------------------------- two-launch kernels
__global__ void __launch_bounds__(kThreads)
row_topk_kernel(const float* __restrict__ logits, const float* __restrict__ alive,
                float* __restrict__ row_vals, int* __restrict__ row_idx, int V,
                int k2, int pad_id, int sos_id) {
  extern __shared__ float x[];   // [V] this row's candidate scores
  __shared__ float red[32];
  __shared__ float arg_v[32];
  __shared__ int arg_i[32];
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const float* in = logits + static_cast<size_t>(row) * V;

  float m = -INFINITY;
  for (int j = threadIdx.x; j < V; j += blockDim.x) {
    const float v = in[j];
    x[j] = v;
    m = fmaxf(m, v);
  }
  m = st::block_reduce<true>(m, red);
  float s = 0.f;
  for (int j = threadIdx.x; j < V; j += blockDim.x) s += expf(x[j] - m);
  s = st::block_reduce<false>(s, red);
  const float lse = logf(s);
  const float a = alive[row];
  for (int j = threadIdx.x; j < V; j += blockDim.x) {
    float v = (x[j] - m) - lse;
    if (j == pad_id || j == sos_id) v = kNegInf;
    x[j] = v + a;
  }
  __syncthreads();

  for (int r = 0; r < k2; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int j = threadIdx.x; j < V; j += blockDim.x) {
      if (better(x[j], j, bv, bi)) {
        bv = x[j];
        bi = j;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      arg_v[warp] = bv;
      arg_i[warp] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < n_warps; ++w) {
        if (better(arg_v[w], arg_i[w], bv, bi)) {
          bv = arg_v[w];
          bi = arg_i[w];
        }
      }
      row_vals[static_cast<size_t>(row) * k2 + r] = bv;
      row_idx[static_cast<size_t>(row) * k2 + r] = bi;
      x[bi] = -INFINITY;
    }
    __syncthreads();
  }
}

// One warp per utterance: merge K rows of k2 winners into the top-k2 over
// the flat index k*V + v.
__global__ void merge_kernel(const float* __restrict__ row_vals,
                             const int* __restrict__ row_idx,
                             float* __restrict__ vals, int* __restrict__ idx,
                             int K, int V, int k2) {
  extern __shared__ float cand_v[];   // [K*k2], then [K*k2] flat indices
  int* cand_i = reinterpret_cast<int*>(cand_v + K * k2);
  const int b = blockIdx.x;
  const int n = K * k2;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int beam = c / k2;
    cand_v[c] = row_vals[static_cast<size_t>(b) * n + c];
    cand_i[c] = beam * V + row_idx[static_cast<size_t>(b) * n + c];
  }
  __syncwarp();
  for (int r = 0; r < k2; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX, bc = -1;
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      if (better(cand_v[c], cand_i[c], bv, bi)) {
        bv = cand_v[c];
        bi = cand_i[c];
        bc = c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
        bc = oc;
      }
    }
    if (threadIdx.x == 0) {
      vals[static_cast<size_t>(b) * k2 + r] = bv;
      idx[static_cast<size_t>(b) * k2 + r] = bi;
      cand_v[bc] = -INFINITY;
      cand_i[bc] = INT_MAX;
    }
    __syncwarp();
  }
}

}  // namespace

// One launch: K <= 8 beams, k2 <= 16.
extern "C" int st_beam_prune(const float* logits, const float* alive, float* vals,
                             int* idx, int batch, int beams, int vocab, int k2,
                             int pad_id, int sos_id, cudaStream_t stream) {
  if (beams < 1 || beams > kMaxBeams || k2 < 1 || k2 > kMaxK2) return cudaErrorInvalidValue;
  return launch_cluster(logits, alive, vals, idx, batch, beams, vocab, k2, pad_id, sos_id,
                        stream);
}

// Two launches joined by row scratch, for any K and k2.
extern "C" int st_beam_prune_rows(const float* logits, const float* alive,
                             float* row_vals, int* row_idx, float* vals,
                             int* idx, int batch, int beams, int vocab, int k2,
                             int pad_id, int sos_id, cudaStream_t stream) {
  const size_t smem = sizeof(float) * vocab;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        row_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  row_topk_kernel<<<batch * beams, kThreads, smem, stream>>>(
      logits, alive, row_vals, row_idx, vocab, k2, pad_id, sos_id);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t merge_smem = (sizeof(float) + sizeof(int)) * beams * k2;
  merge_kernel<<<batch, 32, merge_smem, stream>>>(row_vals, row_idx, vals, idx,
                                                  beams, vocab, k2);
  return cudaGetLastError();
}
