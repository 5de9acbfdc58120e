// Fused beam-candidate scoring and top-k2 (one beam-search step's prune).
//
// Replaces the TPU kernel `_kernel` / `candidate_topk_rows` and the merge in
// `candidate_topk` (speech_tranformer_pytorch_tpu/kernels/beam_prune.py:36,
// :68, :93). For logits [B*K, V] and running beam scores alive [B, K]:
//   cand[b, k, v] = log_softmax(logits[b*K + k])[v] + alive[b, k], with the
//   <pad> and <sos> columns set to -1e9 before the add;
//   out = the k2 best of cand[b] over the flat index k*V + v, ties to the
//   lowest flat index (the order of a stable descending sort).
// Two launches: `row_topk_kernel` (one block per row) stages the row in
// shared memory, takes the log-softmax, then extracts its k2 best by
// repeated block argmax (value desc, index asc), consuming each winner with
// -inf (not -1e9, which real banned or dead-beam candidates carry);
// `merge_kernel` (one warp per utterance) merges the K*k2 row winners the
// same way. Exact: each row contributes at most k2 entries to its
// utterance's top-k2, so the merge sees every global winner.
//
// What bounds it on an H100: bytes — each logit is read once (V*4 bytes per
// row) for ~(5 + k2) f32 operations; the row lives in shared memory, so the
// k2 extraction passes cost no device-memory traffic.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
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

extern "C" int st_beam_prune(const float* logits, const float* alive,
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
