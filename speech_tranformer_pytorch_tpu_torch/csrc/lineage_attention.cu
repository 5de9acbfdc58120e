// One-query beam self-attention over the unpermuted KV cache (decode step).
//
// Replaces the TPU kernel `_kernel` / `lineage_attention`
// (speech_tranformer_pytorch_tpu/kernels/lineage_attention.py:43, :86).
// The beam search never reorders the self-attention cache; beam k of
// utterance b reads position j from cache lane lineage[b, k, j]:
//   s[j]   = q[b*K+k, h] . Kc[b*K + lineage[b,k,j], j, h] / sqrt(D),  j <= index
//   w      = softmax(s) in float32, then rounded to the cache dtype
//   out    = sum_j w[j] * Vc[b*K + lineage[b,k,j], j, h]   (f32 accumulation)
// Positions after `index` are never read (the reference masks them to
// -1e9, which contributes exactly 0 to the softmax).
//
// One block per (beam row, head); its warps take positions in turn, each
// lane holding D/32 query elements in registers, so every cache row is read
// straight from its native [B*K, L, H, D] layout with no gather and no
// relayout. What bounds it on an H100: bytes — each cache entry the beams
// select is read once for 4*D f32 operations.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxChunks = 8;   // head_dim <= 256

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
lineage_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                         const T* __restrict__ vc, const int* __restrict__ lineage,
                         T* __restrict__ out, int K, int L, int H, int D,
                         int index, float sqrt_d) {
  extern __shared__ float smem[];
  float* w = smem;               // [index + 1] scores, then weights
  float* partial = smem + L;     // [kWarps][D]
  __shared__ float red[32];
  const int row = blockIdx.x;    // b*K + k
  const int h = blockIdx.y;
  const int b = row / K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = index + 1;
  const int* lin = lineage + static_cast<size_t>(row) * L;   // [B, K, L] row

  float qr[kMaxChunks];
  const T* qp = q + (static_cast<size_t>(row) * H + h) * D;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int d = lane + 32 * c;
    qr[c] = d < D ? to_f(qp[d]) : 0.f;
  }

  for (int j = warp; j < n; j += kWarps) {
    // The beam search only writes lanes in [0, K); clamp so a bad table
    // can never read outside this utterance's cache rows.
    const int src = b * K + min(max(lin[j], 0), K - 1);
    const T* kp = kc + ((static_cast<size_t>(src) * L + j) * H + h) * D;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int d = lane + 32 * c;
      if (d < D) acc = fmaf(qr[c], to_f(kp[d]), acc);
    }
    acc = st::warp_sum(acc);
    if (lane == 0) w[j] = acc / sqrt_d;
  }
  __syncthreads();

  float m = -INFINITY;
  for (int j = threadIdx.x; j < n; j += blockDim.x) m = fmaxf(m, w[j]);
  m = st::block_reduce<true>(m, red);
  float s = 0.f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float e = expf(w[j] - m);
    w[j] = e;
    s += e;
  }
  s = st::block_reduce<false>(s, red);
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    w[j] = to_f(from_f<T>(w[j] / s));   // weights in the cache dtype
  __syncthreads();

  float acc[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) acc[c] = 0.f;
  for (int j = warp; j < n; j += kWarps) {
    const int src = b * K + min(max(lin[j], 0), K - 1);
    const T* vp = vc + ((static_cast<size_t>(src) * L + j) * H + h) * D;
    const float wj = w[j];
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int d = lane + 32 * c;
      if (d < D) acc[c] = fmaf(wj, to_f(vp[d]), acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int d = lane + 32 * c;
    if (d < D) partial[warp * D + d] = acc[c];
  }
  __syncthreads();
  T* op = out + (static_cast<size_t>(row) * H + h) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) o += partial[wi * D + d];
    op[d] = from_f<T>(o);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lineage, void* out, int batch, int beams, int L,
                   int H, int D, int index, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (L + kWarps * D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lineage_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(batch * beams, H);
  lineage_attention_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lineage, static_cast<T*>(out), beams, L, H, D,
      index, static_cast<float>(sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

}  // namespace

extern "C" int st_lineage_attention(const void* q, const void* k, const void* v,
                                    const int* lineage, void* out, int batch,
                                    int beams, int max_len, int heads,
                                    int head_dim, int index, int is_bf16,
                                    cudaStream_t stream) {
  if (head_dim > 32 * kMaxChunks || index < 0 || index >= max_len)
    return cudaErrorInvalidValue;
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, lineage, out, batch, beams,
                                         max_len, heads, head_dim, index, stream)
                 : launch<float>(q, k, v, lineage, out, batch, beams, max_len,
                                 heads, head_dim, index, stream);
}
