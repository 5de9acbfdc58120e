// Fused clip-scaled Adam over every leaf of the parameter tree, in place.
//
// Replaces the TPU kernel `_adam_kernel` / `_update_leaf`
// (speech_tranformer_pytorch_tpu/ops/fused_adam.py:46, :68). Per element:
//   g  = grad * clip_scale
//   mu = b1 mu + (1 - b1) g ;  nu = b2 nu + (1 - b2) g^2      (f32)
//   u  = (mu c1) / (sqrt(nu c2) + eps) [+ weight_decay p]
//   p -= lr u ;  mu, nu stored in their dtype (f32 or bf16, rounded to nearest)
// The four scalars [clip_scale, lr, c1, c2] are read from a device array,
// so a step never waits on the host. Every operation is an explicitly
// rounded f32 operation (no FMA contraction), the same sequence the plain
// PyTorch version runs, so the two agree bit for bit.
//
// The TPU made one launch per leaf (~100 per step at `base`, its recorded
// reason for being slower than XLA). Here one launch covers all leaves:
// a device table holds (p, g, mu, nu, numel) per leaf and every block
// walks the concatenated index space with a grid stride. What bounds it on
// an H100: bytes — g, p, mu, nu read once and p, mu, nu written once
// (20 B a parameter with bf16 moments, 28 B with f32).
//
// The master-weights variant (`st_fused_adam_master`, JAX's `updm` at
// speech_tranformer_pytorch_tpu/ops/fused_adam.py:199-210) keeps the f32
// master apart from bf16 parameters: it reads the bf16 gradient and upcasts
// it, runs the same rounded sequence against the master, and writes the
// master, the moments and the parameter as the master rounded to nearest
// bf16. Bytes: g 2, master 4 + 4, mu and nu 2 + 2 each, p 2 written
// (20 B a parameter with bf16 moments, 28 B with f32).
#include <cuda_bf16.h>

namespace {

struct Leaf {
  float* p;
  const float* g;
  void* mu;
  void* nu;
  long long n;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename M>
__device__ __forceinline__ M from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct MasterLeaf {
  __nv_bfloat16* p;
  const __nv_bfloat16* g;
  float* w;  // the f32 master
  void* mu;
  void* nu;
  long long n;
};

template <typename M>
__global__ void __launch_bounds__(256)
adam_kernel(const Leaf* __restrict__ leaves, int n_leaves,
            const float* __restrict__ scalars, float b1, float one_minus_b1,
            float b2, float one_minus_b2, float eps, float weight_decay) {
  const float scale = scalars[0], lr = scalars[1], c1 = scalars[2], c2 = scalars[3];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int li = 0; li < n_leaves; ++li) {
    const Leaf leaf = leaves[li];
    M* mu = static_cast<M*>(leaf.mu);
    M* nu = static_cast<M*>(leaf.nu);
    for (long long i = first; i < leaf.n; i += stride) {
      const float g = __fmul_rn(leaf.g[i], scale);
      const float m = __fadd_rn(__fmul_rn(to_f(mu[i]), b1), __fmul_rn(g, one_minus_b1));
      const float v = __fadd_rn(__fmul_rn(to_f(nu[i]), b2),
                                __fmul_rn(__fmul_rn(g, g), one_minus_b2));
      float u = __fdiv_rn(__fmul_rn(m, c1), __fadd_rn(__fsqrt_rn(__fmul_rn(v, c2)), eps));
      const float p = leaf.p[i];
      if (weight_decay != 0.f) u = __fadd_rn(u, __fmul_rn(p, weight_decay));
      leaf.p[i] = __fsub_rn(p, __fmul_rn(u, lr));
      mu[i] = from_f<M>(m);
      nu[i] = from_f<M>(v);
    }
  }
}

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay;
};

// One element's update of the f32 weight `p`: returns p - lr u and writes
// the new moments, every step an explicitly rounded f32 operation in the
// classic kernel's order. Only the master variant uses it: the classic
// kernel through it (p loaded before the arithmetic) ran 7 % slower on the
// `base` tree, the master variant 2 % faster on the `large` tree (PERF.md,
// kernel table row 9).
template <typename M>
__device__ __forceinline__ float adam_elem(float grad, float p, M* mu, M* nu,
                                           const float* sc, const Hyper& h) {
  const float g = __fmul_rn(grad, sc[0]);
  const float m = __fadd_rn(__fmul_rn(to_f(*mu), h.b1), __fmul_rn(g, h.one_minus_b1));
  const float v = __fadd_rn(__fmul_rn(to_f(*nu), h.b2),
                            __fmul_rn(__fmul_rn(g, g), h.one_minus_b2));
  float u = __fdiv_rn(__fmul_rn(m, sc[2]), __fadd_rn(__fsqrt_rn(__fmul_rn(v, sc[3])), h.eps));
  if (h.weight_decay != 0.f) u = __fadd_rn(u, __fmul_rn(p, h.weight_decay));
  *mu = from_f<M>(m);
  *nu = from_f<M>(v);
  return __fsub_rn(p, __fmul_rn(u, sc[1]));
}

template <typename M>
__global__ void __launch_bounds__(256)
adam_master_kernel(const MasterLeaf* __restrict__ leaves, int n_leaves,
                   const float* __restrict__ scalars, Hyper h) {
  const float sc[4] = {scalars[0], scalars[1], scalars[2], scalars[3]};
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int li = 0; li < n_leaves; ++li) {
    const MasterLeaf leaf = leaves[li];
    M* mu = static_cast<M*>(leaf.mu);
    M* nu = static_cast<M*>(leaf.nu);
    for (long long i = first; i < leaf.n; i += stride) {
      const float w = adam_elem<M>(__bfloat162float(leaf.g[i]), leaf.w[i], mu + i, nu + i,
                                   sc, h);
      leaf.w[i] = w;
      leaf.p[i] = __float2bfloat16_rn(w);
    }
  }
}

// Enough blocks to keep every SM's memory pipe busy; the grid stride
// covers the largest leaf.
int adam_blocks(long long max_numel, int threads) {
  const long long want = (max_numel + threads - 1) / threads;
  return static_cast<int>(want < 132 * 16 ? want : 132 * 16);
}

}  // namespace

// `leaves` is a device array of n_leaves (p, g, mu, nu, numel) records,
// each five int64; `scalars` a device array [clip_scale, lr, c1, c2].
extern "C" int st_fused_adam(const void* leaves, int n_leaves, long long max_numel,
                             const float* scalars, float b1, float one_minus_b1,
                             float b2, float one_minus_b2, float eps,
                             float weight_decay, int bf16_moments,
                             cudaStream_t stream) {
  if (n_leaves <= 0 || max_numel <= 0) return cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  const int blocks = adam_blocks(max_numel, kThreads);
  const Leaf* table = static_cast<const Leaf*>(leaves);
  if (bf16_moments)
    adam_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        table, n_leaves, scalars, b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay);
  else
    adam_kernel<float><<<blocks, kThreads, 0, stream>>>(
        table, n_leaves, scalars, b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay);
  return cudaGetLastError();
}

// The master-weights variant: `leaves` holds n_leaves (p, g, master, mu, nu,
// numel) records, each six int64; p and g are bf16, the master f32.
extern "C" int st_fused_adam_master(const void* leaves, int n_leaves, long long max_numel,
                                    const float* scalars, float b1, float one_minus_b1,
                                    float b2, float one_minus_b2, float eps,
                                    float weight_decay, int bf16_moments,
                                    cudaStream_t stream) {
  if (n_leaves <= 0 || max_numel <= 0) return cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  const int blocks = adam_blocks(max_numel, kThreads);
  const MasterLeaf* table = static_cast<const MasterLeaf*>(leaves);
  const Hyper h{b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay};
  if (bf16_moments)
    adam_master_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        table, n_leaves, scalars, h);
  else
    adam_master_kernel<float><<<blocks, kThreads, 0, stream>>>(table, n_leaves, scalars, h);
  return cudaGetLastError();
}
