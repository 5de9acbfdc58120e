// Fused int8-weight feed-forward of the decode step, one launch:
//   h = relu((x @ w1q) * s1 + b1), rounded to the operand type,
//   y = (h @ w2q) * s2 + b2,
// x [m, k] bf16 or f32, w1q [k, ff] and w2q [ff, n] int8, s1, b1 [ff] and
// s2, b2 [n] f32, y [m, n] in x's type; f32 accumulation throughout.
//
// Replaces the TPU kernel `_kernel` of speech_tranformer_pytorch_tpu/
// kernels/int8_ffn.py:50 (entry `int8_ffn` :73). The TPU grid walked the
// ff blocks in order and carried the [m, n] sum in VMEM scratch. Blocks of
// a CUDA grid run in no order, so here each block owns one 128-column
// block j of the hidden layer, one 64-column chunk of y and 64 rows of x:
//   1. it computes its hidden block h_j [64, 128] (x and w1 chunks staged
//      in shared memory, int8 converted after the load), applies s1, b1
//      and the ReLU, rounds it to the operand type and keeps it in shared
//      memory: the [m, ff] hidden never goes to device memory (the blocks
//      of one j but other chunks compute the same h_j, from L2);
//   2. it multiplies h_j by its [128, 64] tile of w2 and writes the f32
//      partial product to a scratch [ff/128, m, n];
//   3. it signals its arrival on its chunk's counter; the last of the
//      ff/128 blocks to deliver the chunk sums the partials in the fixed
//      order j = 0, 1, ..., writes y = sum * s2 + b2 there and resets the
//      counter to 0.
// The sum's order never depends on which block finishes first, so the
// same inputs give bit-identical outputs run to run (no float atomics).
// bf16 operands multiply on the tensor cores (WMMA), f32 ones through
// FMAs.
//
// What bounds it on an H100: at decode shapes (m = 40, k 512, ff 2048,
// n 512) the bytes, mostly the two int8 weights read once (2.1 MB,
// 0.63 us at 3.35 TB/s). The kernel is far above that: each block runs a
// chain of unpipelined loads, the hidden block is recomputed once per
// chunk of y, and the partials make a round trip through L2.
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "int8_tile.cuh"

namespace {

using st::int8::Acc;
using st::int8::kThreads;

constexpr int kBM = 64, kBF = 128, kBK = 128, kBN = 64;

template <typename T>
struct Smem {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int pad = kBf16 ? 8 : 4;
  static constexpr int ldx = kBK + pad;      // x chunk [kBM, kBK]
  static constexpr int ldw1 = kBF + pad;     // w1 chunk [kBK, kBF]
  static constexpr int ldw2 = kBN + pad;     // w2 chunk [kBF, kBN]
  static constexpr int ldhf = kBF + 4;       // f32 hidden [kBM, kBF]
  static constexpr int ldh = kBF + pad;      // operand-type hidden
  static constexpr int ldc = kBN + 4;        // f32 partial chunk [kBM, kBN]
  static constexpr size_t hf_bytes = sizeof(float) * kBM * ldhf;
  // bf16 keeps a rounded copy of the hidden; f32 multiplies the f32 one.
  static constexpr size_t h_bytes = kBf16 ? sizeof(T) * kBM * ldh : 0;
  static constexpr size_t p1_bytes = sizeof(T) * (kBM * ldx + kBK * ldw1);
  static constexpr size_t p2_bytes = sizeof(T) * kBF * ldw2;
  static constexpr size_t stage_bytes = p1_bytes > p2_bytes ? p1_bytes : p2_bytes;
  // bf16 stages the partial chunk in the f32 hidden's room (free once the
  // rounded copy exists); f32 needs a room of its own.
  static constexpr size_t c_bytes = kBf16 ? 0 : sizeof(float) * kBM * ldc;
  static constexpr size_t bytes = hf_bytes + h_bytes + stage_bytes + c_bytes;
};

// y[row0 + r][n0 + c] = (sum over j = 0, 1, ... of partial[j][..]) * s2 + b2
// for the chunk's rows and columns, kV columns a thread (16-byte loads when
// kV = 4, n % 4 == 0), with up to 8 partials' loads in flight at once. The
// sum runs in the order j = 0, 1, ... whatever kV is.
template <typename T, int kV>
__device__ __forceinline__ void reduce_chunk(const float* partial, T* y, const float* s2,
                                             const float* b2, int m, int n, int n_parts,
                                             int row0, int rows, int n0) {
  using V = typename std::conditional<kV == 4, float4, float>::type;
  const int cols = min(kBN, n - n0) / kV;   // n0 % kBN == 0, so whole vectors
  const long long plane = (long long)m * n;
  for (int g = threadIdx.x; g < rows * cols; g += kThreads) {
    const int r = g / cols, c = n0 + (g - r * cols) * kV;
    const long long at = (long long)(row0 + r) * n + c;
    float sum[kV] = {};
    for (int j0 = 0; j0 < n_parts; j0 += 8) {
      V v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (j0 + u < n_parts) v[u] = __ldcg(reinterpret_cast<const V*>(partial + (j0 + u) * plane + at));
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (j0 + u >= n_parts) break;
        const float* e = reinterpret_cast<const float*>(&v[u]);
#pragma unroll
        for (int q = 0; q < kV; ++q) sum[q] += e[q];
      }
    }
#pragma unroll
    for (int q = 0; q < kV; ++q)
      y[at + q] = st::int8::to_t<T>(__fadd_rn(__fmul_rn(sum[q], s2[c + q]), b2[c + q]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_ffn_kernel(const T* __restrict__ x, const int8_t* __restrict__ w1,
                const float* __restrict__ s1, const float* __restrict__ b1,
                const int8_t* __restrict__ w2, const float* __restrict__ s2,
                const float* __restrict__ b2, T* __restrict__ y,
                float* __restrict__ partial, int* __restrict__ counters, int m,
                int k, int ff, int n, long long ldx, int xvec, int vec1, int vec2) {
  using S = Smem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int is_last;
  float* Hf = reinterpret_cast<float*>(smem);
  T* H = S::kBf16 ? reinterpret_cast<T*>(smem + S::hf_bytes) : reinterpret_cast<T*>(Hf);
  const int ldh = S::kBf16 ? S::ldh : S::ldhf;
  unsigned char* stage = smem + S::hf_bytes + S::h_bytes;
  T* Xs = reinterpret_cast<T*>(stage);
  T* W1s = Xs + kBM * S::ldx;
  T* W2s = reinterpret_cast<T*>(stage);
  float* C = S::kBf16 ? Hf : reinterpret_cast<float*>(stage + S::stage_bytes);

  const int j = blockIdx.x, n_blocks = gridDim.x, chunk = blockIdx.y;
  const int f0 = j * kBF, n0 = chunk * kBN, row0 = blockIdx.z * kBM;
  const int rows = min(kBM, m - row0);

  // 1. hidden block h_j = relu((x @ w1[:, f0:f0+kBF]) * s1 + b1).
  {
    Acc<T, kBM, kBF> acc;
    acc.zero();
    for (int k0 = 0; k0 < k; k0 += kBK) {
      st::int8::load_x<T, kBM, kBK>(Xs, S::ldx, x, ldx, row0, m, k0, k, xvec != 0);
      st::int8::load_w<T, kBK, kBF>(W1s, S::ldw1, w1, k0, k, f0, ff, vec1 != 0);
      __syncthreads();
      acc.template mma<kBK>(Xs, S::ldx, W1s, S::ldw1);
      __syncthreads();
    }
    acc.store(Hf, S::ldhf);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBF; i += kThreads) {
    const int r = i / kBF, c = i - r * kBF, f = f0 + c;
    float v = 0.f;   // hidden columns past ff meet zero rows of w2 anyway
    if (f < ff) v = fmaxf(__fadd_rn(__fmul_rn(Hf[r * S::ldhf + c], s1[f]), b1[f]), 0.f);
    H[r * ldh + c] = st::int8::to_t<T>(v);
  }
  __syncthreads();

  // 2. partial[j][:, n0:n0+kBN] = h_j @ w2[f0:f0+kBF, n0:n0+kBN].
  st::int8::load_w<T, kBF, kBN>(W2s, S::ldw2, w2, f0, ff, n0, n, vec2 != 0);
  __syncthreads();
  {
    Acc<T, kBM, kBN> acc;
    acc.zero();
    acc.template mma<kBF>(H, ldh, W2s, S::ldw2);
    acc.store(C, S::ldc);
  }
  __syncthreads();
  float* part = partial + (long long)j * m * n;
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i - r * kBN;
    if (r < rows && n0 + c < n) part[(long long)(row0 + r) * n + n0 + c] = C[r * S::ldc + c];
  }

  // 3. The last of the ff/128 blocks to deliver this chunk sums its
  // partials in the order j = 0, 1, ... and finishes y there.
  __threadfence();
  __syncthreads();
  int* counter = counters + blockIdx.z * gridDim.y + chunk;
  if (threadIdx.x == 0) is_last = atomicAdd(counter, 1) == n_blocks - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (n % 4 == 0)
    reduce_chunk<T, 4>(partial, y, s2, b2, m, n, n_blocks, row0, rows, n0);
  else
    reduce_chunk<T, 1>(partial, y, s2, b2, m, n, n_blocks, row0, rows, n0);
  if (threadIdx.x == 0) *counter = 0;
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* w1, const float* s1, const float* b1,
                   const int8_t* w2, const float* s2, const float* b2, void* y,
                   float* partial, int* counters, int m, int k, int ff, int n,
                   long long ldx, cudaStream_t stream) {
  const size_t bytes = Smem<T>::bytes;
  static bool configured = false;   // the attribute is set once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(int8_ffn_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int xvec = st::int8::vec_ok<T>(x, k, ldx);
  const int vec1 = st::int8::vec_ok<int8_t>(w1, ff, ff);
  const int vec2 = st::int8::vec_ok<int8_t>(w2, n, n);
  dim3 grid((ff + kBF - 1) / kBF, (n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int8_ffn_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), w1, s1, b1, w2, s2, b2, static_cast<T*>(y), partial,
      counters, m, k, ff, n, ldx, xvec, vec1, vec2);
  return cudaGetLastError();
}

}  // namespace

// `partial` is f32 scratch of [ceil(ff / 128), m, n]; `counters` holds
// ceil(m / 64) * ceil(n / 64) ints that are 0 at launch (the kernel leaves
// them 0).
extern "C" int st_int8_ffn(const void* x, const void* w1q, const float* s1,
                           const float* b1, const void* w2q, const float* s2,
                           const float* b2, void* y, float* partial, int* counters,
                           int m, int k, int ff, int n, long long ldx, int is_bf16,
                           cudaStream_t stream) {
  if (m < 0 || k < 0 || ff < 1 || n < 0 || ldx < k) return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  const int8_t* w1 = static_cast<const int8_t*>(w1q);
  const int8_t* w2 = static_cast<const int8_t*>(w2q);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, w1, s1, b1, w2, s2, b2, y, partial, counters, m, k,
                                 ff, n, ldx, stream);
  return launch<float>(x, w1, s1, b1, w2, s2, b2, y, partial, counters, m, k, ff, n,
                       ldx, stream);
}
