// Int8-weight matmul of the decode step: y[m, n] = (x[m, k] @ wq[k, n]) *
// scale[n], f32 accumulation, the f32 scale on the accumulator, y in x's
// type (bf16 or f32).
//
// Replaces the TPU kernel `_kernel` of speech_tranformer_pytorch_tpu/
// kernels/int8_matmul.py:52 (entry `int8_matmul` :61). The TPU kernel
// kept x whole in VMEM and streamed [k, 512] weight tiles; it always ran
// bf16 operands. Here the operands follow x: bf16 x multiplies on the
// tensor cores (WMMA, int8 values are exact in bf16), f32 x through f32
// FMAs, so an f32 model keeps f32 operands as the JAX reference does.
//
// Design. One 128-thread block owns a 64 x 16 tile of y and walks k in
// chunks of 256 (two at the decode shapes): it stages the x chunk and the int8 weight chunk in shared
// memory, converting int8 to the operand type after the load, so device
// memory serves the weight as int8 bytes. Accumulators stay in registers
// across the k loop; the epilogue multiplies by the column scale and
// writes y. m, k and n are arbitrary (ragged edges zero-filled on load and
// masked on store); there is no padding of m and no size gate.
//
// What bounds it on an H100: at decode shapes (m = B*K = 40 or 8, k 512,
// n 512-1536) the bytes, mostly the int8 weight read once (0.29 us at
// 3.35 TB/s for 512 x 1536). The kernel is far above that: few blocks
// (n / 16) for a small m, each walking k / 256 chunks with no load
// pipelining (cp.async or TMA rings and wgmma are later work).
#include <cuda_bf16.h>
#include <stdint.h>

#include "int8_tile.cuh"

namespace {

using st::int8::Acc;
using st::int8::kThreads;

constexpr int kBM = 64, kBN = 16, kBK = 256;

template <typename T>
struct Smem {
  static constexpr int ldx = kBK + (sizeof(T) == 2 ? 8 : 4);
  static constexpr int ldw = kBN + (sizeof(T) == 2 ? 8 : 4);
  static constexpr int ldc = kBN + 4;
  static constexpr size_t x_bytes = sizeof(T) * kBM * ldx;
  static constexpr size_t w_bytes = sizeof(T) * kBK * ldw;
  static constexpr size_t bytes = x_bytes + w_bytes + sizeof(float) * kBM * ldc;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, T* __restrict__ y, int m,
                   int k, int n, long long ldx, int xvec, int wvec) {
  using S = Smem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Xs = reinterpret_cast<T*>(smem);
  T* Ws = reinterpret_cast<T*>(smem + S::x_bytes);
  float* C = reinterpret_cast<float*>(smem + S::x_bytes + S::w_bytes);
  const int n0 = blockIdx.x * kBN, row0 = blockIdx.y * kBM;

  Acc<T, kBM, kBN> acc;
  acc.zero();
  for (int k0 = 0; k0 < k; k0 += kBK) {
    st::int8::load_x<T, kBM, kBK>(Xs, S::ldx, x, ldx, row0, m, k0, k, xvec != 0);
    st::int8::load_w<T, kBK, kBN>(Ws, S::ldw, w, k0, k, n0, n, wvec != 0);
    __syncthreads();
    acc.template mma<kBK>(Xs, S::ldx, Ws, S::ldw);
    __syncthreads();
  }
  acc.store(C, S::ldc);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i - r * kBN;
    if (row0 + r < m && n0 + c < n)
      y[(long long)(row0 + r) * n + n0 + c] =
          st::int8::to_t<T>(__fmul_rn(C[r * S::ldc + c], scale[n0 + c]));
  }
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* w, const float* scale, void* y,
                   int m, int k, int n, long long ldx, cudaStream_t stream) {
  const size_t bytes = Smem<T>::bytes;
  static bool configured = false;   // the attribute is set once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(int8_matmul_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int xvec = st::int8::vec_ok<T>(x, k, ldx);
  const int wvec = st::int8::vec_ok<int8_t>(w, n, n);
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int8_matmul_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), w, scale, static_cast<T*>(y), m, k, n, ldx, xvec, wvec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int st_int8_matmul(const void* x, const void* wq, const float* scale,
                              void* y, int m, int k, int n, long long ldx,
                              int is_bf16, cudaStream_t stream) {
  if (m < 0 || k < 0 || n < 0 || ldx < k) return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  const int8_t* w = static_cast<const int8_t*>(wq);
  if (is_bf16) return launch<__nv_bfloat16>(x, w, scale, y, m, k, n, ldx, stream);
  return launch<float>(x, w, scale, y, m, k, n, ldx, stream);
}
