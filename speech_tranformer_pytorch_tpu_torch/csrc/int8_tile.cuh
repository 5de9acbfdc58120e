// Tiles shared by the int8 kernels (int8_ffn.cu, and int8_matmul.cu's f32
// path and its 16-byte check `vec_ok`): loads of
// an activation tile and of an int8 weight tile converted to the operand
// type in shared memory, and a block-wide accumulator C[BM x BN] += A B that
// runs on the tensor cores (WMMA, bf16 in, f32 accumulate) for bf16
// operands and as f32 FMAs for f32 operands. Accumulators live in
// registers across the k loop. Blocks have kThreads = 128 threads.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace st {
namespace int8 {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T to_t(float v);
template <>
__device__ __forceinline__ float to_t<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// dst[r][c] (leading dimension ld) = x[row0 + r][k0 + c] for r < BM, c < BK;
// zero past m rows or k columns. x has row stride ldx (elements). `vec`:
// k and ldx are multiples of 16 bytes' worth of T and x is 16-byte
// aligned, so each thread moves 16 bytes in one load.
template <typename T, int BM, int BK>
__device__ __forceinline__ void load_x(T* dst, int ld, const T* x, long long ldx,
                                       int row0, int m, int k0, int k, bool vec) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T), kChunks = BK / kPer;
    constexpr int kIters = (BM * kChunks + kThreads - 1) / kThreads;
#pragma unroll
    for (int it = 0; it < kIters; ++it) {   // every load in flight at once
      const int i = threadIdx.x + it * kThreads;
      if (i >= BM * kChunks) break;
      const int r = i / kChunks, c = (i - r * kChunks) * kPer;
      int4 v = make_int4(0, 0, 0, 0);
      if (row0 + r < m && k0 + c < k)
        v = *reinterpret_cast<const int4*>(x + (row0 + r) * ldx + k0 + c);
      *reinterpret_cast<int4*>(dst + r * ld + c) = v;
    }
    return;
  }
  for (int i = threadIdx.x; i < BM * BK; i += kThreads) {
    const int r = i / BK, c = i - r * BK;
    T v = to_t<T>(0.f);
    if (row0 + r < m && k0 + c < k) v = x[(row0 + r) * ldx + k0 + c];
    dst[r * ld + c] = v;
  }
}

// Whether rows of `cols` elements of T at stride `ld` from `p` can be moved
// 16 bytes at a time.
template <typename T>
inline bool vec_ok(const void* p, long long cols, long long ld) {
  constexpr long long kPer = 16 / sizeof(T);
  return cols % kPer == 0 && ld % kPer == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// dst[r][c] = T(w[k0 + r][n0 + c]) for r < BK, c < BN; zero past k rows or
// n columns. w is int8 [k, n] row-major. `vec` (vec_ok<int8_t>): each
// thread moves 16 int8 values in one load.
template <typename T, int BK, int BN>
__device__ __forceinline__ void load_w(T* dst, int ld, const int8_t* w, int k0,
                                       int k, int n0, int n, bool vec) {
  if (vec) {
    constexpr int kChunks = BN / 16;
    constexpr int kIters = (BK * kChunks + kThreads - 1) / kThreads;
#pragma unroll
    for (int it = 0; it < kIters; ++it) {   // every load in flight at once
      const int i = threadIdx.x + it * kThreads;
      if (i >= BK * kChunks) break;
      const int r = i / kChunks, c = (i - r * kChunks) * 16;
      int4 raw = make_int4(0, 0, 0, 0);
      if (k0 + r < k && n0 + c < n)
        raw = *reinterpret_cast<const int4*>(w + (long long)(k0 + r) * n + n0 + c);
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int j = 0; j < 16; ++j) dst[r * ld + c + j] = to_t<T>(static_cast<float>(b[j]));
    }
    return;
  }
  for (int i = threadIdx.x; i < BK * BN; i += kThreads) {
    const int r = i / BN, c = i - r * BN;
    float v = 0.f;
    if (k0 + r < k && n0 + c < n) v = static_cast<float>(w[(long long)(k0 + r) * n + n0 + c]);
    dst[r * ld + c] = to_t<T>(v);
  }
}

// C[BM x BN] accumulated over calls of mma<BK>(A, lda, B, ldb), A [BM x BK]
// and B [BK x BN] row-major in shared memory; store() writes C to shared
// memory (leading dimension ldc) for the epilogue.
template <typename T, int BM, int BN>
struct Acc;

template <int BM, int BN>
struct Acc<__nv_bfloat16, BM, BN> {
  static constexpr int kTilesN = BN / 16;
  static constexpr int kTiles = (BM / 16) * kTilesN / kWarps;
  static_assert((BM / 16) * kTilesN % kWarps == 0, "tiles must split over the warps");
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[kTiles];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kTiles; ++i) nvcuda::wmma::fill_fragment(c[i], 0.f);
  }

  template <int BK>
  __device__ __forceinline__ void mma(const __nv_bfloat16* A, int lda,
                                      const __nv_bfloat16* B, int ldb) {
    using namespace nvcuda;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int tile = warp + kWarps * i;
      const int ti = (tile / kTilesN) * 16, tj = (tile % kTilesN) * 16;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, A + ti * lda + kk, lda);
        wmma::load_matrix_sync(b, B + kk * ldb + tj, ldb);
        wmma::mma_sync(c[i], a, b, c[i]);
      }
    }
  }

  __device__ __forceinline__ void store(float* C, int ldc) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int tile = warp + kWarps * i;
      const int ti = (tile / kTilesN) * 16, tj = (tile % kTilesN) * 16;
      nvcuda::wmma::store_matrix_sync(C + ti * ldc + tj, c[i], ldc,
                                      nvcuda::wmma::mem_row_major);
    }
  }
};

// f32: thread t owns column t % BN of rows t / BN + kRowStep * i; a warp
// reads one A value (broadcast) and 32 neighbouring B values per k.
template <int BM, int BN>
struct Acc<float, BM, BN> {
  static_assert(kThreads % BN == 0, "BN must divide the block");
  static constexpr int kRowStep = kThreads / BN;
  static constexpr int kRows = BM / kRowStep;
  float c[kRows];

  __device__ __forceinline__ int col() const { return threadIdx.x % BN; }
  __device__ __forceinline__ int row(int i) const { return threadIdx.x / BN + kRowStep * i; }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kRows; ++i) c[i] = 0.f;
  }

  template <int BK>
  __device__ __forceinline__ void mma(const float* A, int lda, const float* B, int ldb) {
    const int j = col();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float b = B[kk * ldb + j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) c[i] = fmaf(A[row(i) * lda + kk], b, c[i]);
    }
  }

  __device__ __forceinline__ void store(float* C, int ldc) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) C[row(i) * ldc + col()] = c[i];
  }
};

}  // namespace int8
}  // namespace st
