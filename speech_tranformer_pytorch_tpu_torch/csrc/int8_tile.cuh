// Pieces shared by the int8 kernels (int8_matmul.cu and int8_ffn.cu).
// bf16 paths: the 16-byte check `vec_ok` and the exact conversion of an
// int8 slab in shared memory into wgmma A fragments (`a_fragment`). f32
// paths: loads of an activation tile and of an int8 weight tile converted
// to f32 in shared memory, and a block-wide accumulator C[BM x BN] += A B
// of f32 FMAs whose values live in registers across the k loop. Blocks have
// kThreads = 128 threads.
#pragma once

#include <stdint.h>

namespace st {
namespace int8 {

constexpr int kThreads = 128;

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
    T v = T(0);
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

// The int8 value v in the byte of `flipped` (four bytes, sign bits
// flipped) that `byte_sel` picks, as an exact f32: v + 128 is the low byte
// of the float 2^23 + (v + 128), and the subtraction is exact. A byte
// permute and an add, not the slow conversion pipe.
__device__ __forceinline__ float i8_to_f32(uint32_t flipped, uint32_t byte_sel) {
  return __uint_as_float(__byte_perm(flipped, 0x4B00u, byte_sel)) - 8388736.f;
}

// bf16x2 {lo, hi} of two small integers held exactly in f32: their upper
// halves (the lower 16 bits are zero).
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The bf16 A fragment of wgmma k-step ks (registers {row lo, row hi} x
// {k c, c + 8}, c = 16 ks + 2 q, q = lane % 4) from an int8 slab in shared
// memory whose rows are the K index (`row_bytes` apart) and whose columns
// are the M index. `col` points at this thread's two neighbouring columns
// in row 0: the bf16 kernels permute wgmma's M rows so that a thread's two
// rows are neighbouring weight columns, so one 16-bit load holds both at
// one k, and two loads (k and k + 1) make one word of four values.
__device__ __forceinline__ void a_fragment(const unsigned char* col, uint32_t row_bytes,
                                           int ks, int q, uint32_t (&af)[4]) {
  const unsigned char* row = col + (16 * ks + 2 * q) * row_bytes;
#pragma unroll
  for (int e = 0; e < 2; ++e) {   // k = 16 ks + 2 q + 8 e and the one after
    const uint32_t w2 =
        __byte_perm(*reinterpret_cast<const uint16_t*>(row + 8 * e * row_bytes),
                    *reinterpret_cast<const uint16_t*>(row + (8 * e + 1) * row_bytes),
                    0x5410) ^ 0x80808080u;
    af[2 * e] = pack_exact(i8_to_f32(w2, 0x5440), i8_to_f32(w2, 0x5442));
    af[2 * e + 1] = pack_exact(i8_to_f32(w2, 0x5441), i8_to_f32(w2, 0x5443));
  }
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
      for (int j = 0; j < 16; ++j) dst[r * ld + c + j] = static_cast<T>(b[j]);
    }
    return;
  }
  for (int i = threadIdx.x; i < BK * BN; i += kThreads) {
    const int r = i / BN, c = i - r * BN;
    float v = 0.f;
    if (k0 + r < k && n0 + c < n) v = static_cast<float>(w[(long long)(k0 + r) * n + n0 + c]);
    dst[r * ld + c] = static_cast<T>(v);
  }
}

// C[BM x BN] accumulated over calls of mma<BK>(A, lda, B, ldb), A [BM x BK]
// and B [BK x BN] row-major in shared memory; store() writes C to shared
// memory (leading dimension ldc) for the epilogue.
template <typename T, int BM, int BN>
struct Acc;

// Thread t owns column t % BN of rows t / BN + kRowStep * i; a warp
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
