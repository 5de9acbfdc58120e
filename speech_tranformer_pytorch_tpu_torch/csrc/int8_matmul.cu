// Int8-weight matmul of the decode step: y[m, n] = (x[m, k] @ wq[k, n]) *
// scale[n], f32 accumulation, the f32 scale on the accumulator, y in x's
// type (bf16 or f32).
//
// Replaces the TPU kernel `_kernel` of speech_tranformer_pytorch_tpu/
// kernels/int8_matmul.py:52 (entry `int8_matmul` :61). The TPU kernel
// kept x whole in VMEM and streamed [k, 512] weight tiles; it always ran
// bf16 operands. Here the operands follow x: bf16 x multiplies on the
// tensor cores (int8 values are exact in bf16), f32 x through f32 FMAs, so
// an f32 model keeps f32 operands as the JAX reference does.
//
// bf16 design (Hopper). The product runs transposed, yᵀ = wqᵀ xᵀ, so the
// weight's columns fill wgmma's 64-row M and the activation rows, few at
// decode (B·K = 40 at beam 5, 8 greedy), are its N: a block owns 64
// columns of y and `rows` (N, a multiple of 8 up to 64) rows of x. Its k
// range walks in stages of 64 through a cp.async ring: the int8 weight
// slab [64 k][64 n] as int8 bytes (device memory serves the weight at one
// byte a value), x [rows][64 k] in the 128-byte swizzled layout that
// wgmma reads K-major as B. Each thread converts its own A fragment from
// the int8 slab to bf16 in registers (the M rows of a thread are two
// neighbouring columns of w, one 16-bit load per k; byte permutes and one
// f32 add make each value exact, off the slow conversion pipe) and issues
// the register-A wgmma; a stage's products run on while the next stage is
// converted, and their slot is refilled once they are done. When the plan
// splits k over blocks (grid z, so that ~100 blocks run at the decode
// shapes), the splits of one tile form a thread-block cluster: ranks 1 ..
// S - 1 store their f32 partial tiles into shared memory of rank 0
// (st.async, completing on its mbarrier), and rank 0 adds them to its own
// in the fixed order 1, 2, ..., applies the scale once and writes y. No
// scratch in device memory, no atomics: outputs are bit-identical run to
// run, one launch per call. m, k and n are arbitrary: rows past m and k
// past the split are zero-filled, weight columns past n (or a weight whose
// rows are not 16-byte chunks) take a byte-wise load.
//
// What bounds it on an H100: at decode shapes (m = 40 or 8, k 512,
// n 512-1536) the bytes, mostly the int8 weight read once (0.29 us at
// 3.35 TB/s for 512 x 1536). The kernel is latency-bound above that: each
// block runs one chain of copy, convert, wgmma, partial store (ranks > 0)
// or wait, sum and store (rank 0), each waiting on the one before, with one
// warpgroup an SM to issue it.
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"
#include "int8_tile.cuh"

namespace {

// ------------------------------------------------------------------- f32
using st::int8::Acc;

constexpr int kBM = 64, kBN = 16, kBK = 256;

struct Smem {
  static constexpr int ldx = kBK + 4;
  static constexpr int ldw = kBN + 4;
  static constexpr int ldc = kBN + 4;
  static constexpr size_t x_bytes = sizeof(float) * kBM * ldx;
  static constexpr size_t w_bytes = sizeof(float) * kBK * ldw;
  static constexpr size_t bytes = x_bytes + w_bytes + sizeof(float) * kBM * ldc;
};

// One 128-thread block per 64 x 16 tile of y, walking k in chunks of 256
// staged in shared memory (int8 converted after the load).
__global__ void __launch_bounds__(st::int8::kThreads)
int8_matmul_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, float* __restrict__ y, int m,
                       int k, int n, long long ldx, int xvec, int wvec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Xs = reinterpret_cast<float*>(smem);
  float* Ws = reinterpret_cast<float*>(smem + Smem::x_bytes);
  float* C = reinterpret_cast<float*>(smem + Smem::x_bytes + Smem::w_bytes);
  const int n0 = blockIdx.x * kBN, row0 = blockIdx.y * kBM;

  Acc<float, kBM, kBN> acc;
  acc.zero();
  for (int k0 = 0; k0 < k; k0 += kBK) {
    st::int8::load_x<float, kBM, kBK>(Xs, Smem::ldx, x, ldx, row0, m, k0, k, xvec != 0);
    st::int8::load_w<float, kBK, kBN>(Ws, Smem::ldw, w, k0, k, n0, n, wvec != 0);
    __syncthreads();
    acc.mma<kBK>(Xs, Smem::ldx, Ws, Smem::ldw);
    __syncthreads();
  }
  acc.store(C, Smem::ldc);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += st::int8::kThreads) {
    const int r = i / kBN, c = i - r * kBN;
    if (row0 + r < m && n0 + c < n)
      y[(long long)(row0 + r) * n + n0 + c] = __fmul_rn(C[r * Smem::ldc + c], scale[n0 + c]);
  }
}

cudaError_t launch_f32(const float* x, const int8_t* w, const float* scale, float* y,
                       int m, int k, int n, long long ldx, cudaStream_t stream) {
  static bool configured = false;   // the attribute is set once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(int8_matmul_f32_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(Smem::bytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int xvec = st::int8::vec_ok<float>(x, k, ldx);
  const int wvec = st::int8::vec_ok<int8_t>(w, n, n);
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int8_matmul_f32_kernel<<<grid, st::int8::kThreads, Smem::bytes, stream>>>(
      x, w, scale, y, m, k, n, ldx, xvec, wvec);
  return cudaGetLastError();
}

// --------------------------------------------------------- bf16 (Hopper)
constexpr int kThreads = 128;   // one warpgroup
constexpr int kCols = 64;       // columns of y (of w) per block: wgmma's M
constexpr int kStageK = 64;     // k per ring stage: one 128-byte row of x
constexpr int kStages = 4;
constexpr int kMaxSplits = 8;   // the portable cluster size (the plan keeps to 4)
constexpr int kWRow = 80;       // bytes per weight row in shared memory:
                                // 64 + 16 staggers the fragment loads' banks

// Shared memory, from a 1024-byte aligned base: kStages x tiles of
// [N][64] bf16 (swizzled), then kStages x weight slabs [64 k][kWRow]; with
// S > 1 splits, cluster rank 0 adds S - 1 slots for the other ranks'
// partial tiles (kSlot bytes each).
template <int N>
struct MmSmem {
  static constexpr uint32_t kX = N * 128;
  static constexpr uint32_t kW = kStageK * kWRow;
  static constexpr uint32_t kRing = kStages * (kX + kW);
  static constexpr uint32_t kSlot = N / 2 * kThreads * 4;
  static constexpr uint32_t bytes(int splits) {
    return kRing + (splits - 1) * kSlot + 1024;   // + alignment
  }
};

struct MmArgs {
  const __nv_bfloat16* x;
  const int8_t* w;
  const float* scale;
  __nv_bfloat16* y;
  int m, k, n, k_chunk, wvec;
  long long ldx;
};

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

// y[row][col], y[row][col + 1] = bf16(v * s) where in range.
__device__ __forceinline__ void store_pair(const MmArgs& a, int row, int col, float v0,
                                           float v1, float s0, float s1) {
  if (row >= a.m || col >= a.n) return;
  __nv_bfloat16* dst = a.y + (long long)row * a.n + col;
  if (col + 1 < a.n && (a.n & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(dst) =
        __floats2bfloat162_rn(__fmul_rn(v0, s0), __fmul_rn(v1, s1));
    return;
  }
  dst[0] = __float2bfloat16_rn(__fmul_rn(v0, s0));
  if (col + 1 < a.n) dst[1] = __float2bfloat16_rn(__fmul_rn(v1, s1));
}

template <int N>
__global__ void __launch_bounds__(kThreads) int8_matmul_bf16_kernel(MmArgs a) {
  using L = MmSmem<N>;
  constexpr int kXCopies = (N * 8 + kThreads - 1) / kThreads;   // 16-byte chunks of x
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t arrived;   // rank 0: the other ranks' partials
  unsigned char* smem = smem_raw + ((1024 - (st::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t xs0 = st::smem_u32(smem), ws0 = xs0 + kStages * L::kX;
  const int n0 = blockIdx.x * kCols, m0 = blockIdx.y * N, split = blockIdx.z;
  const int splits = static_cast<int>(gridDim.z);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kb = split * a.k_chunk, ke = min(a.k, kb + a.k_chunk);
  const int steps = (ke - kb + kStageK - 1) / kStageK;
  // x holds whole 16-byte chunks up to ceil8(k), zeros past k.
  const int xe = min((a.k + 7) & ~7, kb + a.k_chunk);
  if (splits > 1) {   // the cluster barrier's wait comes after the k loop
    if (split == 0 && threadIdx.x == 0) st::mbar_init(st::smem_u32(&arrived), 1);
    st::cluster_arrive();
  }

  // This thread's copies, addressed once: chunk c of x row r and chunk c of
  // weight row r; each stage moves them 64 columns (rows) further.
  const __nv_bfloat16* xsrc[kXCopies];
  uint32_t xdst[kXCopies];
  int xcol[kXCopies];   // k offset of the chunk in the split, or past it
#pragma unroll
  for (int t = 0; t < kXCopies; ++t) {
    const int i = threadIdx.x + t * kThreads, r = i >> 3, c = i & 7;
    const bool ok = i < N * 8 && m0 + r < a.m;
    xsrc[t] = ok ? a.x + (m0 + r) * a.ldx + kb + 8 * c : a.x;
    xdst[t] = st::sw128_offset(r, c, N);
    xcol[t] = ok ? kb + 8 * c : INT_MAX / 2;
  }
  const int8_t* wsrc[2];
  uint32_t wdst[2];
  int wrow[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int i = threadIdx.x + t * kThreads, r = i >> 2, c = i & 3;
    const bool ok = n0 + 16 * c < a.n;
    wsrc[t] = ok ? a.w + (long long)(kb + r) * a.n + n0 + 16 * c : a.w;
    wdst[t] = r * kWRow + 16 * c;
    wrow[t] = ok ? kb + r : INT_MAX / 2;
  }
  const long long wstep = (long long)kStageK * a.n;

  auto issue = [&](int it) {   // x and the weight slab of the it-th stage of k
    const int stage = it % kStages, dk = it * kStageK;
    const uint32_t xs = xs0 + stage * L::kX, ws = ws0 + stage * L::kW;
#pragma unroll
    for (int t = 0; t < kXCopies; ++t) {
      const bool ok = xcol[t] + dk < xe;
      if (N * 8 % kThreads == 0 || threadIdx.x + t * kThreads < N * 8)
        st::cp_async_16(xs + xdst[t], ok ? xsrc[t] + dk : a.x, ok);
    }
    if (a.wvec) {   // n % 16 == 0 and w 16-byte aligned: whole 16-byte chunks
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const bool ok = wrow[t] + dk < ke;
        st::cp_async_16(ws + wdst[t], ok ? wsrc[t] + it * wstep : a.w, ok);
      }
    } else {
      unsigned char* wb = smem + kStages * L::kX + stage * L::kW;
      for (int i = threadIdx.x; i < kStageK * kCols; i += kThreads) {
        const int r = i >> 6, c = i & 63, k0 = kb + dk;
        const bool ok = k0 + r < ke && n0 + c < a.n;
        wb[r * kWRow + c] = ok ? a.w[(long long)(k0 + r) * a.n + n0 + c] : 0;
      }
    }
  };

  // Accumulator value i of this thread: M row 16 warp + lane / 4 + 8 hi is
  // y column n0 + nl + hi (the permutation that makes a thread's two M rows
  // neighbouring bytes of a weight row), N column 8 (i / 4) + 2 (lane % 4)
  // + i % 2 is y row m0 + that.
  const int nl = 16 * warp + 2 * (lane >> 2), q = lane & 3;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {   // one commit group per stage
    if (it < steps) issue(it);
    st::cp_async_commit();
  }
  // The scale of this thread's two columns, loaded under the copies.
  const float s_lo = n0 + nl < a.n ? a.scale[n0 + nl] : 0.f;
  const float s_hi = n0 + nl + 1 < a.n ? a.scale[n0 + nl + 1] : 0.f;
  for (int it = 0; it < steps; ++it) {
    st::cp_async_wait<kStages - 2>();   // this stage's group has landed
    st::fence_proxy_async();
    __syncthreads();
    const int stage = it % kStages;
    const uint32_t xs = xs0 + stage * L::kX;
    const unsigned char* ws = smem + kStages * L::kX + stage * L::kW + nl;
    // A fragment of k-step ks: registers {row lo, row hi} x {k c, c + 8}
    // with c = 16 ks + 2 q; each 16-bit load holds columns nl and nl + 1,
    // and two of them (k and k + 1) make one word of four values.
    uint32_t af[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const unsigned char* row = ws + (16 * ks + 2 * q) * kWRow;
#pragma unroll
      for (int e = 0; e < 2; ++e) {   // k = c + 8 e and c + 8 e + 1
        const uint32_t w2 =
            __byte_perm(*reinterpret_cast<const uint16_t*>(row + 8 * e * kWRow),
                        *reinterpret_cast<const uint16_t*>(row + (8 * e + 1) * kWRow),
                        0x5410) ^ 0x80808080u;
        af[ks][2 * e] = pack_exact(i8_to_f32(w2, 0x5440), i8_to_f32(w2, 0x5442));
        af[ks][2 * e + 1] = pack_exact(i8_to_f32(w2, 0x5441), i8_to_f32(w2, 0x5443));
      }
    }
    st::fence_regs(acc);
    st::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      st::wgmma_rs_k16_kmajor<N>(acc, af[ks][0], af[ks][1], af[ks][2], af[ks][3],
                                 st::desc_k_major(xs, N, ks));
    st::wgmma_commit();
    // The previous stage's products are done (this one's may run on), so
    // its slot takes the stage kStages - 1 ahead.
    st::wgmma_wait<1>();
    if (it + kStages - 1 < steps) issue(it + kStages - 1);
    st::cp_async_commit();
  }
  st::wgmma_wait<0>();
  st::fence_regs(acc);
  st::cp_async_wait<0>();

  if (splits > 1) {
    // Split k: the splits of a tile are one cluster (rank = split). Ranks
    // 1 .. S - 1 store their partial tiles into slots of rank 0's shared
    // memory, completing on its mbarrier; rank 0 adds them to its own in
    // the order 1, 2, ..., so the bits never depend on timing.
    const uint32_t bar = st::smem_u32(&arrived);
    const uint32_t slots = xs0 + L::kRing;
    st::cluster_wait();
    if (split > 0) {
      const uint32_t dst = st::map_rank(slots + (split - 1) * L::kSlot, 0) + 16 * threadIdx.x;
      const uint32_t rbar = st::map_rank(bar, 0);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        st::st_async_16(dst + j * kThreads * 16,
                        make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]),
                        rbar);
      return;
    }
    if (threadIdx.x == 0) st::mbar_arrive_expect(bar, (splits - 1) * L::kSlot);
    st::mbar_wait(bar, 0);
    const float4* part = reinterpret_cast<const float4*>(smem + L::kRing) + threadIdx.x;
    for (int s = 0; s < splits - 1; ++s) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float4 v = part[(s * (N / 8) + j) * kThreads];
        acc[4 * j] += v.x;
        acc[4 * j + 1] += v.y;
        acc[4 * j + 2] += v.z;
        acc[4 * j + 3] += v.w;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int r = m0 + 8 * j + 2 * q;
    store_pair(a, r, n0 + nl, acc[4 * j], acc[4 * j + 2], s_lo, s_hi);
    store_pair(a, r + 1, n0 + nl, acc[4 * j + 1], acc[4 * j + 3], s_lo, s_hi);
  }
}

template <int N>
cudaError_t launch_bf16_rows(const MmArgs& a, cudaStream_t stream) {
  static bool configured = false;   // the attribute is set once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(int8_matmul_bf16_kernel<N>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(MmSmem<N>::bytes(kMaxSplits)));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int splits = a.k > 0 ? (a.k + a.k_chunk - 1) / a.k_chunk : 1;
  if (splits > kMaxSplits) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.n + kCols - 1) / kCols, (a.m + N - 1) / N, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = MmSmem<N>::bytes(splits);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, int8_matmul_bf16_kernel<N>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch_bf16(const MmArgs& a, int rows, cudaStream_t stream) {
  switch (rows) {
    case 8: return launch_bf16_rows<8>(a, stream);
    case 16: return launch_bf16_rows<16>(a, stream);
    case 24: return launch_bf16_rows<24>(a, stream);
    case 32: return launch_bf16_rows<32>(a, stream);
    case 40: return launch_bf16_rows<40>(a, stream);
    case 48: return launch_bf16_rows<48>(a, stream);
    case 56: return launch_bf16_rows<56>(a, stream);
    case 64: return launch_bf16_rows<64>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16: x rows 16-byte aligned with ldx % 8 == 0 and ceil8(k) readable
// columns (zeros past k); `rows` (a multiple of 8, <= 64) rows of x and 64
// columns of y per block; k split in chunks of `k_chunk` (a multiple of
// 16) over grid z, at most 8 chunks (one cluster). f32 ignores rows and
// k_chunk.
extern "C" int st_int8_matmul(const void* x, const void* wq, const float* scale, void* y,
                              int m, int k, int n, long long ldx, int rows, int k_chunk,
                              int is_bf16, cudaStream_t stream) {
  if (m < 0 || k < 0 || n < 0 || ldx < k) return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  const int8_t* w = static_cast<const int8_t*>(wq);
  if (!is_bf16)
    return launch_f32(static_cast<const float*>(x), w, scale, static_cast<float*>(y), m, k,
                      n, ldx, stream);
  if (k_chunk < 16 || k_chunk % 16 != 0 ||
      (k > 0 && (ldx % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)))
    return cudaErrorInvalidValue;
  MmArgs a{static_cast<const __nv_bfloat16*>(x), w, scale, static_cast<__nv_bfloat16*>(y),
           m, k, n, k_chunk, st::int8::vec_ok<int8_t>(w, n, n) ? 1 : 0, ldx};
  return launch_bf16(a, rows, stream);
}
