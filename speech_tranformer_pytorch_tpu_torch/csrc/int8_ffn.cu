// Fused int8-weight feed-forward of the decode step, one launch:
//   h = relu((x @ w1q) * s1 + b1), rounded to the operand type,
//   y = (h @ w2q) * s2 + b2,
// x [m, k] bf16 or f32, w1q [k, ff] and w2q [ff, n] int8, s1, b1 [ff] and
// s2, b2 [n] f32, y [m, n] in x's type; f32 accumulation throughout.
//
// Replaces the TPU kernel `_kernel` of speech_tranformer_pytorch_tpu/
// kernels/int8_ffn.py:50 (entry `int8_ffn` :73). The TPU grid walked the
// ff blocks in order and carried the [m, n] sum in VMEM scratch. Blocks of
// a CUDA grid run in no order, so the sum over ff needs another home.
//
// bf16 design (Hopper). Both products run transposed, as in int8_matmul.cu:
// weight columns fill wgmma's 64-row M, the activation rows (few at decode:
// B·K = 40 at beam 5, 8 greedy) are its N. A thread-block cluster of S
// ranks owns CT tiles of 64 columns of y (CT = 2 up to 40 rows) and `N`
// rows of x; rank r owns the hidden columns [r F, (r + 1) F), F = 64 MT
// (MT = 1 or 2; the plan picks MT and S so that S F covers ff, else each
// rank takes every S-th slice of F in turn). A block is one warpgroup.
//  1. hᵀ [F, N] = w1[:, slice]ᵀ xᵀ: the int8 w1 slab and x stream through a
//     cp.async ring in stages of 64 k; each thread converts its own A
//     fragments from the int8 bytes with byte permutes and issues
//     register-A wgmmas, one a 64-column hidden tile and k-step. The ring
//     also brings the rank's [F, 64 CT] slab of w2, once.
//  2. s1, b1, the ReLU and the bf16 rounding are applied in registers, and
//     h is written to shared memory in the 128-byte swizzled K-major layout
//     (hopper.cuh): it is at once the B operand of the second product. The
//     hidden never leaves the SM.
//  3. The partials yᵀ [64, N] = w2[slice, tile]ᵀ hᵀ accumulate in registers.
//  4. The partials are reduce-scattered over the cluster: each rank owns an
//     equal share of each tile's accumulator registers, every rank pushes
//     each share to its owner with st.async (completing on the owner's
//     mbarrier), and each owner sums the S partials in rank order, applies
//     s2 and b2 once and stores its share of y in bf16.
// No device scratch, no counters, no atomics: one launch a call, outputs
// bit-identical run to run. w1 and x are read once per cluster (from L2
// after the first): with two tiles of y a cluster, 4 times at the base
// shapes instead of 8. m, k, ff and n are arbitrary: rows past m, k past
// the end and hidden columns past ff are zero-filled; a weight whose rows
// are not whole 16-byte chunks takes a byte-wise load.
//
// f32 operands keep the first design: one block per (128-column hidden
// block, 64-column chunk of y, 64 rows of x) with FMAs, f32 partials in a
// device scratch [ff/128, m, n] and the last block to arrive on a chunk's
// counter summing them in a fixed order.
//
// What bounds it on an H100: at decode shapes (m = 40 or 8, k 512,
// ff 2048, n 512) the bytes, mostly the two int8 weights read once (2.1 MB,
// 0.63 us at 3.35 TB/s). The bf16 kernel is latency-bound above that:
// each block runs one chain of copies, conversions and wgmmas over k (about
// half the time), then the second product and the cluster exchange, in
// series; a launch with no first product (k = 0) takes over half as long.
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "int8_tile.cuh"

namespace {

// ------------------------------------------------------------------- f32
using st::int8::Acc;

constexpr int kBM = 64, kBF = 128, kBK = 128, kBN = 64;

struct Smem {
  static constexpr int ldx = kBK + 4;    // x chunk [kBM, kBK]
  static constexpr int ldw1 = kBF + 4;   // w1 chunk [kBK, kBF]
  static constexpr int ldw2 = kBN + 4;   // w2 chunk [kBF, kBN]
  static constexpr int ldh = kBF + 4;    // hidden [kBM, kBF]
  static constexpr int ldc = kBN + 4;    // partial chunk [kBM, kBN]
  static constexpr size_t h_bytes = sizeof(float) * kBM * ldh;
  static constexpr size_t p1_bytes = sizeof(float) * (kBM * ldx + kBK * ldw1);
  static constexpr size_t p2_bytes = sizeof(float) * kBF * ldw2;
  static constexpr size_t stage_bytes = p1_bytes > p2_bytes ? p1_bytes : p2_bytes;
  static constexpr size_t bytes = h_bytes + stage_bytes + sizeof(float) * kBM * ldc;
};

// y[row0 + r][n0 + c] = (sum over j = 0, 1, ... of partial[j][..]) * s2 + b2
// for the chunk's rows and columns, kV columns a thread (16-byte loads when
// kV = 4, n % 4 == 0), with up to 8 partials' loads in flight at once. The
// sum runs in the order j = 0, 1, ... whatever kV is.
template <int kV>
__device__ __forceinline__ void reduce_chunk(const float* partial, float* y, const float* s2,
                                             const float* b2, int m, int n, int n_parts,
                                             int row0, int rows, int n0) {
  using V = typename std::conditional<kV == 4, float4, float>::type;
  const int cols = min(kBN, n - n0) / kV;   // n0 % kBN == 0, so whole vectors
  const long long plane = (long long)m * n;
  for (int g = threadIdx.x; g < rows * cols; g += st::int8::kThreads) {
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
    for (int q = 0; q < kV; ++q) y[at + q] = __fadd_rn(__fmul_rn(sum[q], s2[c + q]), b2[c + q]);
  }
}

__global__ void __launch_bounds__(st::int8::kThreads)
int8_ffn_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w1,
                    const float* __restrict__ s1, const float* __restrict__ b1,
                    const int8_t* __restrict__ w2, const float* __restrict__ s2,
                    const float* __restrict__ b2, float* __restrict__ y,
                    float* __restrict__ partial, int* __restrict__ counters, int m, int k,
                    int ff, int n, long long ldx, int xvec, int vec1, int vec2) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int is_last;
  float* H = reinterpret_cast<float*>(smem);
  unsigned char* stage = smem + Smem::h_bytes;
  float* Xs = reinterpret_cast<float*>(stage);
  float* W1s = Xs + kBM * Smem::ldx;
  float* W2s = reinterpret_cast<float*>(stage);
  float* C = reinterpret_cast<float*>(stage + Smem::stage_bytes);

  const int j = blockIdx.x, n_blocks = gridDim.x, chunk = blockIdx.y;
  const int f0 = j * kBF, n0 = chunk * kBN, row0 = blockIdx.z * kBM;
  const int rows = min(kBM, m - row0);

  // 1. hidden block h_j = relu((x @ w1[:, f0:f0+kBF]) * s1 + b1).
  {
    Acc<float, kBM, kBF> acc;
    acc.zero();
    for (int k0 = 0; k0 < k; k0 += kBK) {
      st::int8::load_x<float, kBM, kBK>(Xs, Smem::ldx, x, ldx, row0, m, k0, k, xvec != 0);
      st::int8::load_w<float, kBK, kBF>(W1s, Smem::ldw1, w1, k0, k, f0, ff, vec1 != 0);
      __syncthreads();
      acc.mma<kBK>(Xs, Smem::ldx, W1s, Smem::ldw1);
      __syncthreads();
    }
    acc.store(H, Smem::ldh);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBF; i += st::int8::kThreads) {
    const int r = i / kBF, c = i - r * kBF, f = f0 + c;
    float v = 0.f;   // hidden columns past ff meet zero rows of w2 anyway
    if (f < ff) v = fmaxf(__fadd_rn(__fmul_rn(H[r * Smem::ldh + c], s1[f]), b1[f]), 0.f);
    H[r * Smem::ldh + c] = v;
  }
  __syncthreads();

  // 2. partial[j][:, n0:n0+kBN] = h_j @ w2[f0:f0+kBF, n0:n0+kBN].
  st::int8::load_w<float, kBF, kBN>(W2s, Smem::ldw2, w2, f0, ff, n0, n, vec2 != 0);
  __syncthreads();
  {
    Acc<float, kBM, kBN> acc;
    acc.zero();
    acc.mma<kBF>(H, Smem::ldh, W2s, Smem::ldw2);
    acc.store(C, Smem::ldc);
  }
  __syncthreads();
  float* part = partial + (long long)j * m * n;
  for (int i = threadIdx.x; i < kBM * kBN; i += st::int8::kThreads) {
    const int r = i / kBN, c = i - r * kBN;
    if (r < rows && n0 + c < n) part[(long long)(row0 + r) * n + n0 + c] = C[r * Smem::ldc + c];
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
    reduce_chunk<4>(partial, y, s2, b2, m, n, n_blocks, row0, rows, n0);
  else
    reduce_chunk<1>(partial, y, s2, b2, m, n, n_blocks, row0, rows, n0);
  if (threadIdx.x == 0) *counter = 0;
}

cudaError_t launch_f32(const float* x, const int8_t* w1, const float* s1, const float* b1,
                       const int8_t* w2, const float* s2, const float* b2, float* y,
                       float* partial, int* counters, int m, int k, int ff, int n,
                       long long ldx, cudaStream_t stream) {
  static bool configured = false;   // the attribute is set once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(int8_ffn_f32_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(Smem::bytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int xvec = st::int8::vec_ok<float>(x, k, ldx);
  const int vec1 = st::int8::vec_ok<int8_t>(w1, ff, ff);
  const int vec2 = st::int8::vec_ok<int8_t>(w2, n, n);
  dim3 grid((ff + kBF - 1) / kBF, (n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int8_ffn_f32_kernel<<<grid, st::int8::kThreads, Smem::bytes, stream>>>(
      x, w1, s1, b1, w2, s2, b2, y, partial, counters, m, k, ff, n, ldx, xvec, vec1, vec2);
  return cudaGetLastError();
}

// --------------------------------------------------------- bf16 (Hopper)
constexpr int kWg = 128;        // threads of a warpgroup
constexpr int kCols = 64;       // columns of y a tile: wgmma's M in the second product
constexpr int kStageK = 64;     // k a ring stage: one 128-byte row of x
constexpr int kStages = 4;
constexpr int kMaxRanks = 16;   // past 8 a cluster is non-portable (allowed at launch)

// Shared memory, from a 1024-byte aligned base: kStages x tiles of x
// [N][64] bf16 (swizzled), kStages x w1 slabs [64 k][kF + 16 bytes], the
// hidden hᵀ as a swizzled [N][kF] bf16 tile, the w2 slab [kF][64 CT + 16
// bytes], and the slots of the cluster exchange: CT tiles x S senders x
// this rank's share of the kUnits float4s of a partial tile. Rows of
// 16 bytes past a multiple of 64 stagger the A-fragment loads' banks.
template <int N, int MT, int CT>
struct FfnSmem {
  static constexpr int kF = 64 * MT;   // hidden columns a rank and slice
  static constexpr uint32_t kWRow = kF + 16;
  static constexpr uint32_t kW2Row = kCols * CT + 16;
  static constexpr uint32_t kX = N * 128;
  static constexpr uint32_t kW = kStageK * kWRow;
  static constexpr uint32_t kRing = kStages * (kX + kW);
  static constexpr uint32_t kH = MT * N * 128;
  static constexpr uint32_t kW2 = kF * kW2Row;
  static constexpr uint32_t kUnits = kWg * N / 8;   // float4s of a [64, N] partial
  __host__ __device__ static constexpr uint32_t share(int ranks) {
    return (kUnits + ranks - 1) / ranks;
  }
  __host__ __device__ static constexpr uint32_t bytes(int ranks) {
    return kRing + kH + kW2 + CT * ranks * share(ranks) * 16 + 1024;   // + alignment
  }
  static constexpr uint32_t kMaxBytes =
      kRing + kH + kW2 + CT * (kUnits + kMaxRanks) * 16 + 1024;
};

struct FfnArgs {
  const __nv_bfloat16* x;
  const int8_t* w1;
  const float* s1;
  const float* b1;
  const int8_t* w2;
  const float* s2;
  const float* b2;
  __nv_bfloat16* y;
  int m, k, ff, n, slices, vec1, vec2;   // slices: hidden slices a rank (usually 1)
  long long ldx;
};

// y[row][col], y[row][col + 1] = bf16(v * s2 + b2) where in range.
__device__ __forceinline__ void store_pair(const FfnArgs& a, int row, int col, float v0,
                                           float v1) {
  if (row >= a.m || col >= a.n) return;
  __nv_bfloat16* dst = a.y + (long long)row * a.n + col;
  const float y0 = __fadd_rn(__fmul_rn(v0, a.s2[col]), a.b2[col]);
  if (col + 1 >= a.n) {
    dst[0] = __float2bfloat16_rn(y0);
    return;
  }
  const float y1 = __fadd_rn(__fmul_rn(v1, a.s2[col + 1]), a.b2[col + 1]);
  if ((a.n & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y0, y1);
  } else {
    dst[0] = __float2bfloat16_rn(y0);
    dst[1] = __float2bfloat16_rn(y1);
  }
}

// One warpgroup a block walks the MT hidden tiles of its slice and the CT
// output tiles of its cluster.
template <int N, int MT, int CT>
__global__ void __launch_bounds__(kWg) int8_ffn_bf16_kernel(FfnArgs a) {
  using L = FfnSmem<N, MT, CT>;
  constexpr int kF = L::kF;
  constexpr int kThreads = kWg;
  constexpr int kXCopies = (N * 8 + kThreads - 1) / kThreads;   // 16-byte chunks of x
  constexpr int kW1Copies = kStageK * (kF / 16) / kThreads;     // of a w1 stage: 2 MT
  constexpr int kW2Copies = kF * (kCols * CT / 16) / kThreads;  // of the w2 slab: 2 MT CT
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t arrived;   // this rank's share of the partials
  unsigned char* smem = smem_raw + ((1024 - (st::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t xs0 = st::smem_u32(smem), ws0 = xs0 + kStages * L::kX;
  const uint32_t hs = xs0 + L::kRing;
  unsigned char* w2s = smem + L::kRing + L::kH;
  const uint32_t slots = hs + L::kH + L::kW2;
  const uint32_t bar = st::smem_u32(&arrived);
  const int n0 = blockIdx.x * kCols * CT, m0 = blockIdx.y * N, rank = blockIdx.z;
  const int ranks = static_cast<int>(gridDim.z);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nl = 16 * warp + 2 * (lane >> 2), q = lane & 3;
  const int steps = (a.k + kStageK - 1) / kStageK;
  const int xe = (a.k + 7) & ~7;   // x holds whole 16-byte chunks, zeros past k
  if (threadIdx.x == 0) st::mbar_init(bar, 1);
  st::cluster_arrive();   // its wait comes before the first push

  // This thread's copies of x, addressed once: chunk c of row r; each stage
  // moves them 64 columns further.
  const __nv_bfloat16* xsrc[kXCopies];
  uint32_t xdst[kXCopies];
  int xcol[kXCopies];
#pragma unroll
  for (int t = 0; t < kXCopies; ++t) {
    const int i = threadIdx.x + t * kThreads, r = i >> 3, c = i & 7;
    const bool ok = i < N * 8 && m0 + r < a.m;
    xsrc[t] = ok ? a.x + (m0 + r) * a.ldx + 8 * c : a.x;
    xdst[t] = st::sw128_offset(r, c, N);
    xcol[t] = ok ? 8 * c : INT_MAX / 2;
  }

  // Accumulator value i of this thread: M row 16 warp + lane / 4 + 8 hi is
  // weight column nl + hi of its tile, N column 8 (i / 4) + 2 q + i % 2 is
  // row m0 + that of x (int8_matmul.cu).
  float acc2[CT][N / 2];
#pragma unroll
  for (int ct = 0; ct < CT; ++ct)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc2[ct][i] = 0.f;

  for (int slice = 0; slice < a.slices; ++slice) {
    const int f0 = (slice * ranks + rank) * kF;
    const int8_t* w1src[kW1Copies];
    uint32_t w1dst[kW1Copies];
    int w1row[kW1Copies];
#pragma unroll
    for (int t = 0; t < kW1Copies; ++t) {
      const int i = threadIdx.x + t * kThreads, r = i / (kF / 16), c = i % (kF / 16);
      const bool ok = f0 + 16 * c < a.ff;
      w1src[t] = ok ? a.w1 + (long long)r * a.ff + f0 + 16 * c : a.w1;
      w1dst[t] = r * L::kWRow + 16 * c;
      w1row[t] = ok ? r : INT_MAX / 2;
    }
    auto issue = [&](int it) {   // x and the w1 slab of the it-th stage of k
      const int stage = it % kStages, dk = it * kStageK;
      const uint32_t xs = xs0 + stage * L::kX, ws = ws0 + stage * L::kW;
#pragma unroll
      for (int t = 0; t < kXCopies; ++t) {
        const bool ok = xcol[t] + dk < xe;
        if (N * 8 % kThreads == 0 || threadIdx.x + t * kThreads < N * 8)
          st::cp_async_16(xs + xdst[t], ok ? xsrc[t] + dk : a.x, ok);
      }
      if (a.vec1) {   // ff % 16 == 0 and w1 16-byte aligned: whole chunks
#pragma unroll
        for (int t = 0; t < kW1Copies; ++t) {
          const bool ok = w1row[t] + dk < a.k;
          st::cp_async_16(ws + w1dst[t], ok ? w1src[t] + (long long)dk * a.ff : a.w1, ok);
        }
      } else {
        unsigned char* wb = smem + kStages * L::kX + stage * L::kW;
        for (int i = threadIdx.x; i < kStageK * kF; i += kThreads) {
          const int r = i / kF, c = i % kF;
          const bool ok = dk + r < a.k && f0 + c < a.ff;
          wb[r * L::kWRow + c] = ok ? a.w1[(long long)(dk + r) * a.ff + f0 + c] : 0;
        }
      }
    };
    auto issue_w2 = [&]() {   // the slab w2[f0 : f0 + kF, n0 : n0 + 64 CT]
      if (a.vec2) {
#pragma unroll
        for (int t = 0; t < kW2Copies; ++t) {
          const int i = threadIdx.x + t * kThreads, r = i / (4 * CT), c = i % (4 * CT);
          const bool ok = f0 + r < a.ff && n0 + 16 * c < a.n;
          st::cp_async_16(hs + L::kH + r * L::kW2Row + 16 * c,
                          ok ? a.w2 + (long long)(f0 + r) * a.n + n0 + 16 * c : a.w2, ok);
        }
      } else {
        for (int i = threadIdx.x; i < kF * kCols * CT; i += kThreads) {
          const int r = i / (kCols * CT), c = i % (kCols * CT);
          const bool ok = f0 + r < a.ff && n0 + c < a.n;
          w2s[r * L::kW2Row + c] = ok ? a.w2[(long long)(f0 + r) * a.n + n0 + c] : 0;
        }
      }
    };

    // 1. hᵀ of the slice's MT tiles over the whole of k.
    float acc[MT][N / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[mt][i] = 0.f;
#pragma unroll
    for (int it = 0; it < kStages - 1; ++it) {   // one commit group per stage
      if (it < steps) issue(it);
      if (it == 0) issue_w2();
      st::cp_async_commit();
    }
    // s1 and b1 of this thread's hidden columns, loaded under the copies.
    float sc[MT][2], bi[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int f = f0 + 64 * mt + nl + hi;
        sc[mt][hi] = f < a.ff ? a.s1[f] : 0.f;
        bi[mt][hi] = f < a.ff ? a.b1[f] : 0.f;
      }
    for (int it = 0; it < steps; ++it) {
      st::cp_async_wait<kStages - 2>();   // this stage's group has landed
      st::fence_proxy_async();
      __syncthreads();
      const int stage = it % kStages;
      const uint32_t xs = xs0 + stage * L::kX;
      const unsigned char* ws = smem + kStages * L::kX + stage * L::kW + nl;
      uint32_t af[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          st::int8::a_fragment(ws + 64 * mt, L::kWRow, ks, q, af[mt][ks]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) st::fence_regs(acc[mt]);
      st::wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          st::wgmma_rs_k16_kmajor<N>(acc[mt], af[mt][ks][0], af[mt][ks][1], af[mt][ks][2],
                                     af[mt][ks][3], st::desc_k_major(xs, N, ks));
      st::wgmma_commit();
      // The previous stage's products are done, so its slot takes the
      // stage kStages - 1 ahead.
      st::wgmma_wait<1>();
      if (it + kStages - 1 < steps) issue(it + kStages - 1);
      st::cp_async_commit();
    }
    st::wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) st::fence_regs(acc[mt]);
    st::cp_async_wait<0>();

    // 2. h = bf16(relu(acc * s1 + b1)), 0 past ff, into the swizzled tile:
    // value pairs of one x row and neighbouring hidden columns.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int fl = 64 * mt + nl;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int dr = 0; dr < 2; ++dr) {
          const int r = 8 * j + 2 * q + dr;
          const float lo =
              fmaxf(__fadd_rn(__fmul_rn(acc[mt][4 * j + dr], sc[mt][0]), bi[mt][0]), 0.f);
          const float hi =
              fmaxf(__fadd_rn(__fmul_rn(acc[mt][4 * j + 2 + dr], sc[mt][1]), bi[mt][1]), 0.f);
          *reinterpret_cast<uint32_t*>(smem + L::kRing + st::sw128_offset(r, fl >> 3, N) +
                                       (fl & 7) * 2) = st::pack_bf16(lo, hi);
        }
    }
    st::fence_proxy_async();
    __syncthreads();   // h and the w2 slab are complete

    // 3. yᵀ[64, N] += w2[slice, tile]ᵀ hᵀ for each output tile.
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) {
      uint32_t bf[4 * MT][4];
#pragma unroll
      for (int ks = 0; ks < 4 * MT; ++ks)
        st::int8::a_fragment(w2s + kCols * ct + nl, L::kW2Row, ks, q, bf[ks]);
      st::fence_regs(acc2[ct]);
      st::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4 * MT; ++ks)
        st::wgmma_rs_k16_kmajor<N>(acc2[ct], bf[ks][0], bf[ks][1], bf[ks][2], bf[ks][3],
                                   st::desc_k_major(hs, N, ks));
      st::wgmma_commit();
      st::wgmma_wait<0>();
      st::fence_regs(acc2[ct]);
    }
    __syncthreads();   // the next slice refills the ring, h and the w2 slab
  }

  // 4. Reduce-scatter over the cluster, tile by tile. Float4 j of this
  // thread is unit u = threadIdx.x * N / 8 + j of a tile; rank r owns units
  // [ceil(r U / S), ceil((r + 1) U / S)) and keeps rank s's copy in slot s
  // of its share of that tile.
  constexpr uint32_t kU = L::kUnits;
  const uint32_t share = L::share(ranks);
  st::cluster_wait();
#pragma unroll
  for (int ct = 0; ct < CT; ++ct)
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const uint32_t u = threadIdx.x * (N / 8) + j;
      const uint32_t owner = u * ranks / kU;
      const uint32_t lo = (owner * kU + ranks - 1) / ranks;
      st::st_async_16(
          st::map_rank(slots + ((ct * ranks + rank) * share + u - lo) * 16, owner),
          make_float4(acc2[ct][4 * j], acc2[ct][4 * j + 1], acc2[ct][4 * j + 2],
                      acc2[ct][4 * j + 3]),
          st::map_rank(bar, owner));
    }
  const uint32_t lo = (rank * kU + ranks - 1) / ranks;
  const uint32_t hi = ((rank + 1) * kU + ranks - 1) / ranks;
  if (threadIdx.x == 0) st::mbar_arrive_expect(bar, CT * ranks * (hi - lo) * 16);
  st::mbar_wait(bar, 0);
  const float4* part = reinterpret_cast<const float4*>(smem + L::kRing + L::kH + L::kW2);
  for (uint32_t i = threadIdx.x; i < CT * (hi - lo); i += kThreads) {
    const int ct = static_cast<int>(i / (hi - lo));
    const uint32_t u = lo + i % (hi - lo);
    const float4* slot = part + ct * ranks * share + u - lo;
    float4 s = slot[0];
    for (int r = 1; r < ranks; ++r) {   // in rank order: the same bits every run
      const float4 v = slot[r * share];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int t = static_cast<int>(u / (N / 8)), j = static_cast<int>(u % (N / 8));
    const int tl = t & 31;
    const int col = n0 + kCols * ct + 16 * (t >> 5) + 2 * (tl >> 2);
    const int row = m0 + 8 * j + 2 * (tl & 3);
    store_pair(a, row, col, s.x, s.z);
    store_pair(a, row + 1, col, s.y, s.w);
  }
}

template <int N, int MT, int CT>
cudaError_t launch_bf16_tile(const FfnArgs& a, int ranks, cudaStream_t stream) {
  using L = FfnSmem<N, MT, CT>;
  static bool configured = false;   // the attributes are set once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(int8_ffn_bf16_kernel<N, MT, CT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(L::kMaxBytes));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(int8_ffn_bf16_kernel<N, MT, CT>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.n + kCols * CT - 1) / (kCols * CT), (a.m + N - 1) / N, ranks);
  cfg.blockDim = dim3(kWg);
  cfg.dynamicSmemBytes = L::bytes(ranks);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = ranks;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, int8_ffn_bf16_kernel<N, MT, CT>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Two output tiles a cluster only up to 40 rows: their accumulators stay in
// registers beside the hidden tiles'.
template <int N>
cudaError_t launch_bf16_rows(const FfnArgs& a, int hidden_tiles, int col_tiles, int ranks,
                             cudaStream_t stream) {
  if (hidden_tiles == 1 && col_tiles == 1) return launch_bf16_tile<N, 1, 1>(a, ranks, stream);
  if (hidden_tiles == 2 && col_tiles == 1) return launch_bf16_tile<N, 2, 1>(a, ranks, stream);
  if constexpr (N <= 40) {
    if (hidden_tiles == 1 && col_tiles == 2) return launch_bf16_tile<N, 1, 2>(a, ranks, stream);
    if (hidden_tiles == 2 && col_tiles == 2) return launch_bf16_tile<N, 2, 2>(a, ranks, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_bf16(const FfnArgs& a, int rows, int hidden_tiles, int col_tiles,
                        int ranks, cudaStream_t stream) {
  switch (rows) {
    case 8: return launch_bf16_rows<8>(a, hidden_tiles, col_tiles, ranks, stream);
    case 16: return launch_bf16_rows<16>(a, hidden_tiles, col_tiles, ranks, stream);
    case 24: return launch_bf16_rows<24>(a, hidden_tiles, col_tiles, ranks, stream);
    case 32: return launch_bf16_rows<32>(a, hidden_tiles, col_tiles, ranks, stream);
    case 40: return launch_bf16_rows<40>(a, hidden_tiles, col_tiles, ranks, stream);
    case 48: return launch_bf16_rows<48>(a, hidden_tiles, col_tiles, ranks, stream);
    case 56: return launch_bf16_rows<56>(a, hidden_tiles, col_tiles, ranks, stream);
    case 64: return launch_bf16_rows<64>(a, hidden_tiles, col_tiles, ranks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16: x rows 16-byte aligned with ldx % 8 == 0 and ceil8(k) readable
// columns (zeros past k); `rows` (a multiple of 8, <= 64) rows of x and
// 64 * `col_tiles` (1, or 2 up to 40 rows) columns of y per cluster of
// `ranks` (<= 16) blocks, each taking 64 * `hidden_tiles` (1 or 2) hidden
// columns a slice; `partial` and `counters` are unused. f32 ignores rows, hidden_tiles and ranks:
// `partial` is f32 scratch of [ceil(ff / 128), m, n] and `counters` holds
// ceil(m / 64) * ceil(n / 64) ints that are 0 at launch (the kernel leaves
// them 0).
extern "C" int st_int8_ffn(const void* x, const void* w1q, const float* s1,
                           const float* b1, const void* w2q, const float* s2,
                           const float* b2, void* y, float* partial, int* counters,
                           int m, int k, int ff, int n, long long ldx, int rows,
                           int hidden_tiles, int col_tiles, int ranks, int is_bf16,
                           cudaStream_t stream) {
  if (m < 0 || k < 0 || ff < 1 || n < 0 || ldx < k) return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  const int8_t* w1 = static_cast<const int8_t*>(w1q);
  const int8_t* w2 = static_cast<const int8_t*>(w2q);
  if (!is_bf16)
    return launch_f32(static_cast<const float*>(x), w1, s1, b1, w2, s2, b2,
                      static_cast<float*>(y), partial, counters, m, k, ff, n, ldx, stream);
  if (ranks < 1 || ranks > kMaxRanks ||
      (k > 0 && (ldx % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)))
    return cudaErrorInvalidValue;
  const int per_slice = 64 * hidden_tiles * ranks;
  FfnArgs a{static_cast<const __nv_bfloat16*>(x), w1, s1, b1, w2, s2, b2,
            static_cast<__nv_bfloat16*>(y), m, k, ff, n, (ff + per_slice - 1) / per_slice,
            st::int8::vec_ok<int8_t>(w1, ff, ff) ? 1 : 0,
            st::int8::vec_ok<int8_t>(w2, n, n) ? 1 : 0, ldx};
  return launch_bf16(a, rows, hidden_tiles, col_tiles, ranks, stream);
}
