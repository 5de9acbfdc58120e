// Flash attention for training: forward, dK/dV and dQ.
//
// Replaces the TPU kernels of speech_tranformer_pytorch_tpu/kernels/
// flash_attention.py: `_fa_kernel` (:85, forward with the logsumexp),
// `_fa_bwd_dkv_kernel` (:248) and `_fa_bwd_dq_kernel` (:313). Semantics:
//   s[t, j] = q[t] . k[j] / sqrt(D), kept iff j < kv_len[b] (and j <= t when
//   causal); masked scores are -0.7 * FLT_MAX, never -inf; query rows are
//   not masked. The forward keeps f32 m, l and accumulator (online softmax)
//   and writes o and lse = m + log(max(l, 1e-37)); a row with no valid key
//   gives o = 0 and a finite lse. The backward recomputes
//   p = exp(s - lse) from the saved lse, never stores scores, and takes
//   di = rowsum(o * dO) from the caller (the caller may fold an lse
//   cotangent into it as di - dlse).
//
// Layout: every tensor is addressed as (b, h, t, d) through its own
// (b, h, t) strides with d contiguous, so [B, T, H, D] activations and the
// views of a fused QKV projection are read in place, with no transpose and
// no padding copy. lse and di are f32 [B, H, Tq].
//
// Design. The TPU grid walked the kv axis (forward, dQ) or the q axis
// (dKV) in order and carried its sums in scratch; here one block owns one
// tile of the other axis and walks that axis in a loop, so blocks share no
// state and no output element is written by two blocks (no atomics: a
// second call gives the same bits). Ragged edges are zero-filled on load
// and masked in the scores; whole tiles past kv_len or above the causal
// diagonal are never visited. For bf16 the softmax weights p (forward and
// backward) and ds are rounded to bf16 before their products, as the TPU
// forward rounds p before its PV product.
//
// f32 (forward and backward), which serves only the card-against-CPU f32
// checks: 128-thread blocks, 32 x 32 tiles staged in shared memory,
// products as f32 FMAs.
//
// bf16 (Hopper): one warpgroup per block, 64-row tiles, every product a
// wgmma (hopper.cuh). The forward keeps its Q tile and streams K and V;
// the dK/dV kernel keeps its K and V tiles and streams Q, dO, lse and di;
// the dQ kernel keeps Q and dO and streams K and V. The stream runs
// through a ring of three stages (two at D = 128) in shared memory filled
// by cp.async, so the next tiles' copies run under this tile's products.
// S (or Sᵀ) and dP (or dPᵀ) take both operands from shared memory into f32
// accumulators in registers; p and ds are computed, masked and rounded to
// bf16 in those registers and fed straight back as the A operand of
// O += P V, dV += Pᵀ dO, dK += dSᵀ Q and dQ += dS K, whose f32
// accumulators stay in registers for the whole loop (the forward's online
// max and sum too: each row lives in one quad of lanes, so the rescale of
// O is a register multiply). Each output tile is written once, through a
// staging tile, with 16-byte stores. These kernels take D up to 128
// padded to 64 or 128 columns, rows that start 16-byte aligned, and D a
// multiple of 8 or rows zero-padded to one (the wrapper copies other
// inputs; `vec` is not read).
//
// What bounds it on an H100: at the train path's shapes (T' ~ 150, D = 64)
// the bound is bytes (each input read once, each output written once).
// The kernels sit above it because one warpgroup a block runs a serial
// chain per tile (wait for the copy, S, softmax, the next products) and
// each block walks only a few tiles (three at T' 149, one at the decoder's
// 32), so the first copies and the epilogue weigh on a short life; several
// blocks per SM hide each other's waits. The backward also computes S, dP
// and exp for every tile pair in both kernels (7 products a pair where the
// gradients need 5) and rereads the streamed tiles from L2 once per owned
// tile.
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

struct Params {
  const void *q, *k, *v, *dout;   // dout = dO (backward)
  void *out, *dq, *dk, *dv;       // out = o (forward)
  float* lse;                     // [B, H, Tq], written by the forward
  const float* lse_in;            // [B, H, Tq], read by the backward
  const float* di;                // [B, H, Tq]
  const int* kv_len;              // [B]
  // (b, h, t) strides, in elements, of q, k, v, o, dO, dq, dk, dv.
  long long s[8][3];
  int H, Tq, Tk, D, Dp, causal, vec;
  float scale;
};

enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV };

__device__ __forceinline__ long long offset(const Params& p, int which, int b,
                                            int h, int t) {
  return b * p.s[which][0] + h * p.s[which][1] + t * p.s[which][2];
}

// dst[r][d] (leading dimension ld) = src(b, h, row0 + r, d) for r < rows,
// d < D, where rows past `limit` and columns in [D, Dp) are zero.
__device__ void load_tile(float* dst, int ld, const Params& p, int which,
                          const void* src_v, int b, int h, int row0, int rows,
                          int limit) {
  const float* src = static_cast<const float*>(src_v);
  const int D = p.D, Dp = p.Dp;
  constexpr int kVec = 16 / sizeof(float);
  if (p.vec) {   // D % kVec == 0 and every row 16-byte aligned (host checks)
    const int chunks = D / kVec;
    for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
      const int r = i / chunks, c = (i - r * chunks) * kVec;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row0 + r < limit)
        val = *reinterpret_cast<const uint4*>(src + offset(p, which, b, h, row0 + r) + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
    if (Dp > D) {
      for (int i = threadIdx.x; i < rows * (Dp - D); i += blockDim.x) {
        const int r = i / (Dp - D), c = D + i % (Dp - D);
        dst[r * ld + c] = 0.f;
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * Dp; i += blockDim.x) {
    const int r = i / Dp, c = i - r * Dp;
    float val = 0.f;
    if (row0 + r < limit && c < D) val = src[offset(p, which, b, h, row0 + r) + c];
    dst[r * ld + c] = val;
  }
}

// C[M x N] (+)= op(A) op(B) over K in f32 FMAs; op(A)[i][k] = kTA ?
// A[k*lda+i] : A[i*lda+k], op(B)[k][j] = kTB ? B[j*ldb+k] : B[k*ldb+j].
// Ends without a barrier.
template <bool kTA, bool kTB, bool kAcc>
__device__ void block_gemm(const float* A, int lda, const float* B, int ldb, float* C,
                           int ldc, int M, int N, int K) {
  for (int idx = threadIdx.x; idx < M * N; idx += blockDim.x) {
    const int i = idx / N, j = idx - i * N;
    float acc = kAcc ? C[i * ldc + j] : 0.f;
    for (int kk = 0; kk < K; ++kk) {
      const float a = kTA ? A[kk * lda + i] : A[i * lda + kk];
      const float bv = kTB ? B[j * ldb + kk] : B[kk * ldb + j];
      acc = fmaf(a, bv, acc);
    }
    C[i * ldc + j] = acc;
  }
}

__device__ __forceinline__ int clamp_len(const Params& p, int b) {
  return min(max(p.kv_len[b], 0), p.Tk);
}

__device__ __forceinline__ bool kept(const Params& p, int row, int col, int kv_len) {
  return col < kv_len && (!p.causal || col <= row);
}

// Leading dimensions of the f32 kernels' tiles: input tiles pad by 8
// elements, score and accumulator tiles by 4, staggering shared-memory banks.
__host__ __device__ inline int ld_t(int Dp) { return Dp + 8; }
__host__ __device__ inline int ld_f(int n) { return n + 4; }

// ---------------------------------------------------------------- forward
template <int BQ, int BK>
__host__ __device__ size_t fwd_smem(int Dp) {
  return sizeof(float) * (size_t)(BQ + 2 * BK) * ld_t(Dp)      // Q, K, V
         + sizeof(float) * (size_t)BQ * (BK + 8)                // P
         + sizeof(float) * (size_t)BQ * (ld_f(BK) + ld_f(Dp))  // S, O
         + sizeof(float) * 3 * BQ;                          // m, l, alpha
}

template <int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int Dp = p.Dp, ldt = ld_t(Dp), ldp = BK + 8, lds = ld_f(BK), ldo = ld_f(Dp);
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BQ * ldt;
  float* Vs = Ks + BK * ldt;
  float* Ps = Vs + BK * ldt;
  float* S = reinterpret_cast<float*>(Ps + BQ * ldp);
  float* O = S + BQ * lds;
  float* m = O + BQ * ldo;
  float* l = m + BQ;
  float* alpha = l + BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const int kv_len = clamp_len(p, b);
  const int kend = p.causal ? min(kv_len, q0 + BQ) : kv_len;
  load_tile(Qs, ldt, p, kQ, p.q, b, h, q0, BQ, p.Tq);
  for (int i = threadIdx.x; i < BQ * ldo; i += blockDim.x) O[i] = 0.f;
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    m[r] = kMaskValue;
    l[r] = 0.f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < kend; k0 += BK) {
    load_tile(Ks, ldt, p, kK, p.k, b, h, k0, BK, kv_len);
    load_tile(Vs, ldt, p, kV, p.v, b, h, k0, BK, kv_len);
    __syncthreads();
    block_gemm<false, true, false>(Qs, ldt, Ks, ldt, S, lds, BQ, BK, Dp);
    __syncthreads();
    for (int r = warp; r < BQ; r += kWarps) {
      const int row = q0 + r;
      float s[BK / 32];
      float m_cur = kMaskValue;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const int col = lane + 32 * c;
        s[c] = kept(p, row, k0 + col, kv_len) ? S[r * lds + col] * p.scale : kMaskValue;
        m_cur = fmaxf(m_cur, s[c]);
      }
      m_cur = st::warp_max(m_cur);
      const float m_prev = m[r];
      const float m_next = fmaxf(m_prev, m_cur);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const float e = expf(s[c] - m_next);
        sum += e;
        Ps[r * ldp + lane + 32 * c] = e;
      }
      sum = st::warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_next);
        alpha[r] = a;
        m[r] = m_next;
        l[r] = a * l[r] + sum;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * Dp; i += blockDim.x) {
      const int r = i / Dp;
      O[r * ldo + (i - r * Dp)] *= alpha[r];
    }
    __syncthreads();
    block_gemm<false, false, true>(Ps, ldp, Vs, ldt, O, ldo, BQ, Dp, BK);
    __syncthreads();
  }

  float* out = static_cast<float*>(p.out);
  for (int i = threadIdx.x; i < BQ * p.D; i += blockDim.x) {
    const int r = i / p.D, d = i - r * p.D;
    const int row = q0 + r;
    if (row < p.Tq) {
      const float lr = l[r];
      const float l_inv = lr == 0.f ? 1.f : 1.f / lr;
      out[offset(p, kO, b, h, row) + d] = O[r * ldo + d] * l_inv;
    }
  }
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    const int row = q0 + r;
    if (row < p.Tq)
      p.lse[((size_t)b * p.H + h) * p.Tq + row] = m[r] + logf(fmaxf(l[r], 1e-37f));
  }
}

// ------------------------------------------- backward, f32: shared helpers
// For one (q tile, kv tile) pair: S = Q K^T, dP = dO V^T, then
// P = exp(S*scale - lse) on kept pairs (0 elsewhere) and dS = P (dP - di).
// P and dS are written for the following products (Pt may be null).
template <int BQ, int BK>
__device__ void bwd_probs(const Params& p, const float* Qs, const float* dOs, const float* Ks,
                          const float* Vs, float* S, float* dP, const float* lse_s,
                          const float* di_s, float* Pt, float* dSt, int q0, int k0,
                          int kv_len) {
  const int Dp = p.Dp, ldt = ld_t(Dp), lds = ld_f(BK), ldp = BK + 8;
  block_gemm<false, true, false>(Qs, ldt, Ks, ldt, S, lds, BQ, BK, Dp);
  block_gemm<false, true, false>(dOs, ldt, Vs, ldt, dP, lds, BQ, BK, Dp);
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * BK; i += blockDim.x) {
    const int r = i / BK, c = i - r * BK;
    const int row = q0 + r;
    float pv = 0.f;
    if (row < p.Tq && kept(p, row, k0 + c, kv_len))
      pv = expf(S[r * lds + c] * p.scale - lse_s[r]);
    const float ds = pv * (dP[r * lds + c] - di_s[r]);
    if (Pt != nullptr) Pt[r * ldp + c] = pv;
    dSt[r * ldp + c] = ds;
  }
  __syncthreads();
}

__device__ void load_stats(const Params& p, float* lse_s, float* di_s, int b,
                           int h, int q0, int rows) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int row = q0 + r;
    const size_t at = ((size_t)b * p.H + h) * p.Tq + row;
    lse_s[r] = row < p.Tq ? p.lse_in[at] : 0.f;
    di_s[r] = row < p.Tq ? p.di[at] : 0.f;
  }
}

// ----------------------------------------------------- backward dKV, f32
template <int BQ, int BK>
__host__ __device__ size_t dkv_smem(int Dp) {
  return sizeof(float) * (size_t)(2 * BK + 2 * BQ) * ld_t(Dp)   // K, V, Q, dO
         + sizeof(float) * (size_t)2 * BQ * (BK + 8)             // P, dS
         + sizeof(float) * (size_t)2 * BQ * ld_f(BK)         // S, dP
         + sizeof(float) * (size_t)2 * BK * ld_f(Dp)         // dK, dV
         + sizeof(float) * 2 * BQ;                           // lse, di
}

template <int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BK;
  const int Dp = p.Dp, ldt = ld_t(Dp), ldp = BK + 8, lds = ld_f(BK), ldo = ld_f(Dp);
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BK * ldt;
  float* Qs = Vs + BK * ldt;
  float* dOs = Qs + BQ * ldt;
  float* Pt = dOs + BQ * ldt;
  float* dSt = Pt + BQ * ldp;
  float* S = reinterpret_cast<float*>(dSt + BQ * ldp);
  float* dP = S + BQ * lds;
  float* dK = dP + BQ * lds;
  float* dV = dK + BK * ldo;
  float* lse_s = dV + BK * ldo;
  float* di_s = lse_s + BQ;

  const int kv_len = clamp_len(p, b);
  for (int i = threadIdx.x; i < BK * ldo; i += blockDim.x) {
    dK[i] = 0.f;
    dV[i] = 0.f;
  }
  if (k0 < kv_len) {   // a tile wholly past kv_len has zero gradients
    load_tile(Ks, ldt, p, kK, p.k, b, h, k0, BK, kv_len);
    load_tile(Vs, ldt, p, kV, p.v, b, h, k0, BK, kv_len);
    // Under the causal mask no row before k0 sees this tile's keys.
    for (int q0 = p.causal ? (k0 / BQ) * BQ : 0; q0 < p.Tq; q0 += BQ) {
      load_tile(Qs, ldt, p, kQ, p.q, b, h, q0, BQ, p.Tq);
      load_tile(dOs, ldt, p, kDO, p.dout, b, h, q0, BQ, p.Tq);
      load_stats(p, lse_s, di_s, b, h, q0, BQ);
      __syncthreads();
      bwd_probs<BQ, BK>(p, Qs, dOs, Ks, Vs, S, dP, lse_s, di_s, Pt, dSt, q0,
                           k0, kv_len);
      block_gemm<true, false, true>(Pt, ldp, dOs, ldt, dV, ldo, BK, Dp, BQ);
      block_gemm<true, false, true>(dSt, ldp, Qs, ldt, dK, ldo, BK, Dp, BQ);
      __syncthreads();
    }
  }
  __syncthreads();
  float* dk = static_cast<float*>(p.dk);
  float* dv = static_cast<float*>(p.dv);
  for (int i = threadIdx.x; i < BK * p.D; i += blockDim.x) {
    const int r = i / p.D, d = i - r * p.D;
    const int row = k0 + r;
    if (row < p.Tk) {
      dk[offset(p, kDK, b, h, row) + d] = dK[r * ldo + d] * p.scale;
      dv[offset(p, kDV, b, h, row) + d] = dV[r * ldo + d];
    }
  }
}

// ------------------------------------------------------ backward dQ, f32
template <int BQ, int BK>
__host__ __device__ size_t dq_smem(int Dp) {
  return sizeof(float) * (size_t)(2 * BQ + 2 * BK) * ld_t(Dp)   // Q, dO, K, V
         + sizeof(float) * (size_t)BQ * (BK + 8)                 // dS
         + sizeof(float) * (size_t)2 * BQ * ld_f(BK)         // S, dP
         + sizeof(float) * (size_t)BQ * ld_f(Dp)             // dQ
         + sizeof(float) * 2 * BQ;                           // lse, di
}

template <int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int Dp = p.Dp, ldt = ld_t(Dp), ldp = BK + 8, lds = ld_f(BK), ldo = ld_f(Dp);
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + BQ * ldt;
  float* Ks = dOs + BQ * ldt;
  float* Vs = Ks + BK * ldt;
  float* dSt = Vs + BK * ldt;
  float* S = reinterpret_cast<float*>(dSt + BQ * ldp);
  float* dP = S + BQ * lds;
  float* dQ = dP + BQ * lds;
  float* lse_s = dQ + BQ * ldo;
  float* di_s = lse_s + BQ;

  const int kv_len = clamp_len(p, b);
  const int kend = p.causal ? min(kv_len, q0 + BQ) : kv_len;
  load_tile(Qs, ldt, p, kQ, p.q, b, h, q0, BQ, p.Tq);
  load_tile(dOs, ldt, p, kDO, p.dout, b, h, q0, BQ, p.Tq);
  load_stats(p, lse_s, di_s, b, h, q0, BQ);
  for (int i = threadIdx.x; i < BQ * ldo; i += blockDim.x) dQ[i] = 0.f;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    load_tile(Ks, ldt, p, kK, p.k, b, h, k0, BK, kv_len);
    load_tile(Vs, ldt, p, kV, p.v, b, h, k0, BK, kv_len);
    __syncthreads();
    bwd_probs<BQ, BK>(p, Qs, dOs, Ks, Vs, S, dP, lse_s, di_s, nullptr, dSt,
                         q0, k0, kv_len);
    block_gemm<false, false, true>(dSt, ldp, Ks, ldt, dQ, ldo, BQ, Dp, BK);
    __syncthreads();
  }
  __syncthreads();
  float* dq = static_cast<float*>(p.dq);
  for (int i = threadIdx.x; i < BQ * p.D; i += blockDim.x) {
    const int r = i / p.D, d = i - r * p.D;
    const int row = q0 + r;
    if (row < p.Tq) dq[offset(p, kDQ, b, h, row) + d] = dQ[r * ldo + d] * p.scale;
  }
}

// ------------------------------------------------------- bf16 (Hopper)
// One warpgroup per block; every tile has kRows rows, the M of wgmma. A
// tile of kD (64 or 128) columns is laid out as in hopper.cuh.
constexpr int kRows = 64;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kThreads == 2 * kRows, "one thread copies each lse and di value");

// Shared memory, from a 1024-byte aligned base: the block's own two tiles,
// the ring of kStages x 2 streamed tiles, then (dK/dV) lse and di of each
// stage. Three stages at D = 64 (68 KB, three blocks an SM); two at
// D = 128, where a third would leave one block an SM and spill dK/dV's
// registers (measured in PERF.md).
template <int kD>
struct BwdSmem {
  static constexpr int kStages = kD == 64 ? 3 : 2;
  static constexpr uint32_t kTile = kRows * kD * 2;
  static constexpr uint32_t kRing = 2 * kTile;
  static constexpr uint32_t kStats = kRing + kStages * 2 * kTile;
  static constexpr uint32_t kBytes = kStats + 2 * kStages * kRows * 4 + 1024;  // + alignment
};

// Starts the copy of rows row0 .. row0 + kRows - 1 of one (b, h) slice into
// the swizzled tile at `dst`; rows at or past `limit` and chunks past D are
// zero-filled.
template <int kD>
__device__ __forceinline__ void copy_tile(uint32_t dst, const Params& p, int which,
                                          const void* src_v, int b, int h, int row0,
                                          int limit) {
  const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(src_v);
  constexpr int kChunks = kD / 8;
  const int chunks = (p.D + 7) / 8;
#pragma unroll
  for (int n = 0; n < kRows * kChunks / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < limit && c < chunks;
    const __nv_bfloat16* from = ok ? src + offset(p, which, b, h, row0 + r) + 8 * c : src;
    st::cp_async_16(dst + st::sw128_offset(r, c, kRows), from, ok);
  }
}

// Starts the copy of lse and di of query rows q0 .. q0 + kRows - 1 (0 past Tq).
__device__ __forceinline__ void copy_stats(uint32_t lse_dst, uint32_t di_dst,
                                           const Params& p, int b, int h, int q0) {
  const int r = threadIdx.x % kRows;
  const bool is_lse = threadIdx.x < kRows, ok = q0 + r < p.Tq;
  const float* src = is_lse ? p.lse_in : p.di;
  const size_t at = ((size_t)b * p.H + h) * p.Tq + q0 + r;
  st::cp_async_4((is_lse ? lse_dst : di_dst) + 4 * r, ok ? src + at : src, ok);
}

// Writes this warpgroup's kRows x kD f32 accumulator, times `scale`, as bf16
// rows row0 .. of output `which` (rows past `limit`, chunks past D are left
// out): rounded into the staging tile `stage`, then stored 16 bytes a thread.
template <int kD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* stage, const float (&acc)[kD / 2],
                                           float scale, const Params& p, int which,
                                           void* dst_v, int b, int h, int row0, int limit) {
  constexpr int kLd = kD + 8;   // staggers the banks of the fragment writes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kD / 2; i += 2) {
    const int r = 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(stage + r * kLd + c) =
        __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
  }
  __syncthreads();
  __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(dst_v);
  const int chunks = (p.D + 7) / 8;
  for (int i = threadIdx.x; i < kRows * chunks; i += kThreads) {
    const int r = i / chunks, c = i - r * chunks;
    if (row0 + r < limit)
      *reinterpret_cast<uint4*>(dst + offset(p, which, b, h, row0 + r) + 8 * c) =
          *reinterpret_cast<const uint4*>(stage + r * kLd + 8 * c);
  }
}

// 1024-byte aligned start of the dynamic shared memory (generic pointer).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (st::smem_u32(raw) & 1023)) & 1023);
}

// Forward shared memory, from a 1024-byte aligned base: the block's Q
// tile, then the ring of kStages x (K, V) tiles: 56 KB at D = 64 (three
// stages, four blocks an SM), 80 KB at D = 128 (two stages).
template <int kD>
struct FwdSmem {
  static constexpr int kStages = kD == 64 ? 3 : 2;
  static constexpr uint32_t kTile = kRows * kD * 2;
  static constexpr uint32_t kBytes = kTile + kStages * 2 * kTile + 1024;  // + alignment
};

template <int kD>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16_kernel(Params p) {
  using L = FwdSmem<kD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t Qs = st::smem_u32(smem), ring = Qs + L::kTile;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kv_len = clamp_len(p, b);
  const int kend = p.causal ? min(kv_len, q0 + kRows) : kv_len;
  const int n = (kend + kRows - 1) / kRows;

  // This thread's two query rows of every fragment (r_lo and r_lo + 8),
  // their running max m of the scaled scores and sum l of p, in f32.
  const int r_lo = 16 * warp + (lane >> 2);
  float m2[2] = {kMaskValue, kMaskValue}, l2[2] = {0.f, 0.f};
  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
  auto issue = [&](int it) {   // K and V of the it-th kv tile
    const uint32_t stage = ring + (it % L::kStages) * 2 * L::kTile;
    copy_tile<kD>(stage, p, kK, p.k, b, h, it * kRows, kv_len);
    copy_tile<kD>(stage + L::kTile, p, kV, p.v, b, h, it * kRows, kv_len);
  };
  if (n > 0) {
    copy_tile<kD>(Qs, p, kQ, p.q, b, h, q0, p.Tq);
#pragma unroll
    for (int it = 0; it < L::kStages - 1; ++it) {   // one commit group per kv tile
      if (it < n) issue(it);
      st::cp_async_commit();
    }
    for (int it = 0; it < n; ++it) {
      if (it + L::kStages - 1 < n) issue(it + L::kStages - 1);
      st::cp_async_commit();
      st::cp_async_wait<L::kStages - 1>();   // this tile's group has landed
      st::fence_proxy_async();
      __syncthreads();
      const int k0 = it * kRows;
      const uint32_t Ks = ring + (it % L::kStages) * 2 * L::kTile, Vs = Ks + L::kTile;

      // S = Q Kᵀ: rows are this block's queries, columns keys.
      float s[32];
      st::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks)
        st::wgmma_ss_m64n64k16(s, st::desc_k_major(Qs, kRows, ks),
                               st::desc_k_major(Ks, kRows, ks), ks);
      st::wgmma_commit();
      st::wgmma_wait<0>();
      st::fence_regs(s);

      // Online softmax over the quad of lanes that shares each row: scaled
      // scores, masked ones at kMaskValue for the max, as the TPU kernel.
      uint32_t keep = 0;
      float mt[2] = {m2[0], m2[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hi = (i >> 1) & 1;
        const int t = q0 + r_lo + 8 * hi, j = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const bool kept_ij = j < kv_len && (!p.causal || j <= t);
        keep |= static_cast<uint32_t>(kept_ij) << i;
        s[i] = kept_ij ? s[i] * p.scale : kMaskValue;
        mt[hi] = fmaxf(mt[hi], s[i]);
      }
      float alpha[2], m_log2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mt[e] = fmaxf(mt[e], __shfl_xor_sync(0xffffffffu, mt[e], 1));
        mt[e] = fmaxf(mt[e], __shfl_xor_sync(0xffffffffu, mt[e], 2));
        alpha[e] = exp2f((m2[e] - mt[e]) * kLog2e);
        m2[e] = mt[e];
        m_log2[e] = mt[e] * kLog2e;
      }
      // p = exp(s - m) on kept pairs and exactly 0 elsewhere; l sums the
      // f32 p, the PV product takes p rounded to bf16 as A fragments.
      uint32_t pa[kRows / 16][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int hi = (i >> 1) & 1;
        float pv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          pv[e] = (keep >> (i + e)) & 1u ? exp2f(fmaf(s[i + e], kLog2e, -m_log2[hi])) : 0.f;
        rs[hi] += pv[0] + pv[1];
        pa[i >> 3][(i >> 1) & 3] = st::pack_bf16(pv[0], pv[1]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], 1);
        rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], 2);
        l2[e] = alpha[e] * l2[e] + rs[e];
      }

      // O = alpha O + P V, V read MN-major.
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      st::fence_regs(o);
      st::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks)
        st::wgmma_rs_k16(o, pa[ks], st::desc_mn_major(Vs, kRows, ks), 1);
      st::wgmma_commit();
      st::wgmma_wait<0>();
      st::fence_regs(o);
      __syncthreads();   // the stage is refilled at the top of the next iteration
    }
    st::cp_async_wait<0>();
  }
  // o = acc / l (a row with no kept key keeps acc = 0), staged through the
  // ring, free now; lse = m + log(max(l, 1e-37)) from one lane per row.
  float inv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) inv[e] = l2[e] == 0.f ? 1.f : 1.f / l2[e];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] *= inv[(i >> 1) & 1];
  store_rows<kD>(reinterpret_cast<__nv_bfloat16*>(smem + L::kTile), o, 1.f, p, kO, p.out, b,
                 h, q0, p.Tq);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = q0 + r_lo + 8 * e;
      if (t < p.Tq)
        p.lse[((size_t)b * p.H + h) * p.Tq + t] = m2[e] + logf(fmaxf(l2[e], 1e-37f));
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_bf16_kernel(Params p) {
  using L = BwdSmem<kD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = st::smem_u32(smem);
  const uint32_t Ks = base, Vs = base + L::kTile;
  const float* stats = reinterpret_cast<const float*>(smem + L::kStats);
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kv_len = clamp_len(p, b);
  const float scale_log2 = p.scale * kLog2e;

  float dk[kD / 2], dv[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = 0.f;
  // A tile wholly past kv_len has zero gradients; under the causal mask no
  // query row before k0 sees this tile's keys.
  const int q_first = p.causal ? blockIdx.x : 0;
  const int n = k0 < kv_len ? max((p.Tq + kRows - 1) / kRows - q_first, 0) : 0;
  auto issue = [&](int it) {   // Q, dO, lse and di of the it-th q tile
    const int stage = it % L::kStages, q0 = (q_first + it) * kRows;
    const uint32_t ring = base + L::kRing + stage * 2 * L::kTile;
    copy_tile<kD>(ring, p, kQ, p.q, b, h, q0, p.Tq);
    copy_tile<kD>(ring + L::kTile, p, kDO, p.dout, b, h, q0, p.Tq);
    copy_stats(base + L::kStats + stage * kRows * 4,
               base + L::kStats + (L::kStages + stage) * kRows * 4, p, b, h, q0);
  };
  if (n > 0) {
    copy_tile<kD>(Ks, p, kK, p.k, b, h, k0, kv_len);
    copy_tile<kD>(Vs, p, kV, p.v, b, h, k0, kv_len);
#pragma unroll
    for (int it = 0; it < L::kStages - 1; ++it) {   // one commit group per q tile
      if (it < n) issue(it);
      st::cp_async_commit();
    }
    for (int it = 0; it < n; ++it) {
      if (it + L::kStages - 1 < n) issue(it + L::kStages - 1);
      st::cp_async_commit();
      st::cp_async_wait<L::kStages - 1>();   // this tile's group has landed
      st::fence_proxy_async();
      __syncthreads();
      const int stage = it % L::kStages, q0 = (q_first + it) * kRows;
      const uint32_t Qs = base + L::kRing + stage * 2 * L::kTile, dOs = Qs + L::kTile;
      const float* lse_s = stats + stage * kRows;
      const float* di_s = stats + (L::kStages + stage) * kRows;

      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: rows are this block's keys, columns queries.
      float s[32], dp[32];
      st::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks)
        st::wgmma_ss_m64n64k16(s, st::desc_k_major(Ks, kRows, ks),
                               st::desc_k_major(Qs, kRows, ks), ks);
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks)
        st::wgmma_ss_m64n64k16(dp, st::desc_k_major(Vs, kRows, ks),
                               st::desc_k_major(dOs, kRows, ks), ks);
      st::wgmma_commit();
      st::wgmma_wait<0>();
      st::fence_regs(s);
      st::fence_regs(dp);

      // Pᵀ = exp(scale·Sᵀ − lse) on kept pairs (0 elsewhere) and
      // dSᵀ = Pᵀ (dPᵀ − di), rounded to bf16 as A fragments.
      uint32_t pa[kRows / 16][4], dsa[kRows / 16][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int j = k0 + 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
        const int c = 8 * (i >> 2) + 2 * (lane & 3);
        float pv[2], dsv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = q0 + c + e;
          const bool keep = t < p.Tq && j < kv_len && (!p.causal || j <= t);
          pv[e] = keep ? exp2f(s[i + e] * scale_log2 - lse_s[c + e] * kLog2e) : 0.f;
          dsv[e] = pv[e] * (dp[i + e] - di_s[c + e]);
        }
        pa[i >> 3][(i >> 1) & 3] = st::pack_bf16(pv[0], pv[1]);
        dsa[i >> 3][(i >> 1) & 3] = st::pack_bf16(dsv[0], dsv[1]);
      }

      // dV += Pᵀ dO and dK += dSᵀ Q, dO and Q read MN-major.
      st::fence_regs(dv);
      st::fence_regs(dk);
      st::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks)
        st::wgmma_rs_k16(dv, pa[ks], st::desc_mn_major(dOs, kRows, ks), 1);
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks)
        st::wgmma_rs_k16(dk, dsa[ks], st::desc_mn_major(Qs, kRows, ks), 1);
      st::wgmma_commit();
      st::wgmma_wait<0>();
      st::fence_regs(dv);
      st::fence_regs(dk);
      __syncthreads();   // the stage is refilled at the top of the next iteration
    }
  }
  // Staged through the K/V tiles and ring stage 0, both free now.
  store_rows<kD>(reinterpret_cast<__nv_bfloat16*>(smem), dv, 1.f, p, kDV, p.dv, b, h,
                 k0, p.Tk);
  store_rows<kD>(reinterpret_cast<__nv_bfloat16*>(smem + L::kRing), dk, p.scale, p, kDK,
                 p.dk, b, h, k0, p.Tk);
}

template <int kD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16_kernel(Params p) {
  using L = BwdSmem<kD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = st::smem_u32(smem);
  const uint32_t Qs = base, dOs = base + L::kTile;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kv_len = clamp_len(p, b);
  const int kend = p.causal ? min(kv_len, q0 + kRows) : kv_len;
  const int n = (kend + kRows - 1) / kRows;
  const float scale_log2 = p.scale * kLog2e;

  // This thread's two query rows of every fragment, and their lse and di.
  const int r_lo = 16 * warp + (lane >> 2);
  float lse2[2], di2[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = q0 + r_lo + 8 * e;
    const size_t at = ((size_t)b * p.H + h) * p.Tq + t;
    lse2[e] = t < p.Tq ? p.lse_in[at] * kLog2e : 0.f;
    di2[e] = t < p.Tq ? p.di[at] : 0.f;
  }
  float dq[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dq[i] = 0.f;
  auto issue = [&](int it) {   // K and V of the it-th kv tile
    const uint32_t ring = base + L::kRing + (it % L::kStages) * 2 * L::kTile;
    copy_tile<kD>(ring, p, kK, p.k, b, h, it * kRows, kv_len);
    copy_tile<kD>(ring + L::kTile, p, kV, p.v, b, h, it * kRows, kv_len);
  };
  if (n > 0) {
    copy_tile<kD>(Qs, p, kQ, p.q, b, h, q0, p.Tq);
    copy_tile<kD>(dOs, p, kDO, p.dout, b, h, q0, p.Tq);
#pragma unroll
    for (int it = 0; it < L::kStages - 1; ++it) {
      if (it < n) issue(it);
      st::cp_async_commit();
    }
    for (int it = 0; it < n; ++it) {
      if (it + L::kStages - 1 < n) issue(it + L::kStages - 1);
      st::cp_async_commit();
      st::cp_async_wait<L::kStages - 1>();
      st::fence_proxy_async();
      __syncthreads();
      const int k0 = it * kRows;
      const uint32_t Ks = base + L::kRing + (it % L::kStages) * 2 * L::kTile, Vs = Ks + L::kTile;

      // S = Q Kᵀ and dP = dO Vᵀ: rows are this block's queries, columns keys.
      float s[32], dp[32];
      st::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks)
        st::wgmma_ss_m64n64k16(s, st::desc_k_major(Qs, kRows, ks),
                               st::desc_k_major(Ks, kRows, ks), ks);
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks)
        st::wgmma_ss_m64n64k16(dp, st::desc_k_major(dOs, kRows, ks),
                               st::desc_k_major(Vs, kRows, ks), ks);
      st::wgmma_commit();
      st::wgmma_wait<0>();
      st::fence_regs(s);
      st::fence_regs(dp);

      // dS = P (dP − di) with P = exp(scale·S − lse) on kept pairs, in bf16.
      uint32_t dsa[kRows / 16][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int hi = (i >> 1) & 1;
        const int t = q0 + r_lo + 8 * hi;
        const int c = 8 * (i >> 2) + 2 * (lane & 3);
        float dsv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = k0 + c + e;
          const bool keep = t < p.Tq && j < kv_len && (!p.causal || j <= t);
          const float pv = keep ? exp2f(s[i + e] * scale_log2 - lse2[hi]) : 0.f;
          dsv[e] = pv * (dp[i + e] - di2[hi]);
        }
        dsa[i >> 3][(i >> 1) & 3] = st::pack_bf16(dsv[0], dsv[1]);
      }

      // dQ += dS K, K read MN-major.
      st::fence_regs(dq);
      st::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks)
        st::wgmma_rs_k16(dq, dsa[ks], st::desc_mn_major(Ks, kRows, ks), 1);
      st::wgmma_commit();
      st::wgmma_wait<0>();
      st::fence_regs(dq);
      __syncthreads();
    }
  }
  // Staged through the Q and dO tiles, free now.
  store_rows<kD>(reinterpret_cast<__nv_bfloat16*>(smem), dq, p.scale, p, kDQ, p.dq, b, h,
                 q0, p.Tq);
}

// ---------------------------------------------------------------- launch
enum Kind { kFwd, kDkv, kDq };

template <Kind kKind, int BQ, int BK>
cudaError_t launch_f32(const Params& p, int batch, cudaStream_t stream) {
  const int own = kKind == kDkv ? BK : BQ;   // rows of the axis a block owns
  const int rows = kKind == kDkv ? p.Tk : p.Tq;
  const dim3 grid((rows + own - 1) / own, p.H, batch);
  void (*kernel)(Params);
  size_t smem;
  if constexpr (kKind == kFwd) {
    kernel = flash_fwd_kernel<BQ, BK>;
    smem = fwd_smem<BQ, BK>(p.Dp);
  } else if constexpr (kKind == kDkv) {
    kernel = flash_bwd_dkv_kernel<BQ, BK>;
    smem = dkv_smem<BQ, BK>(p.Dp);
  } else {
    kernel = flash_bwd_dq_kernel<BQ, BK>;
    smem = dq_smem<BQ, BK>(p.Dp);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (grid.x == 0) return cudaSuccess;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <Kind kKind, int kD>
cudaError_t launch_bf16(const Params& p, int batch, cudaStream_t stream) {
  const int rows = kKind == kDkv ? p.Tk : p.Tq;   // rows of the axis a block owns
  const dim3 grid((rows + kRows - 1) / kRows, p.H, batch);
  void (*kernel)(Params) = kKind == kFwd   ? flash_fwd_bf16_kernel<kD>
                           : kKind == kDkv ? flash_bwd_dkv_bf16_kernel<kD>
                                           : flash_bwd_dq_bf16_kernel<kD>;
  const int smem =
      static_cast<int>(kKind == kFwd ? FwdSmem<kD>::kBytes : BwdSmem<kD>::kBytes);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (grid.x == 0) return cudaSuccess;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Tiles: bf16 is the Hopper path above, with D padded to 64 or 128; f32
// keeps 32 x 32 so the f32 tiles fit shared memory at D = 128.
template <Kind kKind>
cudaError_t dispatch(Params& p, int batch, int is_bf16, cudaStream_t stream) {
  if (p.D < 1 || p.D > 128 || p.H < 1 || batch < 1 || p.Tq < 0 || p.Tk < 0)
    return cudaErrorInvalidValue;
  p.Dp = (p.D + 15) / 16 * 16;
  if (!is_bf16) return launch_f32<kKind, 32, 32>(p, batch, stream);
  if (p.D <= 64) return launch_bf16<kKind, 64>(p, batch, stream);
  return launch_bf16<kKind, 128>(p, batch, stream);
}

Params make_params(const long long* strides, int H, int Tq, int Tk, int D,
                   int causal, int vec, const int* kv_len) {
  Params p{};
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) p.s[i][j] = strides[3 * i + j];
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.D = D;
  p.causal = causal;
  p.vec = vec;
  p.kv_len = kv_len;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  return p;
}

}  // namespace

// `strides` is a host array of 24 int64: the (b, h, t) strides of
// q, k, v, o, dO, dq, dk, dv in that order (unused entries ignored).
extern "C" int st_flash_fwd(const void* q, const void* k, const void* v, void* o,
                            float* lse, const int* kv_len, const long long* strides,
                            int batch, int heads, int tq, int tk, int head_dim,
                            int causal, int is_bf16, int vec, cudaStream_t stream) {
  Params p = make_params(strides, heads, tq, tk, head_dim, causal, vec, kv_len);
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = o;
  p.lse = lse;
  return dispatch<kFwd>(p, batch, is_bf16, stream);
}

extern "C" int st_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse, const float* di,
                                void* dk, void* dv, const int* kv_len,
                                const long long* strides, int batch, int heads,
                                int tq, int tk, int head_dim, int causal,
                                int is_bf16, int vec, cudaStream_t stream) {
  Params p = make_params(strides, heads, tq, tk, head_dim, causal, vec, kv_len);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = lse;
  p.di = di;
  p.dk = dk;
  p.dv = dv;
  return dispatch<kDkv>(p, batch, is_bf16, stream);
}

extern "C" int st_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse, const float* di,
                               void* dq, const int* kv_len, const long long* strides,
                               int batch, int heads, int tq, int tk, int head_dim,
                               int causal, int is_bf16, int vec, cudaStream_t stream) {
  Params p = make_params(strides, heads, tq, tk, head_dim, causal, vec, kv_len);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = lse;
  p.di = di;
  p.dq = dq;
  return dispatch<kDq>(p, batch, is_bf16, stream);
}
