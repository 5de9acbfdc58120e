// Cross-attention of one decode step over the beam-invariant cross cache.
//
// Replaces no TPU kernel: the JAX package leaves this product to XLA (an
// einsum on bf16 operands with float32 results,
// speech_tranformer_pytorch_tpu/models/modules.py:503). On the card it is
// everything `MultiHeadAttention.attend_bhsd` does between `project_q` and
// `project_out` (models/modules.py), once a decoder layer and step. For
// beam row r = b*K + k, head h and the utterance's valid frames
// j < T_b = lens[b]:
//   s[j]      = q[r, h] . Kc[b, h, j] / sqrt(D)   (float32 sum of exact products)
//   w         = softmax(s) in float32, then rounded to the cache dtype
//   out[r, h] = sum_j w[j] Vc[b, h, j]            (float32 accumulation)
// Frames at or after T_b are skipped, not masked: the plain version adds
// -1e9 to their scores, which gives them a weight of exactly 0 in float32.
// An utterance with no valid frame takes uniform weights over all S
// frames, as the plain version's all-masked row does.
//
// What bounds it on an H100: bytes. Each valid K and V row is read once
// for all K beams of its utterance (the beams' queries share every row),
// for ~4 K D operations a row. Design: one thread-block cluster per
// (utterance, head), whose `splits` blocks take contiguous shares of the
// utterance's valid frames, so that B*H*splits blocks fill the card (the
// wrapper chooses `splits` from B*H, S and the card's SM count).
//  * A block issues the copies of all its K and V rows at once (cp.async,
//    16 bytes a thread, neighbouring threads on neighbouring addresses, in
//    the cache's own [B, H, S, D] strides: the int8 path's dequantised
//    cache keeps the encoder's frame-major order), so the card has every
//    byte in flight together: up to 749 frames of bf16 K and V at D 64 fit
//    one block's shared memory, and a longer share goes through it in
//    tiles. The K rows land in four groups, and the scores of each are
//    taken as soon as it has landed, while the later rows and V still
//    arrive.
//  * bf16 at D 64 or 128 (the serving shapes) runs both products on the
//    tensor cores, mma.sync m16n8k16 with float32 accumulation: the K beams
//    are rows of A (the rest zero), 8 frames a warp's tile of scores, then
//    the weights rounded to bf16 are A and 16 frames of V the depth of P V.
//    Rows sit in shared memory with their 16-byte chunks swizzled (chunk c
//    of row r at c ^ (r % 8)), so ldmatrix reads them without bank
//    conflicts; a padded tile's rows past the share are zero-filled. Every
//    other case (float32, other D) computes the same on the FMA pipes: a
//    row read by kLpr lanes, 16 bytes each, the queries in registers, the
//    dot products summed over the lanes by shuffles unrolled at compile
//    time (a loop of shuffles with a run-time bound costs each one its
//    whole latency in turn).
//  * The softmax spans the cluster: each block pushes the max and the sum
//    of exp(s - max) of its frames into every block's shared memory, and
//    after one cluster barrier every block has the global max M and sum L
//    (each local sum rescaled by exp(m - M), added in rank order), so every
//    weight exp(s - M) / L is normalised before it is rounded, as in the
//    plain version.
//  * Each block pushes its P V sums to the block that owns each output
//    element (element i to rank i % splits); after a second barrier every
//    block adds what it owns in rank order and writes it. No block reads
//    another's shared memory, so none waits for the others before it
//    leaves; no global scratch, no counter, one graph node a layer.
// Every sum runs in a fixed order, so outputs are bit-identical run to run.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWarps = 8;            // kMaxBeams: a warp a beam for the stats
constexpr int kThreads = kWarps * 32;
constexpr int kSmemBudget = 220 * 1024;  // shared memory a block may take
constexpr int kPieces = 4;               // groups the first tile's K rows land in
constexpr int kMaxSplits = 8;           // the portable cluster size
constexpr int kMaxBeams = 8;
// The kernel's static shared memory (its tables of stats), at most.
constexpr size_t kStaticSmem = 4 * kMaxSplits * kMaxBeams * sizeof(float);

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

// 16 bytes of a row, moved with one load.
template <typename T>
struct alignas(16) Chunk {
  T v[16 / sizeof(T)];
};

// Store `v` at `p`'s place in the shared memory of cluster rank `rank`.
__device__ __forceinline__ void st_rank(float* p, int rank, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n"
               :: "r"(st::map_rank(st::smem_u32(p), rank)), "f"(v) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += A B for a 16 x 16 bf16 A whose rows 8..15 are zero (a0, a2: row
// lane / 4) and a 16 x 8 B (b0, b1).
__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0, uint32_t a2,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// Bytes of the kernel's first shared-memory region: a tile of K rows, or
// later the warps' and the pushed P V sums.
template <typename T>
__host__ __device__ __forceinline__ int first_region(int tile, int D, int K, int splits) {
  const int rows = tile * D * static_cast<int>(sizeof(T));
  const int sums = (kWarps + splits) * K * D * static_cast<int>(sizeof(float));
  return ((rows > sums ? rows : sums) + 15) & ~15;
}

// (max, sum of exp(x - max)) of two such pairs; -inf maxes hold no terms.
__device__ __forceinline__ void merge_stats(float& m, float& l, float m2, float l2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;
  l = (m == -INFINITY ? 0.f : l * expf(m - mm)) + (m2 == -INFINITY ? 0.f : l2 * expf(m2 - mm));
  m = mm;
}

// Grid (splits, H, B), one cluster a grid row of `splits` blocks, K beams
// an utterance. kD > 0: the tensor-core path, bf16 at D = kD; kD = 0: the
// FMA path, a row read by kLpr lanes.
template <typename T, int kLpr, int kD>
__global__ void __launch_bounds__(kThreads, kD == 64 ? 4 : 1)
cross_attention_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                              const T* __restrict__ vc, const int* __restrict__ lens,
                              T* __restrict__ out, int K, int H, int S, int D_arg,
                              long long kb, long long kh, long long ks, long long vb,
                              long long vh, long long vs, int cap, int tile, float sqrt_d) {
  constexpr bool kMma = kD > 0;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kGroups = kThreads / kLpr;   // rows read at once (FMA path)
  using C = Chunk<T>;
  const int D = kMma ? kD : D_arg;
  extern __shared__ __align__(16) unsigned char raw[];
  const int splits = gridDim.x, rank = blockIdx.x;
  // The K rows are read only before the second barrier and the P V sums
  // written only after it (pushes from other blocks too), so they share
  // the first region.
  T* kt = reinterpret_cast<T*>(raw);                      // [tile][D] staged K rows
  float* part = reinterpret_cast<float*>(raw);            // [kWarps][K][D]
  float* got = part + kWarps * K * D;                     // [splits][K][D] pushed P V
  T* vt = reinterpret_cast<T*>(raw + first_region<T>(tile, D, K, splits));  // [tile][D]
  float* w = reinterpret_cast<float*>(vt + tile * D);     // [K][cap] scores (weights)
  __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(w + K * cap);   // [K][cap] weights
  // (max, sum of exp(s - max)) of each beam in each rank's frames, pushed.
  __shared__ float stat_max[kMaxSplits][kMaxBeams], stat_sum[kMaxSplits][kMaxBeams];
  __shared__ float beam_max[kMaxBeams], beam_inv[kMaxBeams];   // the cluster's M, 1 / L

  // Every block of the cluster must be running before any pushes into its
  // shared memory: this arrival is waited for before the first push.
  st::cluster_arrive();

  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cpr = D / kVec;                  // 16-byte chunks a row
  // The tensor-core path: lane holds row lane / 4 (beam frow) of the
  // 16 x 8 and 16 x 16 fragments, columns 2 (lane % 4) and + 1 (and + 8).
  const int frow = lane >> 2, fcol = 2 * (lane & 3);
  // The FMA path: kLpr lanes a row.
  const int sub = lane & (kLpr - 1);
  const int group = threadIdx.x / kLpr;
  const bool has = sub * kVec < D;           // this lane holds part of a row
  const int col = has ? sub * kVec : 0;

  // Queries, read before the lengths so that both loads are in flight
  // together: the tensor-core path's A fragments, the FMA path's chunk of
  // every beam.
  constexpr int kSteps = kMma ? kD / 16 : 1;
  uint32_t qa[kSteps][2];
  float qr[kMma ? 1 : kMaxBeams][kVec];
  if constexpr (kMma) {
    const T* qp = q + ((static_cast<size_t>(b) * K + frow) * H + h) * D;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      qa[s][0] = frow < K ? *reinterpret_cast<const uint32_t*>(qp + 16 * s + fcol) : 0u;
      qa[s][1] = frow < K ? *reinterpret_cast<const uint32_t*>(qp + 16 * s + 8 + fcol) : 0u;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k) {
      C c = {};
      const size_t row = (static_cast<size_t>(b) * K + k) * H + h;
      if (has && k < K) c = *reinterpret_cast<const C*>(q + row * D + col);
#pragma unroll
      for (int e = 0; e < kVec; ++e) qr[k][e] = to_f(c.v[e]);
    }
  }

  // This block's frames: [lo, lo + cnt) of the utterance's n.
  int n = min(max(lens[b], 0), S);
  const bool empty = n == 0;
  if (empty) n = S;
  const int per = (n + splits - 1) / splits;
  const int lo = min(rank * per, n);
  const int cnt = min(per, n - lo);
  const T* kp = kc + b * kb + h * kh + lo * ks;
  const T* vp = vc + b * vb + h * vh + lo * vs;

  // Rows [r0, r1) of the tile at t0 (of `rows` rows) into `dst`, 16 bytes
  // a thread, as one cp.async group (every thread commits one, copies or
  // not). The tensor-core path swizzles each row's chunks and zero-fills
  // the rows past `rows` up to the next 16 (`padded`).
  auto padded = [](int rows) { return kMma ? (rows + 15) & ~15 : rows; };
  auto stage = [&](T* dst, const T* src, long long stride, int t0, int rows, int r0, int r1) {
    if constexpr (kMma) {   // a thread's chunk of every (kThreads / chunks)-th row
      constexpr int kCpr = kD / kVec, kStep = kThreads / kCpr;
      const int c = threadIdx.x % kCpr;
      int r = r0 + threadIdx.x / kCpr;
      const T* sp = src + static_cast<long long>(t0 + r) * stride + c * kVec;
      uint32_t dp = st::smem_u32(dst + r * kD + (c ^ (r & 7)) * kVec);   // r % 8 stays
      for (; r < r1; r += kStep, sp += kStep * stride, dp += kStep * kD * sizeof(T))
        st::cp_async_16(dp, r < rows ? sp : src, r < rows);
    } else {
      for (int i = r0 * cpr + threadIdx.x; i < r1 * cpr; i += kThreads) {
        const int r = i / cpr, c = i - r * cpr;
        st::cp_async_16(st::smem_u32(dst + r * D + c * kVec),
                        src + static_cast<long long>(t0 + r) * stride + c * kVec, true);
      }
    }
    st::cp_async_commit();
  };
  // Every row of the first tile in flight at once: K in kPieces groups,
  // which the scores take as they land, then V.
  const int ntiles = (cnt + tile - 1) / tile;
  const int rows0 = min(tile, cnt), pad0 = padded(rows0);
  const int piece = kMma ? (pad0 + 16 * kPieces - 1) / (16 * kPieces) * 16
                         : (rows0 + kPieces - 1) / kPieces;
#pragma unroll
  for (int c = 0; c < kPieces; ++c)
    stage(kt, kp, ks, 0, rows0, min(c * piece, pad0), min((c + 1) * piece, pad0));
  stage(vt, vp, vs, 0, rows0, 0, pad0);

  // Scores of the block's frames, into w.
  for (int t = 0; t < ntiles; ++t) {
    const int t0 = t * tile, rows = min(tile, cnt - t0);
    if (t > 0) {
      __syncthreads();                       // the K buffer is free
      stage(kt, kp, ks, t0, rows, 0, padded(rows));
    }
    for (int pc = 0; pc < (t == 0 ? kPieces : 1); ++pc) {
      const int c0 = t == 0 ? min(pc * piece, rows) : 0;
      const int c1 = t == 0 ? min((pc + 1) * piece, rows) : rows;
      if (t > 0) {
        st::cp_async_wait<0>();
      } else {                               // piece pc landed; later ones and V may not
        static_assert(kPieces == 4, "one wait a piece");
        if (pc == 0) st::cp_async_wait<4>();
        else if (pc == 1) st::cp_async_wait<3>();
        else if (pc == 2) st::cp_async_wait<2>();
        else st::cp_async_wait<1>();
      }
      __syncthreads();
      if constexpr (kMma) {
        // A warp's tile: 8 frames from row f0; lane l addresses row f0 + l % 8
        // of the 8 x 8 matrix l / 8 (chunks 4 j .. 4 j + 3 of x4 number j).
#pragma unroll 2
        for (int f0 = c0 + warp * 8; f0 < c1; f0 += kWarps * 8) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          const int r = f0 + (lane & 7);
#pragma unroll
          for (int j = 0; j < kSteps / 2; ++j) {
            uint32_t bm[4];
            ldsm_x4(bm, st::smem_u32(kt + r * kD + ((4 * j + (lane >> 3)) ^ (r & 7)) * 8));
            mma_16816(c, qa[2 * j][0], qa[2 * j][1], bm[0], bm[1]);
            mma_16816(c, qa[2 * j + 1][0], qa[2 * j + 1][1], bm[2], bm[3]);
          }
          if (frow < K) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float sc = empty ? 0.f : c[i] / sqrt_d;
              w[frow * cap + t0 + f0 + fcol + i] = sc;
            }
          }
        }
      } else {
#pragma unroll 2
        for (int r0 = c0; r0 < c1; r0 += kGroups) {   // uniform over the warp: shuffles
          const int r = r0 + group;
          const bool ok = r < c1;
          C c = {};
          if (ok) c = *reinterpret_cast<const C*>(kt + r * D + col);
          float dot[kMaxBeams];
#pragma unroll
          for (int k = 0; k < kMaxBeams; ++k) {
            float s = 0.f;
#pragma unroll
            for (int e = 0; e < kVec; ++e) s = fmaf(qr[k][e], to_f(c.v[e]), s);
            dot[k] = s;
          }
#pragma unroll
          for (int o = kLpr / 2; o > 0; o >>= 1)
#pragma unroll
            for (int k = 0; k < kMaxBeams; ++k)
              dot[k] += __shfl_xor_sync(0xffffffffu, dot[k], o);
          if (ok && sub == 0) {
#pragma unroll
            for (int k = 0; k < kMaxBeams; ++k)
              if (k < K) w[k * cap + t0 + r] = empty ? 0.f : dot[k] / sqrt_d;
          }
        }
      }
    }
  }

  // The block's (max, sum of exp(s - max)) of beam k, taken by warp k
  // from the stored scores and pushed to every rank d of the cluster by
  // lane d (slot `rank`).
  __syncthreads();
  if (warp < K) {   // four partial results a lane, added in a fixed order
    const float* wk = w + warp * cap;
    float m4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY}, l4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = lane; j < cnt; j += 128)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j + 32 * u < cnt) m4[u] = fmaxf(m4[u], wk[j + 32 * u]);
    const float m = st::warp_max(fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3])));
    for (int j = lane; j < cnt; j += 128)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j + 32 * u < cnt) l4[u] += expf(wk[j + 32 * u] - m);
    const float l = st::warp_sum((l4[0] + l4[1]) + (l4[2] + l4[3]));
    st::cluster_wait();
    if (lane < splits) {
      st_rank(&stat_max[rank][warp], lane, m);
      st_rank(&stat_sum[rank][warp], lane, l);
    }
  } else {
    st::cluster_wait();
  }
  st::cluster_arrive();
  st::cluster_wait();
  // The cluster's max and sum of each beam, merged in rank order; then the
  // weights, normalised and rounded to the cache dtype (0 on the padded
  // frames past the share): bf16 for the tensor-core path, in place for
  // the FMA path.
  if (threadIdx.x < K) {
    const int k = threadIdx.x;
    float m = stat_max[0][k], l = stat_sum[0][k];
    for (int r = 1; r < splits; ++r) merge_stats(m, l, stat_max[r][k], stat_sum[r][k]);
    beam_max[k] = m;
    beam_inv[k] = 1.f / l;
  }
  __syncthreads();
  {
    const int pc = padded(cnt);
    for (int i = threadIdx.x; i < K * pc; i += kThreads) {
      const int k = i / pc, j = i - k * pc;
      const float p = j < cnt ? expf(w[k * cap + j] - beam_max[k]) * beam_inv[k] : 0.f;
      if constexpr (kMma) wb[k * cap + j] = __float2bfloat16_rn(p);
      else if (j < cnt) w[k * cap + j] = to_f(from_f<T>(p));
    }
  }

  // P V over this block's frames, each warp's sums into part[warp].
  if constexpr (kMma) {
    constexpr int kTiles = kD / 8;           // 8-wide column tiles of the output
    float o[kTiles][4];
#pragma unroll
    for (int i = 0; i < kTiles; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    const __nv_bfloat16* wr = wb + min(frow, K - 1) * cap;
    for (int t = 0; t < ntiles; ++t) {
      const int t0 = t * tile, rows = min(tile, cnt - t0);
      if (t > 0) {
        __syncthreads();                     // the V buffer is free
        stage(vt, vp, vs, t0, rows, 0, padded(rows));
      }
      st::cp_async_wait<0>();
      __syncthreads();
      // 16 frames from f0: A = their weights, B = V rows through ldmatrix
      // .trans; x4 number j holds column tiles 2 j and 2 j + 1 (matrix l / 8
      // of lane l: frames + 8 (l / 8 % 2), chunk 2 j + l / 16).
#pragma unroll 2
      for (int f0 = warp * 16; f0 < rows; f0 += kWarps * 16) {
        const __nv_bfloat16* wf = wr + t0 + f0 + fcol;
        const uint32_t a0 = frow < K ? *reinterpret_cast<const uint32_t*>(wf) : 0u;
        const uint32_t a2 = frow < K ? *reinterpret_cast<const uint32_t*>(wf + 8) : 0u;
        const int r = f0 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int j = 0; j < kTiles / 2; ++j) {
          uint32_t bm[4];
          ldsm_x4_trans(bm, st::smem_u32(vt + r * kD + ((2 * j + (lane >> 4)) ^ (r & 7)) * 8));
          mma_16816(o[2 * j], a0, a2, bm[0], bm[1]);
          mma_16816(o[2 * j + 1], a0, a2, bm[2], bm[3]);
        }
      }
    }
    if (frow < K) {
#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
        float* pp = part + (warp * K + frow) * kD + 8 * i + fcol;
        pp[0] = o[i][0];
        pp[1] = o[i][1];
      }
    }
  } else {
    float a[kMaxBeams][kVec];
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k)
#pragma unroll
      for (int e = 0; e < kVec; ++e) a[k][e] = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      const int t0 = t * tile, rows = min(tile, cnt - t0);
      if (t > 0) {
        __syncthreads();                     // the V buffer is free
        stage(vt, vp, vs, t0, rows, 0, padded(rows));
      }
      st::cp_async_wait<0>();
      __syncthreads();
      for (int r = group; r < rows; r += kGroups) {
        const C c = *reinterpret_cast<const C*>(vt + r * D + col);
#pragma unroll
        for (int k = 0; k < kMaxBeams; ++k) {
          if (k < K) {
            const float wk = w[k * cap + t0 + r];
#pragma unroll
            for (int e = 0; e < kVec; ++e) a[k][e] = fmaf(wk, to_f(c.v[e]), a[k][e]);
          }
        }
      }
    }
    // Sum over the groups of a warp.
#pragma unroll
    for (int o = kLpr; o < 32; o <<= 1)
#pragma unroll
      for (int k = 0; k < kMaxBeams; ++k)
#pragma unroll
        for (int e = 0; e < kVec; ++e) a[k][e] += __shfl_xor_sync(0xffffffffu, a[k][e], o);
    if (lane < kLpr && has) {
#pragma unroll
      for (int k = 0; k < kMaxBeams; ++k)
        if (k < K)
#pragma unroll
          for (int e = 0; e < kVec; ++e) part[(warp * K + k) * D + col + e] = a[k][e];
    }
  }
  // Sum over the warps; push each element to its owner; after the barrier
  // each block adds what it owns.
  __syncthreads();
  for (int i = threadIdx.x; i < K * D; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += part[wi * K * D + i];
    st_rank(&got[rank * K * D + i], i % splits, s);
  }
  st::cluster_arrive();
  st::cluster_wait();
  for (int i = rank + threadIdx.x * splits; i < K * D; i += kThreads * splits) {
    float s = 0.f;
    for (int r = 0; r < splits; ++r) s += got[r * K * D + i];
    const int k = i / D;
    out[((static_cast<size_t>(b) * K + k) * H + h) * D + (i - k * D)] = from_f<T>(s);
  }
}

template <typename T, int kLpr, int kD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lens, void* out,
                   int batch, int beams, int H, int S, int D, const long long* kst,
                   const long long* vst, int splits, cudaStream_t stream) {
  const int row_bytes = 2 * D * static_cast<int>(sizeof(T));   // a K and a V row
  const int round = kD > 0 ? 16 : 1;        // the tensor-core path pads to 16 frames
  const int cap = ((S + splits - 1) / splits + round - 1) / round * round;
  const int w_bytes = 6 * beams * cap;      // the scores in float, the weights in bf16
  const int tile = min(cap, max(round, (kSmemBudget - w_bytes) / row_bytes / round * round));
  const size_t smem = first_region<T>(tile, D, beams, splits) + static_cast<size_t>(tile) *
                      row_bytes / 2 + static_cast<size_t>(w_bytes);
  auto kernel = cross_attention_decode_kernel<T, kLpr, kD>;
  if (smem + kStaticSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, H, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, static_cast<T*>(out), beams, H, S, D, kst[0], kst[1],
      kst[2], vst[0], vst[1], vst[2], cap, tile,
      static_cast<float>(sqrt(static_cast<double>(D))));
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The tensor-core path for bf16 at D 64 and 128; otherwise the FMA path
// with kLpr lanes a row: its 16-byte chunks, rounded up to a power of 2,
// at least 8.
template <typename T>
cudaError_t launch_path(const void* q, const void* k, const void* v, const int* lens,
                        void* out, int batch, int beams, int H, int S, int D,
                        const long long* kst, const long long* vst, int splits,
                        cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int chunks = D / kVec;
  if (D % kVec || chunks > 32) return cudaErrorInvalidValue;
#define ST_LAUNCH(lpr, d) \
  launch<T, lpr, d>(q, k, v, lens, out, batch, beams, H, S, D, kst, vst, splits, stream)
  if constexpr (sizeof(T) == 2) {
    if (D == 64) return ST_LAUNCH(8, 64);
    if (D == 128) return ST_LAUNCH(8, 128);
  }
  if (chunks <= 8) return ST_LAUNCH(8, 0);
  if (chunks <= 16) return ST_LAUNCH(16, 0);
  return ST_LAUNCH(32, 0);
#undef ST_LAUNCH
}

}  // namespace

// strides: (b, h, s) of the K cache, then of the V cache, in elements; the
// head dimension is contiguous in both.
extern "C" int st_cross_attention_decode(const void* q, const void* k, const void* v,
                                         const int* lens, void* out, int batch, int beams,
                                         int heads, int frames, int head_dim,
                                         const long long* strides, int splits, int is_bf16,
                                         cudaStream_t stream) {
  if (batch < 1 || heads < 1 || frames < 1 || head_dim < 1 || beams < 1 ||
      beams > kMaxBeams || splits < 1 || splits > kMaxSplits)
    return cudaErrorInvalidValue;
  return is_bf16 ? launch_path<__nv_bfloat16>(q, k, v, lens, out, batch, beams, heads, frames,
                                              head_dim, strides, strides + 3, splits, stream)
                 : launch_path<float>(q, k, v, lens, out, batch, beams, heads, frames,
                                      head_dim, strides, strides + 3, splits, stream);
}
