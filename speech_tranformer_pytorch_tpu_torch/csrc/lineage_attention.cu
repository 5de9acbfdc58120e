// One-query beam self-attention over the unpermuted KV cache (decode step),
// and the step's own K/V row written into that cache.
//
// Replaces the TPU kernel `_kernel` / `lineage_attention`
// (speech_tranformer_pytorch_tpu/kernels/lineage_attention.py:43, :86).
// The beam search never reorders the self-attention cache; beam k of
// utterance b reads position j from cache lane lineage[b, k, j]:
//   s[j]   = q[b*K+k, h] . Kc[b*K + lineage[b,k,j], j, h] / sqrt(D),  j <= index
//   w      = softmax(s) in float32, then rounded to the cache dtype
//   out    = sum_j w[j] * Vc[b*K + lineage[b,k,j], j, h]   (f32 accumulation)
// Positions after `index` are never read (the reference masks them to
// -1e9, which contributes exactly 0 to the softmax). `index` is a pointer to
// the decode step's int32 in device memory, which every thread reads
// (clamped to [0, L)), so the dynamic shared memory covers all L positions.
// Out-of-range lanes in the table are clamped to [0, K), so a bad table
// never reads outside the utterance's cache rows.
//
// Two forms. Attend-only: the cache already holds position `index`.
// Write-and-attend (k_new and v_new given, the decode step's form): block
// (row, h) also stores k_new[row, h] and v_new[row, h] into the cache at
// (row, index, h), which replaces the step's two index writes. Column
// `index` of the table is the identity at the step that writes it (the
// search composes a step's parents into columns <= index only after the
// step), so position `index` of row `row` is its own new row: the block
// takes it from the k_new/v_new loads it stores (the same values the
// cache would hold), never reads it back, and no other block of the
// launch reads a row any block writes. q, k_new and v_new are [B*K, 1, H,
// D] views with a row stride of their own (the fused qkv projection's
// output is read in place, with no copy); heads are D apart.
//
// Design. One block of 4 warps per (beam row, head) reads the cache in its
// native [B*K, L, H, D] layout, with no gather and no relayout. A cache
// row is read by a group of `lpr` lanes, 16 bytes a lane (8 bf16: eight
// lanes cover a D = 64 row, so a warp reads four positions with one
// instruction). Each group takes every `groups`-th position and keeps
// kR of them in flight: it reads their lineage entries, then issues all
// their K rows and (for the first kR) their V rows before it uses any, so
// the whole score pass at index < 64 (bf16, D = 64) is two dependent
// memory round trips. The group that holds position `index` stores its
// new K chunks from registers once its score has used them, and its V
// chunks once the AV pass has (so no warp waits for V before the
// softmax): the write adds no round trip. Dot products are summed within the group (3
// shuffles at lpr = 8). The softmax runs over the block (two reductions),
// the weights are rounded to the cache dtype after normalisation as the
// reference does, and the AV pass reuses the V rows already in registers
// (later batches, at index >= 64, read theirs then). The sum over
// positions runs in a fixed order, so outputs are bit-identical run to run.
// Rows whose D is not a multiple of 16 bytes, or that sit off the 16-byte
// grid, take one element a lane per load instead.
//
// What bounds it on an H100: bytes (each selected cache entry read once,
// about 4*D f32 operations per entry). The kernel is latency-bound above
// that: launch, the lineage read, one round trip for the K and V rows, and
// four block barriers for the softmax, in series.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 256;
constexpr long long kPast = -1;   // slot offsets: a position after `index`
constexpr long long kOwn = -2;    // the step's own new row (write-and-attend)

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

// kVec consecutive elements of a row, moved with one load.
template <typename T, int kVec>
struct alignas(kVec * sizeof(T)) Chunk {
  T v[kVec];
};

// A lane holds chunks sub, sub + lpr, ... (kCpl of them) of each row it reads.
// `kc`/`vc` are read only at positions whose rows no block of the launch
// writes; `kw`/`vw` (the same caches) take the step's row, with k_new
// (`kn`) null in the attend-only form.
template <typename T, int kVec, int kCpl>
__global__ void __launch_bounds__(kThreads)
lineage_attention_kernel(const T* __restrict__ q, long long q_stride,
                         const T* __restrict__ kn, long long kn_stride,
                         const T* __restrict__ vn, long long vn_stride,
                         const T* __restrict__ kc, const T* __restrict__ vc, T* kw, T* vw,
                         const int* __restrict__ lineage, T* __restrict__ out, int K, int L,
                         int H, int D, const int* __restrict__ index_dev, int lpr_log2,
                         float sqrt_d) {
  constexpr int kBytes = kVec * kCpl * static_cast<int>(sizeof(T));
  constexpr int kR = kBytes <= 16 ? 4 : 2;   // positions a group keeps in flight
  using C = Chunk<T, kVec>;
  extern __shared__ float w[];               // [L]: scores, then weights (j <= index)
  const int index = min(max(*index_dev, 0), L - 1);
  __shared__ float red[32];
  __shared__ float part[kWarps][kMaxD];
  const int row = blockIdx.x;                // b*K + k
  const int h = blockIdx.y;
  const int base_lane = (row / K) * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lpr = 1 << lpr_log2;             // lanes a cache row
  const int sub = lane & (lpr - 1);
  const int per_warp = 32 >> lpr_log2;
  const int group = warp * per_warp + (lane >> lpr_log2);
  const int groups = kWarps * per_warp;
  const int batch = kR * groups;
  const int n = index + 1;
  const bool write = kn != nullptr;
  const int* lin = lineage + static_cast<size_t>(row) * L;   // [B, K, L] row
  const long long row_stride = static_cast<long long>(H) * D;   // one position
  const long long lane_stride = L * row_stride;
  const T* kh = kc + static_cast<size_t>(h) * D;
  const T* vh = vc + static_cast<size_t>(h) * D;
  // The step's new rows and where they go (write-and-attend only).
  const T* knh = write ? kn + row * kn_stride + h * D : nullptr;
  const T* vnh = write ? vn + row * vn_stride + h * D : nullptr;
  const long long dst = row * lane_stride + index * row_stride + h * D;

  bool has[kCpl];   // chunk i of this lane lies inside the row
#pragma unroll
  for (int i = 0; i < kCpl; ++i) has[i] = (sub + i * lpr) * kVec < D;
  float qr[kCpl][kVec];
  const T* qp = q + row * q_stride + h * D;
#pragma unroll
  for (int i = 0; i < kCpl; ++i) {
    C c = {};
    if (has[i]) c = *reinterpret_cast<const C*>(qp + (sub + i * lpr) * kVec);
#pragma unroll
    for (int e = 0; e < kVec; ++e) qr[i][e] = to_f(c.v[e]);
  }

  // Offsets of the rows of batch `b0`: position j of slot u is
  // b0 + u * groups + group; kPast past index, kOwn for the step's own row.
  auto offsets = [&](int b0, long long (&off)[kR]) {
    int src[kR];
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      const int j = b0 + u * groups + group;
      src[u] = j < n ? min(max(lin[j], 0), K - 1) : -1;
    }
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      const int j = b0 + u * groups + group;
      off[u] = src[u] < 0            ? kPast
               : write && j == index ? kOwn
                                     : (base_lane + src[u]) * lane_stride + j * row_stride;
    }
  };
  auto load = [&](const T* base, const T* own, const long long (&off)[kR],
                  C (&dst_r)[kR][kCpl]) {
#pragma unroll
    for (int u = 0; u < kR; ++u)
#pragma unroll
      for (int i = 0; i < kCpl; ++i) {
        dst_r[u][i] = C{};
        if (off[u] != kPast && has[i]) {
          const T* p = off[u] == kOwn ? own : base + off[u];
          dst_r[u][i] = *reinterpret_cast<const C*>(p + (sub + i * lpr) * kVec);
        }
      }
  };
  // The slot of a batch that holds the step's own row, -1 if none does.
  auto own_slot = [&](const long long (&off)[kR]) {
    int slot = -1;
#pragma unroll
    for (int u = 0; u < kR; ++u)
      if (off[u] == kOwn) slot = u;
    return slot;
  };
  // The own row's chunks (slot `slot`), once loaded and used, into the cache.
  auto store_own = [&](T* cache, int slot, const C (&src_r)[kR][kCpl]) {
#pragma unroll
    for (int u = 0; u < kR; ++u)
      if (u == slot)
#pragma unroll
        for (int i = 0; i < kCpl; ++i)
          if (has[i])
            *reinterpret_cast<C*>(cache + dst + (sub + i * lpr) * kVec) = src_r[u][i];
  };

  // Scores. The V rows of the first batch are read with its K rows; its
  // own V row is stored after the AV pass has used it, so no warp waits
  // for V before the softmax.
  C vr[kR][kCpl];
  int own_v0 = -1;
  for (int b0 = 0; b0 < n; b0 += batch) {
    long long off[kR];
    offsets(b0, off);
    C kr[kR][kCpl];
    load(kh, knh, off, kr);
    if (b0 == 0) load(vh, vnh, off, vr);
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kCpl; ++i)
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(qr[i][e], to_f(kr[u][i].v[e]), dot);
      for (int o = lpr >> 1; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const int j = b0 + u * groups + group;
      if (sub == 0 && j < n) w[j] = dot / sqrt_d;
    }
    const int slot = own_slot(off);
    if (slot >= 0) store_own(kw, slot, kr);
    if (b0 == 0) own_v0 = slot;
  }
  __syncthreads();

  float m = -INFINITY;
  for (int j = threadIdx.x; j < n; j += kThreads) m = fmaxf(m, w[j]);
  m = st::block_reduce<true>(m, red);
  float s = 0.f;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float e = expf(w[j] - m);
    w[j] = e;
    s += e;
  }
  s = st::block_reduce<false>(s, red);
  for (int j = threadIdx.x; j < n; j += kThreads)
    w[j] = to_f(from_f<T>(w[j] / s));   // weights in the cache dtype
  __syncthreads();

  // out = sum_j w[j] V[j], positions in the same slots as the scores.
  float acc[kCpl][kVec];
#pragma unroll
  for (int i = 0; i < kCpl; ++i)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[i][e] = 0.f;
  for (int b0 = 0; b0 < n; b0 += batch) {
    int slot = own_v0;
    if (b0 > 0) {
      long long off[kR];
      offsets(b0, off);
      load(vh, vnh, off, vr);
      slot = own_slot(off);
    }
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      const int j = b0 + u * groups + group;
      const float wj = j < n ? w[j] : 0.f;
#pragma unroll
      for (int i = 0; i < kCpl; ++i)
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[i][e] = fmaf(wj, to_f(vr[u][i].v[e]), acc[i][e]);
    }
    if (slot >= 0) store_own(vw, slot, vr);
  }
  // Sum over the groups of a warp, then over the warps.
#pragma unroll
  for (int i = 0; i < kCpl; ++i)
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      for (int o = lpr; o < 32; o <<= 1)
        acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], o);
  if (lane < lpr) {
#pragma unroll
    for (int i = 0; i < kCpl; ++i)
      if (has[i])
#pragma unroll
        for (int e = 0; e < kVec; ++e) part[warp][(sub + i * lpr) * kVec + e] = acc[i][e];
  }
  __syncthreads();
  T* op = out + (static_cast<size_t>(row) * H + h) * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) o += part[wi][d];
    op[d] = from_f<T>(o);
  }
}

struct Args {
  const void* q;
  long long q_stride;
  const void* k_new;   // null: attend-only
  long long k_stride;
  const void* v_new;
  long long v_stride;
  void* k;
  void* v;
  const int* lineage;
  void* out;
  int batch, beams, L, H, D;
  const int* index;
};

template <typename T, int kVec, int kCpl>
cudaError_t launch_vec(const Args& a, cudaStream_t stream) {
  // Lanes a row: the chunks of a row over kCpl, rounded up to a power of 2.
  const int chunks = (a.D + kVec - 1) / kVec;
  const int per_lane = (chunks + kCpl - 1) / kCpl;
  int lpr_log2 = 0;
  while ((1 << lpr_log2) < per_lane) ++lpr_log2;
  if (lpr_log2 > 5) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * a.L;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lineage_attention_kernel<T, kVec, kCpl>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.batch * a.beams, a.H);
  lineage_attention_kernel<T, kVec, kCpl><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), a.q_stride, static_cast<const T*>(a.k_new), a.k_stride,
      static_cast<const T*>(a.v_new), a.v_stride, static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.k), static_cast<T*>(a.v), a.lineage,
      static_cast<T*>(a.out), a.beams, a.L, a.H, a.D, a.index, lpr_log2,
      static_cast<float>(sqrt(static_cast<double>(a.D))));
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool rows = a.q_stride % kVec == 0 &&
                    (!a.k_new || (a.k_stride % kVec == 0 && a.v_stride % kVec == 0 &&
                                  aligned16(a.k_new) && aligned16(a.v_new)));
  const bool vec = a.D % kVec == 0 && rows && aligned16(a.q) && aligned16(a.k) &&
                   aligned16(a.v);
  if (!vec)   // one element a load, up to 8 a lane: D <= 256
    return launch_vec<T, 1, 8>(a, stream);
  // bf16: D <= 256 is at most 32 chunks, one a lane; f32 up to two a lane.
  constexpr int kCpl = sizeof(T) == 2 ? 1 : 2;
  return launch_vec<T, kVec, kCpl>(a, stream);
}

}  // namespace

extern "C" int st_lineage_attention(const void* q, long long q_stride, const void* k_new,
                                    long long k_stride, const void* v_new,
                                    long long v_stride, void* k, void* v,
                                    const int* lineage, void* out, int batch,
                                    int beams, int max_len, int heads,
                                    int head_dim, const int* index, int is_bf16,
                                    cudaStream_t stream) {
  // `index` holds the decode step's index in device memory. q, k_new and
  // v_new rows are `*_stride` elements apart; k_new and v_new are both
  // null (attend-only) or both given (write-and-attend).
  if (head_dim < 1 || head_dim > kMaxD || max_len < 1 || !index || !k_new != !v_new)
    return cudaErrorInvalidValue;
  const Args a{q, q_stride, k_new, k_stride, v_new, v_stride, k, v, lineage, out,
               batch, beams, max_len, heads, head_dim, index};
  return is_bf16 ? launch<__nv_bfloat16>(a, stream) : launch<float>(a, stream);
}
