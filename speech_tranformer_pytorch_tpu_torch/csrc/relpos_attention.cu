// Relative-position self-attention of the Conformer encoder (forward).
//
// Replaces no TPU kernel: the JAX package has no Conformer. It is what
// `models/conformer.RelPositionAttention` computes between its projections
// (ESPnet's `RelPositionMultiHeadedAttention`, "latest" positions), one
// launch an encoder layer. For utterance b, head h, query i and key j of
// the padded length T:
//   s[i, j] = ((q_i + u) . k_j + (q_i + v) . p[T - 1 - i + j]) / sqrt(D)
//   o[i]    = sum_j softmax_j(s[i, :]) v_j   over the keys j < len[b]
// where p [2T - 1, H, D] holds the position rows of relative positions
// T - 1 .. -(T - 1) (`linear_pos` of the position table, shared by the
// batch), u and v [H, D] the biases `pos_bias_u` / `pos_bias_v`. q + u and
// q + v are rounded to bf16 before their products (the plain version rounds
// them too); products are bf16 with float32 sums, the softmax is float32
// and its weights are rounded to bf16 before P V. Rows i >= len[b] are
// zero, as are all rows of an utterance of length 0.
//
// The plain route (ESPnet's) writes the second term as a [B, H, T, 2T - 1]
// product and shift-copies it (`rel_shift`): at B 32 and T 749 in bf16 that
// is 574 MB a layer. Here nothing of it leaves the SM.
//
// Design: one block of 4 warps owns 64 query rows of one (utterance,
// head), 16 rows a warp, and walks the key tiles of 64 below len[b] (tiles
// past it are skipped; keys past it inside a tile are masked). Per tile the
// block stages in shared memory the 64 K rows, the 64 V rows and the band
// of position rows the tile needs: for queries [i0, i0 + 64) and keys
// [j0, j0 + 64) the relative index T - 1 - i + j runs over 127 rows from
// T - 1 - (i0 + 63) + j0 (rows outside the table are zero). Each warp's 16
// rows read 79 of them, from row 48 - 16 w of the band. On the tensor cores
// (mma.sync m16n8k16, bf16, f32 accumulation), with q + u and q + v held
// in registers as A fragments for the whole walk:
//   * AC = (q + u) K^T, 16 x 64 in registers;
//   * BD = (q + v) P_band^T, 16 x 80, written to the warp's own scratch in
//     shared memory, from which each lane reads its score's diagonal
//     element (row ii, key jj at band column 15 - ii + jj): the shift is a
//     read of shared memory, not a copy through device memory;
//   * the scores (AC + BD) / sqrt(D) go through the online softmax (max and
//     sum kept in float32 per row, each row held by one quad of lanes), and
//     the weights, rounded to bf16 in registers, are the A operand of
//     O += P V.
// Shared-memory rows are padded by 16 bytes, so the fragment loads of a
// warp touch distinct banks. Every sum runs in a fixed order: outputs are
// bit-identical run to run.
//
// What bounds it on an H100: operations, 6 H t^2 D an utterance of t valid
// frames (AC, BD and P V) against the bf16 peak, over the bytes of q, k, v,
// the output and the 2t - 1 position rows. The kernel stages each tile's
// rows with synchronous loads and one barrier (no copy overlaps the
// products), and computes BD over 80 band rows for 64 keys (1.25x the
// needed products): the distance from the bound is PERF.md's.
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBq = 64;              // query rows a block, 16 a warp
constexpr int kBk = 64;              // keys a tile
constexpr int kBand = kBq + kBk;     // position rows staged a tile (127 used)
constexpr int kWarpBand = 80;        // band rows a warp's product covers (79 used)
constexpr int kBdLd = 84;            // floats a row of a warp's BD scratch
constexpr float kMask = -0.7f * 3.4028234663852886e38f;

struct Params {
  const __nv_bfloat16 *q, *k, *v, *p, *u, *vb;
  const int* lens;
  __nv_bfloat16* out;
  long long sq[3], sk[3], sv[3], sp[2];   // (b, t, h) strides; p's (r, h); elements
  int T, H;
  float scale;
};

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  const uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
}

// dst[r][c] = src[(row0 + r) * stride + c] (c < D) for row0 + r in [lo, hi),
// else zero; rows of ld elements.
template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                      long long stride, int row0, int rows, int lo, int hi) {
  constexpr int kChunks = D / 8;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row >= lo && row < hi)
      val = *reinterpret_cast<const uint4*>(src + row * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// (q + bias) of rows `ra`, `ra` + 8 as the A fragments of D / 16 k-steps.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const Params& p,
                                       const __nv_bfloat16* bias, int b, int h, int ra,
                                       int tig) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = ra + ((e & 1) ? 8 : 0);
      const int col = 16 * kk + ((e & 2) ? 8 : 0) + 2 * tig;
      float x0 = 0.f, x1 = 0.f;
      if (row < p.T) {
        const __nv_bfloat162 qv = *reinterpret_cast<const __nv_bfloat162*>(
            p.q + b * p.sq[0] + row * p.sq[1] + h * p.sq[2] + col);
        const __nv_bfloat162 bv =
            *reinterpret_cast<const __nv_bfloat162*>(bias + h * D + col);
        x0 = __bfloat162float(qv.x) + __bfloat162float(bv.x);
        x1 = __bfloat162float(qv.y) + __bfloat162float(bv.y);
      }
      a[kk][e] = pack(x0, x1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
relpos_attention_kernel(const Params p) {
  constexpr int kLd = D + 8;   // bf16 elements a staged row (16 bytes of padding)
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kBk * kLd;
  __nv_bfloat16* ps = vs + kBk * kLd;
  float* bd_all = reinterpret_cast<float*>(ps + kBand * kLd);

  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kBq;
  const int T = p.T, len = min(p.lens[b], T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int ra = i0 + 16 * warp + gid;   // this lane's rows: ra and ra + 8
  __nv_bfloat16* out = p.out + static_cast<long long>(b) * T * p.H * D + h * D;
  const long long out_row = static_cast<long long>(p.H) * D;

  if (i0 >= len) {   // every row of the tile lies past the length
    for (int i = threadIdx.x; i < kBq * (D / 8); i += kThreads) {
      const int r = i0 + i / (D / 8), c = (i % (D / 8)) * 8;
      if (r < T) *reinterpret_cast<uint4*>(out + r * out_row + c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  uint32_t qu[D / 16][4], qv[D / 16][4];
  load_a<D>(qu, p, p.u, b, h, ra, tig);
  load_a<D>(qv, p, p.vb, b, h, ra, tig);

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float* bd = bd_all + warp * 16 * kBdLd;
  const int band0 = kBq - 16 - 16 * warp;   // the warp's first band row

  for (int j0 = 0; j0 < len; j0 += kBk) {
    __syncthreads();   // the previous tile's rows are read
    const __nv_bfloat16* kb = p.k + b * p.sk[0] + h * p.sk[2];
    const __nv_bfloat16* vb = p.v + b * p.sv[0] + h * p.sv[2];
    stage<D>(ks, kLd, kb, p.sk[1], j0, kBk, 0, len);
    stage<D>(vs, kLd, vb, p.sv[1], j0, kBk, 0, len);
    stage<D>(ps, kLd, p.p + h * p.sp[1], p.sp[0], T - 1 - (i0 + kBq - 1) + j0, kBand, 0,
             2 * T - 1);
    __syncthreads();

    // AC: the content term.
    float s[kBk / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* row = ks + (nt * 8 + gid) * kLd + 16 * kk + 2 * tig;
        mma_16816(s[nt], qu[kk], ld32(row), ld32(row + 8));
      }
    }
    // BD: the position term over the warp's band, then its diagonal.
#pragma unroll
    for (int nt = 0; nt < kWarpBand / 8; ++nt) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* row = ps + (band0 + nt * 8 + gid) * kLd + 16 * kk + 2 * tig;
        mma_16816(c, qv[kk], ld32(row), ld32(row + 8));
      }
      *reinterpret_cast<float2*>(bd + gid * kBdLd + nt * 8 + 2 * tig) = make_float2(c[0], c[1]);
      *reinterpret_cast<float2*>(bd + (gid + 8) * kBdLd + nt * 8 + 2 * tig) =
          make_float2(c[2], c[3]);
    }
    __syncwarp();
    float mx_a = kMask, mx_b = kMask;
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = gid + ((e & 2) ? 8 : 0);
        const int jj = nt * 8 + 2 * tig + (e & 1);
        const float x = (s[nt][e] + bd[ii * kBdLd + 15 - ii + jj]) * p.scale;
        s[nt][e] = j0 + jj < len ? x : kMask;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
    }
    __syncwarp();   // the scratch is read before the next tile writes it
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    // Key j0 is valid, so each row's max is finite.
    const float new_a = fmaxf(m_a, mx_a), new_b = fmaxf(m_b, mx_b);
    const float alpha_a = __expf(m_a - new_a), alpha_b = __expf(m_b - new_b);
    m_a = new_a;
    m_b = new_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - m_a);
      s[nt][1] = __expf(s[nt][1] - m_a);
      s[nt][2] = __expf(s[nt][2] - m_b);
      s[nt][3] = __expf(s[nt][3] - m_b);
      sum_a += s[nt][0] + s[nt][1];
      sum_b += s[nt][2] + s[nt][3];
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= alpha_a;
      o[dt][1] *= alpha_a;
      o[dt][2] *= alpha_b;
      o[dt][3] *= alpha_b;
    }
    // O += P V, the weights rounded to bf16 as the A operand.
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]), pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* r0 = vs + (16 * kk + 2 * tig) * kLd + gid;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* c = r0 + dt * 8;
        mma_16816(o[dt], a, pair(c, c + kLd), pair(c + 8 * kLd, c + 9 * kLd));
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = ra < len ? 1.f / l_a : 0.f;
  const float inv_b = ra + 8 < len ? 1.f / l_b : 0.f;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * tig;
    if (ra < T)
      *reinterpret_cast<__nv_bfloat162*>(out + ra * out_row + c) =
          __floats2bfloat162_rn(o[dt][0] * inv_a, o[dt][1] * inv_a);
    if (ra + 8 < T)
      *reinterpret_cast<__nv_bfloat162*>(out + (ra + 8) * out_row + c) =
          __floats2bfloat162_rn(o[dt][2] * inv_b, o[dt][3] * inv_b);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return (2 * kBk + kBand) * (D + 8) * sizeof(__nv_bfloat16) +
         kWarps * 16 * kBdLd * sizeof(float);
}

template <int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = relpos_attention_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + kBq - 1) / kBq, p.H, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// strides: (b, t, h) of q, of k, of v, then (r, h) of p, in elements; the
// head dimension is contiguous in each, u and v are [H, D] contiguous and
// out is a contiguous [B, T, H, D].
extern "C" int st_relpos_attention(const void* q, const void* k, const void* v,
                                   const void* p, const void* u, const void* vb,
                                   const int* lens, void* out, const long long* strides,
                                   int batch, int frames, int heads, int head_dim,
                                   cudaStream_t stream) {
  if (batch < 1 || frames < 1 || heads < 1 || (head_dim != 64 && head_dim != 128) ||
      batch > 65535 || heads > 65535)
    return cudaErrorInvalidValue;
  Params prm;
  prm.q = static_cast<const __nv_bfloat16*>(q);
  prm.k = static_cast<const __nv_bfloat16*>(k);
  prm.v = static_cast<const __nv_bfloat16*>(v);
  prm.p = static_cast<const __nv_bfloat16*>(p);
  prm.u = static_cast<const __nv_bfloat16*>(u);
  prm.vb = static_cast<const __nv_bfloat16*>(vb);
  prm.lens = lens;
  prm.out = static_cast<__nv_bfloat16*>(out);
  for (int i = 0; i < 3; ++i) {
    prm.sq[i] = strides[i];
    prm.sk[i] = strides[3 + i];
    prm.sv[i] = strides[6 + i];
  }
  prm.sp[0] = strides[9];
  prm.sp[1] = strides[10];
  prm.T = frames;
  prm.H = heads;
  prm.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(head_dim)));
  return head_dim == 64 ? launch<64>(prm, batch, stream) : launch<128>(prm, batch, stream);
}
