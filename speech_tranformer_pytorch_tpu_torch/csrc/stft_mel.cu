// Fused Kaldi-style fbank: framing, DC removal, pre-emphasis, window, real
// FFT, power spectrum, sparse mel filters and log, in one launch.
//
// Replaces the TPU kernel `_stft_mel_kernel` / `log_mel_pallas`
// (speech_tranformer_pytorch_tpu/kernels/stft_mel.py:80, :107). For frame
// t = wave[b, hop*t : hop*t + frame_len] it computes
//   out[b, t, m] = log(max(sum_k |rfft(w * pre(x - mean(x)), fft_len)[k]|^2
//                          * M[k, m], floor)),
// everything in f32 (no TF32, no bf16: at reduced precision the low-energy
// bins wash out after the log).
//
// What bounds it on an H100: bytes. The waveform is read once and the
// features written once (4.4 MB for 8 utterances of 4-6 s, 37 MB for 64):
// a 512-point real FFT costs ~15k f32 operations a frame, and the mel step
// only 501 nonzero weights of the dense [257, 80] matrix (each filter's
// nonzero bins are contiguous). The TPU kernel folds everything before
// |.|^2 into two [frame_len, n_bins] matrices for its MXU; on CUDA cores
// that product costs ~30x the FFT, so `stft_mel_fft_kernel` does the FFT:
//  * A block takes a tile of frames of one utterance (one a warp, two a
//    warp for large batches) and stages the tile's samples in shared
//    memory once (16-byte loads where the row's alignment allows; samples
//    past the waveform's end read as 0), with the window (zero past the
//    frame) and the sparse mel table.
//  * One warp a frame. The real FFT of fft_len = 64 P points is an
//    N = 32 P point complex FFT of z[n] = y[2n] + i y[2n+1]: lane l holds
//    z[32 a + l], a < P. A P-point DIF in registers, the twiddle
//    W_N^(l b), then a 32-point DIF across lanes with xor shuffles leave
//    Z[b + P rev5(l)] in register rev_P(b) of lane l. The split step
//    X[k] = E[k] + W_2N^k O[k] pairs Z[k] with Z[N - k], which sits in
//    lane l ^ 31 (lane rev5(32 - c) for b = 0): one shuffle each. Only the
//    power spectrum goes through shared memory (N + 1 words at stride
//    P + 1 against bank conflicts), for the mel filters.
//  * Twiddles come from a lane-major host table (float64, rounded to f32)
//    and stay in registers for all of a warp's frames; never
//    __sinf/__cosf. Each mel filter sums its bins in increasing order.
//  * No global scratch, no atomics: a second call gives the same bits.
// Measured on the card (PERF.md), the shuffles and the mel step's
// dependent loads take most of its time, well above the bytes bound.
// A fft_len that is no power of two (or outside 64..1024, or shorter than
// the frame) goes to `stft_mel_dft_kernel`, the first version: the DFT as
// a [frame_len, n_bins] product against the folded matrices.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// ------------------------------------------------------------ FFT kernel
constexpr int kWarps = 8;
constexpr int kMaxFramesPerWarp = 2;

// The low `bits` (<= 5) bits of x reversed; loop-free, so that an index
// computed from an unrolled loop's counter folds to a constant and the
// register arrays it indexes stay in registers.
__host__ __device__ constexpr int bit_reverse(int x, int bits) {
  return (((x & 1) << 4) | ((x & 2) << 2) | (x & 4) | ((x & 8) >> 2) | ((x & 16) >> 4)) >>
         (5 - bits);
}

__host__ __device__ constexpr int log2_of(int p) { return p <= 1 ? 0 : 1 + log2_of(p / 2); }

// Rows of the lane-major twiddle table [2][kRows][32] (re, im) for a
// fft_len of 64 P; kernels/stft_mel.py `lane_twiddles` builds it.
template <int P>
struct Rows {
  static constexpr int kCross = 0;            // 4: W_2h^(l mod h) (upper lanes) for h = 16, 8, 4, 2
  static constexpr int kStep = 4;             // P - 1: W_N^(l rev_P(i)), i = 1 .. P-1
  static constexpr int kRegs = kStep + P - 1; // P - 1: W_2h^j at row kRegs + h + j - 1
  static constexpr int kSplit = kRegs + P - 1;// P: W_2N^k, k = rev_P(i) + P rev5(l)
  static constexpr int kRows = kSplit + P;
};

struct FftArgs {
  const float* wave;     // [batch, num_samples]
  const float* window;   // [fft_len]: the window, zero past frame_len
  const float* twiddle;  // [2, rows, 32]: Rows<P>
  const int* mel_index;  // [3, n_mels]: first bin, bin count, weight offset
  const float* mel_w;    // [n_weights], each filter's weights in bin order
  float* out;            // [batch, n_frames, n_mels]
  int num_samples, n_frames, frame_len, hop, n_mels, n_weights, use_log;
  int tile;              // frames a block: kWarps times the frames a warp
  float preemph, log_floor;
};

// Shared memory, in 4-byte words: the tile's samples (up to 3 words in,
// through the last frame's fft_len-th sample, whole 16-byte vectors), the
// window, the mel table and one power spectrum per warp (N + 1 bins at
// word k + k / P).
__host__ __device__ inline int span_words(const FftArgs& a, int fft_len) {
  return ((a.tile - 1) * a.hop + max(a.frame_len, fft_len) + 6 + 3) / 4 * 4;
}

__host__ __device__ inline int smem_words(const FftArgs& a, int P) {
  return span_words(a, 64 * P) + 64 * P + a.n_weights + 3 * a.n_mels +
         kWarps * (32 * (P + 1) + 4);
}

// (re, im) *= (wr, wi)
__device__ __forceinline__ void cmul(float& re, float& im, float wr, float wi) {
  const float r = re * wr - im * wi;
  im = re * wi + im * wr;
  re = r;
}

// At most 64 registers a thread: four blocks an SM.
template <int P>
__global__ void __launch_bounds__(kWarps * 32, 4)
stft_mel_fft_kernel(const FftArgs a) {
  using R = Rows<P>;
  constexpr int N = 32 * P;          // complex points
  constexpr int kFft = 2 * N;        // real points
  constexpr int kPB = log2_of(P);
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* win = xs + span_words(a, kFft);
  float* mel_w = win + kFft;
  int* mel_idx = reinterpret_cast<int*>(mel_w + a.n_weights);
  float* pbuf = reinterpret_cast<float*>(mel_idx + 3 * a.n_mels);

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * a.tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int frames_here = min(a.tile, a.n_frames - f0);
  const int span = (frames_here - 1) * a.hop + max(a.frame_len, kFft);

  // Stage the span: sample start + q at word q + off, off even so that
  // frames start on an even word (hop is even) and a lane reads its sample
  // pair in one 8-byte load. Where the row allows (off = pre, the sample's
  // offset in its 16-byte vector, even), 16-byte loads and stores; else
  // one word a thread. Samples past the waveform's end read as 0.
  const float* row = a.wave + static_cast<size_t>(b) * a.num_samples;
  const long long start = static_cast<long long>(f0) * a.hop;
  const int pre = static_cast<int>((reinterpret_cast<uintptr_t>(row + start) >> 2) & 3);
  const int off = (pre & 1) ? 0 : pre;
  if (off == pre) {
    const int n_vec = (pre + span + 3) / 4;
#pragma unroll 4
    for (int v = threadIdx.x; v < n_vec; v += blockDim.x) {
      const long long s0 = start - pre + 4 * v;
      float4 val;
      if (s0 >= 0 && s0 + 3 < a.num_samples) {
        val = *reinterpret_cast<const float4*>(row + s0);
      } else {
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const long long s = s0 + i;
          e[i] = (s >= 0 && s < a.num_samples) ? row[s] : 0.f;
        }
        val = make_float4(e[0], e[1], e[2], e[3]);
      }
      reinterpret_cast<float4*>(xs)[v] = val;
    }
  } else {
#pragma unroll 4
    for (int q = threadIdx.x; q < span; q += blockDim.x)
      xs[q] = start + q < a.num_samples ? row[start + q] : 0.f;
  }
  for (int i = threadIdx.x; i < kFft; i += blockDim.x) win[i] = a.window[i];
  for (int i = threadIdx.x; i < a.n_weights; i += blockDim.x) mel_w[i] = a.mel_w[i];
  for (int i = threadIdx.x; i < 3 * a.n_mels; i += blockDim.x) mel_idx[i] = a.mel_index[i];

  // This lane's twiddles for every frame, in registers: the cross-lane
  // stages', the step between the two FFT levels' and the in-register
  // stages' (whose j = 0 and N/4 are 1 and -i, applied exactly).
  const float* tw_re = a.twiddle + lane;
  const float* tw_im = a.twiddle + R::kRows * 32 + lane;
  float xl_re[4], xl_im[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    xl_re[s] = __ldg(tw_re + 32 * (R::kCross + s));
    xl_im[s] = __ldg(tw_im + 32 * (R::kCross + s));
  }
  float lb_re[P], lb_im[P];
#pragma unroll
  for (int i = 1; i < P; ++i) {
    lb_re[i] = __ldg(tw_re + 32 * (R::kStep + i - 1));
    lb_im[i] = __ldg(tw_im + 32 * (R::kStep + i - 1));
  }
  float ir_re[P], ir_im[P];          // index h + j for stage h
#pragma unroll
  for (int h = 1; h < P; h *= 2) {
#pragma unroll
    for (int j = 1; j < h; ++j) {
      if (4 * j == 2 * h) continue;
      ir_re[h + j] = __ldg(tw_re + 32 * (R::kRegs + h + j - 1));
      ir_im[h + j] = __ldg(tw_im + 32 * (R::kRegs + h + j - 1));
    }
  }
  __syncthreads();

  float* power = pbuf + warp * (32 * (P + 1) + 4);
  const int L = a.frame_len;
  const bool even_hop = (a.hop & 1) == 0;
  const int c = static_cast<int>(__brev(static_cast<unsigned>(lane)) >> 27);
  const int src0 = static_cast<int>(__brev(static_cast<unsigned>((32 - c) & 31)) >> 27);
  for (int f = warp; f < frames_here; f += kWarps) {
    const float* xf = xs + off + f * a.hop;
    // Lane l takes samples j = 64 i + 2 l and j + 1 (the window is zero
    // past L); sample j - 1 comes from the lane before.
    float x0[P], x1[P];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int j = 64 * i + 2 * lane;
      if (even_hop) {
        const float2 v = *reinterpret_cast<const float2*>(xf + j);
        x0[i] = v.x;
        x1[i] = v.y;
      } else {
        x0[i] = xf[j];
        x1[i] = xf[j + 1];
      }
      sum += (j < L ? x0[i] : 0.f) + (j + 1 < L ? x1[i] : 0.f);
    }
    // DC removal, pre-emphasis on the DC-free frame, window.
    const float mean = st::warp_sum(sum) / static_cast<float>(L);
    float re[P], im[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float prev_src = (lane == 31 && i > 0) ? x1[i > 0 ? i - 1 : 0] : x1[i];
      const float xp = __shfl_sync(0xffffffffu, prev_src, (lane + 31) & 31);
      const float2 w = *reinterpret_cast<const float2*>(win + 64 * i + 2 * lane);
      const float c0 = x0[i] - mean, c1 = x1[i] - mean;
      const float cp = (lane == 0 && i == 0) ? c0 : xp - mean;
      re[i] = (c0 - a.preemph * cp) * w.x;
      im[i] = (c1 - a.preemph * c0) * w.y;
    }
    // P-point DIF over the register index: register i ends as rev_P(i).
#pragma unroll
    for (int stage = 0; stage < kPB; ++stage) {
      const int h = P >> (stage + 1);
#pragma unroll
      for (int blk = 0; blk < P; blk += 2 * h) {
#pragma unroll
        for (int j = 0; j < h; ++j) {
          const int u = blk + j, v = blk + j + h;
          const float dr = re[u] - re[v], di = im[u] - im[v];
          re[u] += re[v];
          im[u] += im[v];
          if (j == 0) {
            re[v] = dr;
            im[v] = di;
          } else if (4 * j == 2 * h) {   // times -i
            re[v] = di;
            im[v] = -dr;
          } else {
            re[v] = dr;
            im[v] = di;
            cmul(re[v], im[v], ir_re[h + j], ir_im[h + j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 1; i < P; ++i) cmul(re[i], im[i], lb_re[i], lb_im[i]);
    // 32-point DIF across lanes: the lower lane keeps v + p, the upper
    // (p - v) W; lane l ends holding index c = rev5(l), so register i
    // holds Z[k], k = rev_P(i) + P c.
#pragma unroll
    for (int stage = 0; stage < 5; ++stage) {
      const int h = 16 >> stage;
      const float sgn = (lane & h) ? -1.f : 1.f;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float pr = __shfl_xor_sync(0xffffffffu, re[i], h);
        const float pi = __shfl_xor_sync(0xffffffffu, im[i], h);
        re[i] = fmaf(sgn, re[i], pr);
        im[i] = fmaf(sgn, im[i], pi);
        if (stage < 4) cmul(re[i], im[i], xl_re[stage], xl_im[stage]);
      }
    }
    // Split step: X[k] = E + W_2N^k O with E = (Z[k] + conj Z[N-k]) / 2,
    // O = (Z[k] - conj Z[N-k]) / 2i. Z[N-k] is register rev_P(P - b) of
    // lane l ^ 31 for b = rev_P(i) > 0, register 0 of lane
    // rev5(32 - c) for b = 0. X[N] = Re Z[0] - Im Z[0].
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int bb = bit_reverse(i, kPB);
      float zmr, zmi;
      if (bb == 0) {
        zmr = __shfl_sync(0xffffffffu, re[0], src0);
        zmi = __shfl_sync(0xffffffffu, im[0], src0);
      } else {
        const int ip = bit_reverse(P - bb, kPB);
        zmr = __shfl_xor_sync(0xffffffffu, re[ip], 31);
        zmi = __shfl_xor_sync(0xffffffffu, im[ip], 31);
      }
      const float er = 0.5f * (re[i] + zmr), ei = 0.5f * (im[i] - zmi);
      float tr = 0.5f * (im[i] + zmi), ti = -0.5f * (re[i] - zmr);
      cmul(tr, ti, __ldg(tw_re + 32 * (R::kSplit + i)), __ldg(tw_im + 32 * (R::kSplit + i)));
      const float xr = er + tr, xi = ei + ti;
      power[bb + (P + 1) * c] = xr * xr + xi * xi;
    }
    if (lane == 0) {
      const float nyq = re[0] - im[0];
      power[N + N / P] = nyq * nyq;
    }
    __syncwarp();
    // Mel filters over their nonzero bins, then the log floor.
    float* dst = a.out + (static_cast<size_t>(b) * a.n_frames + f0 + f) * a.n_mels;
    for (int m = lane; m < a.n_mels; m += 32) {
      const int first = mel_idx[m], count = mel_idx[a.n_mels + m];
      const float* w = mel_w + mel_idx[2 * a.n_mels + m];
      float acc = 0.f;
#pragma unroll 4
      for (int t = 0; t < count; ++t) {
        const int k = first + t;
        acc += w[t] * power[k + k / P];
      }
      dst[m] = a.use_log ? logf(fmaxf(acc, a.log_floor)) : acc;
    }
    __syncwarp();
  }
}

template <int P>
cudaError_t launch_fft(FftArgs a, int batch, cudaStream_t stream) {
  static bool configured = false;   // the attribute is set once per process
  // A warp a frame while that fills the card; more frames a warp for
  // larger batches, which reuse each warp's twiddle registers.
  const long long frames = static_cast<long long>(batch) * a.n_frames;
  const long long fill = frames / (132 * kWarps * 4);
  const int per_warp = fill < 1 ? 1 : fill > kMaxFramesPerWarp ? kMaxFramesPerWarp
                                                               : static_cast<int>(fill);
  a.tile = kWarps * per_warp;
  const size_t smem = sizeof(float) * smem_words(a, P);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        stft_mel_fft_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.n_frames + a.tile - 1) / a.tile, batch);
  stft_mel_fft_kernel<P><<<grid, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------------------ DFT kernel
// The first version, for any fft_len: one DFT bin per thread against the
// folded matrices C_eff, S_eff [frame_len, n_bins], kDftFrames frames a
// block in shared memory, then the dense mel product.
constexpr int kDftFrames = 16;
constexpr int kDftThreads = 288;

__global__ void __launch_bounds__(kDftThreads)
stft_mel_dft_kernel(const float* __restrict__ wave, const float* __restrict__ c_eff,
                    const float* __restrict__ s_eff, const float* __restrict__ mel,
                    float* __restrict__ out, int num_samples, int n_frames,
                    int frame_len, int hop, int n_bins, int n_mels, int use_log,
                    float log_floor) {
  extern __shared__ float dsmem[];
  const int span = (kDftFrames - 1) * hop + frame_len;
  float* x = dsmem;              // [span] samples of this block's frames
  float* power = dsmem + span;   // [kDftFrames][n_bins]
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kDftFrames;
  const float* w = wave + static_cast<size_t>(b) * num_samples;
  const long long start = static_cast<long long>(f0) * hop;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const long long s = start + i;
    x[i] = s < num_samples ? w[s] : 0.f;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    float re[kDftFrames], im[kDftFrames];
#pragma unroll
    for (int f = 0; f < kDftFrames; ++f) re[f] = im[f] = 0.f;
    for (int n = 0; n < frame_len; ++n) {
      const float c = c_eff[n * n_bins + k];
      const float s = s_eff[n * n_bins + k];
#pragma unroll
      for (int f = 0; f < kDftFrames; ++f) {
        const float xv = x[f * hop + n];
        re[f] = fmaf(xv, c, re[f]);
        im[f] = fmaf(xv, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kDftFrames; ++f)
      power[f * n_bins + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  const int frames_here = min(kDftFrames, n_frames - f0);
  for (int o = threadIdx.x; o < frames_here * n_mels; o += blockDim.x) {
    const int f = o / n_mels, m = o - f * n_mels;
    const float* p = power + f * n_bins;
    float acc = 0.f;
    for (int k = 0; k < n_bins; ++k) acc = fmaf(p[k], mel[k * n_mels + m], acc);
    if (use_log) acc = logf(fmaxf(acc, log_floor));
    out[(static_cast<size_t>(b) * n_frames + f0 + f) * n_mels + m] = acc;
  }
}

}  // namespace

// The FFT kernel: fft_len a power of two in 64..1024, frame_len <= fft_len.
extern "C" int st_stft_mel(const float* wave, const float* window, const float* twiddle,
                           const int* mel_index, const float* mel_w, float* out,
                           int batch, int num_samples, int n_frames, int frame_len,
                           int hop, int fft_len, int n_mels, int n_weights,
                           float preemph, int use_log, float log_floor,
                           cudaStream_t stream) {
  const FftArgs a{wave, window, twiddle, mel_index, mel_w,
                  out, num_samples, n_frames, frame_len, hop, n_mels, n_weights,
                  use_log, 0, preemph, log_floor};
  if (frame_len > fft_len) return cudaErrorInvalidValue;
  switch (fft_len) {
    case 64: return launch_fft<1>(a, batch, stream);
    case 128: return launch_fft<2>(a, batch, stream);
    case 256: return launch_fft<4>(a, batch, stream);
    case 512: return launch_fft<8>(a, batch, stream);
    case 1024: return launch_fft<16>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The DFT kernel, for any fft_len.
extern "C" int st_stft_mel_dft(const float* wave, const float* c_eff,
                               const float* s_eff, const float* mel, float* out,
                               int batch, int num_samples, int n_frames,
                               int frame_len, int hop, int n_bins, int n_mels,
                               int use_log, float log_floor, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((kDftFrames - 1) * hop + frame_len + kDftFrames * n_bins);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stft_mel_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n_frames + kDftFrames - 1) / kDftFrames, batch);
  stft_mel_dft_kernel<<<grid, kDftThreads, smem, stream>>>(
      wave, c_eff, s_eff, mel, out, num_samples, n_frames, frame_len, hop,
      n_bins, n_mels, use_log, log_floor);
  return cudaGetLastError();
}
