// Fused framing + DFT power + mel + log: the Kaldi-style fbank.
//
// Replaces the TPU kernel `_stft_mel_kernel` / `log_mel_pallas`
// (speech_tranformer_pytorch_tpu/kernels/stft_mel.py:80, :107). As there,
// everything before |.|^2 (DC removal, pre-emphasis, window, real DFT) is
// linear in the frame samples and arrives folded into two matrices
// C_eff, S_eff [frame_len, n_bins]; the kernel computes
//   out[b, t, m] = log(max(sum_k ((F C)^2 + (F S)^2)[t, k] M[k, m], floor))
// with frame t = wave[b, hop*t : hop*t + frame_len].
//
// Unlike the TPU kernel, framing happens here, straight from the waveform:
// a block stages the samples of its kFrames overlapping frames in shared
// memory once. All products are float32 FMAs on the CUDA cores (no TF32,
// no bf16): at reduced precision the low-energy bins wash out after the
// log. What bounds the function on an H100: bytes — the waveform in and
// the features out (about 4.4 MB for 8 utterances of 4-6 s), since a
// 512-point real FFT needs only ~15k f32 operations per frame. This
// kernel does not reach that bound: its DFT as a [frame_len, n_bins]
// product costs ~0.45 MFLOP per frame, ~30x the FFT, so its own f32 FMAs
// bound it. An in-kernel FFT is the way down to the function's bound.
// The design keeps each block's frames in shared memory and one DFT bin
// per thread with kFrames accumulators in registers, so every C/S element
// read from L2 feeds 2*kFrames FMAs.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kFrames = 16;    // frames per block
constexpr int kThreads = 288;  // 9 warps: one DFT bin per thread (257 bins)

__global__ void __launch_bounds__(kThreads)
stft_mel_kernel(const float* __restrict__ wave, const float* __restrict__ c_eff,
                const float* __restrict__ s_eff, const float* __restrict__ mel,
                float* __restrict__ out, int num_samples, int n_frames,
                int frame_len, int hop, int n_bins, int n_mels, int use_log,
                float log_floor) {
  extern __shared__ float smem[];
  const int span = (kFrames - 1) * hop + frame_len;
  float* x = smem;              // [span] samples of this block's frames
  float* power = smem + span;   // [kFrames][n_bins]
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const float* w = wave + static_cast<size_t>(b) * num_samples;
  const long long start = static_cast<long long>(f0) * hop;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const long long s = start + i;
    x[i] = s < num_samples ? w[s] : 0.f;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    float re[kFrames], im[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) re[f] = im[f] = 0.f;
    for (int n = 0; n < frame_len; ++n) {
      const float c = c_eff[n * n_bins + k];
      const float s = s_eff[n * n_bins + k];
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        const float xv = x[f * hop + n];
        re[f] = fmaf(xv, c, re[f]);
        im[f] = fmaf(xv, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kFrames; ++f)
      power[f * n_bins + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  const int frames_here = min(kFrames, n_frames - f0);
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

extern "C" int st_stft_mel(const float* wave, const float* c_eff,
                           const float* s_eff, const float* mel, float* out,
                           int batch, int num_samples, int n_frames,
                           int frame_len, int hop, int n_bins, int n_mels,
                           int use_log, float log_floor, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((kFrames - 1) * hop + frame_len + kFrames * n_bins);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stft_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  stft_mel_kernel<<<grid, kThreads, smem, stream>>>(
      wave, c_eff, s_eff, mel, out, num_samples, n_frames, frame_len, hop,
      n_bins, n_mels, use_log, log_floor);
  return cudaGetLastError();
}
