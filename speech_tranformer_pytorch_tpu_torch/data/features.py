"""Log-mel filterbank front-end (counterpart of the JAX package's
``data/features.py``).

Kaldi conventions: snip-edges framing, per-frame DC removal, in-frame
pre-emphasis, povey window, 512-point real DFT, HTK mel scale, log floor at
float32 eps, then per-utterance CMVN over the valid frames. The fbank itself
runs through ``kernels/interface.log_mel``: the fused CUDA kernel for a CUDA
tensor, the plain rfft path for a CPU tensor.

``features.kind='whisper'`` (a port-only field) is OpenAI Whisper's log-mel
instead (``whisper/audio.py``): each utterance, zero past its length, is
padded or trimmed to ``N_FRAMES`` hops (``pad_or_trim``), reflect-padded
by half a window at both ends (``torch.stft``'s ``center``), framed at the
hop with a periodic Hann window of ``frame_length`` points and a DFT of as
many (the last frame dropped), its power taken through a Slaney-scale,
Slaney-normalised filter bank (librosa's ``filters.mel``), then
log10(max(x, 1e-10)), clamped from below at the utterance's maximum less 8,
and scaled as (x + 4) / 4. Every utterance then has ``N_FRAMES`` valid
frames, so the encoder attends over the whole window, as Whisper's does.
The same kernel route computes the mel power (its DFT form: 400 points is
no power of two), the rest is elementwise on the device.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..config import FeatureConfig
from ..device import DeviceLike, resolve_device
from ..utils.profiling import named_scope

LOG_EPS = 1.1920928955078125e-07  # float32 eps, Kaldi's log floor
N_FRAMES = 3000   # Whisper's window: 30 s of 10-ms hops (``whisper/audio.py``)


def num_frames(num_samples: int, frame_length: int, frame_shift: int) -> int:
    """Kaldi snip-edges frame count."""
    if num_samples < frame_length:
        return 0
    return 1 + (num_samples - frame_length) // frame_shift


def frame_lengths_from_sample_lengths(
    sample_lengths: torch.Tensor, frame_length: int, frame_shift: int
) -> torch.Tensor:
    """Per-utterance valid-frame counts (int32) from sample counts."""
    n = 1 + torch.div(sample_lengths - frame_length, frame_shift,
                      rounding_mode="floor")
    return torch.clamp(n, min=0).to(torch.int32)


def make_window(kind: str, length: int, periodic: bool = False) -> np.ndarray:
    """The symmetric window of ``length`` points, or with ``periodic`` the
    first ``length`` points of the symmetric one of ``length + 1``
    (``torch.hann_window``'s default, Whisper's)."""
    n = np.arange(length, dtype=np.float64)
    a = 2.0 * math.pi / (length if periodic else length - 1)
    if kind == "povey":
        w = (0.5 - 0.5 * np.cos(a * n)) ** 0.85
    elif kind == "hann":
        w = 0.5 - 0.5 * np.cos(a * n)
    elif kind == "hamming":
        w = 0.54 - 0.46 * np.cos(a * n)
    else:
        raise ValueError(f"unknown window {kind!r}")
    return w.astype(np.float32)


def hz_to_mel(hz):
    return 1127.0 * np.log1p(np.asarray(hz, np.float64) / 700.0)


def make_mel_matrix(
    num_bins: int,
    fft_length: int,
    sample_rate: int,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """[fft_length//2 + 1, num_bins] triangular mel weights (HTK scale)."""
    nyquist = sample_rate / 2.0
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    num_fft_bins = fft_length // 2 + 1
    fft_freqs = np.linspace(0.0, nyquist, num_fft_bins)
    mel_lo, mel_hi = hz_to_mel(low_freq), hz_to_mel(high_freq)
    mel_points = np.linspace(mel_lo, mel_hi, num_bins + 2)
    fft_mels = hz_to_mel(fft_freqs)

    left = mel_points[:-2][None, :]
    center = mel_points[1:-1][None, :]
    right = mel_points[2:][None, :]
    m = fft_mels[:, None]
    up = (m - left) / np.maximum(center - left, 1e-10)
    down = (right - m) / np.maximum(right - center, 1e-10)
    weights = np.maximum(0.0, np.minimum(up, down))
    return weights.astype(np.float32)


def slaney_mel_matrix(num_bins: int, fft_length: int, sample_rate: int,
                      low_freq: float = 0.0, high_freq: float = 0.0) -> np.ndarray:
    """[fft_length//2 + 1, num_bins] triangular weights on the Slaney mel
    scale (linear below 1 kHz, logarithmic above), each filter scaled by 2
    over its width in Hz (Slaney's area normalisation), as librosa's
    ``filters.mel(htk=False, norm='slaney')`` builds them."""
    f_sp, min_log_hz, logstep = 200.0 / 3, 1000.0, math.log(6.4) / 27.0
    min_log_mel = min_log_hz / f_sp

    def to_mel(hz):
        hz = np.asarray(hz, np.float64)
        return np.where(hz >= min_log_hz,
                        min_log_mel + np.log(np.maximum(hz, min_log_hz) / min_log_hz) / logstep,
                        hz / f_sp)

    def to_hz(mel):
        return np.where(mel >= min_log_mel, min_log_hz * np.exp(logstep * (mel - min_log_mel)),
                        f_sp * mel)

    if high_freq <= 0.0:
        high_freq = sample_rate / 2.0 + high_freq
    edges = to_hz(np.linspace(to_mel(low_freq), to_mel(high_freq), num_bins + 2))
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, fft_length // 2 + 1)
    up = (fft_freqs[None, :] - edges[:-2, None]) / (edges[1:-1] - edges[:-2])[:, None]
    down = (edges[2:, None] - fft_freqs[None, :]) / (edges[2:] - edges[1:-1])[:, None]
    weights = np.maximum(0.0, np.minimum(up, down)) * (2.0 / (edges[2:] - edges[:-2]))[:, None]
    return np.ascontiguousarray(weights.T, dtype=np.float32)


def feature_window(cfg: FeatureConfig) -> np.ndarray:
    """The analysis window of ``cfg``: ``make_window``'s, periodic for
    Whisper's log-mel."""
    return make_window(cfg.window, cfg.frame_length, periodic=cfg.kind == "whisper")


def feature_mel_matrix(cfg: FeatureConfig) -> np.ndarray:
    """The filter bank of ``cfg``: HTK (Kaldi) or Slaney (Whisper)."""
    make = slaney_mel_matrix if cfg.kind == "whisper" else make_mel_matrix
    return make(cfg.num_mel_bins, cfg.fft_length, cfg.sample_rate, cfg.low_freq,
                cfg.high_freq)


def log_mel_spectrogram(waveform: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """[..., S] f32 waveform -> [..., T, num_mel_bins] log-mel features on
    the waveform's device (the CUDA kernel on a card, the plain path on the
    CPU; ``cfg.use_pallas`` is the JAX package's switch and is not read)."""
    from ..kernels import interface

    n = num_frames(waveform.shape[-1], cfg.frame_length, cfg.frame_shift)
    if n <= 0:
        raise ValueError(
            f"waveform too short: {waveform.shape[-1]} samples < "
            f"{cfg.frame_length} frame_length")
    squeeze = waveform.dim() == 1
    out = interface.log_mel(waveform.reshape(-1, waveform.shape[-1]), cfg, n)
    return out[0] if squeeze else out.reshape(*waveform.shape[:-1], n, -1)


def apply_cmvn(feats: torch.Tensor, frame_lens: torch.Tensor, *,
               eps: float = 1e-8) -> torch.Tensor:
    """Per-utterance mean-variance normalisation over valid frames; padded
    frames come out zero. Statistics accumulate in float32."""
    t = feats.shape[1]
    f32 = feats.float()
    valid = (torch.arange(t, device=feats.device)[None, :]
             < frame_lens[:, None]).float()[..., None]
    count = torch.clamp(valid.sum(dim=1, keepdim=True), min=1.0)
    mean = (f32 * valid).sum(dim=1, keepdim=True) / count
    var = (torch.square(f32 - mean) * valid).sum(dim=1, keepdim=True) / count
    normed = (f32 - mean) * torch.rsqrt(var + eps) * valid
    return normed.to(feats.dtype)


def whisper_log_mel(waveforms: torch.Tensor, sample_lengths: torch.Tensor,
                    cfg: FeatureConfig) -> torch.Tensor:
    """[B, S] f32 waveforms -> [B, N_FRAMES, M] Whisper log-mel (module
    docstring), on the waveforms' device."""
    from torch.nn import functional as F

    from ..kernels import interface

    n = N_FRAMES * cfg.frame_shift
    s = waveforms.shape[1]
    keep = torch.arange(s, device=waveforms.device)[None, :] < sample_lengths[:, None]
    x = torch.where(keep, waveforms, 0.0)
    x = x[:, :n] if s >= n else F.pad(x, (0, n - s))
    half = cfg.fft_length // 2
    x = F.pad(x[:, None], (half, half), mode="reflect")[:, 0].contiguous()
    power = interface.log_mel(x, cfg, N_FRAMES)
    logs = torch.log10(torch.clamp(power, min=1e-10))
    logs = torch.maximum(logs, logs.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (logs + 4.0) / 4.0


def extract_features(
    waveforms,                     # [B, S] padded audio, int16 or float
    sample_lengths,                # [B] valid sample counts
    cfg: FeatureConfig,
    *,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full front-end: fbank + CMVN, or Whisper's log-mel
    (``features.kind``). Returns (feats [B,T,F], frame_lens [B]).

    Inputs may be numpy arrays or tensors; they are moved to ``device``
    (CUDA unless the caller asks for the CPU). int16 PCM is dequantized
    here by 1/32768. ``feats`` is cast to ``cfg.output_dtype`` only after
    CMVN, whose statistics stay float32."""
    dev = resolve_device(device)
    with named_scope("st.features"):
        waveforms = torch.as_tensor(waveforms).to(dev)
        sample_lengths = torch.as_tensor(sample_lengths).to(dev)
        if waveforms.dtype == torch.int16:
            waveforms = waveforms.float() * (1.0 / 32768.0)
        if cfg.kind == "whisper":
            feats = whisper_log_mel(waveforms.float(), sample_lengths, cfg)
            frame_lens = torch.full((feats.shape[0],), N_FRAMES, dtype=torch.int32,
                                    device=dev)
            return feats.to(getattr(torch, cfg.output_dtype)), frame_lens
        feats = log_mel_spectrogram(waveforms.float(), cfg)
        frame_lens = frame_lengths_from_sample_lengths(
            sample_lengths, cfg.frame_length, cfg.frame_shift)
        frame_lens = torch.clamp(frame_lens, max=feats.shape[-2])
        if cfg.cmvn:
            feats = apply_cmvn(feats, frame_lens)
        return feats.to(getattr(torch, cfg.output_dtype)), frame_lens
