"""Fused fbank: framing, DFT power, mel and log in one CUDA kernel.

Replaces the TPU kernel ``_stft_mel_kernel`` / ``log_mel_pallas``
(speech_tranformer_pytorch_tpu/kernels/stft_mel.py:80, :107). The kernel is
``csrc/stft_mel.cu``; its header says what bounds the function on an H100
(bytes) and why this kernel's DFT-as-matmul sits far above that bound.
This module holds its wrapper, the
effective matrices it multiplies by, and the plain rfft version of the same
function, which the CPU path and the card-side checks use.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..config import FeatureConfig
from ..data.features import LOG_EPS, make_mel_matrix, make_window
from . import _build


@functools.lru_cache(maxsize=8)
def _effective_matrices(cfg: FeatureConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(C_eff [L, n_bins], S_eff [L, n_bins], mel [n_bins, M]) in float32.

    DC removal, pre-emphasis and the window are linear in the frame
    samples, so they fold with the real DFT into two matrices:
    ``C_eff = D_dc @ P_pre @ diag(window) @ C_dft`` (and ``S_eff`` with the
    sine basis). Unlike the TPU copy, the bin axis is not padded."""
    L = cfg.frame_length
    nfft = cfg.fft_length
    n_bins = nfft // 2 + 1
    d_dc = np.eye(L) - np.full((L, L), 1.0 / L)
    p = np.eye(L)
    if cfg.preemphasis > 0:
        k = cfg.preemphasis
        for j in range(1, L):
            p[j - 1, j] = -k
        p[0, 0] = 1.0 - k
    w = np.diag(make_window(cfg.window, L).astype(np.float64))
    n = np.arange(L)[:, None]
    kk = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * kk / nfft
    pre = d_dc @ p @ w
    c_eff = (pre @ np.cos(ang)).astype(np.float32)
    s_eff = (pre @ -np.sin(ang)).astype(np.float32)
    mel = make_mel_matrix(cfg.num_mel_bins, nfft, cfg.sample_rate,
                          cfg.low_freq, cfg.high_freq)
    return c_eff, s_eff, mel


_device_matrices: dict = {}


def _matrices_on(cfg: FeatureConfig, device: torch.device):
    key = (cfg, str(device))
    if key not in _device_matrices:
        _device_matrices[key] = tuple(
            torch.from_numpy(m).to(device) for m in _effective_matrices(cfg))
    return _device_matrices[key]


def _window_and_mel_on(cfg: FeatureConfig, device: torch.device):
    key = ("plain", cfg, str(device))
    if key not in _device_matrices:
        _device_matrices[key] = (
            torch.from_numpy(make_window(cfg.window, cfg.frame_length)).to(device),
            torch.from_numpy(_effective_matrices(cfg)[2]).to(device))
    return _device_matrices[key]


def log_mel_reference(waveform: torch.Tensor, cfg: FeatureConfig,
                      n_frames: int) -> torch.Tensor:
    """Plain version: [B, S] f32 -> [B, n_frames, M] by framing, DC
    removal, pre-emphasis, window, ``torch.fft.rfft``, power, mel, log —
    the rfft form of the JAX package's ``_log_mel_impl``."""
    x = waveform.float()
    frames = x.unfold(-1, cfg.frame_length, cfg.frame_shift)[..., :n_frames, :]
    frames = frames - frames.mean(dim=-1, keepdim=True)
    if cfg.preemphasis > 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - cfg.preemphasis * prev
    window, mel_mat = _window_and_mel_on(cfg, x.device)
    spec = torch.fft.rfft(frames * window, n=cfg.fft_length, dim=-1)
    power = torch.square(spec.real) + torch.square(spec.imag)
    mel = power @ mel_mat
    if cfg.use_log:
        mel = torch.log(torch.clamp(mel, min=LOG_EPS))
    return mel


def log_mel_cuda(waveform: torch.Tensor, cfg: FeatureConfig,
                 n_frames: int) -> torch.Tensor:
    """Kernel wrapper: [B, S] f32 CUDA waveform -> [B, n_frames, M] f32."""
    if waveform.device.type != "cuda":
        raise ValueError("log_mel_cuda needs a CUDA tensor")
    if waveform.dim() != 2 or waveform.dtype != torch.float32:
        raise ValueError(f"log_mel_cuda takes [B, S] float32, got "
                         f"{tuple(waveform.shape)} {waveform.dtype}")
    b, s = waveform.shape
    if n_frames <= 0 or cfg.frame_shift * (n_frames - 1) + cfg.frame_length > s:
        raise ValueError(f"{n_frames} frames do not fit in {s} samples")
    waveform = waveform.contiguous()
    c_eff, s_eff, mel = _matrices_on(cfg, waveform.device)
    n_bins, n_mels = mel.shape
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32,
                      device=waveform.device)
    lib = _build.library()
    _build.check(lib.st_stft_mel(
        waveform.data_ptr(), c_eff.data_ptr(), s_eff.data_ptr(),
        mel.data_ptr(), out.data_ptr(), b, s, n_frames, cfg.frame_length,
        cfg.frame_shift, n_bins, n_mels, int(cfg.use_log), LOG_EPS,
        _build.stream_ptr(waveform.device)), "st_stft_mel")
    log_mel_cuda.launches += 1
    return out


log_mel_cuda.launches = 0
