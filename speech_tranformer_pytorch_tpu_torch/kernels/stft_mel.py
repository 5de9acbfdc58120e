"""Fused fbank: framing, FFT power, mel and log in one CUDA kernel.

Replaces the TPU kernel ``_stft_mel_kernel`` / ``log_mel_pallas``
(speech_tranformer_pytorch_tpu/kernels/stft_mel.py:80, :107). The kernels
are in ``csrc/stft_mel.cu``; its header says what bounds the function on
an H100 (bytes) and how the in-kernel real FFT gets there. This module
holds their wrapper, which picks the kernel by the config's shape
(``kernel_for``), the host tables the FFT kernel reads (``fft_tables``),
the effective matrices of the DFT kernel, and the plain rfft version of
the same function, which the CPU path and the card-side checks use.
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


# Power-of-two FFT lengths the FFT kernel takes (64 P points, P = 1..16).
FFT_LENGTHS = (64, 128, 256, 512, 1024)


def kernel_for(cfg: FeatureConfig) -> str:
    """"fft" for a power-of-two ``fft_length`` the FFT kernel takes (and a
    frame no longer than it), else "dft": the DFT kernel over the folded
    matrices, which takes any length. Chosen by shape, never on failure."""
    if cfg.fft_length in FFT_LENGTHS and cfg.frame_length <= cfg.fft_length:
        return "fft"
    return "dft"


def sparse_mel(mel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The mel matrix [n_bins, M] as the FFT kernel reads it: int32 [3, M]
    (each filter's first bin, bin count and offset into the weights) and
    f32 weights of each filter's span from its first to its last nonzero
    bin, in bin order. An empty filter has count 0."""
    n_mels = mel.shape[1]
    index = np.zeros((3, n_mels), np.int32)
    weights = []
    offset = 0
    for m in range(n_mels):
        nz = np.flatnonzero(mel[:, m])
        if nz.size:
            first, count = int(nz[0]), int(nz[-1] - nz[0] + 1)
            weights.append(mel[first:first + count, m])
        else:
            first, count = 0, 0
        index[:, m] = (first, count, offset)
        offset += count
    packed = np.concatenate(weights) if weights else np.zeros(0, np.float32)
    return index, packed.astype(np.float32)


def bit_reverse(x: int, bits: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def lane_twiddles(fft_length: int, dtype=np.float32) -> np.ndarray:
    """The FFT kernel's twiddles, lane-major: [2 (cos, -sin), rows, 32]
    for fft_length = 64 P (csrc/stft_mel.cu ``Rows<P>``), computed in
    float64 and cast to ``dtype``. With N = 32 P and W_n^e = exp(-2 pi i e / n):
    rows 0-3, the cross-lane stages h = 16, 8, 4, 2: W_2h^(l mod h) for a
    lane l with bit h set, else 1; then P - 1 rows W_N^(l rev_P(i)),
    i = 1 .. P-1; then P - 1 rows W_2h^j at row h + j - 1 (the same in
    every lane); then P rows W_2N^k, k = rev_P(i) + P rev5(l), i < P."""
    p = fft_length // 64
    n = 32 * p
    pb = p.bit_length() - 1
    lane = np.arange(32)
    rev5 = np.array([bit_reverse(x, 5) for x in lane])
    rows = []                                          # (numerator, denominator)
    for h in (16, 8, 4, 2):
        rows.append((np.where(lane & h, lane & (h - 1), 0), 2 * h))
    for i in range(1, p):
        rows.append((lane * bit_reverse(i, pb), n))
    for r in range(p - 1):
        h = 1 << (r + 1).bit_length() - 1
        rows.append((np.full(32, r + 1 - h), 2 * h))
    for i in range(p):
        rows.append((bit_reverse(i, pb) + p * rev5, 2 * n))
    ang = np.stack([2.0 * np.pi * num / den for num, den in rows])
    return np.stack([np.cos(ang), -np.sin(ang)]).astype(dtype)


@functools.lru_cache(maxsize=8)
def fft_tables(cfg: FeatureConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(window f32 [fft_length], twiddles f32 [2, rows, 32], mel index
    int32 [3, M], mel weights f32 [nnz]) for the FFT kernel. The window is
    ``make_window``'s, zero past the frame (the FFT's zero padding); the
    twiddles are ``lane_twiddles``."""
    nfft = cfg.fft_length
    mel = make_mel_matrix(cfg.num_mel_bins, nfft, cfg.sample_rate,
                          cfg.low_freq, cfg.high_freq)
    index, weights = sparse_mel(mel)
    window = np.zeros(nfft, np.float32)
    window[:cfg.frame_length] = make_window(cfg.window, cfg.frame_length)
    return window, lane_twiddles(nfft), index, weights


_device_matrices: dict = {}


def _matrices_on(cfg: FeatureConfig, device: torch.device):
    key = (cfg, str(device))
    if key not in _device_matrices:
        _device_matrices[key] = tuple(
            torch.from_numpy(m).to(device) for m in _effective_matrices(cfg))
    return _device_matrices[key]


def _fft_tables_on(cfg: FeatureConfig, device: torch.device):
    key = ("fft", cfg, str(device))
    if key not in _device_matrices:
        _device_matrices[key] = tuple(
            torch.from_numpy(t).to(device) for t in fft_tables(cfg))
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
    out = torch.empty((b, n_frames, cfg.num_mel_bins), dtype=torch.float32,
                      device=waveform.device)
    lib = _build.library()
    stream = _build.stream_ptr(waveform.device)
    if kernel_for(cfg) == "fft":
        window, twiddle, mel_index, mel_w = _fft_tables_on(cfg, waveform.device)
        _build.check(lib.st_stft_mel(
            waveform.data_ptr(), window.data_ptr(), twiddle.data_ptr(),
            mel_index.data_ptr(), mel_w.data_ptr(), out.data_ptr(), b, s, n_frames,
            cfg.frame_length, cfg.frame_shift, cfg.fft_length, cfg.num_mel_bins,
            mel_w.numel(), max(cfg.preemphasis, 0.0), int(cfg.use_log), LOG_EPS,
            stream), "st_stft_mel")
    else:
        c_eff, s_eff, mel = _matrices_on(cfg, waveform.device)
        _build.check(lib.st_stft_mel_dft(
            waveform.data_ptr(), c_eff.data_ptr(), s_eff.data_ptr(),
            mel.data_ptr(), out.data_ptr(), b, s, n_frames, cfg.frame_length,
            cfg.frame_shift, mel.shape[0], cfg.num_mel_bins, int(cfg.use_log),
            LOG_EPS, stream), "st_stft_mel_dft")
    log_mel_cuda.launches += 1
    return out


log_mel_cuda.launches = 0
