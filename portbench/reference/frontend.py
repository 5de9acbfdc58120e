"""Front end of the reference: fbank + CMVN and SpecAugment masks.

The fbank follows Kaldi's conventions as the configuration states them:
snip-edges framing, per-frame DC removal, in-frame pre-emphasis, the povey
window, a ``fft_length``-point real DFT, power, an HTK mel bank over
[low_freq, Nyquist], and the log floored at the float32 epsilon. CMVN
normalises each utterance over its valid frames (variance floor 1e-8) and
zeroes the padding frames.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

LOG_FLOOR = float(np.finfo(np.float32).eps)


def _window(kind: str, n: int) -> np.ndarray:
    t = np.arange(n, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * math.pi * t / (n - 1))
    if kind == "povey":
        return hann ** 0.85
    if kind == "hann":
        return hann
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * math.pi * t / (n - 1))
    raise ValueError(f"unknown window {kind!r}")


def _mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_bank(f: dict) -> np.ndarray:
    """[fft_length // 2 + 1, num_mel_bins] triangular weights on the HTK scale."""
    nyq = f["sample_rate"] / 2.0
    hi = f["high_freq"] if f["high_freq"] > 0 else nyq + f["high_freq"]
    bins = f["fft_length"] // 2 + 1
    fft_mel = _mel(np.linspace(0.0, nyq, bins))[:, None]
    pts = np.linspace(_mel(f["low_freq"]), _mel(hi), f["num_mel_bins"] + 2)
    lo, mid, top = pts[:-2][None], pts[1:-1][None], pts[2:][None]
    rise = (fft_mel - lo) / np.maximum(mid - lo, 1e-10)
    fall = (top - fft_mel) / np.maximum(top - mid, 1e-10)
    return np.clip(np.minimum(rise, fall), 0.0, None)


def frame_geometry(f: dict) -> Tuple[int, int]:
    """(samples a frame, samples a hop)."""
    return (int(f["sample_rate"] * f["frame_length_ms"] / 1000.0),
            int(f["sample_rate"] * f["frame_shift_ms"] / 1000.0))


def fbank(audio: torch.Tensor, sample_lens: torch.Tensor, f: dict
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int16 PCM [B, S] (padded) -> (features [B, T, bins] f32, valid frames [B])."""
    flen, hop = frame_geometry(f)
    wave = audio.to(torch.float32) / 32768.0
    frames = wave.unfold(-1, flen, hop)                           # [B, T, flen]
    frames = frames - frames.mean(dim=-1, keepdim=True)
    if f["preemphasis"] > 0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - f["preemphasis"] * prev
    win = torch.tensor(_window(f["window"], flen), dtype=torch.float32, device=audio.device)
    spec = torch.fft.rfft(frames * win, n=f["fft_length"])
    power = spec.real.square() + spec.imag.square()
    bank = torch.tensor(mel_bank(f), dtype=torch.float32, device=audio.device)
    mel = power @ bank
    if f["use_log"]:
        mel = torch.log(torch.clamp(mel, min=LOG_FLOOR))
    t = mel.shape[1]
    lens = torch.clamp(torch.div(sample_lens.to(audio.device).long() - flen, hop,
                                 rounding_mode="floor") + 1, min=0, max=t)
    if f["cmvn"]:
        valid = (torch.arange(t, device=audio.device)[None] < lens[:, None]).float()[..., None]
        n = torch.clamp(valid.sum(1, keepdim=True), min=1.0)
        mean = (mel * valid).sum(1, keepdim=True) / n
        var = ((mel - mean).square() * valid).sum(1, keepdim=True) / n
        mel = (mel - mean) / torch.sqrt(var + 1e-8) * valid
    return mel, lens


def _keep(width: torch.Tensor, start: torch.Tensor, length: int) -> torch.Tensor:
    pos = torch.arange(length, device=width.device)[None]
    return ~((pos >= start[:, None]) & (pos < (start + width)[:, None]))


def spec_augment_keep(draws, frame_lens: torch.Tensor, frames: int, bins: int,
                      s: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(frequency keep [B, bins], time keep [B, frames]) of SpecAugment as
    the configuration states it (Park et al., 2019, with the recipe's caps):
    mask m has width raw_m mod (max_width + 1), starts at its drawn start,
    and spends a per-axis budget of ``max_total_frac`` of the axis (the
    valid frames in time); time widths are capped at ``time_mask_max_frac``
    of the valid frames (at least 1) and ``time_mask_width``; with
    ``time_masks_per_frame`` only the first max(floor(frames * rate), 1)
    time masks apply. ``draws`` = (freq raw widths, freq starts, time raw
    widths, time starts), each [B, masks]."""
    fw, fs, tw, ts = draws
    n = frame_lens.to(fw.device).long()
    b = n.shape[0]
    frac = s["max_total_frac"]
    keep_f = torch.ones(b, bins, dtype=torch.bool, device=fw.device)
    budget = torch.full((b,), int(bins * frac), device=fw.device) if frac > 0 else None
    for m in range(fw.shape[1]):
        w = fw[:, m] % (s["freq_mask_width"] + 1)
        if budget is not None:
            w = torch.minimum(w, budget)
            budget = budget - w
        keep_f &= _keep(w, fs[:, m], bins)
    cap = torch.clamp(torch.clamp((n.float() * s["time_mask_max_frac"]).long(), min=1),
                      max=s["time_mask_width"])
    budget = (n.float() * frac).long() if frac > 0 else None
    active = (torch.clamp((n.float() * s["time_masks_per_frame"]).long(), min=1)
              if s["time_masks_per_frame"] > 0 else None)
    keep_t = torch.ones(b, frames, dtype=torch.bool, device=fw.device)
    for m in range(tw.shape[1]):
        w = tw[:, m] % (cap + 1)
        if active is not None:
            w = torch.where(active > m, w, torch.zeros_like(w))
        if budget is not None:
            w = torch.minimum(w, budget)
            budget = budget - w
        keep_t &= _keep(w, ts[:, m], frames)
    return keep_f, keep_t
