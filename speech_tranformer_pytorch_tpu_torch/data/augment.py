"""SpecAugment (counterpart of the JAX package's ``data/augment.py``):
frequency and time masks on the log-mel features inside the train step.

The semantics are JAX's, utterance by utterance:
- a mask's width is ``randint(0, 10000) mod (max_width + 1)``; its start
  is uniform over the padded axis; masked cells are multiplied by 0;
- the time width is capped per utterance at ``time_mask_max_frac`` of its
  valid frames, and is at least 1;
- with ``max_total_frac`` the widths on each axis are spent mask by mask
  from a budget of that fraction of the axis (the valid frames in time);
- with ``time_masks_per_frame`` only the first
  ``max(floor(frames · time_masks_per_frame), 1)`` time masks are applied.

Two parts: ``draw_spec_augment`` draws the raw widths and starts from an
explicit ``torch.Generator`` (the bits cannot match JAX's keys), and
``spec_augment_masks`` builds the keep-masks from given draws with the
clamps, budgets and active counts, so a test can feed it JAX's own draws.
Everything runs on the features' device, batched over utterances, with no
host sync; only the loop over masks (at most ``num_*_masks``) is Python.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import SpecAugmentConfig

RAW_WIDTH_HIGH = 10_000     # raw widths are drawn in [0, 10000), then reduced


class SpecAugmentDraws(NamedTuple):
    """Raw draws, one row per utterance: widths in [0, 10000), starts in
    [0, axis length)."""
    freq_width: torch.Tensor    # [B, num_freq_masks] int64
    freq_start: torch.Tensor    # [B, num_freq_masks]
    time_width: torch.Tensor    # [B, num_time_masks]
    time_start: torch.Tensor    # [B, num_time_masks]


def draw_spec_augment(generator: torch.Generator, batch: int, frames: int, bins: int,
                      cfg: SpecAugmentConfig) -> SpecAugmentDraws:
    """Draw every mask's raw width and start on ``generator``'s device."""
    def randint(high, n):
        return torch.randint(0, high, (batch, n), generator=generator,
                             device=generator.device)

    return SpecAugmentDraws(randint(RAW_WIDTH_HIGH, cfg.num_freq_masks),
                            randint(bins, cfg.num_freq_masks),
                            randint(RAW_WIDTH_HIGH, cfg.num_time_masks),
                            randint(frames, cfg.num_time_masks))


def _axis_keep(raw_width: torch.Tensor, start: torch.Tensor, length: int, max_width,
               budget: Optional[torch.Tensor] = None,
               n_active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, length] bool keep-mask: mask m zeroes [start, start + width) with
    width = raw mod (max_width + 1), 0 from mask ``n_active`` on, and at
    most what is left of ``budget``. ``max_width``, ``budget`` and
    ``n_active`` are ints or [B] tensors."""
    pos = torch.arange(length, device=raw_width.device)
    keep = torch.ones((raw_width.shape[0], length), dtype=torch.bool,
                      device=raw_width.device)
    for m in range(raw_width.shape[1]):
        width = torch.remainder(raw_width[:, m], max_width + 1)
        if n_active is not None:
            width = torch.where(n_active > m, width, 0)
        if budget is not None:
            width = torch.minimum(width, budget)
            budget = budget - width
        lo = start[:, m:m + 1]
        keep &= ~((pos >= lo) & (pos < lo + width[:, None]))
    return keep


def spec_augment_masks(draws: SpecAugmentDraws, frame_lens: torch.Tensor, frames: int,
                       bins: int, cfg: SpecAugmentConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(freq keep [B, bins], time keep [B, frames]) from ``draws`` and the
    valid frame counts, with JAX's clamps (f32 products truncated to int32,
    as JAX's ``astype(int32)``)."""
    frac = cfg.max_total_frac
    n = frame_lens.to(device=draws.time_width.device, dtype=torch.int32)
    b = n.shape[0]
    fbudget = None
    if frac > 0:
        fbudget = torch.full((b,), int(bins * frac), dtype=torch.int64, device=n.device)
    freq = _axis_keep(draws.freq_width, draws.freq_start, bins, cfg.freq_mask_width,
                      budget=fbudget)
    tw = torch.clamp((n * cfg.time_mask_max_frac).to(torch.int32), min=1)
    tw = torch.clamp(tw, max=cfg.time_mask_width).to(torch.int64)
    tbudget = (n * frac).to(torch.int64) if frac > 0 else None
    n_active = None
    if cfg.time_masks_per_frame > 0:
        n_active = torch.clamp((n * cfg.time_masks_per_frame).to(torch.int32), min=1)
    time = _axis_keep(draws.time_width, draws.time_start, frames, tw, budget=tbudget,
                      n_active=n_active)
    return freq, time


def apply_masks(feats: torch.Tensor, freq_keep: torch.Tensor,
                time_keep: torch.Tensor) -> torch.Tensor:
    """``feats * freq_keep * time_keep`` in the features' dtype, as JAX
    multiplies (masked cells become 0: the CMVN'd per-utterance mean)."""
    dt = feats.dtype
    return feats * freq_keep[:, None, :].to(dt) * time_keep[:, :, None].to(dt)


def spec_augment(generator: torch.Generator, feats: torch.Tensor,
                 frame_lens: torch.Tensor, cfg: SpecAugmentConfig) -> torch.Tensor:
    """[B, T, F] features with independent frequency and time masks per
    utterance; the identity when ``cfg.enabled`` is false."""
    if not cfg.enabled:
        return feats
    b, t, f = feats.shape
    draws = draw_spec_augment(generator, b, t, f, cfg)
    freq, time = spec_augment_masks(draws, frame_lens, t, f, cfg)
    return apply_masks(feats, freq, time)
