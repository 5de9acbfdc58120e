"""Audio-batch train step (counterpart of the JAX package's
``data/pipeline.py``: ``AudioBatch`` :33, ``make_preprocess_fn`` :290 and
``make_audio_train_step`` :309).

The features are computed on the device inside the step: fbank + CMVN run
under ``torch.no_grad()`` through ``extract_features`` (the stft_mel kernel
on a card, once per step), then the train step of ``train.py`` runs on the
result. Manifests, bucketing and file reading are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import ExperimentConfig, FeatureConfig, SpecAugmentConfig
from ..train import Batch, TrainState, make_train_step
from .features import extract_features


@dataclasses.dataclass(frozen=True)
class AudioBatch:
    """Padded raw-audio batch (features are computed on the device)."""
    audio: torch.Tensor          # [B, S] int16 PCM or float32
    sample_lens: torch.Tensor    # [B]
    targets_in: torch.Tensor     # [B, U]
    targets_out: torch.Tensor    # [B, U]
    target_lens: torch.Tensor    # [B]
    valid: torch.Tensor          # [B] bool — False for eval-padding rows

    def to(self, device) -> "AudioBatch":
        return AudioBatch(*(torch.as_tensor(getattr(self, f.name)).to(device)
                            for f in dataclasses.fields(self)))


def make_preprocess_fn(feature_cfg: FeatureConfig,
                       spec_cfg: Optional[SpecAugmentConfig] = None):
    """``preprocess(batch, device) -> Batch``: fbank + CMVN on ``device``."""
    if spec_cfg is not None and spec_cfg.enabled:
        raise NotImplementedError(
            "SpecAugment is not ported yet (ROADMAP queue A, 'training "
            "slice, left out'); set spec_augment.enabled=False")

    def preprocess(batch: AudioBatch, device) -> Batch:
        with torch.no_grad():
            feats, frame_lens = extract_features(batch.audio, batch.sample_lens,
                                                 feature_cfg, device=device)
        return Batch(feats=feats, frame_lens=frame_lens,
                     targets_in=batch.targets_in, targets_out=batch.targets_out,
                     target_lens=batch.target_lens).to(device)

    return preprocess


def make_audio_train_step(cfg: ExperimentConfig):
    """``step(state, audio_batch, seed=cfg.train.seed) -> (state, metrics)``:
    on-device preprocess → model → loss → update."""
    preprocess = make_preprocess_fn(cfg.features, cfg.spec_augment)
    inner = make_train_step(cfg)

    def step(state: TrainState, abatch: AudioBatch, seed: int = cfg.train.seed):
        return inner(state, preprocess(abatch, state.device), seed)

    return step
