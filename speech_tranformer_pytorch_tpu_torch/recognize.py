"""Batch recognizer (counterpart of the JAX package's ``recognize.py``):
int16 PCM -> fbank + CMVN -> encoder -> beam search -> best hypotheses with
<eos> removed."""

from __future__ import annotations

from typing import Dict, List

import torch

from .config import ExperimentConfig
from .data.features import extract_features
from .decoding import beam_decode, best_hypotheses
from .decoding.beam import EOS
from .device import DeviceLike, resolve_device
from .models import SpeechTransformer


class Recognizer:
    def __init__(self, cfg: ExperimentConfig, params: Dict[str, torch.Tensor], *,
                 device: DeviceLike = None):
        """``params`` is a float32 ``state_dict`` of ``SpeechTransformer``
        (``convert.params_from_jax`` makes one from a JAX checkpoint tree).
        The model lives on ``device`` (CUDA unless the caller asks for the
        CPU); inference never updates params, so they are cast to the
        compute dtype ``model.dtype`` once, here."""
        self.cfg = cfg
        self.device = resolve_device(device)
        model = SpeechTransformer(cfg.model)
        model.load_state_dict(params)
        self.model = model.to(self.device, getattr(torch, cfg.model.dtype)).eval()
        self.last_steps = 0

    def decode_result(self, audio_int16, sample_lens, *, beam_size: int,
                      max_len: int, alpha: float):
        """Beam search over a padded int16 batch [B, S]; returns the
        ``BeamResult``."""
        feats, frame_lens = extract_features(audio_int16, sample_lens,
                                             self.cfg.features, device=self.device)
        result = beam_decode(self.model, feats, frame_lens, beam_size=beam_size,
                             max_len=max_len, alpha=alpha, device=self.device)
        self.last_steps = result.steps
        return result

    def decode_batch(self, audio_int16, sample_lens, *, beam_size: int,
                     max_len: int, alpha: float) -> List[List[int]]:
        """Best hypothesis of each utterance, <eos> removed."""
        result = self.decode_result(audio_int16, sample_lens, beam_size=beam_size,
                                    max_len=max_len, alpha=alpha)
        return [[x for x in h if x != EOS] for h in best_hypotheses(result)]
