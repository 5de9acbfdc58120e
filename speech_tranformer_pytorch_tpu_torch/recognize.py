"""Batch recognizer (counterpart of the JAX package's ``recognize.py``):
int16 PCM -> fbank + CMVN -> encoder -> beam search (greedy at beam 1) ->
best hypotheses with <eos> removed."""

from __future__ import annotations

from typing import Dict, List, Union

import torch

from .config import ExperimentConfig
from .data.features import extract_features
from .decoding import (BeamResult, GreedyResult, beam_decode, best_hypotheses,
                       greedy_decode, tokens_to_lists)
from .decoding.beam import EOS
from .device import DeviceLike, resolve_device
from .models import SpeechTransformer
from .ops.quantize import decode_model, quantize_params


class Recognizer:
    def __init__(self, cfg: ExperimentConfig, params: Dict[str, torch.Tensor], *,
                 device: DeviceLike = None):
        """``params`` is a float32 ``state_dict`` of ``SpeechTransformer``
        (``convert.params_from_jax`` makes one from a JAX checkpoint tree).
        The model lives on ``device`` (CUDA unless the caller asks for the
        CPU); inference never updates params, so they are cast to the
        compute dtype ``model.dtype`` once, here.

        ``decode.int8_weights``: the weights are quantized from the f32
        params (per-row int8 embedding included) and served by
        ``ops.quantize.decode_model``: encoder dequantized once, decoder
        dense layers on the int8 kernels. ``decode.int8_kv_cache``: int8
        cross K/V cache."""
        self.cfg = cfg
        self.device = resolve_device(device)
        dt = getattr(torch, cfg.model.dtype)
        self.int8_kv = bool(cfg.decode.int8_kv_cache)
        if cfg.decode.int8_weights:
            qparams, scales = quantize_params(params, cfg.model, embedding_rows=True)
            self.model = decode_model(cfg.model, qparams, scales, dt).to(self.device)
        else:
            model = SpeechTransformer(cfg.model)
            model.load_state_dict(params)
            self.model = model.to(self.device, dt)
        self.model.eval()
        self.last_steps = 0

    def decode_result(self, audio_int16, sample_lens, *, beam_size: int,
                      max_len: int, alpha: float) -> Union[BeamResult, GreedyResult]:
        """Decode a padded int16 batch [B, S]: beam search, or greedy search
        when ``beam_size == 1`` (as the JAX ``Recognizer`` routes it)."""
        feats, frame_lens = extract_features(audio_int16, sample_lens,
                                             self.cfg.features, device=self.device)
        if beam_size == 1:
            result = greedy_decode(self.model, feats, frame_lens, max_len=max_len,
                                   int8_kv=self.int8_kv, device=self.device)
        else:
            result = beam_decode(self.model, feats, frame_lens, beam_size=beam_size,
                                 max_len=max_len, alpha=alpha, int8_kv=self.int8_kv,
                                 device=self.device)
        self.last_steps = result.steps
        return result

    def decode_batch(self, audio_int16, sample_lens, *, beam_size: int,
                     max_len: int, alpha: float) -> List[List[int]]:
        """Best hypothesis of each utterance, <eos> removed."""
        return self.hypotheses(self.decode_result(
            audio_int16, sample_lens, beam_size=beam_size, max_len=max_len, alpha=alpha))

    @staticmethod
    def hypotheses(result: Union[BeamResult, GreedyResult]) -> List[List[int]]:
        """Best hypothesis of each utterance of a decode result, <eos> removed."""
        hyps = (tokens_to_lists(result) if isinstance(result, GreedyResult)
                else best_hypotheses(result))
        return [[x for x in h if x != EOS] for h in hyps]
