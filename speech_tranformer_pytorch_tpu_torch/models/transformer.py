"""SpeechTransformer — the encoder-decoder assembly (counterpart of the JAX
package's ``models/transformer.py``)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from .decoder import Cache, Decoder
from .encoder import Encoder


class SpeechTransformer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.subsample_impl != "conv":
            raise ValueError(f"the port implements subsample_impl='conv', "
                             f"not {cfg.subsample_impl!r}")
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)

    def forward(self, feats, frame_lens, targets_in, tgt_lens, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced forward; returns logits [B, U, V] (f32).
        ``deterministic=False`` turns dropout on, its bits drawn from
        ``generator``."""
        kw = dict(deterministic=deterministic, generator=generator)
        memory, mem_lens = self.encoder(feats, frame_lens, **kw)
        return self.decoder(targets_in, tgt_lens, memory, mem_lens, **kw)

    def encode(self, feats, frame_lens) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encoder(feats, frame_lens)

    def init_cache(self, memory, max_len: int, beam_width: int = 1) -> Cache:
        return self.decoder.init_cache(memory, max_len, beam_width)

    def decode_step(self, tokens, index, cache, mem_lens, beam_width, lineage):
        return self.decoder.decode_step(tokens, index, cache, mem_lens,
                                        beam_width, lineage)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "SpeechTransformer":
        """Seeded random weights: normal(0, 1/fan_in) kernels (LeCun), zero
        biases, unit LayerNorm scales, normal(0, 1/d) embeddings. Draws on
        ``generator``'s device; build on the CPU to share weights across
        devices."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim),
                                 generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        return self
