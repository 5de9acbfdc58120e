"""Speech-Transformer encoder (counterpart of the JAX package's
``models/encoder.py``): subsample → positional encoding (+ dropout) → N ×
{self-attention, feed-forward} with dropout on each sublayer's output and
residuals, pre-LN by default or the paper's post-LN with
``normalize_before=False``, then a final LayerNorm and zeroed padding.
Self-attention masks keys past each utterance's subsampled length."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import masks as mask_ops
from ..ops.dropout import dropout
from .modules import (Conv2dSubsampling, FeedForward, LayerNorm,
                      MultiHeadAttention, PositionalEncoding, subsampled_lengths)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.normalize_before = cfg.normalize_before
        self.dropout_rate = cfg.dropout_rate
        self.self_attn = MultiHeadAttention(cfg.d_model, cfg.num_heads,
                                            fused_qkv=cfg.fused_qkv,
                                            dropout_rate=cfg.attention_dropout_rate)
        self.ffn = FeedForward(cfg.d_model, cfg.d_ff, cfg.dropout_rate)
        self.ln1 = LayerNorm(cfg.d_model)
        self.ln2 = LayerNorm(cfg.d_model)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        kw = dict(deterministic=deterministic, generator=generator)
        drop = lambda y: dropout(y, self.dropout_rate, **kw)
        attn = lambda h: self.self_attn(h, h, kv_lengths=lengths,
                                        deterministic=deterministic)
        if self.normalize_before:
            h = self.ln1(x)
            x = x + drop(attn(h))
            return x + drop(self.ffn(self.ln2(x), **kw))
        x = self.ln1(x + drop(attn(x)))
        return self.ln2(x + drop(self.ffn(x, **kw)))


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.subsample = Conv2dSubsampling(cfg.input_dim, cfg.d_model,
                                           cfg.subsample_channels)
        self.pos_enc = PositionalEncoding(cfg.d_model, cfg.max_source_positions,
                                          cfg.dropout_rate)
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.num_encoder_layers))
        self.final_norm = LayerNorm(cfg.d_model)

    def forward(self, feats: torch.Tensor, frame_lens: torch.Tensor, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (memory [B, T', d_model], memory_lens [B])."""
        kw = dict(deterministic=deterministic, generator=generator)
        x = self.pos_enc(self.subsample(feats), **kw)
        out_lens = subsampled_lengths(frame_lens)
        for layer in self.layers:
            x = layer(x, out_lens, **kw)
        x = self.final_norm(x)
        valid = mask_ops.length_mask(out_lens, x.shape[1])[..., None]
        return x * valid.to(x.dtype), out_lens
