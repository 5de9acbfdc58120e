"""Speech-Transformer encoder (counterpart of the JAX package's
``models/encoder.py``): subsample → positional encoding → N × {self-attention,
feed-forward} with residuals, pre-LN by default or the paper's post-LN with
``normalize_before=False``, then a final LayerNorm and zeroed padding."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import masks as mask_ops
from .modules import (Conv2dSubsampling, FeedForward, LayerNorm,
                      MultiHeadAttention, PositionalEncoding, subsampled_lengths)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.normalize_before = cfg.normalize_before
        self.self_attn = MultiHeadAttention(cfg.d_model, cfg.num_heads,
                                            fused_qkv=cfg.fused_qkv)
        self.ffn = FeedForward(cfg.d_model, cfg.d_ff)
        self.ln1 = LayerNorm(cfg.d_model)
        self.ln2 = LayerNorm(cfg.d_model)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        if self.normalize_before:
            h = self.ln1(x)
            x = x + self.self_attn(h, h, bias)
            return x + self.ffn(self.ln2(x))
        x = self.ln1(x + self.self_attn(x, x, bias))
        return self.ln2(x + self.ffn(x))


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.subsample = Conv2dSubsampling(cfg.input_dim, cfg.d_model,
                                           cfg.subsample_channels)
        self.pos_enc = PositionalEncoding(cfg.d_model, cfg.max_source_positions)
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.num_encoder_layers))
        self.final_norm = LayerNorm(cfg.d_model)

    def forward(self, feats: torch.Tensor,
                frame_lens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (memory [B, T', d_model], memory_lens [B])."""
        x = self.pos_enc(self.subsample(feats))
        out_lens = subsampled_lengths(frame_lens)
        t = x.shape[1]
        bias = mask_ops.mask_to_bias(mask_ops.self_attention_mask(out_lens, t))
        for layer in self.layers:
            x = layer(x, bias)
        x = self.final_norm(x)
        valid = mask_ops.length_mask(out_lens, t)[..., None]
        return x * valid.to(x.dtype), out_lens
