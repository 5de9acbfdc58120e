"""Speech-Transformer encoder (counterpart of the JAX package's
``models/encoder.py``): subsample → positional encoding (+ dropout) → N ×
{self-attention, feed-forward} with dropout on each sublayer's output and
residuals, pre-LN by default or the paper's post-LN with
``normalize_before=False``, then a final LayerNorm and zeroed padding.
Self-attention masks keys past each utterance's subsampled length.

With ``model.remat`` each layer runs under ``ops/remat.remat_module`` while
gradients are taken (JAX ``encoder.py:84-88, 138-141``): its activations
are recomputed in the backward, with the forward's dropout bits. The layers
are always built one by one; ``model.scan_layers`` only tells
``convert.py`` how a JAX tree stacks them. With a ``mesh`` the layers are
tensor-parallel, and ``model.attention_impl='ring'`` sends self-attention
through ring attention over the model axis (JAX ``encoder.py:44-55``);
without one the ring's function is computed by the ordinary flash route,
as JAX's ``train.build_model`` substitutes it.

Whisper's encoder (``whisper/model.py`` ``AudioEncoder``) is this one with
port-only fields: ``model.stem`` 'conv1d_gelu' (``Conv1dStem``),
``model.encoder_positions`` 'whisper' ([sin | cos] sinusoids),
``model.activation`` 'gelu' and ``model.layer_norm_eps``; its final
LayerNorm is Whisper's ``ln_post``. Whisper's keys have no bias; the
port's key biases load as zeros (a key bias moves no attention). It
attends over every frame of its 30-s window: its front end
(``data/features``) gives every utterance the window's whole length."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import masks as mask_ops
from ..ops.dropout import dropout
from ..ops.remat import remat_module
from .modules import (ACTIVATIONS, Conv1dStem, Conv2dSubsampling, FeedForward, LayerNorm,
                      MultiHeadAttention, PositionalEncoding, stem_lengths)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        self.normalize_before = cfg.normalize_before
        self.dropout_rate = cfg.dropout_rate
        self.self_attn = MultiHeadAttention(
            cfg.d_model, cfg.num_heads, fused_qkv=cfg.fused_qkv,
            dropout_rate=cfg.attention_dropout_rate, remat=cfg.attention_remat,
            mesh=mesh, ring=mesh is not None and cfg.attention_impl == "ring")
        self.ffn = FeedForward(cfg.d_model, cfg.d_ff, cfg.dropout_rate, mesh,
                               activation=ACTIVATIONS[cfg.activation])
        self.ln1 = LayerNorm(cfg.d_model, cfg.layer_norm_eps)
        self.ln2 = LayerNorm(cfg.d_model, cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        kw = dict(deterministic=deterministic, generator=generator)
        drop = lambda y: dropout(y, self.dropout_rate, **kw)
        attn = lambda h: self.self_attn(h, h, kv_lengths=lengths, q_lengths=lengths,
                                        **kw)
        if self.normalize_before:
            h = self.ln1(x)
            x = x + drop(attn(h))
            return x + drop(self.ffn(self.ln2(x), **kw))
        x = self.ln1(x + drop(attn(x)))
        return self.ln2(x + drop(self.ffn(x, **kw)))


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        self.stem = cfg.stem
        self.subsample = (Conv1dStem(cfg.input_dim, cfg.d_model) if cfg.stem == "conv1d_gelu"
                          else Conv2dSubsampling(cfg.input_dim, cfg.d_model,
                                                 cfg.subsample_channels))
        self.pos_enc = PositionalEncoding(cfg.d_model, cfg.max_source_positions,
                                          cfg.dropout_rate, cfg.encoder_positions)
        self.layers = nn.ModuleList(EncoderLayer(cfg, mesh)
                                    for _ in range(cfg.num_encoder_layers))
        self.final_norm = LayerNorm(cfg.d_model, cfg.layer_norm_eps)
        self.remat = cfg.remat

    def forward(self, feats: torch.Tensor, frame_lens: torch.Tensor, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (memory [B, T', d_model], memory_lens [B])."""
        kw = dict(deterministic=deterministic, generator=generator)
        x = self.pos_enc(self.subsample(feats), **kw)
        out_lens = stem_lengths(frame_lens, self.stem)
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            x = (remat_module(layer, x, out_lens, **kw) if remat
                 else layer(x, out_lens, **kw))
        x = self.final_norm(x)
        valid = mask_ops.length_mask(out_lens, x.shape[1])[..., None]
        return x * valid.to(x.dtype), out_lens
