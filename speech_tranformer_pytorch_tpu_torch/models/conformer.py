"""The Conformer encoder (Gulati et al., 2020) as ESPnet serves it for
LibriSpeech (``ConformerEncoder`` with ``macaron_style``, ``rel_pos`` /
``rel_selfattn`` in their "latest" form, Swish, ``normalize_before``):
``model.encoder='conformer'``. The JAX package has no counterpart.

Conv2dSubsampling (the port's module, with its projection) → ×√d_model →
N blocks, each::

    x = x + ½·FFN_swish(LN(x))
    x = x + MHSA_rel(LN(x), pos)
    x = x + Conv(LN(x))
    x = x + ½·FFN_swish(LN(x))
    x = LN(x)

→ a final LayerNorm (ESPnet's ``after_norm``) → zeroed padding. Dropout
follows each sublayer's output and the feed-forwards' hidden layer, as
ESPnet drops them; the positions are dropped with the input.

* Positions: ``RelPositionalEncoding`` holds one sinusoidal table of the
  relative positions max_len - 1 … -(max_len - 1), built at
  ``model.max_source_positions`` as a buffer; a batch of T frames takes its
  2T - 1 rows T - 1 … -(T - 1) by a slice on the device, so a CUDA graph
  captures it.
* Attention: ``RelPositionAttention`` projects q, k, v (one fused matmul),
  the position rows (``pos``, no bias: ESPnet's ``linear_pos``) and has the
  biases ``pos_bias_u`` / ``pos_bias_v``; the scores and the weighted sum
  are ``kernels/interface.relpos_attention`` (one kernel launch on the
  card), in the span ``st.encode.relpos`` with the position projection.
* Convolution: ``ConvolutionModule`` is pointwise d → 2d, GLU, the padded
  frames zeroed, a depthwise convolution of kernel ``model.conv_kernel``
  ("same" padding), BatchNorm, Swish, pointwise d → d, in the span
  ``st.encode.conv``. Zeroing the padded frames before the depthwise
  convolution keeps an utterance's output independent of the bucket it is
  padded to (WeNet's ``mask_pad``). The BatchNorm normalises with its
  running statistics when the module is in eval mode (serving) and with
  the batch's statistics over the padded [B, d, T] in train mode, updating
  the running ones, as ``nn.BatchNorm1d`` does; its arithmetic is float32
  whatever the compute dtype.

The Conformer is single-device serving and training: no mesh, ring
attention, remat, int8 weights or export (each refuses).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..config import ModelConfig
from ..kernels import interface
from ..ops import masks as mask_ops
from ..ops.dropout import dropout
from ..utils.profiling import named_scope
from .modules import Conv2dSubsampling, FeedForward, LayerNorm, subsampled_lengths


def relative_position_table(max_len: int, d_model: int) -> np.ndarray:
    """[2·max_len - 1, d_model]: row c holds the sinusoid of relative
    position max_len - 1 - c (sines at even columns, cosines at odd), as
    ESPnet's "latest" ``RelPositionalEncoding`` concatenates its flipped
    positive and its negative tables."""
    rel = (max_len - 1 - np.arange(2 * max_len - 1, dtype=np.float64))[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pe = np.zeros((2 * max_len - 1, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(rel * div)
    pe[:, 1::2] = np.cos(rel * div)
    return pe.astype(np.float32)


class RelPositionalEncoding(nn.Module):
    def __init__(self, d_model: int, max_len: int, dropout_rate: float = 0.0):
        super().__init__()
        self.max_len = max_len
        self.xscale = math.sqrt(d_model)
        self.dropout_rate = dropout_rate
        self.register_buffer("pe", torch.from_numpy(relative_position_table(max_len, d_model)),
                             persistent=False)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x·√d [B, T, d], the position rows [2T - 1, d] of T - 1 … -(T - 1))."""
        t = x.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence length {t} exceeds the relative position table's "
                             f"max_len={self.max_len}")
        pos = self.pe[self.max_len - t:self.max_len + t - 1].to(x.dtype)
        kw = dict(deterministic=deterministic, generator=generator)
        return (dropout(x * self.xscale, self.dropout_rate, **kw),
                dropout(pos, self.dropout_rate, **kw))


class RelPositionAttention(nn.Module):
    """Self-attention with a learned relative-position term (ESPnet's
    ``RelPositionMultiHeadedAttention``)."""

    def __init__(self, d_model: int, num_heads: int, dropout_rate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.dropout_rate = dropout_rate
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.pos = nn.Linear(d_model, d_model, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, self.head_dim))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, self.head_dim))
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, lengths: torch.Tensor, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        heads = (self.num_heads, self.head_dim)
        q, k, v = self.qkv(x).unflatten(-1, (3,) + heads).unbind(-3)
        with named_scope("st.encode.relpos"):
            p = self.pos(pos).unflatten(-1, heads)                       # [2T-1, H, D]
            out = interface.relpos_attention(
                q, k, v, p, self.pos_bias_u, self.pos_bias_v, lengths,
                dropout_rate=self.dropout_rate, deterministic=deterministic,
                generator=generator)
        return self.out(out.flatten(-2))


class ConvolutionModule(nn.Module):
    def __init__(self, d_model: int, kernel: int):
        super().__init__()
        self.pointwise1 = nn.Linear(d_model, 2 * d_model)
        self.depthwise = nn.Conv1d(d_model, d_model, kernel, padding=(kernel - 1) // 2,
                                   groups=d_model)
        self.norm = nn.BatchNorm1d(d_model)
        self.pointwise2 = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        with named_scope("st.encode.conv"):
            h = F.glu(self.pointwise1(x), dim=-1)                        # [B, T, d]
            valid = mask_ops.length_mask(lengths, x.shape[1])[..., None]
            h = self.depthwise(torch.where(valid, h, 0.0).transpose(1, 2))   # [B, d, T]
            n = self.norm
            h = F.batch_norm(h.float(), n.running_mean.float(), n.running_var.float(),
                             n.weight.float(), n.bias.float(), n.training, n.momentum,
                             n.eps).to(x.dtype)
            return self.pointwise2(F.silu(h).transpose(1, 2))


class ConformerLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.d_model
        self.dropout_rate = cfg.dropout_rate
        self.ffn_macaron = FeedForward(d, cfg.d_ff, cfg.dropout_rate, activation=F.silu)
        self.self_attn = RelPositionAttention(d, cfg.num_heads, cfg.attention_dropout_rate)
        self.conv = ConvolutionModule(d, cfg.conv_kernel)
        self.ffn = FeedForward(d, cfg.d_ff, cfg.dropout_rate, activation=F.silu)
        self.norm_ff_macaron = LayerNorm(d)
        self.norm_mha = LayerNorm(d)
        self.norm_conv = LayerNorm(d)
        self.norm_ff = LayerNorm(d)
        self.norm_final = LayerNorm(d)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, lengths: torch.Tensor, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        kw = dict(deterministic=deterministic, generator=generator)
        drop = lambda y: dropout(y, self.dropout_rate, **kw)
        x = x + 0.5 * drop(self.ffn_macaron(self.norm_ff_macaron(x), **kw))
        x = x + drop(self.self_attn(self.norm_mha(x), pos, lengths, **kw))
        x = x + drop(self.conv(self.norm_conv(x), lengths))
        x = x + 0.5 * drop(self.ffn(self.norm_ff(x), **kw))
        return self.norm_final(x)


class ConformerEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        if mesh is not None:
            raise ValueError("model.encoder='conformer' is single-device: its relative-"
                             "position attention and convolution have no tensor-parallel "
                             "form")
        if cfg.attention_impl == "ring":
            raise ValueError("model.encoder='conformer' has no ring attention: its relative-"
                             "position attention runs on one device")
        self.subsample = Conv2dSubsampling(cfg.input_dim, cfg.d_model, cfg.subsample_channels)
        self.pos_enc = RelPositionalEncoding(cfg.d_model, cfg.max_source_positions,
                                             cfg.dropout_rate)
        self.layers = nn.ModuleList(ConformerLayer(cfg) for _ in range(cfg.num_encoder_layers))
        self.final_norm = LayerNorm(cfg.d_model)

    def forward(self, feats: torch.Tensor, frame_lens: torch.Tensor, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (memory [B, T', d_model], memory_lens [B])."""
        kw = dict(deterministic=deterministic, generator=generator)
        x, pos = self.pos_enc(self.subsample(feats), **kw)
        out_lens = subsampled_lengths(frame_lens)
        for layer in self.layers:
            x = layer(x, pos, out_lens, **kw)
        x = self.final_norm(x)
        valid = mask_ops.length_mask(out_lens, x.shape[1])[..., None]
        return torch.where(valid, x, 0.0), out_lens

    @torch.no_grad()
    def init_extra(self, generator: torch.Generator) -> None:
        """Seeded draws of what ``SpeechTransformer.init_weights`` does not
        cover: the position biases, normal(0, 1/√D)."""
        for layer in self.layers:
            a = layer.self_attn
            for bias in (a.pos_bias_u, a.pos_bias_v):
                bias.normal_(0.0, 1.0 / math.sqrt(a.head_dim), generator=generator)
