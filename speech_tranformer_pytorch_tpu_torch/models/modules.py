"""Core model modules (counterpart of the JAX package's ``models/modules.py``).

Every module computes in the dtype of its parameters (``Recognizer`` casts
the model to ``model.dtype`` once; the train step casts the f32 master
parameters once per step) and takes ``deterministic`` (no dropout, the
serving default) and a ``generator`` for the dropout bits. Teacher-forced
attention goes through ``kernels/interface.flash_attention`` with the key
lengths and the causal flag the JAX package passes; query rows are not
masked (flash semantics), so rows past a length hold finite values that
the loss ignores. Layouts follow the JAX package at the function
boundaries: activations are [B, T, d], attention heads [B, T, H, D], the
cross-attention cache head-major [B, H, S, D].
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..kernels import interface
from ..ops.dropout import dropout


def sinusoidal_position_encoding(max_len: int, d_model: int) -> np.ndarray:
    """[max_len, d_model] fixed sinusoidal table (Vaswani et al., 2017)."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term[: (d_model + 1) // 2])
    return pe.astype(np.float32)


class PositionalEncoding(nn.Module):
    def __init__(self, d_model: int, max_len: int, dropout_rate: float = 0.0):
        super().__init__()
        self.max_len = max_len
        self.dropout_rate = dropout_rate
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_position_encoding(max_len, d_model)),
            persistent=False)

    def forward(self, x: torch.Tensor, offset: int = 0, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        seq_len = x.shape[-2]
        if seq_len + offset > self.max_len:
            raise ValueError(
                f"sequence length {seq_len}+{offset} exceeds positional table "
                f"max_len={self.max_len}")
        x = x + self.pe[offset:offset + seq_len].to(x.dtype)
        return dropout(x, self.dropout_rate, deterministic=deterministic,
                       generator=generator)


def conv_output_length(length: torch.Tensor, kernel: int = 3,
                       stride: int = 2) -> torch.Tensor:
    """VALID-conv output length: (L - kernel)//stride + 1, floored at 0."""
    return torch.clamp(torch.div(length - kernel, stride, rounding_mode="floor")
                       + 1, min=0)


def subsampled_lengths(frame_lens: torch.Tensor) -> torch.Tensor:
    """Length transform of the 2-layer 3×3/s2 subsampler."""
    return conv_output_length(conv_output_length(frame_lens))


class Conv2dSubsampling(nn.Module):
    """[B,T,F] fbank -> [B,T//4,d_model]: two 3×3/stride-2 VALID convs with
    ReLU over (time, freq), then a linear projection of the flattened
    (freq, channel) axes — the JAX package's NHWC flatten order."""

    def __init__(self, input_dim: int, d_model: int, channels: int):
        super().__init__()
        self.conv0 = nn.Conv2d(1, channels, 3, stride=2)
        self.conv1 = nn.Conv2d(channels, channels, 3, stride=2)
        freq = (((input_dim - 3) // 2 + 1) - 3) // 2 + 1
        self.out = nn.Linear(freq * channels, d_model)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats.to(self.out.weight.dtype)[:, None]         # [B,1,T,F]
        x = F.relu(self.conv0(x))
        x = F.relu(self.conv1(x))                             # [B,C,T',F']
        b, c, t, f = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, f * c)        # (F', C) order
        return self.out(x)


class MultiHeadAttention(nn.Module):
    """Self/cross attention with ragged key lengths. ``fused_qkv``
    (self-attention only) projects q, k and v with one [d, 3·d] matmul."""

    def __init__(self, d_model: int, num_heads: int, fused_qkv: bool = False,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.head_dim = d_model // num_heads
        self.fused_qkv = fused_qkv
        if fused_qkv:
            self.qkv = nn.Linear(d_model, 3 * d_model)
        else:
            self.q = nn.Linear(d_model, d_model)
            self.k = nn.Linear(d_model, d_model)
            self.v = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def _heads(self, y: torch.Tensor) -> torch.Tensor:
        return y.unflatten(-1, (self.num_heads, self.head_dim))

    def project_qkv(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """q, k, v [..., H, D] of a single input."""
        if self.fused_qkv:
            qkv = self.qkv(x).unflatten(-1, (3, self.num_heads, self.head_dim))
            return qkv.unbind(-3)
        return self._heads(self.q(x)), self._heads(self.k(x)), self._heads(self.v(x))

    def project_q(self, x: torch.Tensor) -> torch.Tensor:
        return self.project_qkv(x)[0] if self.fused_qkv else self._heads(self.q(x))

    def project_kv(self, kv_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.fused_qkv:
            _, k, v = self.project_qkv(kv_in)
            return k, v
        return self._heads(self.k(kv_in)), self._heads(self.v(kv_in))

    def attend(self, q_in, k, v, *, kv_lengths: torch.Tensor, causal: bool = False,
               deterministic: bool = True, q: Optional[torch.Tensor] = None):
        """Attention against [B,S,H,D] keys/values (key j of row b kept iff
        j < kv_lengths[b], and j <= t when causal), then the out projection."""
        if q is None:
            q = self.project_q(q_in)
        out = interface.flash_attention(q, k, v, kv_lengths=kv_lengths, causal=causal,
                                        dropout_rate=self.dropout_rate,
                                        deterministic=deterministic)
        return self.out(out.flatten(-2))

    def attend_bhsd(self, q_in: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
        """Cross-attention against a head-major [B,H,S,D] cache."""
        q = self.project_q(q_in)                              # [B,T,H,D]
        qb = q.transpose(1, 2)                                # [B,H,T,D]
        scores = torch.einsum("bhtd,bhsd->bhts", qb.float(), k.float())
        scores = scores / math.sqrt(q.shape[-1])
        if bias is not None:
            scores = scores + bias.float()
        weights = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhts,bhsd->bhtd", weights, v)
        return self.out(out.transpose(1, 2).flatten(-2))

    def forward(self, q_in, kv_in, *, kv_lengths: torch.Tensor, causal: bool = False,
                deterministic: bool = True):
        if self.fused_qkv and q_in is kv_in:
            q, k, v = self.project_qkv(q_in)
        else:
            q, (k, v) = None, self.project_kv(kv_in)
        return self.attend(q_in, k, v, kv_lengths=kv_lengths, causal=causal,
                           deterministic=deterministic, q=q)


class FeedForward(nn.Module):
    """Linear → ReLU → dropout → Linear."""

    def __init__(self, d_model: int, d_ff: int, dropout_rate: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(d_model, d_ff)
        self.fc2 = nn.Linear(d_ff, d_model)
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(F.relu(self.fc1(x)), self.dropout_rate,
                    deterministic=deterministic, generator=generator)
        return self.fc2(h)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with the JAX package's epsilon (flax's 1e-6, not torch's
    1e-5)."""

    def __init__(self, d_model: int):
        super().__init__(d_model, eps=1e-6)
