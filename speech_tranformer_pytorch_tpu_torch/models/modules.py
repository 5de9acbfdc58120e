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
cross-attention cache head-major [B, H, S, D]. With attention dropout
active, ``interface.flash_attention`` sends attention to
``dot_product_attention`` instead, as JAX routes it.

Given a ``parallel.mesh.Mesh``, attention and the feed-forward are
Megatron tensor-parallel over its ``model`` axis (``parallel/tp.py``):
each rank holds H/tp heads and d_ff/tp hidden columns, takes the
replicated input through column-parallel projections and sums the
row-parallel output projections' partial results over the model ranks
before the replicated bias. With ``ring`` (``model.attention_impl='ring'``
under a mesh) encoder self-attention runs ring attention over the model
axis (``parallel/ring_attention.py``). Without a mesh every module is the
single-device one.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..kernels import interface
from ..ops.dropout import dropout, dropout_quantized
from ..parallel.tp import column_linear, dropout_shard, row_linear


def sinusoidal_position_encoding(max_len: int, d_model: int) -> np.ndarray:
    """[max_len, d_model] fixed sinusoidal table (Vaswani et al., 2017)."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term[: (d_model + 1) // 2])
    return pe.astype(np.float32)


def whisper_sinusoids(max_len: int, d_model: int) -> np.ndarray:
    """[max_len, d_model] Whisper's encoder table (``whisper/model.py``
    ``sinusoids``): sines then cosines, concatenated, of timescales
    exp(-log(10^4) i / (d/2 - 1)), i < d/2."""
    inc = math.log(10000.0) / (d_model // 2 - 1)
    scaled = (np.arange(max_len, dtype=np.float64)[:, None]
              * np.exp(-inc * np.arange(d_model // 2, dtype=np.float64))[None, :])
    return np.concatenate([np.sin(scaled), np.cos(scaled)], 1).astype(np.float32)


class PositionalEncoding(nn.Module):
    """Adds position rows: a fixed table, ``kind`` "sinusoidal" (Vaswani's)
    or "whisper" (``whisper_sinusoids``), a non-persistent buffer; or
    "learned", a parameter (Whisper's decoder). Either is ``pe``."""

    def __init__(self, d_model: int, max_len: int, dropout_rate: float = 0.0,
                 kind: str = "sinusoidal"):
        super().__init__()
        self.max_len = max_len
        self.dropout_rate = dropout_rate
        if kind == "learned":
            self.pe = nn.Parameter(torch.zeros(max_len, d_model))
        else:
            table = (whisper_sinusoids if kind == "whisper"
                     else sinusoidal_position_encoding)(max_len, d_model)
            self.register_buffer("pe", torch.from_numpy(table), persistent=False)

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


def stem_lengths(frame_lens: torch.Tensor, stem: str) -> torch.Tensor:
    """Encoder frames of ``frame_lens`` feature frames through ``stem``
    (``model.stem``): the conv2d subsampler's, or Whisper's Conv1d stem,
    whose stride-2 convolution pads by one: (L - 1) // 2 + 1."""
    if stem == "conv1d_gelu":
        return torch.div(frame_lens + 1, 2, rounding_mode="floor")
    return subsampled_lengths(frame_lens)


class Conv1dStem(nn.Module):
    """Whisper's audio stem (``AudioEncoder``): [B, T, n_mels] ->
    [B, T // 2, d_model] by Conv1d(k 3, pad 1) → GELU → Conv1d(k 3,
    stride 2, pad 1) → GELU over time."""

    def __init__(self, input_dim: int, d_model: int):
        super().__init__()
        self.conv1 = nn.Conv1d(input_dim, d_model, 3, padding=1)
        self.conv2 = nn.Conv1d(d_model, d_model, 3, stride=2, padding=1)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats.to(self.conv1.weight.dtype).transpose(1, 2)    # [B,F,T]
        x = F.gelu(self.conv2(F.gelu(self.conv1(x))))
        return x.transpose(1, 2)


class Conv2dSubsampling(nn.Module):
    """[B,T,F] fbank -> [B,T//4,d_model]: two 3×3/stride-2 VALID convs with
    ReLU over (time, freq), then a linear projection of the flattened
    (freq, channel) axes — the JAX package's NHWC flatten order.

    It serves every ``model.subsample_impl``. The JAX package's ``'im2col'``
    (``_PatchConv``: strided patches and one matmul) and ``'phase'``
    (``_PhaseConv`` for the second conv: even/odd phases and one matmul)
    were TPU layout experiments that compute this conv's function on the
    same ``Conv_0``/``Conv_1`` parameters, so their checkpoints load here
    unchanged and give the same outputs up to summation order."""

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


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor], *, dropout_rate: float = 0.0,
                          deterministic: bool = True,
                          generator: Optional[torch.Generator] = None,
                          dropout_shard=None) -> torch.Tensor:
    """[B, T, H, D] x [B, S, H, D] -> [B, T, H, D]: the JAX package's jnp
    attention (``models/modules.py:383-412``). Scores in f32 over
    1/sqrt(D), plus the additive ``bias`` (broadcastable to [B, H, T, S]),
    an f32 softmax, u8 dropout of the weights (``dropout_quantized``) when
    training, a cast to v's dtype, then the product with V. ``dropout_shard``:
    the heads are a tensor-parallel rank's (``ops/dropout``'s ``shard``).

    JAX's ``bf16_weights`` route (its bf16-residual backward) is taken only
    when no dropout is active; the port sends every such call to the flash
    kernels, so this core never needs it."""
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    scores = scores / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias.float()
    weights = torch.softmax(scores, dim=-1)
    if not deterministic and dropout_rate > 0.0:
        weights = dropout_quantized(weights, dropout_rate, generator, dropout_shard)
    return torch.einsum("bhts,bshd->bthd", weights.to(v.dtype), v)


class MultiHeadAttention(nn.Module):
    """Self/cross attention with ragged key lengths. ``fused_qkv``
    (self-attention only) projects q, k and v with one [d, 3·d] matmul.
    ``remat`` (``model.attention_remat``) checkpoints the dot core that
    attention dropout routes to; on the flash route it changes nothing,
    as the flash backward already recomputes from the log-sum-exp.

    With a ``mesh`` the module holds its model rank's H/tp heads
    (``num_heads`` counts them): q/k/v weights (and the fused ``qkv``'s
    weight and bias) by head, the output projection by input head; q/k/v
    biases stay whole, as the JAX rules keep them. ``ring`` sends
    self-attention through ring attention over the model axis."""

    def __init__(self, d_model: int, num_heads: int, fused_qkv: bool = False,
                 dropout_rate: float = 0.0, remat: bool = False, mesh=None,
                 ring: bool = False):
        super().__init__()
        self.mesh = mesh
        self.ring = ring
        self.num_heads = num_heads // (1 if mesh is None else mesh.tp)
        self.dropout_rate = dropout_rate
        self.remat = remat
        self.head_dim = d_model // num_heads
        self.fused_qkv = fused_qkv
        width = self.num_heads * self.head_dim
        if fused_qkv:
            self.qkv = nn.Linear(d_model, 3 * width)
        else:
            self.q = nn.Linear(d_model, width)
            self.k = nn.Linear(d_model, width)
            self.v = nn.Linear(d_model, width)
            if mesh is not None:       # whole biases; each rank adds its heads'
                for lin in (self.q, self.k, self.v):
                    lin.bias = nn.Parameter(torch.zeros(d_model))
        self.out = nn.Linear(width, d_model)

    def _heads(self, y: torch.Tensor) -> torch.Tensor:
        return y.unflatten(-1, (self.num_heads, self.head_dim))

    def _proj(self, linear: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return self._heads(column_linear(linear, x, self.mesh))

    def project_qkv(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """q, k, v [..., H, D] of a single input."""
        if self.fused_qkv:
            qkv = column_linear(self.qkv, x, self.mesh, bias_replicated=False)
            return qkv.unflatten(-1, (3, self.num_heads, self.head_dim)).unbind(-3)
        return self._proj(self.q, x), self._proj(self.k, x), self._proj(self.v, x)

    def project_q(self, x: torch.Tensor) -> torch.Tensor:
        return self.project_qkv(x)[0] if self.fused_qkv else self._proj(self.q, x)

    def project_kv(self, kv_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.fused_qkv:
            _, k, v = self.project_qkv(kv_in)
            return k, v
        return self._proj(self.k, kv_in), self._proj(self.v, kv_in)

    def project_out(self, y: torch.Tensor) -> torch.Tensor:
        """[..., H, D] -> [..., d_model]: the output projection, summed over
        the model ranks."""
        return row_linear(self.out, y.flatten(-2), self.mesh)

    def attend(self, q_in, k, v, *, kv_lengths: torch.Tensor, causal: bool = False,
               deterministic: bool = True, q: Optional[torch.Tensor] = None,
               q_lengths: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """Attention against [B,S,H,D] keys/values (key j of row b kept iff
        j < kv_lengths[b], and j <= t when causal), then the out projection.
        ``q_lengths`` (self-attention) also masks query rows on the dropout
        route, as JAX's self-attention bias does; ``generator`` draws the
        attention-dropout bits."""
        if q is None:
            q = self.project_q(q_in)
        if self.ring:
            from ..parallel.ring_attention import ring_self_attention

            if causal:
                raise ValueError("ring attention is non-causal self-attention only")
            out = ring_self_attention(q, k, v, kv_lengths, self.mesh)
        else:
            out = interface.flash_attention(q, k, v, kv_lengths=kv_lengths,
                                            causal=causal, q_lengths=q_lengths,
                                            dropout_rate=self.dropout_rate,
                                            deterministic=deterministic,
                                            generator=generator, remat=self.remat,
                                            dropout_shard=dropout_shard(self.mesh, 1))
        return self.project_out(out)

    def attend_bhsd(self, q_in: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mem_lens: torch.Tensor) -> torch.Tensor:
        """A decode step's cross-attention: the rows of ``q_in`` [B·K, 1, d]
        (K beams an utterance) against a head-major [B,H,S,D] cache in the
        compute dtype, over the frames before ``mem_lens`` [B], then the
        out projection. Between the two projections is
        ``interface.cross_attention_decode``: one kernel launch on the card,
        the plain einsum route on the CPU (float32 scores of the
        compute-dtype values, weights rounded to that dtype before P·V)."""
        q = self.project_q(q_in)                              # [B·K,1,H,D]
        return self.project_out(interface.cross_attention_decode(q, k, v, mem_lens))

    def forward(self, q_in, kv_in, *, kv_lengths: torch.Tensor, causal: bool = False,
                deterministic: bool = True, q_lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        if self.fused_qkv and q_in is kv_in:
            q, k, v = self.project_qkv(q_in)
        else:
            q, (k, v) = None, self.project_kv(kv_in)
        return self.attend(q_in, k, v, kv_lengths=kv_lengths, causal=causal,
                           deterministic=deterministic, q=q, q_lengths=q_lengths,
                           generator=generator)


class Int8Linear(nn.Module):
    """An int8-weight dense layer for serving: the counterpart of the int8
    branch of the JAX ``QuantDenseGeneral`` (``models/modules.py:285-306``)
    at the kernel path, which the port takes for every size.

    Holds the int8 kernel in the JAX kernel layout [in, out], an f32 scale
    per output column, and the bias in the compute dtype. ``forward`` runs
    ``interface.int8_dense`` (f32 accumulate, f32 scale), casts the result
    to the compute dtype and then adds the bias in that dtype, as JAX does.
    ``bias_f32`` is the same bias in f32 for the fused int8 feed-forward."""

    def __init__(self, weight_q: torch.Tensor, scale: Optional[torch.Tensor],
                 bias: Optional[torch.Tensor], dtype: torch.dtype):
        super().__init__()
        if scale is None:
            raise ValueError("an int8 weight needs its per-column scale "
                             "(ops.quantize.quantize_params makes both)")
        out_features = weight_q.shape[0]
        if weight_q.dtype != torch.int8 or tuple(scale.shape) != (out_features,):
            raise ValueError(f"int8 [out, in] weight and f32 [out] scale expected, "
                             f"got {weight_q.dtype} {tuple(weight_q.shape)} and "
                             f"{tuple(scale.shape)}")
        self.dtype = dtype
        self.register_buffer("weight_q", weight_q.t().contiguous())     # [in, out]
        self.register_buffer("scale", scale.float().contiguous())
        if bias is None:
            self.bias = self.bias_f32 = None
        else:
            self.register_buffer("bias", bias.to(dtype))
            self.register_buffer("bias_f32", self.bias.float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, n = self.weight_q.shape
        out = interface.int8_dense(x.reshape(-1, k), self.weight_q, self.scale)
        out = out.to(self.dtype).reshape(x.shape[:-1] + (n,))
        return out if self.bias is None else out + self.bias


class Int8Embedding(nn.Module):
    """Per-row int8 embedding (``quantize_params(embedding_rows=True)``):
    the token gather dequantizes its rows as ``q.to(dt) * s.to(dt)``, and
    ``table()`` is the whole [V, d] table in the compute dtype for the
    tied output projection (JAX ``decoder.py:284-319``)."""

    def __init__(self, weight_q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype):
        super().__init__()
        if weight_q.dtype != torch.int8 or tuple(scale.shape) != (weight_q.shape[0],):
            raise ValueError("int8 [V, d] table and f32 [V] row scale expected")
        self.dtype = dtype
        self.register_buffer("weight_q", weight_q.contiguous())
        self.register_buffer("scale", scale.float().contiguous())

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        rows = self.weight_q[tokens].to(self.dtype)
        return rows * self.scale[tokens][..., None].to(self.dtype)

    def table(self) -> torch.Tensor:
        return self.weight_q.to(self.dtype) * self.scale[:, None].to(self.dtype)


class FeedForward(nn.Module):
    """Linear → activation → dropout → Linear; the activation is ReLU (the
    Speech-Transformer's) or ``activation`` (the Conformer's Swish,
    ``F.silu``). With both layers int8 (``Int8Linear``, ReLU only), one
    fused ``interface.int8_ffn`` launch. With a ``mesh`` the rank holds
    d_ff/tp hidden columns (fc1 by rows, fc2 by columns; fc1's bias whole,
    as the JAX rules keep it)."""

    def __init__(self, d_model: int, d_ff: int, dropout_rate: float = 0.0, mesh=None,
                 activation=F.relu):
        super().__init__()
        self.mesh = mesh
        self.activation = activation
        hidden = d_ff // (1 if mesh is None else mesh.tp)
        self.fc1 = nn.Linear(d_model, hidden)
        self.fc2 = nn.Linear(hidden, d_model)
        if mesh is not None:
            self.fc1.bias = nn.Parameter(torch.zeros(d_ff))
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        int8 = [isinstance(fc, Int8Linear) for fc in (self.fc1, self.fc2)]
        if any(int8):
            return self._int8(x, int8)
        h = dropout(self.activation(column_linear(self.fc1, x, self.mesh)), self.dropout_rate,
                    deterministic=deterministic, generator=generator,
                    shard=dropout_shard(self.mesh, -1))
        return row_linear(self.fc2, h, self.mesh)

    def _int8(self, x: torch.Tensor, int8) -> torch.Tensor:
        """The int8 branch (JAX ``modules.py:600-627``): serving only, so no
        dropout; biases enter the kernel in f32, the result is cast to the
        compute dtype."""
        fc1, fc2 = self.fc1, self.fc2
        if self.activation is not F.relu:
            raise ValueError("the int8 feed-forward kernel computes ReLU only")
        if not all(int8) or fc1.bias is None or fc2.bias is None:
            raise ValueError("the int8 feed-forward needs both layers int8 with "
                             "their scales and biases (ops.quantize.decode_model)")
        k, n = fc1.weight_q.shape[0], fc2.weight_q.shape[1]
        out = interface.int8_ffn(x.reshape(-1, k), fc1.weight_q, fc1.scale, fc1.bias_f32,
                                 fc2.weight_q, fc2.scale, fc2.bias_f32)
        return out.to(fc2.dtype).reshape(x.shape[:-1] + (n,))


class LayerNorm(nn.LayerNorm):
    """LayerNorm with the JAX package's epsilon (flax's 1e-6, not torch's
    1e-5) unless given one (``model.layer_norm_eps``)."""

    def __init__(self, d_model: int, eps: float = 1e-6):
        super().__init__(d_model, eps=eps)


ACTIVATIONS = {"relu": F.relu, "gelu": F.gelu}   # ``model.activation``
