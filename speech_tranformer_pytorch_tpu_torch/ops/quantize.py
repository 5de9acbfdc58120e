"""Weights-only int8 post-training quantization for serving (counterpart of
the JAX package's ``ops/quantize.py``).

Scheme: symmetric, ``w ≈ round(w / s) * s`` with ``s = max|w| / 127``
(1 where a group is all zero) and round half to even. The scale groups
follow the JAX kernel layout, not ``nn.Linear``'s: ``s`` is reduced over
every axis of the JAX kernel but its LAST one. So the fused self-attention
``qkv`` kernel [d, 3, H, Dh] and the cross ``q/k/v`` kernels [d, H, Dh]
get one scale per Dh channel, shared across q/k/v and heads; ``out``
[H, Dh, d] one per d; feed-forward and subsampling dense kernels one per
output; convolutions (HWIO) one per Cout. With ``embedding_rows`` the
decoder embedding is quantized too, one scale per row [V].

Leaves that stay float: ndim < 2 (LayerNorm, conv biases), every bias
(including the multi-dimensional ones of the JAX tree), and the embedding
unless ``embedding_rows`` is set.

Layouts here are the port's ``state_dict``: the int8 tensor keeps the
float leaf's shape, and its output channels are dim 0 in every case
(Linear [out, in], Conv2d OIHW, Embedding rows [V, d]), so each scale is
stored expanded to one f32 value per output column or row: a vector the
length of dim 0 (JAX's ``scale_cols``, ``models/modules.py:298-300``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import ModelConfig
from ..convert import _entries

StateDict = Dict[str, torch.Tensor]
EMBED = "decoder.embed.weight"


def _jax_kernel(w: torch.Tensor, kind, shape) -> torch.Tensor:
    """A port weight viewed in its JAX kernel layout."""
    if kind[0] == "dense":
        return w.t().reshape(shape)
    return w.permute(2, 3, 1, 0)                     # OIHW -> HWIO


def _quantize(w: torch.Tensor, axes) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 values and the broadcastable f32 scale, JAX's arithmetic."""
    w = w.float()
    s = torch.amax(w.abs(), dim=axes, keepdim=True) / 127.0
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return q, s


def quantize_params(params: StateDict, cfg: ModelConfig, *,
                    embedding_rows: bool = False) -> Tuple[StateDict, StateDict]:
    """f32 ``state_dict`` -> ``(qparams, scales)``. ``qparams`` has every
    key of ``params``: int8 tensors (same shape) for the quantized leaves,
    the float leaf itself for the rest. ``scales`` maps each quantized key
    to its f32 per-output-column vector [shape[0]]. The Conformer
    (``model.encoder='conformer'``) has no int8 serving path."""
    if cfg.encoder == "conformer":
        raise ValueError("model.encoder='conformer' has no int8 serving path: turn "
                         "decode.int8_weights off")
    qparams, scales = dict(params), {}
    for name, _, kind, shape, _ in _entries(cfg):
        w = params[name]
        if name == EMBED and embedding_rows:
            q, s = _quantize(w, (1,))                 # one scale per row
        elif kind[0] in ("dense", "conv"):
            wj = _jax_kernel(w, kind, shape)
            qj, s = _quantize(wj, tuple(range(wj.dim() - 1)))
            s = s.expand(wj.shape)
            if kind[0] == "dense":
                q = qj.reshape(w.shape[1], w.shape[0]).t()
                s = s.reshape(w.shape[1], w.shape[0])[0]
            else:
                q = qj.permute(3, 2, 0, 1)
                s = s[0, 0, 0]
        else:
            continue
        qparams[name] = q.contiguous()
        scales[name] = s.reshape(-1).contiguous()
    return qparams, scales


def _expand(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return s.reshape((-1,) + (1,) * (like.dim() - 1))


def dequantize_params(qparams: StateDict, scales: StateDict,
                      dtype: torch.dtype = torch.bfloat16) -> StateDict:
    """int8 leaves become ``q.to(dtype) * s.to(dtype)`` (the scale rounded
    to ``dtype`` first, as JAX's ``dequantize_params``); float leaves pass
    through unchanged."""
    out = dict(qparams)
    for name, s in scales.items():
        q = qparams[name]
        out[name] = q.to(dtype) * _expand(s, q).to(dtype)
    return out


def max_abs_error(params: StateDict, qparams: StateDict, scales: StateDict) -> float:
    """Largest |w - dequant(w)| over the quantized leaves (<= s/2 per
    channel by construction)."""
    deq = dequantize_params(qparams, scales, torch.float32)
    return max((float((params[n].float() - deq[n]).abs().max()) for n in scales),
               default=0.0)


def decode_model(cfg: ModelConfig, qparams: StateDict, scales: StateDict,
                 dtype: torch.dtype):
    """The int8 serving model (counterpart of JAX ``decode_variables``):
    the encoder, run once a batch, is dequantized here to
    ``q.to(dtype) * s.to(dtype)``; every other float leaf is cast to
    ``dtype``; the decoder's int8 leaves stay int8 with their f32 scales
    (``Decoder.use_int8``), read every decode step by the int8 kernels.
    Built on the CPU; move it with ``.to(device)`` (no dtype: the scales
    stay f32)."""
    from ..models import SpeechTransformer

    enc = {n: s for n, s in scales.items() if n.startswith("encoder.")}
    dec = [n for n in scales if n not in enc]
    state = dequantize_params({n: t for n, t in qparams.items() if n not in dec},
                              enc, dtype)
    model = SpeechTransformer(cfg)
    missing, unexpected = model.load_state_dict(state, strict=False)
    if sorted(missing) != sorted(dec) or unexpected:
        raise ValueError(f"state does not fit the model: missing {missing}, "
                         f"unexpected {unexpected}")
    model.to(dtype)
    model.decoder.use_int8({n[len("decoder."):]: (qparams[n], scales[n]) for n in dec})
    return model
