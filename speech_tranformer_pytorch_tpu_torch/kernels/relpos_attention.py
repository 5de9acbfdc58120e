"""Relative-position self-attention of the Conformer encoder.

The JAX package has no Conformer, so no TPU kernel is replaced: on the card
``csrc/relpos_attention.cu`` is everything ``models/conformer.RelPositionAttention``
does between its projections (ESPnet's ``RelPositionMultiHeadedAttention``
with "latest" positions), one launch an encoder layer. For utterance b,
head h, query i and key j of the padded length T::

    s[i, j] = ((q_i + u) · k_j + (q_i + v) · p[T - 1 - i + j]) / √D

softmax over the keys j < lengths[b], then P·V. ``p`` [2T - 1, H, D] holds
the position rows of relative positions T - 1 … -(T - 1), shared by the
batch. Query rows at or past an utterance's length are zero. What bounds it
on an H100 and how the kernel spreads the work is in its header.

The plain version materialises the position term as ESPnet does, [B, H, T,
2T - 1], and reads its shifted diagonal by a gather (ESPnet shifts it by a
pad-and-view, ``rel_shift``; ``portbench/reference/conformer.py`` does
that, so the two check each other). q + u and q + v are rounded to q's
dtype before their products, scores and softmax are float32, the weights
are rounded to v's dtype before P·V, as the kernel does. It is the route
of the CPU and of every call that takes a gradient; there it also drops
attention weights (``ops/dropout.dropout_quantized``) when asked to.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..ops.dropout import dropout_quantized
from . import _build

HEAD_DIMS = (64, 128)   # the kernel's instantiations


def relpos_attention_reference(
    q: torch.Tensor,         # [B, T, H, D]
    k: torch.Tensor,         # [B, T, H, D]
    v: torch.Tensor,         # [B, T, H, D]
    p: torch.Tensor,         # [2T - 1, H, D] position rows
    u: torch.Tensor,         # [H, D] pos_bias_u
    vb: torch.Tensor,        # [H, D] pos_bias_v
    lengths: torch.Tensor,   # [B] valid frames
    *, dropout_rate: float = 0.0, deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Plain version: [B, T, H, D] in v's dtype."""
    b, t, h, d = q.shape
    qu = (q.float() + u.float()).to(q.dtype).float()
    qv = (q.float() + vb.float()).to(q.dtype).float()
    ac = torch.einsum("bihd,bjhd->bhij", qu, k.float())
    bd_full = torch.einsum("bihd,rhd->bhir", qv, p.float())          # [B, H, T, 2T-1]
    pos = torch.arange(t, device=q.device)
    shift = (t - 1 - pos[:, None] + pos[None, :]).expand(b, h, t, t)
    scores = (ac + bd_full.gather(-1, shift)) / math.sqrt(d)
    keep = pos[None, :] < lengths.to(q.device).long()[:, None]       # [B, T]
    scores = scores + torch.where(keep, 0.0, -1e9)[:, None, None, :]
    weights = torch.softmax(scores, dim=-1)
    if not deterministic and dropout_rate > 0.0:
        weights = dropout_quantized(weights, dropout_rate, generator)
    out = torch.einsum("bhij,bjhd->bihd", weights.to(v.dtype), v)
    return torch.where(keep[..., None, None], out, torch.zeros((), dtype=out.dtype,
                                                                device=out.device))


def relpos_attention_cuda(q, k, v, p, u, vb, lengths) -> torch.Tensor:
    """Kernel wrapper: same contract as ``relpos_attention_reference``
    (without dropout) for bf16 CUDA tensors at D 64 or 128, ``lengths``
    int32 on the same card. q, k, v and p may have any strides that keep D
    contiguous and every row on a 16-byte boundary (the views of a fused
    projection); u and vb are contiguous [H, D]."""
    dt = torch.bfloat16
    if any(x.dtype != dt for x in (q, k, v, p, u, vb)):
        raise ValueError(f"relpos_attention_cuda takes bfloat16 q, k, v, p, u, vb, got "
                         f"{[str(x.dtype) for x in (q, k, v, p, u, vb)]}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be one [B, T, H, D] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    if d not in HEAD_DIMS or t < 1 or b < 1:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}, or an empty batch {tuple(q.shape)}")
    if tuple(p.shape) != (2 * t - 1, h, d) or tuple(u.shape) != (h, d) or u.shape != vb.shape:
        raise ValueError(f"p must be [2T-1={2 * t - 1}, H, D] and u, vb [H, D], got "
                         f"{tuple(p.shape)}, {tuple(u.shape)}, {tuple(vb.shape)}")
    if (lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,)
            or not lengths.is_contiguous()):
        raise ValueError(f"lengths must be a contiguous int32 [B={b}], got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("p", p)):
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16:
            raise ValueError(f"{name} must keep D contiguous and rows 16-byte aligned, got "
                             f"strides {x.stride()}")
    if not (u.is_contiguous() and vb.is_contiguous()) or u.data_ptr() % 4 or vb.data_ptr() % 4:
        raise ValueError("u and vb must be contiguous")
    if q.device.type != "cuda" or any(x.device != q.device for x in (k, v, p, u, vb, lengths)):
        raise ValueError("relpos_attention_cuda needs every input on one CUDA device")
    out = torch.empty((b, t, h, d), dtype=dt, device=q.device)
    strides = (ctypes.c_longlong * 11)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *p.stride()[:2])
    _build.check(_build.library().st_relpos_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(), u.data_ptr(), vb.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), strides, b, t, h, d,
        _build.stream_ptr(q.device)), "st_relpos_attention")
    relpos_attention_cuda.launches += 1
    return out


relpos_attention_cuda.launches = 0
