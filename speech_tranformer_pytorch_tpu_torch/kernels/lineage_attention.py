"""One-query beam self-attention over the unpermuted KV cache.

Replaces the TPU kernel ``_kernel`` / ``lineage_attention``
(speech_tranformer_pytorch_tpu/kernels/lineage_attention.py:43, :86). On
Hopper it is the decode self-attention kernel of every beam step and layer.
The kernel is ``csrc/lineage_attention.cu``; its header says what bounds it
on an H100 (bytes: one read of the cache entries the beams select) and how
it reads the cache in its native [B·K, L, H, D] layout without a gather.
"""

from __future__ import annotations

import math

import torch

from ..ops.masks import NEG_INF
from . import _build


def lineage_attention_reference(
    q_new: torch.Tensor,       # [B·K, 1, H, D] current-token queries
    self_k: torch.Tensor,      # [B·K, L, H, D] unpermuted cache (incl. index)
    self_v: torch.Tensor,      # [B·K, L, H, D]
    lineage: torch.Tensor,     # [B, K, L] int32: lane of beam k's step-j entry
    index: int,                # current position
    beam_width: int,
) -> torch.Tensor:
    """Plain version: the one-hot einsum formulation. Scores and softmax in
    f32; weights rounded to the cache dtype before the AV product."""
    bk, L, h, d = self_k.shape
    c = beam_width
    b = bk // c
    q = q_new.reshape(b, c, h, d).float()
    kc = self_k.reshape(b, c, L, h, d).float()
    vc = self_v.reshape(b, c, L, h, d)
    scores_all = torch.einsum("bkhd,bcjhd->bkcjh", q, kc) / math.sqrt(d)
    lanes = torch.arange(c, dtype=lineage.dtype, device=lineage.device)
    onehot = (lineage[:, :, :, None] == lanes).float()        # [B,K,L,C]
    scores = torch.einsum("bkcjh,bkjc->bkjh", scores_all, onehot)
    pos_ok = torch.arange(L, device=scores.device) <= index
    scores = torch.where(pos_ok[None, None, :, None], scores,
                         torch.full((), NEG_INF, device=scores.device))
    weights = torch.softmax(scores, dim=2)
    w_sel = (weights.to(vc.dtype)[:, :, None, :, :]
             * onehot.permute(0, 1, 3, 2)[..., None].to(vc.dtype))
    out = torch.einsum("bkcjh,bcjhd->bkhd", w_sel.float(), vc.float())
    return out.to(vc.dtype).reshape(bk, 1, h, d)


def lineage_attention_cuda(q_new, self_k, self_v, lineage, index: int,
                           beam_width: int) -> torch.Tensor:
    """Kernel wrapper: same contract as ``lineage_attention_reference`` for
    CUDA tensors in float32 or bfloat16."""
    if self_k.device.type != "cuda":
        raise ValueError("lineage_attention_cuda needs CUDA tensors")
    bk, L, h, d = self_k.shape
    b = bk // beam_width
    dt = self_k.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cache dtype {dt} not in (float32, bfloat16)")
    if (q_new.shape != (bk, 1, h, d) or self_v.shape != self_k.shape
            or q_new.dtype != dt or self_v.dtype != dt):
        raise ValueError("q_new [B·K,1,H,D] and self_v must match the cache")
    if tuple(lineage.shape) != (b, beam_width, L) or b * beam_width != bk:
        raise ValueError(f"lineage {tuple(lineage.shape)} does not match "
                         f"[B={b}, K={beam_width}, L={L}]")
    if not 0 <= index < L or d > 256:
        raise ValueError(f"index {index} outside [0, {L}) or head_dim {d} > 256")
    q_new, self_k, self_v = (t.contiguous() for t in (q_new, self_k, self_v))
    lineage = lineage.to(torch.int32).contiguous()
    out = torch.empty_like(q_new)
    lib = _build.library()
    _build.check(lib.st_lineage_attention(
        q_new.data_ptr(), self_k.data_ptr(), self_v.data_ptr(),
        lineage.data_ptr(), out.data_ptr(), b, beam_width, L, h, d, int(index),
        int(dt == torch.bfloat16), _build.stream_ptr(self_k.device)),
        "st_lineage_attention")
    lineage_attention_cuda.launches += 1
    return out


lineage_attention_cuda.launches = 0
