"""One-query beam self-attention over the unpermuted KV cache.

Replaces the TPU kernel ``_kernel`` / ``lineage_attention``
(speech_tranformer_pytorch_tpu/kernels/lineage_attention.py:43, :86). On
Hopper it is the decode self-attention kernel of every beam step and layer
(and of every greedy step, at K = 1). The kernel is
``csrc/lineage_attention.cu``. What bounds it on an H100 is the bytes (one
read of the cache entries the beams select); the kernel sits above that,
latency-bound. Its design: one block per (beam row, head) reading the cache
in its native [B·K, L, H, D] layout, 16 bytes a lane (eight lanes a D = 64
bf16 row), every K and V row of a batch of positions issued before any is
used, so the decode shapes take two dependent memory round trips; scores
and the softmax in f32, the weights rounded to the cache dtype after
normalisation, and a fixed summation order (bit-identical run to run).

The decode step calls its write-and-attend form
(``lineage_attention_step_cuda``): each block also stores the step's new
K and V rows into the cache at the index, taking q, k_new and v_new
straight from the projection's output views, so the step needs no index
write, no int64 index and no copy of q. The attend-only form
(``lineage_attention_cuda``) is the ``st_port::lineage_attention`` op's,
which ``torch.export`` traces with functional index writes beside it.
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
    index: torch.Tensor,       # current position: a 0-d int32 tensor
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


def lineage_attention_step_reference(q_new, k_new, v_new, self_k, self_v, lineage,
                                     index, beam_width: int) -> torch.Tensor:
    """Plain version of the write-and-attend form: the step's rows k_new,
    v_new [B·K, 1, H, D] written into self_k/self_v at ``index`` with
    ``index_copy_``, then ``lineage_attention_reference``."""
    pos = index.reshape(1).long()
    self_k.index_copy_(1, pos, k_new)
    self_v.index_copy_(1, pos, v_new)
    return lineage_attention_reference(q_new, self_k, self_v, lineage, index, beam_width)


def _row_stride(name: str, t: torch.Tensor, shape, dt) -> int:
    """The row stride of a [B·K, 1, H, D] view whose heads lie D apart and
    whose elements are adjacent, which is how the kernel reads q, k_new
    and v_new; anything else is refused."""
    _, _, h, d = shape
    if tuple(t.shape) != tuple(shape) or t.dtype != dt:
        raise ValueError(f"{name} must be {list(shape)} in {dt}, got "
                         f"{list(t.shape)} in {t.dtype}")
    if (h > 1 and t.stride(2) != d) or (d > 1 and t.stride(3) != 1):
        raise ValueError(f"{name}: heads must lie D apart and elements be adjacent, "
                         f"got strides {t.stride()}")
    return t.stride(0)


def _check_cache(self_k, self_v, lineage, beam_width: int):
    """(B, dtype) of a [B·K, L, H, D] cache pair and its [B, K, L] table."""
    bk, L, _, d = self_k.shape
    b = bk // beam_width
    dt = self_k.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cache dtype {dt} not in (float32, bfloat16)")
    if self_v.shape != self_k.shape or self_v.dtype != dt:
        raise ValueError("self_v must match self_k")
    if tuple(lineage.shape) != (b, beam_width, L) or b * beam_width != bk:
        raise ValueError(f"lineage {tuple(lineage.shape)} does not match "
                         f"[B={b}, K={beam_width}, L={L}]")
    if d > 256:
        raise ValueError(f"head_dim {d} > 256")
    return b, dt


def _launch(q_new, q_stride, k_new, k_stride, v_new, v_stride, self_k, self_v, lineage,
            index, beam_width: int) -> torch.Tensor:
    """One launch of the kernel on checked CUDA tensors (``k_new`` None:
    attend-only); returns the contiguous [B·K, 1, H, D] output."""
    bk, L, h, d = self_k.shape
    lineage = lineage.to(torch.int32).contiguous()
    out = self_k.new_empty((bk, 1, h, d))
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.check(_build.library().st_lineage_attention(
        q_new.data_ptr(), q_stride, ptr(k_new), k_stride, ptr(v_new), v_stride,
        self_k.data_ptr(), self_v.data_ptr(), lineage.data_ptr(), out.data_ptr(),
        bk // beam_width, beam_width, L, h, d, _build.index_ptr(index, self_k.device),
        int(self_k.dtype == torch.bfloat16), _build.stream_ptr(self_k.device)),
        "st_lineage_attention")
    lineage_attention_cuda.launches += 1
    return out


def lineage_attention_cuda(q_new, self_k, self_v, lineage, index,
                           beam_width: int) -> torch.Tensor:
    """Kernel wrapper, attend-only: same contract as
    ``lineage_attention_reference`` for CUDA tensors in float32 or
    bfloat16, with ``index`` a 0-d int32 tensor on the cache's device,
    which the kernel reads itself (clamped to [0, L)): no host sync."""
    if self_k.device.type != "cuda":
        raise ValueError("lineage_attention_cuda needs CUDA tensors")
    _, dt = _check_cache(self_k, self_v, lineage, beam_width)
    bk, _, h, d = self_k.shape
    if q_new.shape != (bk, 1, h, d) or q_new.dtype != dt:
        raise ValueError("q_new must be [B·K,1,H,D] in the cache's dtype")
    q_new, self_k, self_v = (t.contiguous() for t in (q_new, self_k, self_v))
    return _launch(q_new, h * d, None, 0, None, 0, self_k, self_v, lineage, index,
                   beam_width)


def lineage_attention_step_cuda(q_new, k_new, v_new, self_k, self_v, lineage, index,
                                beam_width: int) -> torch.Tensor:
    """Kernel wrapper, write-and-attend: same contract as
    ``lineage_attention_step_reference`` (self_k/self_v written in place at
    ``index``) for CUDA tensors in float32 or bfloat16. q_new, k_new and
    v_new are [B·K, 1, H, D] views with any row stride, heads D apart
    (the fused qkv projection's ``unbind`` views are read in place); the
    cache must be contiguous, since it is written. Column ``index`` of the
    table must be the identity, as every beam step keeps it: the kernel
    takes position ``index`` from k_new/v_new."""
    _, dt = _check_cache(self_k, self_v, lineage, beam_width)
    bk, _, h, d = self_k.shape
    strides = [_row_stride(name, t, (bk, 1, h, d), dt)
               for name, t in (("q_new", q_new), ("k_new", k_new), ("v_new", v_new))]
    if not (self_k.is_contiguous() and self_v.is_contiguous()):
        raise ValueError("the self cache is written in place: it must be contiguous")
    dev = self_k.device
    if dev.type != "cuda" or any(t.device != dev for t in (q_new, k_new, v_new, self_v,
                                                           lineage)):
        raise ValueError("lineage_attention_step_cuda needs CUDA tensors on one card")
    return _launch(q_new, strides[0], k_new, strides[1], v_new, strides[2], self_k,
                   self_v, lineage, index, beam_width)


lineage_attention_cuda.launches = 0
