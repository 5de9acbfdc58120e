"""The serving kernels as ``torch.library`` custom ops (namespace ``st_port``).

``torch.export`` and graph compilers cannot see into a ctypes call on
``data_ptr``s, so the serving kernels are
registered here as operators with a fake implementation that gives their
output shapes, dtypes and strides:

  st_port::beam_candidate_topk     B-2, ``kernels/beam_prune.py``
  st_port::lineage_attention       B-3, ``kernels/lineage_attention.py``
  st_port::flash_fwd               B-4, ``kernels/flash_attention.py``
  st_port::cross_attention_decode  the port's own, ``kernels/cross_attention.py``
  st_port::relpos_attention        the port's own, ``kernels/relpos_attention.py``

Each op's CUDA implementation is the hand-written kernel's wrapper (which
counts its launches) and its CPU implementation the plain version; the
tensors' device picks one, as everywhere in ``kernels/interface.py``,
which calls these ops. A serving process that loads an exported program
imports this module alone (``serving.load_exported``): it needs the
operators, not the model code.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from . import beam_prune, cross_attention as cross, flash_attention as flash
from . import lineage_attention as lineage, relpos_attention as relpos

NAMESPACE = "st_port"


# ---------------------------------------------------------------- B-2

@torch.library.custom_op(f"{NAMESPACE}::beam_candidate_topk", mutates_args=(),
                         device_types="cpu")
def beam_candidate_topk(logits: Tensor, alive_scores: Tensor, k2: int, pad_id: int,
                        sos_id: int) -> Tuple[Tensor, Tensor]:
    """(vals [B, k2] f32, idx [B, k2] int32) of one beam step's candidates:
    logits [B·K, V] f32, alive_scores [B, K] f32."""
    vals, idx = beam_prune.candidate_topk_reference(
        logits, alive_scores, k2=k2, pad_id=pad_id, sos_id=sos_id)
    return vals.contiguous(), idx.contiguous()


@beam_candidate_topk.register_kernel("cuda")
def _(logits, alive_scores, k2, pad_id, sos_id):
    return beam_prune.candidate_topk_cuda(logits, alive_scores, k2=k2,
                                          pad_id=pad_id, sos_id=sos_id)


@beam_candidate_topk.register_fake
def _(logits, alive_scores, k2, pad_id, sos_id):
    b = alive_scores.shape[0]
    return (logits.new_empty((b, k2), dtype=torch.float32),
            logits.new_empty((b, k2), dtype=torch.int32))


# ---------------------------------------------------------------- B-3

@torch.library.custom_op(f"{NAMESPACE}::lineage_attention", mutates_args=(),
                         device_types="cpu")
def lineage_attention(q_new: Tensor, self_k: Tensor, self_v: Tensor, lineage_table: Tensor,
                      index: Tensor, beam_width: int) -> Tensor:
    """[B·K, 1, H, D] in q's dtype: q_new [B·K, 1, H, D] against the
    unpermuted cache self_k/self_v [B·K, L, H, D] through lineage_table
    [B, K, L] int32, positions <= index (a 0-d int32 tensor on the cache's
    device: on the CPU it is read on the host, on the card by the kernel)."""
    return lineage.lineage_attention_reference(q_new, self_k, self_v, lineage_table,
                                               index, beam_width).contiguous()


@lineage_attention.register_kernel("cuda")
def _(q_new, self_k, self_v, lineage_table, index, beam_width):
    return lineage.lineage_attention_cuda(q_new, self_k, self_v, lineage_table, index,
                                          beam_width)


@lineage_attention.register_fake
def _(q_new, self_k, self_v, lineage_table, index, beam_width):
    return q_new.new_empty(q_new.shape)


# ----------------------------------------------- decode cross-attention

@torch.library.custom_op(f"{NAMESPACE}::cross_attention_decode", mutates_args=(),
                         device_types="cpu")
def cross_attention_decode(q: Tensor, k: Tensor, v: Tensor, mem_lens: Tensor) -> Tensor:
    """[B·K, 1, H, D] in q's dtype: the step's queries q [B·K, 1, H, D]
    against the cross cache k/v [B, H, S, D], frames < mem_lens[b] [B]."""
    return cross.cross_attention_decode_reference(q, k, v, mem_lens).contiguous()


@cross_attention_decode.register_kernel("cuda")
def _(q, k, v, mem_lens):
    return cross.cross_attention_decode_cuda(q, k, v, mem_lens)


@cross_attention_decode.register_fake
def _(q, k, v, mem_lens):
    return q.new_empty(q.shape)


# ------------------------------------ Conformer relative-position attention

@torch.library.custom_op(f"{NAMESPACE}::relpos_attention", mutates_args=(), device_types="cpu")
def relpos_attention(q: Tensor, k: Tensor, v: Tensor, p: Tensor, u: Tensor, vb: Tensor,
                     lengths: Tensor) -> Tensor:
    """[B, T, H, D] in v's dtype: q, k, v [B, T, H, D] with the position
    rows p [2T - 1, H, D] and biases u, vb [H, D], keys < lengths[b] [B];
    rows past a length zero."""
    return relpos.relpos_attention_reference(q, k, v, p, u, vb, lengths).contiguous()


@relpos_attention.register_kernel("cuda")
def _(q, k, v, p, u, vb, lengths):
    return relpos.relpos_attention_cuda(q, k, v, p, u, vb, lengths)


@relpos_attention.register_fake
def _(q, k, v, p, u, vb, lengths):
    return v.new_empty(q.shape)


# ---------------------------------------------------------------- B-4

def _flash_out(q: Tensor) -> Tensor:
    """An empty o as ``flash_fwd_cuda`` returns it: [B, H, T, D] stored as
    [B, T, H, D8], where D8 is D rounded up to 8 for bf16 (the width of the
    kernel's aligned copy) and D otherwise."""
    b, h, t, d = q.shape
    width = -(-d // 8) * 8 if q.dtype == torch.bfloat16 else d
    return q.new_empty((b, t, h, width)).transpose(1, 2)[..., :d]


@torch.library.custom_op(f"{NAMESPACE}::flash_fwd", mutates_args=(), device_types="cpu")
def flash_fwd(q: Tensor, k: Tensor, v: Tensor, kv_lengths: Tensor,
              causal: bool) -> Tuple[Tensor, Tensor]:
    """(o [B, H, T, D] in q's dtype, lse [B, H, T] f32) of q, k, v [B, H, T, D]
    with key j of row b kept iff j < kv_lengths[b] (and j <= t if causal).

    On the CPU o is ``flash_attention_reference``'s, the plain attention
    that a CPU training step differentiates, so a model computes the same
    bits with and without gradients; lse is the forward kernel's."""
    out = _flash_out(q)
    out.copy_(flash.flash_attention_reference(q, k, v, kv_lengths, causal=causal))
    return out, flash.flash_lse_reference(q, k, kv_lengths, causal=causal).contiguous()


@flash_fwd.register_kernel("cuda")
def _(q, k, v, kv_lengths, causal):
    return flash.flash_fwd_cuda(q, k, v, kv_lengths, causal=causal)


@flash_fwd.register_fake
def _(q, k, v, kv_lengths, causal):
    b, h, t, _ = q.shape
    return _flash_out(q), q.new_empty((b, h, t), dtype=torch.float32)
