"""The one dispatch point for the port's kernels.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
PyTorch version of the same function. There is no fallback: a kernel that
fails to build or launch raises. Each kernel wrapper counts its launches;
``launch_counts`` reads them and ``reset_launch_counts`` zeroes them.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import beam_prune, flash_attention as flash, fused_adam as adam
from . import lineage_attention as lineage, stft_mel

_WRAPPERS = {
    "stft_mel": stft_mel.log_mel_cuda,
    "beam_prune": beam_prune.candidate_topk_cuda,
    "lineage_attention": lineage.lineage_attention_cuda,
    "flash_fwd": flash.flash_fwd_cuda,
    "flash_bwd_dkv": flash.flash_bwd_dkv_cuda,
    "flash_bwd_dq": flash.flash_bwd_dq_cuda,
    "fused_adam": adam.fused_adam_cuda,
}


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def log_mel(waveform: torch.Tensor, cfg, n_frames: int) -> torch.Tensor:
    """[B, S] f32 -> [B, n_frames, M] log-mel (kernels/stft_mel.py)."""
    if _on_cuda(waveform):
        return stft_mel.log_mel_cuda(waveform, cfg, n_frames)
    return stft_mel.log_mel_reference(waveform, cfg, n_frames)


def beam_candidate_topk(logits, alive_scores, *, k2, pad_id=0, sos_id=1):
    """Candidate scoring + top-k2 of one beam step (kernels/beam_prune.py)."""
    fn = (beam_prune.candidate_topk_cuda if _on_cuda(logits)
          else beam_prune.candidate_topk_reference)
    return fn(logits, alive_scores, k2=k2, pad_id=pad_id, sos_id=sos_id)


def lineage_attention(q_new, self_k, self_v, lineage_table, index, beam_width):
    """Beam self-attention over the unpermuted KV cache
    (kernels/lineage_attention.py)."""
    fn = (lineage.lineage_attention_cuda if _on_cuda(self_k)
          else lineage.lineage_attention_reference)
    return fn(q_new, self_k, self_v, lineage_table, index, beam_width)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kv_lengths: torch.Tensor, causal: bool,
                    dropout_rate: float = 0.0,
                    deterministic: bool = True) -> torch.Tensor:
    """[B, T, H, D] x [B, S, H, D] -> [B, T, H, D] attention with ragged key
    lengths (kernels/flash_attention.py): the autograd Function over the
    three kernels for CUDA tensors, the plain version with torch autograd
    for CPU tensors. Attention dropout is not ported."""
    if dropout_rate > 0.0 and not deterministic:
        raise NotImplementedError(
            "attention dropout (model.attention_dropout_rate > 0) is not "
            "ported yet: ROADMAP queue A, 'training slice, left out'")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))     # [B, H, T, D] views
    if _on_cuda(q):
        out = flash.FlashAttention.apply(qt, kt, vt, kv_lengths, causal)
    else:
        out = flash.flash_attention_reference(qt, kt, vt, kv_lengths, causal=causal)
    return out.transpose(1, 2)


def flash_fwd(q, k, v, kv_lengths, *, causal: bool):
    """(o, lse) of [B, H, T, D] inputs (the forward kernel, B-4)."""
    fn = flash.flash_fwd_cuda if _on_cuda(q) else flash.flash_fwd_reference
    return fn(q, k, v, kv_lengths, causal=causal)


def flash_bwd_dkv(q, k, v, do, lse, di, kv_lengths, *, causal: bool):
    """(dk, dv) recomputed from lse (the dK/dV kernel, B-5)."""
    fn = flash.flash_bwd_dkv_cuda if _on_cuda(q) else flash.flash_bwd_dkv_reference
    return fn(q, k, v, do, lse, di, kv_lengths, causal=causal)


def flash_bwd_dq(q, k, v, do, lse, di, kv_lengths, *, causal: bool):
    """dq recomputed from lse (the dQ kernel, B-6)."""
    fn = flash.flash_bwd_dq_cuda if _on_cuda(q) else flash.flash_bwd_dq_reference
    return fn(q, k, v, do, lse, di, kv_lengths, causal=causal)


def fused_adam(params: List[torch.Tensor], grads: List[torch.Tensor],
               mus: List[torch.Tensor], nus: List[torch.Tensor],
               scalars: torch.Tensor, *, b1: float, b2: float, eps: float,
               weight_decay: float) -> None:
    """In-place clip-scaled Adam over every leaf (kernels/fused_adam.py):
    one kernel launch for CUDA tensors, the plain loop for CPU tensors."""
    fn = adam.fused_adam_cuda if _on_cuda(params[0]) else adam.adam_update_reference
    fn(params, grads, mus, nus, scalars, b1=b1, b2=b2, eps=eps,
       weight_decay=weight_decay)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
