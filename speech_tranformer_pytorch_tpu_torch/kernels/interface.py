"""The one dispatch point for the port's kernels.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
PyTorch version of the same function. There is no fallback: a kernel that
fails to build or launch raises. Each kernel wrapper counts its launches;
``launch_counts`` reads them and ``reset_launch_counts`` zeroes them.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import beam_prune, lineage_attention as lineage, stft_mel

_WRAPPERS = {
    "stft_mel": stft_mel.log_mel_cuda,
    "beam_prune": beam_prune.candidate_topk_cuda,
    "lineage_attention": lineage.lineage_attention_cuda,
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


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
