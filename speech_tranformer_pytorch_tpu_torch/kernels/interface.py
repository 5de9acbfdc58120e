"""The one dispatch point for the port's kernels.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
PyTorch version of the same function. There is no fallback: a kernel that
fails to build or launch raises. Each kernel wrapper counts its launches;
``launch_counts`` reads them and ``reset_launch_counts`` zeroes them.
Beside them ``decode_step_counts`` counts how decode steps were issued:
CUDA graphs captured and replayed (``decoding/beam_graph.py``), and steps
run eagerly (``decoding/beam.decode_loop``), and likewise how each served
call's prologue (features, encoder, caches) ran on the graph path, and
``row_write_counts`` counts the decode step's self-K/V row writes (one a
layer and step) by route: ``kernel``, inside the lineage kernel's
write-and-attend form, or ``index_copy``, the plain writes of the CPU and
of ``use_lineage=False``. A captured graph's launches and row writes are
taken back after its capture and credited at each replay
(``credit_launches``, ``credit_row_writes``), so the counts stay the work
the port ran.

The serving kernels (beam prune, lineage attention, decode
cross-attention, the flash forward, the Conformer's relative-position
attention) are reached through their
``torch.library`` custom ops
(``kernels/custom_ops.py``), whose CUDA and CPU implementations are that
same pair, so that ``torch.export`` traces through them. The decode step's
write-and-attend lineage call (``lineage_attention_step``) writes the cache
and is called directly; an exported step takes the attend-only op.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..ops import masks
from . import beam_prune, cross_attention as cross, ctc_prefix, custom_ops
from . import flash_attention as flash
from . import fused_adam as adam
from . import int8_ffn as ffn8, int8_matmul as mm8
from . import lineage_attention as lineage, relpos_attention as relpos, stft_mel

_WRAPPERS = {
    "stft_mel": stft_mel.log_mel_cuda,
    "beam_prune": beam_prune.candidate_topk_cuda,
    "lineage_attention": lineage.lineage_attention_cuda,
    "flash_fwd": flash.flash_fwd_cuda,
    "flash_bwd_dkv": flash.flash_bwd_dkv_cuda,
    "flash_bwd_dq": flash.flash_bwd_dq_cuda,
    "fused_adam": adam.fused_adam_cuda,
    "fused_adam_master": adam.fused_adam_master_cuda,
    "int8_matmul": mm8.int8_matmul_cuda,
    "int8_ffn": ffn8.int8_ffn_cuda,
    "ctc_prefix": ctc_prefix.ctc_prefix_cuda,
    "cross_attention_decode": cross.cross_attention_decode_cuda,
    "relpos_attention": relpos.relpos_attention_cuda,
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
    """Candidate scoring + top-k2 of one beam step (kernels/beam_prune.py),
    the op ``st_port::beam_candidate_topk``."""
    return custom_ops.beam_candidate_topk(logits, alive_scores, k2, pad_id, sos_id)


def lineage_attention(q_new, self_k, self_v, lineage_table, index, beam_width):
    """Beam self-attention over the unpermuted KV cache
    (kernels/lineage_attention.py), the op ``st_port::lineage_attention``.
    ``index`` is the step's 0-d int32 tensor on the cache's device."""
    return custom_ops.lineage_attention(q_new, self_k, self_v, lineage_table, index,
                                        int(beam_width))


def lineage_attention_step(q_new, k_new, v_new, self_k, self_v, lineage_table, index,
                           beam_width):
    """The decode step's self-attention with its own K/V row write
    (kernels/lineage_attention.py, write-and-attend): k_new and v_new
    [B·K, 1, H, D] are written into the unpermuted cache self_k/self_v at
    ``index`` (a 0-d int32 tensor on the cache's device), then q_new
    attends through the lineage table. A CUDA tensor goes to the kernel,
    which writes the rows itself and reads q, k_new and v_new in place
    (any row stride); a CPU tensor to the plain version (``index_copy_``,
    then the plain attention). Counts one row write of its route. Not an
    op: it writes the cache, which ``torch.export``'s traced loop may not
    (that loop takes ``lineage_attention`` with functional writes)."""
    if _on_cuda(self_k):
        count_row_writes("kernel")
        return lineage.lineage_attention_step_cuda(q_new, k_new, v_new, self_k, self_v,
                                                   lineage_table, index, int(beam_width))
    count_row_writes("index_copy")
    return lineage.lineage_attention_step_reference(q_new, k_new, v_new, self_k, self_v,
                                                    lineage_table, index, int(beam_width))


def cross_attention_decode(q, k, v, mem_lens):
    """One decode step's cross-attention (kernels/cross_attention.py), the op
    ``st_port::cross_attention_decode``: the queries [B·K, 1, H, D] of K
    beams an utterance against its cross K/V [B, H, S, D], over the frames
    before ``mem_lens`` [B] (int32 on the card). Returns [B·K, 1, H, D]."""
    return custom_ops.cross_attention_decode(q, k, v, mem_lens)


def relpos_attention(q, k, v, p, u, vb, lengths, *, dropout_rate: float = 0.0,
                     deterministic: bool = True,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The Conformer's relative-position self-attention
    (kernels/relpos_attention.py): q, k, v [B, T, H, D], the position rows
    p [2T - 1, H, D], the biases u, vb [H, D] and the valid ``lengths``
    [B]; returns [B, T, H, D], rows past a length zero. Where a gradient
    will be taken, or attention dropout is active, the plain version with
    torch autograd (on any device); otherwise the op
    ``st_port::relpos_attention``: the kernel on the card (``lengths`` cast
    to int32 there), the plain version on the CPU."""
    grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v, p, u, vb))
    if grad or (dropout_rate > 0.0 and not deterministic):
        return relpos.relpos_attention_reference(
            q, k, v, p, u, vb, lengths, dropout_rate=dropout_rate,
            deterministic=deterministic, generator=generator)
    if _on_cuda(q):
        lengths = lengths.to(torch.int32)
    return custom_ops.relpos_attention(q, k, v, p, u, vb, lengths)


def ctc_prefix_scores(logp, state, last, cand, index, lens, *, beams: int,
                      blank: int = 0, eos: int = 2):
    """CTC prefix scores and states of every candidate of one beam step
    (kernels/ctc_prefix.py): (ψ [R, P], states [R, P, 2, T]) from the
    log-probs [B, V, T], the hypotheses' states [R, 2, T] and last tokens
    [R], the candidates [R, P] and the step ``index`` (a 0-d int32 tensor
    on the log-probs' device)."""
    fn = (ctc_prefix.ctc_prefix_cuda if _on_cuda(logp)
          else ctc_prefix.ctc_prefix_reference)
    return fn(logp, state, last, cand, index, lens, beams=beams, blank=blank, eos=eos)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kv_lengths: torch.Tensor, causal: bool,
                    q_lengths: Optional[torch.Tensor] = None,
                    dropout_rate: float = 0.0, deterministic: bool = True,
                    generator: Optional[torch.Generator] = None,
                    remat: bool = False, dropout_shard=None) -> torch.Tensor:
    """[B, T, H, D] x [B, S, H, D] -> [B, T, H, D] attention with ragged key
    lengths (kernels/flash_attention.py). Where a gradient will be taken,
    the autograd Function over the three kernels for CUDA tensors and the
    plain version with torch autograd for CPU tensors; where none will
    (``torch.no_grad()``, or no input requires one), the forward op
    ``flash_fwd`` alone, which ``torch.export`` traces. These keep flash
    semantics: keys masked by length (and causally), query rows not masked.

    With attention dropout active (``dropout_rate > 0 and not
    deterministic``, JAX's condition at ``kernels/interface.py:49``) the
    call goes to ``models.modules.dot_product_attention`` instead, as JAX
    routes it: no TPU flash kernel drops anything. That route masks as
    JAX's dot path does, with an additive bias of the key lengths, the
    causal order and, given ``q_lengths``, the query lengths; ``generator``
    draws its dropout bits (``dropout_shard``: the heads are a tensor-parallel
    rank's, ``ops/dropout``'s ``shard``), and ``remat`` checkpoints it
    (``model.attention_remat``; the flash route already recomputes from
    the log-sum-exp, so there it changes nothing)."""
    if dropout_rate > 0.0 and not deterministic:
        from ..models.modules import dot_product_attention
        from ..ops.remat import remat as remat_call

        bias = _attention_bias(q.shape[1], k.shape[1], kv_lengths, causal, q_lengths)
        core = lambda q_, k_, v_, *, generator: dot_product_attention(
            q_, k_, v_, bias, dropout_rate=dropout_rate, deterministic=False,
            generator=generator, dropout_shard=dropout_shard)
        if remat:
            return remat_call(core, q, k, v, generator=generator)
        return core(q, k, v, generator=generator)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))     # [B, H, T, D] views
    if not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)):
        out = flash_fwd(qt, kt, vt, kv_lengths, causal=causal)[0]
    elif _on_cuda(q):
        out = flash.FlashAttention.apply(qt, kt, vt, kv_lengths, causal)
    else:
        out = flash.flash_attention_reference(qt, kt, vt, kv_lengths, causal=causal)
    return out.transpose(1, 2)


def _attention_bias(t: int, s: int, kv_lengths: torch.Tensor, causal: bool,
                    q_lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, 1, T, S] f32 additive bias: 0 where key j of query t is kept."""
    keep = masks.length_mask(kv_lengths, s)[:, None, None, :]
    if q_lengths is not None:
        keep = keep & masks.length_mask(q_lengths, t)[:, None, :, None]
    if causal:    # key j of query t kept iff j <= t
        pos = torch.arange(max(t, s), device=kv_lengths.device)
        keep = keep & (pos[None, :s] <= pos[:t, None])[None, None]
    return masks.mask_to_bias(keep.expand(-1, 1, t, s))


def flash_attention_stats(q, k, v, kv_lengths, *, causal: bool = False):
    """Differentiable ``(o, lse)`` of [B, H, T, D] inputs, the ring's
    per-block body: ``FlashAttentionStats`` over B-4/B-5/B-6 for CUDA
    tensors, the plain forward with torch autograd for CPU tensors."""
    if _on_cuda(q):
        return flash.FlashAttentionStats.apply(q, k, v, kv_lengths, causal)
    return flash.flash_fwd_reference(q, k, v, kv_lengths, causal=causal)


def flash_fwd(q, k, v, kv_lengths, *, causal: bool):
    """(o, lse) of [B, H, T, D] inputs (the forward kernel, B-4), the op
    ``st_port::flash_fwd``."""
    return custom_ops.flash_fwd(q, k, v, kv_lengths, bool(causal))


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


def fused_adam_master(params: List[torch.Tensor], grads: List[torch.Tensor],
                      masters: List[torch.Tensor], mus: List[torch.Tensor],
                      nus: List[torch.Tensor], scalars: torch.Tensor, *, b1: float,
                      b2: float, eps: float, weight_decay: float) -> None:
    """The master-weights variant, in place: the f32 ``masters`` updated from
    compute-dtype ``grads``, ``params`` set to them rounded
    (kernels/fused_adam.py). Counted as ``fused_adam_master``."""
    fn = (adam.fused_adam_master_cuda if _on_cuda(params[0])
          else adam.adam_update_master_reference)
    fn(params, grads, masters, mus, nus, scalars, b1=b1, b2=b2, eps=eps,
       weight_decay=weight_decay)


def int8_dense(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """[m, k] x [k, n] int8 -> [m, n] in x's dtype: ``(x @ wq) * scale``
    with f32 accumulation (kernels/int8_matmul.py). Every int8 dense layer
    comes here: there is no size gate."""
    fn = mm8.int8_matmul_cuda if _on_cuda(x) else mm8.int8_matmul_reference
    return fn(x, wq, scale)


def int8_ffn(x, w1q, s1, b1, w2q, s2, b2) -> torch.Tensor:
    """``relu((x @ w1q) * s1 + b1) @ w2q * s2 + b2`` in x's dtype, one
    launch with the hidden kept on chip (kernels/int8_ffn.py)."""
    fn = ffn8.int8_ffn_cuda if _on_cuda(x) else ffn8.int8_ffn_reference
    return fn(x, w1q, s1, b1, w2q, s2, b2)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def credit_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Add ``counts`` (kernel name -> launches) ``times`` over to the
    launch counts; a negative ``times`` takes them back."""
    for name, n in counts.items():
        _WRAPPERS[name].launches += n * times


_ROW_WRITES = {"kernel": 0, "index_copy": 0}


def count_row_writes(route: str, n: int = 1) -> None:
    """Count ``n`` self-K/V row writes of a decode step (one a layer and
    step, both caches) by ``route``: "kernel" or "index_copy"."""
    _ROW_WRITES[route] += n


def row_write_counts() -> Dict[str, int]:
    return dict(_ROW_WRITES)


def reset_row_write_counts() -> None:
    for route in _ROW_WRITES:
        _ROW_WRITES[route] = 0


def credit_row_writes(counts: Dict[str, int], times: int = 1) -> None:
    """Add ``counts`` (route -> row writes) ``times`` over, as
    ``credit_launches`` does for launches."""
    for route, n in counts.items():
        count_row_writes(route, n * times)


_DECODE_STEPS = {"captures": 0, "replays": 0, "eager_steps": 0,
                 "prologue_captures": 0, "prologue_replays": 0, "prologue_eager": 0}


def count_decode_steps(kind: str, n: int = 1) -> None:
    """Count ``n`` decode steps issued as ``kind``: "captures" (a step
    captured as a CUDA graph), "replays" (a graph replayed) or
    "eager_steps"; or ``n`` call prologues of the graph path
    (``beam_graph.graph_beam_decode``) as "prologue_captures",
    "prologue_replays" or "prologue_eager"."""
    _DECODE_STEPS[kind] += n


def decode_step_counts() -> Dict[str, int]:
    return dict(_DECODE_STEPS)


def reset_decode_step_counts() -> None:
    for kind in _DECODE_STEPS:
        _DECODE_STEPS[kind] = 0
