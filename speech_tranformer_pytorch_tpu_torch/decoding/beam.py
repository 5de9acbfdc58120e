"""Batched beam-search decoding (counterpart of the JAX package's
``decoding/beam.py``).

The whole batch and all K beams advance together; state is fixed-shape
[B, K, ...]. Each step takes the top-2K candidates over the flattened K·V
scores (``kernels/interface.beam_candidate_topk``), routes <eos> candidates
to the finished pool and keeps the best K others alive. The self-attention
KV cache is never reordered: a [B, K, L] lineage table records which cache
lane holds each beam's step-j entry. Finished hypotheses are ranked by
``score / lp(len)`` with the GNMT penalty ``lp(n) = ((5+n)/6)^alpha``. The
loop stops as soon as no alive beam can beat the worst finished one (an
exact bound, not an approximation). Every top-k uses ``topk_stable``, whose
tie order is ``jax.lax.top_k``'s.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..device import DeviceLike, resolve_device
from ..kernels import interface
from ..models import SpeechTransformer
from ..ops.masks import NEG_INF
from ..ops.topk import topk_stable

PAD, SOS, EOS = 0, 1, 2


def length_penalty(lengths: torch.Tensor, alpha: float) -> torch.Tensor:
    """GNMT length normalisation factor lp(n) = ((5+n)/6)^alpha (float32)."""
    return torch.pow((5.0 + lengths.float()) / 6.0, alpha)


@dataclasses.dataclass(frozen=True)
class BeamResult:
    tokens: torch.Tensor     # [B, K, L] token ids (eos-terminated, pad tail)
    lengths: torch.Tensor    # [B, K] lengths excluding eos
    scores: torch.Tensor     # [B, K] length-penalized log-probs, sorted desc
    steps: int               # decode steps run before the stop


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx[..., None...], axis=1)`` for [B, N, ...] x."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


@torch.no_grad()
def beam_search(
    model: SpeechTransformer,
    memory: torch.Tensor,        # [B, S, d_model]
    mem_lens: torch.Tensor,      # [B]
    *,
    beam_size: int,
    max_len: int,
    alpha: float = 1.0,
) -> BeamResult:
    b, k = memory.shape[0], beam_size
    dev = memory.device
    i32 = dict(dtype=torch.int32, device=dev)
    cache = model.init_cache(memory, max_len, k)

    # Only beam 0 is live at step 0 (all beams would be identical).
    alive_scores = torch.tensor([0.0] + [NEG_INF] * (k - 1), device=dev).repeat(b, 1)
    alive_tokens = torch.full((b, k, max_len), PAD, **i32)
    cur_tokens = torch.full((b, k), SOS, **i32)
    fin_tokens = torch.full((b, k, max_len), PAD, **i32)
    fin_scores = torch.full((b, k), NEG_INF, device=dev)
    fin_lens = torch.zeros((b, k), **i32)
    # lineage[b, k, j]: the cache lane holding beam k's step-j key/value.
    identity = torch.arange(k, **i32)[None, :, None].expand(b, k, max_len)
    lineage = identity.clone()
    positions = torch.arange(max_len, device=dev)[None, None, :]
    max_lp = length_penalty(torch.tensor(max_len), alpha).to(dev)

    steps = 0
    for i in range(max_len):
        # An alive hypothesis can at best reach score / lp(max_len): stop
        # once that is <= the worst finished score everywhere (one host
        # sync per step).
        bound = alive_scores.max(dim=1).values / max_lp
        worst_fin = fin_scores.min(dim=1).values
        pool_full = worst_fin > NEG_INF / 2.0
        if not bool(torch.any(~pool_full | (bound > worst_fin))):
            break
        logits, cache = model.decode_step(cur_tokens.reshape(b * k), i, cache,
                                          mem_lens, k, lineage)
        v = logits.shape[-1]
        top_scores, top_idx = interface.beam_candidate_topk(
            logits, alive_scores, k2=2 * k, pad_id=PAD, sos_id=SOS)
        top_idx = top_idx.long()
        top_beam = torch.div(top_idx, v, rounding_mode="floor")
        top_tok = (top_idx % v).to(torch.int32)

        seqs = _take(alive_tokens, top_beam)                   # [B, 2K, L]
        seqs[:, :, i] = top_tok
        is_eos = top_tok == EOS

        # Finished pool: the existing K plus the new <eos> candidates.
        new_fin_lens = torch.full((b, 2 * k), i, **i32)
        penalized = top_scores / length_penalty(new_fin_lens, alpha)
        cand_fin = torch.where(is_eos, penalized, torch.full_like(penalized, NEG_INF))
        fin_scores, fin_sel = topk_stable(torch.cat([fin_scores, cand_fin], 1), k)
        fin_tokens = _take(torch.cat([fin_tokens, seqs], 1), fin_sel)
        fin_lens = _take(torch.cat([fin_lens, new_fin_lens], 1), fin_sel)

        # Alive set: the best K non-eos candidates.
        alive_cand = torch.where(is_eos, torch.full_like(top_scores, NEG_INF),
                                 top_scores)
        alive_scores, alive_sel = topk_stable(alive_cand, k)
        alive_tokens = _take(seqs, alive_sel)
        cur_tokens = _take(top_tok, alive_sel)
        src_beam = _take(top_beam, alive_sel)                  # [B, K]

        # Compose the beam permutation into the lineage table: columns <= i
        # follow the chosen parents, later columns stay identity.
        lineage = torch.where(positions <= i, _take(lineage, src_beam), identity)
        steps += 1

    # Still-alive beams join the pool, penalized at full length.
    alive_pen = alive_scores / length_penalty(torch.full((b, k), max_len, **i32), alpha)
    all_scores = torch.cat([fin_scores, alive_pen], 1)
    all_tokens = torch.cat([fin_tokens, alive_tokens], 1)
    all_lens = torch.cat([fin_lens, torch.full((b, k), max_len, **i32)], 1)
    final_scores, sel = topk_stable(all_scores, k)
    return BeamResult(tokens=_take(all_tokens, sel), lengths=_take(all_lens, sel),
                      scores=final_scores, steps=steps)


@torch.no_grad()
def beam_decode(
    model: SpeechTransformer,
    feats,
    frame_lens,
    *,
    beam_size: int,
    max_len: int,
    alpha: float = 1.0,
    device: DeviceLike = None,
) -> BeamResult:
    """Encode + beam search on ``device`` (CUDA unless the caller asks for
    the CPU); the model must already live there."""
    dev = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != dev.type:
        raise ValueError(f"model is on {param.device}, decoding on {dev}")
    feats = torch.as_tensor(feats).to(dev)
    frame_lens = torch.as_tensor(frame_lens).to(dev)
    memory, mem_lens = model.encode(feats, frame_lens)
    return beam_search(model, memory, mem_lens, beam_size=beam_size,
                       max_len=max_len, alpha=alpha)


def best_hypotheses(result: BeamResult) -> List[List[int]]:
    """Top beam of each utterance -> python lists."""
    t = result.tokens[:, 0].cpu().numpy()
    l = result.lengths[:, 0].cpu().numpy()
    return [t[i, :l[i]].tolist() for i in range(t.shape[0])]
