"""Greedy decoding (counterpart of the JAX package's ``decoding/greedy.py``).

The whole batch advances together, one token a step: the argmax of each
row's logits with <pad> and <sos> never emitted; a row that has emitted
<eos> emits <pad> from then on. With ``early_stop`` (the default) the loop
stops as soon as every row has emitted <eos> (one host sync per step),
which is exact: a finished row only appends <pad>, as the remaining steps
would; ``early_stop=False`` runs all ``max_len`` steps with no host sync
(the loop ``serving.export_recognizer`` exports). Each step is
``SpeechTransformer.decode_step`` at beam width 1 with the identity lineage
table (all zeros), so self-attention runs the lineage kernel as beam search
does; the JAX K=1 path uses masked dot attention, equal up to f32
summation order.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import DeviceLike
from ..models import SpeechTransformer
from ..utils.profiling import named_scope
from .beam import EOS, PAD, SOS, decode_loop, decode_step, encode_on, split_cache


@dataclasses.dataclass(frozen=True)
class GreedyResult:
    tokens: torch.Tensor     # [B, max_len] incl. <eos>, <pad> after it
    lengths: torch.Tensor    # [B] excl. <eos> and <pad>
    steps: int               # decode steps run before the stop


@torch.no_grad()
def greedy_search(model: SpeechTransformer, memory: torch.Tensor,
                  mem_lens: torch.Tensor, *, max_len: int,
                  int8_kv: bool = False, early_stop: bool = True) -> GreedyResult:
    b, dev = memory.shape[0], memory.device
    with named_scope("st.decode.init_cache"):
        const, own = split_cache(model.init_cache(memory, max_len, 1, int8_kv))
    lineage = torch.zeros((b, 1, max_len), dtype=torch.int32, device=dev)
    positions = torch.arange(max_len, device=dev)[None, :]

    def step(c, i):
        cur, finished, tokens, own = c
        logits, own = decode_step(model, cur, i, const, own, mem_lens, 1, lineage)
        with named_scope("st.decode.search"):
            logits[:, PAD].fill_(float("-inf"))
            logits[:, SOS].fill_(float("-inf"))
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            nxt = torch.where(finished, torch.full_like(nxt, PAD), nxt)
            tokens = torch.where(positions == i, nxt[:, None], tokens)
            return nxt, finished | (nxt == EOS), tokens, own

    carry = (torch.full((b,), SOS, dtype=torch.int32, device=dev),
             torch.zeros((b,), dtype=torch.bool, device=dev),
             torch.full((b, max_len), PAD, dtype=torch.int32, device=dev), own)
    (_, _, tokens, _), steps = decode_loop(
        step, carry, torch.arange(max_len, dtype=torch.int32, device=dev),
        stop=(lambda c: bool(c[1].all())) if early_stop else None)
    with named_scope("st.decode.finalize"):
        lengths = ((tokens != EOS) & (tokens != PAD)).sum(dim=-1, dtype=torch.int32)
        return GreedyResult(tokens=tokens, lengths=lengths, steps=steps)


@torch.no_grad()
def greedy_decode(model: SpeechTransformer, feats, frame_lens, *, max_len: int,
                  int8_kv: bool = False, device: DeviceLike = None,
                  early_stop: bool = True) -> GreedyResult:
    """Encode + greedy search on ``device`` (CUDA unless the caller asks
    for the CPU); the model must already live there."""
    memory, mem_lens = encode_on(model, feats, frame_lens, device)
    return greedy_search(model, memory, mem_lens, max_len=max_len, int8_kv=int8_kv,
                         early_stop=early_stop)


def tokens_to_lists(result: GreedyResult):
    """Each row's tokens before its <eos>, as python lists."""
    t, l = result.tokens.cpu().numpy(), result.lengths.cpu().numpy()
    return [t[i, :l[i]].tolist() for i in range(t.shape[0])]
