"""Served beam hypotheses, judged by the reference: their scores, the
prune that kept them, and a plain beam search of the reference's own (the
control serves through it).

A hypothesis of n tokens scores sum_j log p(y_j | y_<j, audio), plus
log p(<eos>) when it finished, over the GNMT length penalty
((5 + n) / 6) ** alpha; log p is the log-softmax over the whole vocabulary.
"""

from __future__ import annotations

import numpy as np
import torch

from .frontend import fbank
from .model import F32, Precision, decode, encode

PAD, SOS, EOS = 0, 1, 2     # the configuration's special ids


@torch.no_grad()
def judge(params, cfg: dict, audio: torch.Tensor, sample_lens: torch.Tensor,
          tokens: torch.Tensor, lengths: torch.Tensor, alpha: float):
    """(scores [B, K], prune gaps [B]) of hypotheses ``tokens`` [B, K, L]
    with ``lengths`` [B, K] (a hypothesis of length < L ends with <eos>),
    from one teacher-forced float32 pass over each; see ``prune_gaps``."""
    m = cfg["model"]
    dev = audio.device
    feats, frame_lens = fbank(audio, sample_lens, cfg["features"])
    memory, mem_lens = encode(params, m, feats, frame_lens)
    b, k, L = tokens.shape
    memory = memory.repeat_interleave(k, 0)
    mem_lens = mem_lens.repeat_interleave(k, 0)
    toks = tokens.reshape(b * k, L).long().to(dev)
    n = lengths.reshape(b * k).long().to(dev)
    tin = torch.cat([torch.full((b * k, 1), SOS, dtype=torch.long, device=dev), toks], 1)
    logp = torch.log_softmax(decode(params, m, tin, torch.full_like(n, L + 1), memory,
                                    mem_lens), dim=-1)                 # [BK, L+1, V]
    pos = torch.arange(L, device=dev)[None]
    tok_lp = torch.gather(logp[:, :L], 2, toks.clamp(min=0)[..., None])[..., 0]
    total = (tok_lp * (pos < n[:, None])).sum(1)
    finished = n < L
    eos_lp = logp[torch.arange(b * k, device=dev), n.clamp(max=L), EOS]
    total = total + torch.where(finished, eos_lp, torch.zeros_like(eos_lp))
    penalty = ((5.0 + n.double()) / 6.0) ** alpha
    scores = (total.double() / penalty).reshape(b, k)
    gaps = prune_gaps(logp.reshape(b, k, L + 1, -1).double().cpu().numpy(),
                      tokens.long().cpu().numpy(), lengths.cpu().numpy())
    return scores, gaps


def prune_gaps(logp: np.ndarray, tokens: np.ndarray, lengths: np.ndarray) -> list:
    """For each utterance, the widest margin (nats) by which an extension
    that the search dropped outscores the worst hypothesis it kept; -inf
    where no step can be judged.

    The served hypotheses of a search that ran to its last step are the
    lanes alive there, and their first t + 1 tokens were lanes at step t.
    Wherever those prefixes are ``beam`` distinct ones, they are all the
    lanes of step t, their parents are known, and a right prune kept the
    best ``beam`` extensions of those parents (every token but <pad>,
    <sos> and <eos>): no dropped extension of them scores above the worst
    kept lane. The margin of each such step is taken with the reference's
    log-probabilities ``logp`` [B, K, L + 1, V]; a sound search reads near
    nought (rounding swaps near ties), a prune that drops the best
    candidate reads the gap between the best and the kept."""
    b, k, L = tokens.shape
    tok_lp = np.take_along_axis(logp[:, :, :L], tokens[..., None], -1)[..., 0]
    prefix = np.concatenate([np.zeros((b, k, 1)), np.cumsum(tok_lp, -1)], -1)
    out = []
    for u in range(b):
        widest = -np.inf
        if (lengths[u] == L).all():
            for t in range(L):
                if len({tokens[u, r, :t + 1].tobytes() for r in range(k)}) < k:
                    continue
                kept = prefix[u, :, t + 1].min()
                parents = {}
                for r in range(k):
                    parents.setdefault(tokens[u, r, :t].tobytes(), []).append(r)
                for rows in parents.values():
                    cand = prefix[u, rows[0], t] + logp[u, rows[0], t]
                    cand[[PAD, SOS, EOS]] = -np.inf
                    cand[tokens[u, rows, t]] = -np.inf
                    widest = max(widest, float(cand.max() - kept))
        out.append(widest)
    return out


@torch.no_grad()
def beam_search(params, cfg: dict, audio: torch.Tensor, sample_lens: torch.Tensor,
                beam: int, max_len: int, alpha: float, pr: Precision = F32):
    """(scores [B, K], best first, and tokens [B, K, max_len]) of a beam
    search that runs ``max_len`` steps: at each step every live hypothesis
    is extended by every token but <pad>, <sos> and <eos>, and the best
    ``beam`` of all extensions of an utterance live on (at the first step,
    those of the empty hypothesis). Each step runs the decoder over the
    whole prefix. Scores are length-penalised as ``judge``'s."""
    m = cfg["model"]
    dev = audio.device
    feats, frame_lens = fbank(audio, sample_lens, cfg["features"])
    memory, mem_lens = encode(params, m, feats, frame_lens, pr=pr)
    b, k = memory.shape[0], beam
    memory = memory.repeat_interleave(k, 0)
    mem_lens = mem_lens.repeat_interleave(k, 0)
    scores = torch.full((b, k), float("-inf"), dtype=torch.float64, device=dev)
    scores[:, 0] = 0.0
    toks = torch.zeros((b, k, 0), dtype=torch.long, device=dev)
    for i in range(max_len):
        tin = torch.cat([torch.full((b * k, 1), SOS, dtype=torch.long, device=dev),
                         toks.reshape(b * k, i)], 1)
        logits = decode(params, m, tin, torch.full((b * k,), i + 1, device=dev), memory,
                        mem_lens, pr=pr)[:, -1]
        logp = torch.log_softmax(logits.double(), dim=-1)
        logp[:, [PAD, SOS, EOS]] = float("-inf")
        v = logp.shape[-1]
        scores, idx = (scores[:, :, None] + logp.reshape(b, k, v)).reshape(b, k * v).topk(k)
        parent = torch.div(idx, v, rounding_mode="floor")
        toks = torch.cat([torch.gather(toks, 1, parent[..., None].expand(b, k, i)),
                          (idx % v)[..., None]], 2)
    return scores / ((5.0 + max_len) / 6.0) ** alpha, toks
