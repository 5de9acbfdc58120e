"""The CTC side of the hybrid CTC/attention model in the reference: its
head, the forward algorithm, prefix scores, and the hybrid judge and beam
search that the served hypotheses and the control are held to.

The head is one Linear d_model -> V over the encoder output (the port's
``ctc.weight`` / ``ctc.bias``), its log-softmax taken in float32; the blank
is id 0. Every probability over alignments comes from the standard forward
algorithm over the blank-extended label sequence b y1 b y2 ... yn b, in
float64: alpha_t(s), the log-probability that frames 0..t align to its
first s + 1 states ending in state s. A state's column over the frames is
a first-order linear recursion, alpha_t(s) = (alpha_{t-1}(s) + u_{t-1}) x_t
in the probability semiring with u from the columns before it, so each
column is computed in closed form with a cumulative log-sum-exp over t
(``_column``), one column after another. This is not the incremental
rn / rb recursion the port runs (ESPnet's ``CTCPrefixScore``); the two
derivations check each other.

With phi_t(n) = alpha_t(2n - 1) (+) alpha_t(2n) (the first n labels read
by frame t; alpha_t(2n) alone when the next label repeats the n-th), the
prefix score of y_1..y_n c is psi = (+)_t phi_{t-1}(n) + x_t(c) over the
valid frames (phi_{-1}(0) = 0), and the probability of y_1..y_n as the
whole transcript is phi_{T-1}(n).

A served hypothesis of n tokens scores ((1 - w) sum_j log p_att(y_j) + w
psi(y)) / lp(n), with the attention log-probs over the whole vocabulary
and w the CTC weight; a finished one adds the <eos> terms, with psi the
probability of the whole transcript.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .frontend import fbank
from .model import F32, Precision, decode, encode

PAD, SOS, EOS = 0, 1, 2     # the configuration's special ids
BLANK = PAD
NEG = float("-inf")


def param_spec(m: dict):
    """(name, shape, init) of the CTC head's parameters, as
    ``model.param_spec`` lists the rest."""
    return [("ctc.weight", (m["vocab_size"], m["d_model"]), "fan_in"),
            ("ctc.bias", (m["vocab_size"],), "zeros")]


def pre_beam_size(beam: int) -> int:
    """Tokens each hypothesis keeps by attention log-prob before CTC
    scoring (ESPnet's ``pre_beam_ratio`` 1.5)."""
    return int(1.5 * beam)


def log_probs(p, memory: torch.Tensor, pr: Precision = F32) -> torch.Tensor:
    """[B, T, V] float32 log-softmax of the CTC head over ``memory``."""
    logits = pr.out(pr(memory) @ pr(p["ctc.weight"]).t()) + p["ctc.bias"]
    return torch.log_softmax(logits, dim=-1)


def _column(x: torch.Tensor, u: torch.Tensor, first: bool) -> torch.Tensor:
    """log a_t of a_t = (a_{t-1} + u_{t-1}) x_t (probabilities), a_0 =
    x_0 if ``first`` else 0: log a_t = C_t + lcse_{tau <= t}(w_tau -
    C_{tau-1}) with C_t = sum_{tau <= t} log x_tau, C_{-1} = 0, w_0 = log 1
    or log 0, w_tau = log u_{tau-1}. ``x``, ``u`` [R, T] float64."""
    c = torch.cumsum(x, 1)
    c_prev = torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], 1)
    w0 = torch.full_like(u[:, :1], 0.0 if first else NEG)
    w = torch.cat([w0, u[:, :-1]], 1)
    return c + torch.logcumsumexp(w - c_prev, 1)


def frames(lp: torch.Tensor, utt: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x[r, ..., t] = lp[utt[r], t, ids[r, ...]]: the log-probs [B, T, V]
    of each row's ids, frames last."""
    at = utt.reshape((-1,) + (1,) * (ids.dim() - 1))
    return lp.transpose(1, 2)[at, ids.long()]


def forward(lp: torch.Tensor, labels: torch.Tensor, utt: torch.Tensor) -> torch.Tensor:
    """alpha [R, 2L + 1, T] (float64) of the labels [R, L] of row r over
    the log-probs ``lp`` [B, T, V] (float64) of utterance ``utt[r]``, every
    state of every row."""
    n_lab = labels.shape[1]
    xb = frames(lp, utt, torch.full_like(utt, BLANK))                 # [R, T]
    xl = frames(lp, utt, labels)                                      # [R, L, T]
    cols = [_column(xb, torch.full_like(xb, NEG), True)]
    for j in range(n_lab):
        u = cols[-1]
        if j > 0:
            skip = (labels[:, j] != labels[:, j - 1])[:, None]
            u = torch.where(skip, torch.logaddexp(u, cols[-2]), u)
        cols.append(_column(xl[:, j], u, j == 0))
        cols.append(_column(xb, cols[-1], False))
    return torch.stack(cols, 1)


def phis(alpha: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(phi [R, L + 1, T], phi before a repeated label [R, L + 1, T]):
    phi_t(n) = alpha_t(2n - 1) (+) alpha_t(2n), the second alpha_t(2n)
    alone; n = 0 is the blank column."""
    blank = alpha[:, 0::2]                                  # states 0, 2, .., 2L
    label = torch.cat([torch.full_like(alpha[:, :1], NEG), alpha[:, 1::2]], 1)
    return torch.logaddexp(blank, label), blank


def _shift(phi: torch.Tensor, n0: torch.Tensor) -> torch.Tensor:
    """phi_{t-1} over t: frame -1 reads log 1 where ``n0`` (n = 0), else
    log 0. ``phi`` [..., T], ``n0`` broadcast over its leading axes."""
    first = torch.where(n0, 0.0, NEG).to(phi.dtype).expand(phi.shape[:-1])[..., None]
    return torch.cat([first, phi[..., :-1]], -1)


def prefix_scores(phi_prev: torch.Tensor, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """psi = (+)_t phi_{t-1} + x_t(c) over the valid frames; the inputs
    [..., T] broadcast."""
    return torch.logsumexp(torch.where(valid, phi_prev + x, NEG), -1)


def _valid(lens: torch.Tensor, t_all: int) -> torch.Tensor:
    return torch.arange(t_all, device=lens.device)[None, :] < lens[:, None]


def _parent_last(labels: torch.Tensor) -> torch.Tensor:
    """[R, L]: the label before each position (-1 before the first)."""
    return torch.cat([torch.full_like(labels[:, :1], -1), labels[:, :-1]], 1).long()


def prefix_log_probs(lp: torch.Tensor, labels: torch.Tensor, utt: torch.Tensor,
                     lens: torch.Tensor, phi=None, rep=None) -> torch.Tensor:
    """psi(y_1..y_{j+1}) [R, L], j = 0 .. L - 1, of the labels [R, L] of
    row r over the first ``lens[r]`` frames of ``lp[utt[r]]`` ([B, T, V],
    float64); ``phi`` and ``rep`` (``phis`` of ``forward``) if at hand."""
    if phi is None:
        phi, rep = phis(forward(lp, labels, utt))
    n_lab, t_all = labels.shape[1], lp.shape[1]
    x = frames(lp, utt, labels)                                        # [R, L, T]
    before = torch.where((labels.long() == _parent_last(labels))[..., None],
                         rep[:, :n_lab], phi[:, :n_lab])
    n0 = (torch.arange(n_lab, device=lp.device) == 0)[None, :]
    return prefix_scores(_shift(before, n0), x, _valid(lens, t_all)[:, None])


def sequence_log_prob(lp: torch.Tensor, labels: torch.Tensor, n: torch.Tensor,
                      lens: torch.Tensor) -> torch.Tensor:
    """log p(y | x) [R] of the first ``n`` labels of row r as the whole
    transcript over the first ``lens`` frames of ``lp`` [R, T, V] (the CTC
    loss's negative)."""
    rows = torch.arange(len(n), device=lp.device)
    phi, _ = phis(forward(lp.double(), labels, rows))
    at = phi[rows, n.long()]                                           # [R, T]
    return at.gather(1, (lens.long() - 1)[:, None])[:, 0]


@torch.no_grad()
def _served_terms(params, cfg: dict, audio, sample_lens, tokens):
    """Teacher-forced attention log-probs [R, L + 1, V] (float64), the CTC
    log-probs [B, T, V] (float64) and valid frames [R] of the served
    hypotheses ``tokens`` [B, K, L], R = B·K."""
    m = cfg["model"]
    dev = audio.device
    feats, frame_lens = fbank(audio, sample_lens, cfg["features"])
    memory, mem_lens = encode(params, m, feats, frame_lens)
    b, k, L = tokens.shape
    ctc = log_probs(params, memory).double()
    memory = memory.repeat_interleave(k, 0)
    mem_lens = mem_lens.repeat_interleave(k, 0)
    toks = tokens.reshape(b * k, L).long().to(dev)
    tin = torch.cat([torch.full((b * k, 1), SOS, dtype=torch.long, device=dev), toks], 1)
    att = torch.log_softmax(decode(params, m, tin, torch.full((b * k,), L + 1, device=dev),
                                   memory, mem_lens).double(), dim=-1)
    return att, ctc, mem_lens


@torch.no_grad()
def judge(params, cfg: dict, audio: torch.Tensor, sample_lens: torch.Tensor,
          tokens: torch.Tensor, lengths: torch.Tensor, alpha: float, weight: float,
          beam: Optional[int] = None):
    """(hybrid scores [B, K], hybrid prune gaps [B]) of the served
    hypotheses ``tokens`` [B, K, L] with ``lengths`` [B, K] (a hypothesis
    shorter than L ends with <eos>); ``beam`` sets the pre-beam
    (``pre_beam_size``; K by default). The prune is judged over each
    parent's first P - 1 tokens of the pre-beam (``prune_gaps``): the P-th
    by the reference's attention log-probs may lie outside the search's
    own pre-beam through a rounding tie at the boundary, and a candidate
    that a right search never scored is no fault of its prune."""
    b, k, L = tokens.shape
    dev = audio.device
    att, ctc, mem_lens = _served_terms(params, cfg, audio, sample_lens, tokens)
    r, t_all = b * k, ctc.shape[1]
    utt = torch.arange(r, device=dev) // k
    toks = tokens.reshape(r, L).long().to(dev)
    n = lengths.reshape(r).long().to(dev)
    valid = _valid(mem_lens, t_all)                                    # [R, T]
    phi, rep = phis(forward(ctc, toks, utt))                           # [R, L + 1, T]
    tok_att = torch.gather(att[:, :L], 2, toks[..., None])[..., 0]     # [R, L]
    psi_own = prefix_log_probs(ctc, toks, utt, mem_lens, phi, rep)    # [R, L]
    pos = torch.arange(L, device=dev)[None]
    total_att = (tok_att * (pos < n[:, None])).sum(1)
    rows = torch.arange(r, device=dev)
    psi_y = torch.where(n > 0, psi_own[rows, (n - 1).clamp(min=0)], torch.zeros_like(total_att))
    finished = n < L
    eos_att = att[rows, n.clamp(max=L), EOS]
    whole = phi[rows, n.clamp(max=L)].gather(1, (mem_lens.long() - 1)[:, None])[:, 0]
    total = torch.where(finished, (1 - weight) * (total_att + eos_att) + weight * whole,
                        (1 - weight) * total_att + weight * psi_y)
    scores = (total / ((5.0 + n.double()) / 6.0) ** alpha).reshape(b, k)
    gaps = prune_gaps(att, ctc, utt, phi, rep, valid, toks, tok_att, psi_own, b, k,
                      lengths.cpu().numpy(), weight, pre_beam_size(beam or k) - 1)
    return scores, gaps


def prune_gaps(att, ctc, utt, phi, rep, valid, toks, tok_att, psi_own, b: int, k: int,
               lengths: np.ndarray, weight: float, n_pre: int) -> list:
    """For each utterance, the widest margin (nats) by which a candidate
    that the search dropped, among each kept parent's ``n_pre`` best tokens
    by the reference's attention log-prob (every id but <pad> and <sos>), outscores the
    worst hypothesis it kept, under the combined score (1 - w) sum log
    p_att + w psi; -inf where no step can be judged. The steps judged are
    ``serve.prune_gaps``': those where the served hypotheses' first t + 1
    tokens are ``k`` distinct prefixes, so every lane of step t and its
    parent are known; <eos> candidates are not alive ones and are skipped."""
    r, L = toks.shape
    dev = toks.device
    # The pre-beam of every served prefix (as a parent at step t).
    ranked = att[:, :L].clone()
    ranked[..., [PAD, SOS]] = NEG
    cand = ranked.topk(n_pre, dim=-1).indices                          # [R, L, P]
    parent_last = _parent_last(toks)
    x = frames(ctc, utt, cand)                                         # [R, L, P, T]
    n0 = (torch.arange(L, device=dev) == 0)[None, :, None]
    phi_c = torch.where((cand == parent_last[..., None])[..., None], rep[:, :L, None],
                        phi[:, :L, None])
    psi_c = prefix_scores(_shift(phi_c, n0), x, valid[:, None, None])  # [R, L, P]
    cum = torch.cat([torch.zeros_like(tok_att[:, :1]), torch.cumsum(tok_att, 1)], 1)
    cand_score = ((1 - weight) * (cum[:, :L, None] + torch.gather(att[:, :L], 2, cand))
                  + weight * psi_c)                                    # [R, L, P]
    own = (1 - weight) * cum[:, 1:] + weight * psi_own                 # [R, L]: y_1..y_{t+1}
    cand, cand_score, own = (a.reshape(b, k, *a.shape[1:]).cpu().numpy()
                             for a in (cand, cand_score, own))
    tokens = toks.reshape(b, k, L).cpu().numpy()
    out = []
    for u in range(b):
        widest = -np.inf
        if (lengths[u] == L).all():
            for t in range(L):
                if len({tokens[u, q, :t + 1].tobytes() for q in range(k)}) < k:
                    continue
                kept = own[u, :, t].min()
                parents = {}
                for q in range(k):
                    parents.setdefault(tokens[u, q, :t].tobytes(), []).append(q)
                for lanes in parents.values():
                    q = lanes[0]
                    taken = set(tokens[u, lanes, t].tolist()) | {EOS}
                    for c, s in zip(cand[u, q, t], cand_score[u, q, t]):
                        if int(c) not in taken:
                            widest = max(widest, float(s - kept))
        out.append(widest)
    return out


def _extend(x_lab: torch.Tensor, xb: torch.Tensor, last2: torch.Tensor,
            repeat: torch.Tensor, first: bool) -> torch.Tensor:
    """The two new columns [R, 2, T] of a hypothesis extended by one label:
    its label state (from the last two columns ``last2`` [R, 2, T], the
    label's and the blank's, skipping the label's unless ``repeat``) and
    the blank after it."""
    u = torch.where(repeat[:, None], last2[:, 1], torch.logaddexp(last2[:, 0], last2[:, 1]))
    lab = _column(x_lab, u, first)
    return torch.stack([lab, _column(xb, lab, False)], 1)


@torch.no_grad()
def beam_search(params, cfg: dict, audio: torch.Tensor, sample_lens: torch.Tensor,
                beam: int, max_len: int, alpha: float, weight: float, pr: Precision = F32):
    """(scores [B, K], best first, and tokens [B, K, max_len]) of the hybrid
    beam search over ``max_len`` steps: each live hypothesis keeps its
    ``pre_beam_size`` best tokens by attention log-prob (every id but
    <pad> and <sos>), each of them scores the hypothesis's score + (1 - w)
    log p_att(c) + w (psi(g c) - psi(g)), and the best ``beam`` of all but
    the <eos> ones live on (at the first step, those of the empty
    hypothesis). Each step runs the decoder over the whole prefix; each
    hypothesis keeps its forward algorithm's last two columns. Scores are
    length-penalised as ``judge``'s."""
    m = cfg["model"]
    dev = audio.device
    feats, frame_lens = fbank(audio, sample_lens, cfg["features"])
    memory, mem_lens = encode(params, m, feats, frame_lens, pr=pr)
    b, k, n_pre = memory.shape[0], beam, pre_beam_size(beam)
    ctc = log_probs(params, memory, pr).double()                       # [B, T, V]
    t_all = ctc.shape[1]
    memory = memory.repeat_interleave(k, 0)
    mem_lens_k = mem_lens.repeat_interleave(k, 0)
    valid = _valid(mem_lens_k, t_all)
    utt = torch.arange(b * k, device=dev) // k
    xb = frames(ctc, utt, torch.full_like(utt, BLANK))                 # [BK, T]
    # The empty hypothesis: no label column, the blank column.
    cols = torch.stack([torch.full_like(xb, NEG), _column(xb, torch.full_like(xb, NEG), True)], 1)
    scores = torch.full((b, k), NEG, dtype=torch.float64, device=dev)
    scores[:, 0] = 0.0
    psi = torch.zeros((b * k,), dtype=torch.float64, device=dev)
    toks = torch.zeros((b, k, 0), dtype=torch.long, device=dev)
    for i in range(max_len):
        tin = torch.cat([torch.full((b * k, 1), SOS, dtype=torch.long, device=dev),
                         toks.reshape(b * k, i)], 1)
        logits = decode(params, m, tin, torch.full((b * k,), i + 1, device=dev), memory,
                        mem_lens_k, pr=pr)[:, -1]
        att = torch.log_softmax(logits.double(), dim=-1)
        ranked = att.clone()
        ranked[:, [PAD, SOS]] = NEG
        cand = ranked.topk(n_pre, dim=-1).indices                      # [BK, P]
        last = toks[:, :, -1].reshape(b * k) if i else torch.full((b * k,), -1, device=dev)
        repeat = cand == last[:, None]
        phi = torch.where(repeat[..., None], cols[:, None, 1],
                          torch.logaddexp(cols[:, 0], cols[:, 1])[:, None])
        x = frames(ctc, utt, cand)                                     # [BK, P, T]
        psi_c = prefix_scores(_shift(phi, torch.tensor(i == 0, device=dev)), x,
                              valid[:, None])                          # [BK, P]
        total = (scores.reshape(b * k, 1) + (1 - weight) * att.gather(1, cand)
                 + weight * (psi_c - psi[:, None]))
        total = torch.where(cand == EOS, NEG, total)
        scores, idx = total.reshape(b, k * n_pre).topk(k)
        parent = torch.div(idx, n_pre, rounding_mode="floor")
        src = (parent + torch.arange(b, device=dev)[:, None] * k).reshape(b * k)
        tok = cand.reshape(b, k * n_pre).gather(1, idx)
        flat = (src * n_pre + idx.reshape(b * k) % n_pre)
        psi = psi_c.reshape(-1)[flat]
        x_lab = x.reshape(b * k * n_pre, t_all)[flat]
        cols = _extend(x_lab, xb, cols[src], repeat.reshape(-1)[flat], i == 0)
        toks = torch.cat([torch.gather(toks, 1, parent[..., None].expand(b, k, i)),
                          tok[..., None]], 2)
    return scores / ((5.0 + max_len) / 6.0) ** alpha, toks
