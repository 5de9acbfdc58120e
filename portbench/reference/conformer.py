"""The Conformer encoder of the reference (Gulati et al., 2020, as ESPnet
serves it for LibriSpeech: ``ConformerEncoder`` with ``macaron_style``,
``rel_pos`` / ``rel_selfattn`` in their "latest" form, Swish,
``normalize_before``), written from the equations, functional over a
``{name: tensor}`` dictionary keyed as the port's ``state_dict``; and the
hybrid CTC/attention judge and beam search over it, which take everything
after the encoder from ``reference/ctc.py`` and ``reference/model.decode``.
It imports neither package. Every product is float32 with TF32 off
(``exact_float32``), or rounded by a ``Precision`` (the control).

Encoder: the Speech-Transformer's subsampling (``model.param_spec``'s
``encoder.subsample.*``), x·√d, then N blocks

    x = x + ½·FFN(LN(x));  x = x + MHSA_rel(LN(x));  x = x + Conv(LN(x));
    x = x + ½·FFN(LN(x));  x = LN(x)

with FFN = Linear → Swish → Linear, a final LayerNorm and zeroed padding
frames. MHSA_rel: q, k, v of one Linear, the position rows P = pos(R) of
the table R of relative positions T' - 1 … -(T' - 1) (sines at even
columns, cosines at odd), and the scores ((q + u)·kᵀ + rel_shift((q + v)·Pᵀ))
/ √D, the second term materialised as [B, H, T', 2T' - 1] and shifted by
ESPnet's pad-and-view ``rel_shift``; keys past an utterance's length
masked. Conv: pointwise d → 2d, GLU, the padded frames zeroed, the
depthwise convolution (kernel ``conv_kernel``, "same" padding), BatchNorm
(running statistics; the batch's in training, ``bn_train``), Swish,
pointwise d → d.

Departures from the published description (each also in the configuration
file's ``assumed``): the padded frames are zeroed before the depthwise
convolution (WeNet's ``mask_pad``; the recipe as recalled convolves the
padding as it is); LayerNorm's epsilon is 1e-6 (ESPnet's 1e-12); the
projections of q, k and v are one fused Linear (the same function as
ESPnet's three); query rows past an utterance's length are not zeroed here
(the port zeroes them: no valid frame reads them either way); no dropout
(the reference judges served calls and deterministic train steps).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from . import ctc
from .frontend import fbank
from .model import F32, Precision, _linear, _ln, decode, exact_float32, subsampled
from .model import param_spec as attention_param_spec

NEG = float("-inf")
BN_EPS = 1e-5


def param_spec(m: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter and BatchNorm statistic: the
    subsampling and the decoder as ``model.param_spec`` lists them, the
    Conformer blocks, and the CTC head (``ctc.param_spec``). init is
    ``model.param_spec``'s, or ``pos_bias`` (normal, std 1/√D),
    ``bn_mean`` (normal, std 0.3), ``bn_var`` (uniform in [0.5, 2]) or
    ``count`` (an int64 zero)."""
    d, ff, h, k = m["d_model"], m["d_ff"], m["num_heads"], m["conv_kernel"]
    shared = attention_param_spec(m)
    spec = [e for e in shared if e[0].startswith("encoder.subsample.")]

    def lin(name, out_f, in_f, bias=True):
        spec.append((f"{name}.weight", (out_f, in_f), "fan_in"))
        if bias:
            spec.append((f"{name}.bias", (out_f,), "zeros"))

    def ln(name):
        spec.extend([(f"{name}.weight", (d,), "ones"), (f"{name}.bias", (d,), "zeros")])

    for i in range(m["num_encoder_layers"]):
        p = f"encoder.layers.{i}"
        for f in ("ffn_macaron", "ffn"):
            lin(f"{p}.{f}.fc1", ff, d)
            lin(f"{p}.{f}.fc2", d, ff)
        spec.extend([(f"{p}.self_attn.pos_bias_u", (h, d // h), "pos_bias"),
                     (f"{p}.self_attn.pos_bias_v", (h, d // h), "pos_bias")])
        lin(f"{p}.self_attn.qkv", 3 * d, d)
        lin(f"{p}.self_attn.pos", d, d, bias=False)
        lin(f"{p}.self_attn.out", d, d)
        lin(f"{p}.conv.pointwise1", 2 * d, d)
        spec.extend([(f"{p}.conv.depthwise.weight", (d, 1, k), "fan_in"),
                     (f"{p}.conv.depthwise.bias", (d,), "zeros"),
                     (f"{p}.conv.norm.weight", (d,), "ones"),
                     (f"{p}.conv.norm.bias", (d,), "zeros"),
                     (f"{p}.conv.norm.running_mean", (d,), "bn_mean"),
                     (f"{p}.conv.norm.running_var", (d,), "bn_var"),
                     (f"{p}.conv.norm.num_batches_tracked", (), "count")])
        lin(f"{p}.conv.pointwise2", d, d)
        for n in ("norm_ff_macaron", "norm_mha", "norm_conv", "norm_ff", "norm_final"):
            ln(f"{p}.{n}")
    ln("encoder.final_norm")
    spec += [e for e in shared if e[0].startswith("decoder.")]
    return spec + ctc.param_spec(m)


def relative_positions(t: int, d: int, device) -> torch.Tensor:
    """[2t - 1, d]: row c the sinusoid of relative position t - 1 - c,
    computed in float64."""
    rel = (t - 1 - np.arange(2 * t - 1, dtype=np.float64))[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    pe = np.zeros((2 * t - 1, d))
    pe[:, 0::2] = np.sin(rel * div)
    pe[:, 1::2] = np.cos(rel * div)
    return torch.tensor(pe, dtype=torch.float32, device=device)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T - 1] -> [B, H, T, T], out[.., i, j] = x[.., i, T - 1 - i + j]:
    ESPnet's pad-and-view shift."""
    b, h, t, n = x.shape
    padded = torch.cat([x.new_zeros(b, h, t, 1), x], dim=-1).view(b, h, n + 1, t)
    return padded[:, :, 1:].reshape(b, h, t, n)[..., : n // 2 + 1]


def rel_attention(p, name: str, y: torch.Tensor, pos: torch.Tensor, lens: torch.Tensor,
                  h: int, pr: Precision) -> torch.Tensor:
    qkv = _linear(p, f"{name}.qkv", y, pr).unflatten(-1, (3, h, -1))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]                  # [B, T, H, D]
    rows = pr.out(pr(pos) @ pr(p[f"{name}.pos.weight"]).t()).unflatten(-1, (h, -1))
    q_u, q_v = q + p[f"{name}.pos_bias_u"], q + p[f"{name}.pos_bias_v"]
    ac = pr.out(torch.einsum("bihd,bjhd->bhij", pr(q_u), pr(k)))
    bd = rel_shift(pr.out(torch.einsum("bihd,rhd->bhir", pr(q_v), pr(rows))))
    s = (ac + bd) / math.sqrt(q.shape[-1])
    keep = torch.arange(s.shape[-1], device=y.device)[None, :] < lens[:, None].long()
    w = torch.softmax(s.masked_fill(~keep[:, None, None, :], NEG), dim=-1)
    a = pr.out(torch.einsum("bhij,bjhd->bihd", pr(w), pr(v)))
    return _linear(p, f"{name}.out", a.flatten(-2), pr)


def conv_module(p, name: str, y: torch.Tensor, valid: torch.Tensor, kernel: int,
                pr: Precision, bn_train: bool) -> torch.Tensor:
    d = y.shape[-1]
    g = _linear(p, f"{name}.pointwise1", y, pr)
    g = (g[..., :d] * torch.sigmoid(g[..., d:])) * valid[..., None].float()
    c = pr.out(F.conv1d(pr(g.transpose(1, 2)), pr(p[f"{name}.depthwise.weight"]),
                        p[f"{name}.depthwise.bias"], padding=(kernel - 1) // 2, groups=d))
    c = F.batch_norm(c, p[f"{name}.norm.running_mean"].clone(),
                     p[f"{name}.norm.running_var"].clone(), p[f"{name}.norm.weight"],
                     p[f"{name}.norm.bias"], bn_train, 0.1, BN_EPS)
    return _linear(p, f"{name}.pointwise2", F.silu(c).transpose(1, 2), pr)


def ffn(p, name: str, y: torch.Tensor, pr: Precision) -> torch.Tensor:
    return _linear(p, f"{name}.fc2", F.silu(_linear(p, f"{name}.fc1", y, pr)), pr)


def encode(p, m: dict, feats: torch.Tensor, frame_lens: torch.Tensor, *,
           pr: Precision = F32, bn_train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(memory [B, T', d] with zeroed padding, valid lengths [B])."""
    h, d = m["num_heads"], m["d_model"]
    x = feats[:, None]
    for conv in ("conv0", "conv1"):
        w = p[f"encoder.subsample.{conv}.weight"]
        x = F.relu(pr.out(F.conv2d(pr(x), pr(w), stride=2))
                   + p[f"encoder.subsample.{conv}.bias"][:, None, None])
    b, c, t, f = x.shape
    x = _linear(p, "encoder.subsample.out", x.permute(0, 2, 3, 1).reshape(b, t, f * c), pr)
    x = x * math.sqrt(d)
    pos = relative_positions(t, d, x.device)
    lens = subsampled(frame_lens.long())
    valid = torch.arange(t, device=x.device)[None, :] < lens[:, None]
    for i in range(m["num_encoder_layers"]):
        n = f"encoder.layers.{i}"
        x = x + 0.5 * ffn(p, f"{n}.ffn_macaron", _ln(p, f"{n}.norm_ff_macaron", x), pr)
        x = x + rel_attention(p, f"{n}.self_attn", _ln(p, f"{n}.norm_mha", x), pos, lens, h, pr)
        x = x + conv_module(p, f"{n}.conv", _ln(p, f"{n}.norm_conv", x), valid,
                            m["conv_kernel"], pr, bn_train)
        x = x + 0.5 * ffn(p, f"{n}.ffn", _ln(p, f"{n}.norm_ff", x), pr)
        x = _ln(p, f"{n}.norm_final", x)
    x = _ln(p, "encoder.final_norm", x)
    return x * valid[..., None].float(), lens


# ----------------------------------------------------------------------------
# The hybrid judge and beam search over the Conformer (ctc.py's, written out
# with this encoder).
# ----------------------------------------------------------------------------

@torch.no_grad()
def _served_terms(params, cfg: dict, audio, sample_lens, tokens):
    """``ctc._served_terms`` over the Conformer: teacher-forced attention
    log-probs [R, L + 1, V], the CTC log-probs [B, T, V] (float64) and the
    valid frames [R] of the hypotheses ``tokens`` [B, K, L]."""
    m = cfg["model"]
    dev = audio.device
    feats, frame_lens = fbank(audio, sample_lens, cfg["features"])
    memory, mem_lens = encode(params, m, feats, frame_lens)
    b, k, L = tokens.shape
    lp = ctc.log_probs(params, memory).double()
    memory = memory.repeat_interleave(k, 0)
    mem_lens = mem_lens.repeat_interleave(k, 0)
    toks = tokens.reshape(b * k, L).long().to(dev)
    tin = torch.cat([torch.full((b * k, 1), ctc.SOS, dtype=torch.long, device=dev), toks], 1)
    att = torch.log_softmax(decode(params, m, tin, torch.full((b * k,), L + 1, device=dev),
                                   memory, mem_lens).double(), dim=-1)
    return att, lp, mem_lens


@torch.no_grad()
def judge(params, cfg: dict, audio: torch.Tensor, sample_lens: torch.Tensor,
          tokens: torch.Tensor, lengths: torch.Tensor, alpha: float, weight: float,
          beam: Optional[int] = None):
    """``ctc.judge`` over the Conformer: (hybrid scores [B, K], hybrid prune
    gaps [B]) of the served hypotheses ``tokens`` [B, K, L] with
    ``lengths`` [B, K]."""
    b, k, L = tokens.shape
    dev = audio.device
    with exact_float32():
        att, lp, mem_lens = _served_terms(params, cfg, audio, sample_lens, tokens)
    r, t_all = b * k, lp.shape[1]
    utt = torch.arange(r, device=dev) // k
    toks = tokens.reshape(r, L).long().to(dev)
    n = lengths.reshape(r).long().to(dev)
    valid = ctc._valid(mem_lens, t_all)
    phi, rep = ctc.phis(ctc.forward(lp, toks, utt))
    tok_att = torch.gather(att[:, :L], 2, toks[..., None])[..., 0]
    psi_own = ctc.prefix_log_probs(lp, toks, utt, mem_lens, phi, rep)
    pos = torch.arange(L, device=dev)[None]
    total_att = (tok_att * (pos < n[:, None])).sum(1)
    rows = torch.arange(r, device=dev)
    psi_y = torch.where(n > 0, psi_own[rows, (n - 1).clamp(min=0)], torch.zeros_like(total_att))
    finished = n < L
    eos_att = att[rows, n.clamp(max=L), ctc.EOS]
    whole = phi[rows, n.clamp(max=L)].gather(1, (mem_lens.long() - 1)[:, None])[:, 0]
    total = torch.where(finished, (1 - weight) * (total_att + eos_att) + weight * whole,
                        (1 - weight) * total_att + weight * psi_y)
    scores = (total / ((5.0 + n.double()) / 6.0) ** alpha).reshape(b, k)
    gaps = ctc.prune_gaps(att, lp, utt, phi, rep, valid, toks, tok_att, psi_own, b, k,
                          lengths.cpu().numpy(), weight, ctc.pre_beam_size(beam or k) - 1)
    return scores, gaps


@torch.no_grad()
def beam_search(params, cfg: dict, audio: torch.Tensor, sample_lens: torch.Tensor,
                beam: int, max_len: int, alpha: float, weight: float, pr: Precision = F32):
    """``ctc.beam_search`` over the Conformer: (scores [B, K], best first,
    tokens [B, K, max_len]) of the hybrid beam search over ``max_len``
    steps, every product rounded by ``pr``."""
    m = cfg["model"]
    dev = audio.device
    with exact_float32():
        feats, frame_lens = fbank(audio, sample_lens, cfg["features"])
        memory, mem_lens = encode(params, m, feats, frame_lens, pr=pr)
        b, k, n_pre = memory.shape[0], beam, ctc.pre_beam_size(beam)
        lp = ctc.log_probs(params, memory, pr).double()                    # [B, T, V]
        t_all = lp.shape[1]
        memory = memory.repeat_interleave(k, 0)
        mem_lens_k = mem_lens.repeat_interleave(k, 0)
        valid = ctc._valid(mem_lens_k, t_all)
        utt = torch.arange(b * k, device=dev) // k
        xb = ctc.frames(lp, utt, torch.full_like(utt, ctc.BLANK))
        cols = torch.stack([torch.full_like(xb, NEG),
                            ctc._column(xb, torch.full_like(xb, NEG), True)], 1)
        scores = torch.full((b, k), NEG, dtype=torch.float64, device=dev)
        scores[:, 0] = 0.0
        psi = torch.zeros((b * k,), dtype=torch.float64, device=dev)
        toks = torch.zeros((b, k, 0), dtype=torch.long, device=dev)
        for i in range(max_len):
            tin = torch.cat([torch.full((b * k, 1), ctc.SOS, dtype=torch.long, device=dev),
                             toks.reshape(b * k, i)], 1)
            logits = decode(params, m, tin, torch.full((b * k,), i + 1, device=dev), memory,
                            mem_lens_k, pr=pr)[:, -1]
            att = torch.log_softmax(logits.double(), dim=-1)
            ranked = att.clone()
            ranked[:, [ctc.PAD, ctc.SOS]] = NEG
            cand = ranked.topk(n_pre, dim=-1).indices
            last = toks[:, :, -1].reshape(b * k) if i else torch.full((b * k,), -1, device=dev)
            repeat = cand == last[:, None]
            phi = torch.where(repeat[..., None], cols[:, None, 1],
                              torch.logaddexp(cols[:, 0], cols[:, 1])[:, None])
            x = ctc.frames(lp, utt, cand)
            psi_c = ctc.prefix_scores(ctc._shift(phi, torch.tensor(i == 0, device=dev)), x,
                                      valid[:, None])
            total = (scores.reshape(b * k, 1) + (1 - weight) * att.gather(1, cand)
                     + weight * (psi_c - psi[:, None]))
            total = torch.where(cand == ctc.EOS, NEG, total)
            scores, idx = total.reshape(b, k * n_pre).topk(k)
            parent = torch.div(idx, n_pre, rounding_mode="floor")
            src = (parent + torch.arange(b, device=dev)[:, None] * k).reshape(b * k)
            tok = cand.reshape(b, k * n_pre).gather(1, idx)
            flat = src * n_pre + idx.reshape(b * k) % n_pre
            psi = psi_c.reshape(-1)[flat]
            x_lab = x.reshape(b * k * n_pre, t_all)[flat]
            cols = ctc._extend(x_lab, xb, cols[src], repeat.reshape(-1)[flat], i == 0)
            toks = torch.cat([torch.gather(toks, 1, parent[..., None].expand(b, k, i)),
                              tok[..., None]], 2)
    return scores / ((5.0 + max_len) / 6.0) ** alpha, toks
