"""OpenAI's Whisper as the reference computes it, written from
``whisper/audio.py``, ``whisper/model.py`` and ``whisper/decoding.py``
(Radford et al., 2022, arXiv:2212.04356), functional over a
``{name: tensor}`` dictionary keyed as the port's ``state_dict``; its judge
and a beam search of its own. It imports neither package. Every product
is float32 with TF32 off (``exact_float32``), or rounded by a
``Precision`` (the control).

Log-mel (``audio.py``): each utterance, zero past its length, padded or
trimmed to ``N_FRAMES`` hops (``pad_or_trim``); reflect-padded by half
a window at both ends, framed at the hop (``torch.stft``'s ``center``), a
periodic Hann window, the real DFT of ``fft_length`` points, |.|² with the
last frame dropped; the Slaney-scale, Slaney-normalised filter bank
(librosa's ``filters.mel``) built here from its formula; log10 of the
power floored at 1e-10, clamped from below at the utterance's maximum less
8, and (x + 4) / 4.

Encoder (``AudioEncoder``): Conv1d(k 3, pad 1) → GELU → Conv1d(k 3, stride
2, pad 1) → GELU, plus the [sin | cos] sinusoids, pre-LN blocks
{self-attention, GELU MLP} over every frame, ``ln_post``. Decoder
(``TextDecoder``): token embedding plus learned positions (no scaling),
pre-LN blocks {causal self-attention, cross-attention, GELU MLP}, a final
LayerNorm, logits by the tied embedding. Keys have no bias; LayerNorm's
epsilon is ``model.layer_norm_eps`` (1e-5); attention scores are
q·k / √D (Whisper's q·D^-¼ times k·D^-¼).

Decoding (``decoding.py``): the forced prompt (``decode.prompt``) is read
first; ``SuppressTokens`` sets the logits of ``decode.suppress`` to -inf
at every step and ``SuppressBlank`` those of ``decode.suppress_first`` at
the first sampled step, before the log-softmax; a hypothesis of n sampled
tokens scores the sum of their log-probabilities, plus <|endoftext|>'s
when it finished, over ((5 + n) / 6) ** alpha (``MaximumLikelihoodRanker``
with ``length_penalty`` alpha).

Departures (each also in the configuration file's ``assumed``): the
dynamic-range clamp takes each utterance's own maximum (``audio.py`` takes
the maximum over whatever batch it is handed; a transcription service
computes each window alone); the port's ids keep <pad>, <sos> and <eos> at
0, 1 and 2 (``config.WHISPER_IDS`` in the port); the port's key biases
(the key third of its fused q/k/v bias, the cross-attention's
``k.bias``) are leaves here that are not read (Whisper's key projections
have none, and a key bias moves no attention);
no temperature fallback and no compression-ratio or log-prob checks.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from .model import F32, Precision, attention, exact_float32
from .serve import EOS, SOS, prune_gaps

NEG = float("-inf")
N_FRAMES = 3000   # the window: 30 s of 10-ms hops (audio.py's N_FRAMES)


# ----------------------------------------------------------------------------
# Log-mel.
# ----------------------------------------------------------------------------

def _slaney_mel(hz: np.ndarray) -> np.ndarray:
    """Hz to Slaney mels: linear at 3/200 mel a Hz up to 1 kHz (15 mels),
    logarithmic above, 27 mels for every factor of 6.4."""
    return np.where(hz < 1000.0, 3.0 * hz / 200.0,
                    15.0 + 27.0 * np.log(np.maximum(hz, 1000.0) / 1000.0) / np.log(6.4))


def _slaney_hz(mel: np.ndarray) -> np.ndarray:
    return np.where(mel < 15.0, 200.0 * mel / 3.0,
                    1000.0 * np.exp((mel - 15.0) * np.log(6.4) / 27.0))


def mel_filters(f: dict) -> np.ndarray:
    """[M, fft_length // 2 + 1] float32: M triangles between M + 2 points
    even on the Slaney scale from ``low_freq`` to Nyquist (``high_freq`` 0),
    each divided by half its width in Hz."""
    sr, n_fft, m = f["sample_rate"], f["fft_length"], f["num_mel_bins"]
    top = f["high_freq"] if f["high_freq"] > 0 else sr / 2.0 + f["high_freq"]
    pts = _slaney_hz(np.linspace(_slaney_mel(np.float64(f["low_freq"])),
                                 _slaney_mel(np.float64(top)), m + 2))
    bins = np.arange(n_fft // 2 + 1) * (sr / n_fft)
    out = np.zeros((m, bins.size))
    for i in range(m):
        lo, mid, hi = pts[i], pts[i + 1], pts[i + 2]
        rise = (bins - lo) / (mid - lo)
        fall = (hi - bins) / (hi - mid)
        out[i] = np.clip(np.minimum(rise, fall), 0.0, None) * 2.0 / (hi - lo)
    return out.astype(np.float32)


def log_mel(audio: torch.Tensor, sample_lens: torch.Tensor, f: dict) -> torch.Tensor:
    """[B, N_FRAMES, M] float32 Whisper log-mel of int16 PCM [B, S]."""
    hop, n_fft, chunk = (int(f["sample_rate"] * f["frame_shift_ms"] / 1000.0),
                         f["fft_length"], N_FRAMES)
    x = audio.double() / 32768.0
    x = x * (torch.arange(x.shape[1], device=x.device)[None] < sample_lens[:, None].long())
    n = chunk * hop
    x = x[:, :n] if x.shape[1] >= n else F.pad(x, (0, n - x.shape[1]))
    x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0].float()
    frames = x.unfold(1, n_fft, hop)[:, :chunk]                          # [B, T, n_fft]
    k = torch.arange(n_fft, dtype=torch.float64, device=x.device)
    window = (0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n_fft)).float()   # periodic Hann
    power = torch.fft.rfft(frames * window, dim=-1).abs() ** 2
    with exact_float32():
        mel = power @ torch.from_numpy(mel_filters(f)).to(x.device).t()
    logs = torch.log10(torch.clamp(mel, min=1e-10))
    logs = torch.maximum(logs, logs.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (logs + 4.0) / 4.0


# ----------------------------------------------------------------------------
# Parameters.
# ----------------------------------------------------------------------------

def param_spec(m: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter, keyed as the port's
    ``state_dict``: init ``fan_in`` (normal, std 1/√fan-in), ``embed``
    (normal, std 1/√d_model: the token embedding and the decoder's learned
    positions), ``zeros`` or ``ones``. The key biases (the key third of
    the fused q/k/v leaf, ``cross_attn.k.bias``) are leaves that nothing
    reads."""
    d, ff, v, mels = m["d_model"], m["d_ff"], m["vocab_size"], m["input_dim"]
    spec = []

    def lin(name, out_f, in_f):
        spec.append((f"{name}.weight", (out_f, in_f), "fan_in"))
        spec.append((f"{name}.bias", (out_f,), "zeros"))

    def ln(name):
        spec.extend([(f"{name}.weight", (d,), "ones"), (f"{name}.bias", (d,), "zeros")])

    spec += [("encoder.subsample.conv1.weight", (d, mels, 3), "fan_in"),
             ("encoder.subsample.conv1.bias", (d,), "zeros"),
             ("encoder.subsample.conv2.weight", (d, d, 3), "fan_in"),
             ("encoder.subsample.conv2.bias", (d,), "zeros")]
    for i in range(m["num_encoder_layers"]):
        p = f"encoder.layers.{i}"
        lin(f"{p}.self_attn.qkv", 3 * d, d)
        lin(f"{p}.self_attn.out", d, d)
        lin(f"{p}.ffn.fc1", ff, d)
        lin(f"{p}.ffn.fc2", d, ff)
        ln(f"{p}.ln1")
        ln(f"{p}.ln2")
    ln("encoder.final_norm")
    spec += [("decoder.embed.weight", (v, d), "embed"),
             ("decoder.pos_enc.pe", (m["max_target_positions"], d), "embed")]
    for i in range(m["num_decoder_layers"]):
        p = f"decoder.layers.{i}"
        lin(f"{p}.self_attn.qkv", 3 * d, d)
        lin(f"{p}.self_attn.out", d, d)
        lin(f"{p}.cross_attn.q", d, d)
        lin(f"{p}.cross_attn.k", d, d)
        lin(f"{p}.cross_attn.v", d, d)
        lin(f"{p}.cross_attn.out", d, d)
        lin(f"{p}.ffn.fc1", ff, d)
        lin(f"{p}.ffn.fc2", d, ff)
        for j in (1, 2, 3):
            ln(f"{p}.ln{j}")
    ln("decoder.final_norm")
    return spec


# ----------------------------------------------------------------------------
# Forward.
# ----------------------------------------------------------------------------

def sinusoids(length: int, channels: int, device) -> torch.Tensor:
    """``whisper/model.py``'s ``sinusoids``, in float64, as float32."""
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], 1).float().to(device)


def _dense(p, name: str, x: torch.Tensor, pr: Precision, bias: bool = True) -> torch.Tensor:
    """x Wᵀ (+ b) of the leaf ``name``; a key projection reads no bias."""
    y = pr.out(pr(x) @ pr(p[f"{name}.weight"]).t())
    return y + p[f"{name}.bias"] if bias else y


def _ln(p, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps=eps)


def _self_qkv(p, name: str, y: torch.Tensor, h: int, pr: Precision):
    """q, k, v [.., H, D] of the fused leaf: the key without its bias."""
    d = y.shape[-1]
    w = p[f"{name}.weight"]
    q = pr.out(pr(y) @ pr(w[:d]).t()) + p[f"{name}.bias"][:d]
    k = pr.out(pr(y) @ pr(w[d:2 * d]).t())
    v = pr.out(pr(y) @ pr(w[2 * d:]).t()) + p[f"{name}.bias"][2 * d:]
    split = lambda t: t.unflatten(-1, (h, d // h))
    return split(q), split(k), split(v)


def _mlp(p, name: str, y: torch.Tensor, pr: Precision) -> torch.Tensor:
    return _dense(p, f"{name}.fc2", F.gelu(_dense(p, f"{name}.fc1", y, pr)), pr)


def encode(p, m: dict, mel: torch.Tensor, pr: Precision = F32) -> torch.Tensor:
    """[B, T, M] log-mel -> [B, T // 2, d] memory."""
    h, eps = m["num_heads"], m["layer_norm_eps"]
    x = mel.transpose(1, 2)
    x = F.gelu(pr.out(F.conv1d(pr(x), pr(p["encoder.subsample.conv1.weight"]), padding=1))
               + p["encoder.subsample.conv1.bias"][:, None])
    x = F.gelu(pr.out(F.conv1d(pr(x), pr(p["encoder.subsample.conv2.weight"]), stride=2,
                               padding=1)) + p["encoder.subsample.conv2.bias"][:, None])
    x = x.transpose(1, 2)
    x = x + sinusoids(x.shape[1], x.shape[2], x.device)
    every = torch.full((x.shape[0],), x.shape[1], device=x.device)
    for i in range(m["num_encoder_layers"]):
        n = f"encoder.layers.{i}"
        q, k, v = _self_qkv(p, f"{n}.self_attn.qkv", _ln(p, f"{n}.ln1", x, eps), h, pr)
        x = x + _dense(p, f"{n}.self_attn.out", attention(q, k, v, every, False, pr).flatten(-2),
                       pr)
        x = x + _mlp(p, f"{n}.ffn", _ln(p, f"{n}.ln2", x, eps), pr)
    return _ln(p, "encoder.final_norm", x, eps)


def cross_kv(p, m: dict, memory: torch.Tensor, pr: Precision = F32):
    """Each decoder layer's cross keys (no bias) and values [B, S, H, D]."""
    h = m["num_heads"]
    split = lambda t: t.unflatten(-1, (h, t.shape[-1] // h))
    return [(split(_dense(p, f"decoder.layers.{i}.cross_attn.k", memory, pr, bias=False)),
             split(_dense(p, f"decoder.layers.{i}.cross_attn.v", memory, pr)))
            for i in range(m["num_decoder_layers"])]


def decode(p, m: dict, tokens: torch.Tensor, kv, rows: int, pr: Precision = F32,
           cache=None, start: int = 0) -> torch.Tensor:
    """Logits [N, U, V] of ``tokens`` [N, U] at positions start .. start + U - 1,
    N = B·rows (``rows`` hypotheses an utterance, in order), against each
    utterance's cross K/V ``kv`` (``cross_kv``). The self-attention is
    causal over the U tokens; with ``cache`` (a list of [K, V] a layer,
    each [N, start, H, D]) their K/V are appended to it and a single token
    (U = 1) attends to every cached position and its own."""
    h, eps = m["num_heads"], m["layer_norm_eps"]
    emb = p["decoder.embed.weight"]
    n_rows, u = tokens.shape
    x = emb[tokens.long()] + p["decoder.pos_enc.pe"][start:start + u]
    b = n_rows // rows
    for i in range(m["num_decoder_layers"]):
        n = f"decoder.layers.{i}"
        q, k, v = _self_qkv(p, f"{n}.self_attn.qkv", _ln(p, f"{n}.ln1", x, eps), h, pr)
        if cache is not None:
            k = cache[i][0] = torch.cat([cache[i][0], k], 1)
            v = cache[i][1] = torch.cat([cache[i][1], v], 1)
        a = attention(q, k, v, torch.full((n_rows,), k.shape[1], device=x.device),
                      cache is None or start == 0, pr)
        x = x + _dense(p, f"{n}.self_attn.out", a.flatten(-2), pr)
        y = _ln(p, f"{n}.ln2", x, eps)
        q = _dense(p, f"{n}.cross_attn.q", y, pr).unflatten(-1, (h, -1))
        ck, cv = kv[i]
        a = attention(q.reshape((b, rows * u) + q.shape[2:]), ck, cv,
                      torch.full((b,), ck.shape[1], device=x.device), False, pr)
        x = x + _dense(p, f"{n}.cross_attn.out", a.reshape(n_rows, u, -1), pr)
        x = x + _mlp(p, f"{n}.ffn", _ln(p, f"{n}.ln3", x, eps), pr)
    x = _ln(p, "decoder.final_norm", x, eps)
    return pr.out(pr(x) @ pr(emb).t())


def _prompt(cfg: dict) -> List[int]:
    return list(cfg["decode"]["prompt"]) or [SOS]


def suppression(cfg: dict, vocab: int, device) -> torch.Tensor:
    """[2, V] additive rows: -inf at ``decode.suppress`` (row 0, every
    step) and also at ``decode.suppress_first`` (row 1, the first)."""
    rows = torch.zeros((2, vocab), dtype=torch.float64, device=device)
    rows[:, list(cfg["decode"]["suppress"])] = NEG
    rows[1, list(cfg["decode"]["suppress_first"])] = NEG
    return rows


@torch.no_grad()
def judge(params, cfg: dict, audio: torch.Tensor, sample_lens: torch.Tensor,
          tokens: torch.Tensor, lengths: torch.Tensor, alpha: float):
    """(scores [B, K], prune gaps [B]) of hypotheses ``tokens`` [B, K, L]
    with ``lengths`` [B, K] (a hypothesis of length < L ends with <eos>):
    one teacher-forced float32 pass over prompt + hypothesis, the
    log-softmax of each sampled position under the suppression, the score
    over the GNMT penalty of its sampled tokens, and ``serve.prune_gaps``
    over the same log-probabilities."""
    m = cfg["model"]
    dev = audio.device
    with exact_float32():
        memory = encode(params, m, log_mel(audio, sample_lens, cfg["features"]))
        kv = cross_kv(params, m, memory)
        del memory
        b, k, L = tokens.shape
        prompt = _prompt(cfg)
        toks = tokens.reshape(b * k, L).long().to(dev)
        tin = torch.cat([torch.tensor(prompt, device=dev).expand(b * k, -1), toks], 1)
        logits = decode(params, m, tin, kv, k)[:, len(prompt) - 1:]         # [BK, L+1, V]
    ban = suppression(cfg, logits.shape[-1], dev)
    logits = logits.double()
    logits[:, 0] += ban[1]
    logits[:, 1:] += ban[0]
    logp = torch.log_softmax(logits, dim=-1)
    n = lengths.reshape(b * k).long().to(dev)
    tok_lp = torch.gather(logp[:, :L], 2, toks[..., None])[..., 0]
    kept = torch.arange(L, device=dev)[None] < n[:, None]
    total = torch.where(kept, tok_lp, torch.zeros_like(tok_lp)).sum(1)
    eos_lp = logp[torch.arange(b * k, device=dev), n.clamp(max=L), EOS]
    total = total + torch.where(n < L, eos_lp, torch.zeros_like(eos_lp))
    scores = (total / ((5.0 + n.double()) / 6.0) ** alpha).reshape(b, k)
    gaps = prune_gaps(logp.reshape(b, k, L + 1, -1).cpu().numpy(),
                      tokens.long().cpu().numpy(), lengths.cpu().numpy())
    return scores, gaps


@torch.no_grad()
def beam_search(params, cfg: dict, audio: torch.Tensor, sample_lens: torch.Tensor,
                beam: int, max_len: int, alpha: float, pr: Precision = F32):
    """(scores [B, K], best first, and tokens [B, K, max_len]) of a beam
    search of ``max_len`` steps after the prompt: every live hypothesis is
    extended by every token but <pad>, <sos>, <eos> and the suppressed
    ones, and the best ``beam`` of an utterance's extensions live on (at
    the first step those of the prompt). The self K/V of each hypothesis
    are cached and follow its parent; scores are length-penalised as
    ``judge``'s."""
    m = cfg["model"]
    dev = audio.device
    prompt = _prompt(cfg)
    with exact_float32():
        memory = encode(params, m, log_mel(audio, sample_lens, cfg["features"]), pr)
        kv = cross_kv(params, m, memory, pr)
        b, k = memory.shape[0], beam
        del memory
        h = m["num_heads"]
        empty = torch.zeros((b, 0, h, m["d_model"] // h), device=dev)
        cache = [[empty, empty] for _ in range(m["num_decoder_layers"])]
        logits = decode(params, m, torch.tensor(prompt, device=dev).expand(b, -1), kv, 1, pr,
                        cache)
        # every hypothesis starts from the prompt's rows and last logits
        cache = [[t.repeat_interleave(k, 0) for t in layer] for layer in cache]
        logits = logits[:, -1].repeat_interleave(k, 0)
        ban = suppression(cfg, logits.shape[-1], dev)
        scores = torch.full((b, k), NEG, dtype=torch.float64, device=dev)
        scores[:, 0] = 0.0
        toks = torch.zeros((b, k, 0), dtype=torch.long, device=dev)
        for i in range(max_len):
            logp = torch.log_softmax(logits.double() + ban[1 if i == 0 else 0], dim=-1)
            logp[:, [0, SOS, EOS]] = NEG
            v = logp.shape[-1]
            scores, idx = (scores[:, :, None] + logp.reshape(b, k, v)).reshape(b, k * v).topk(k)
            parent = torch.div(idx, v, rounding_mode="floor")
            rows = (parent + torch.arange(b, device=dev)[:, None] * k).reshape(b * k)
            cache = [[t[rows] for t in layer] for layer in cache]
            toks = torch.cat([torch.gather(toks, 1, parent[..., None].expand(b, k, i)),
                              (idx % v)[..., None]], 2)
            if i + 1 < max_len:
                logits = decode(params, m, (idx % v).reshape(b * k, 1), kv, k, pr, cache,
                                len(prompt) + i)[:, -1]
    return scores / ((5.0 + max_len) / 6.0) ** alpha, toks
